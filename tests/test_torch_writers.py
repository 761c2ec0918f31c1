"""The port's post-processing writers (``buzzdetect_torch/write/detections.py``,
``trim.py``, ``activity.py``) and their tools
(``buzzdetect_torch.tools.call_detections``, ``trim_results``,
``activity_report``) against the JAX package's.

Every case of ``tests/test_detections.py`` (20), ``tests/test_activity.py``
(9) and the seven trim cases of ``tests/test_train.py`` runs here twice,
through each package, on its own copy of the same result files. The
returned values must be equal, and the two working trees must be
byte-identical afterwards: event CSVs, Audacity labels, Raven tables,
event WAVs, activity CSVs and SVGs, trimmed npz archives (member by
member: the zip container stamps the time of writing). Tool cases compare
exit codes and standard output. Each case prints its max |port - reference|.
"""

import contextlib
import importlib
import importlib.util
import io
import os
import shutil
import sys
import zipfile
from datetime import datetime
from types import SimpleNamespace

import numpy as np
import pytest

from tests.audio_fixtures import pattern_position, pcm_pattern, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ('buzzdetect_tpu', 'buzzdetect_torch')
CLASSES = ['ins_buzz', 'ambient_noise']

METRICS_SYNTH = """threshold,precision,sensitivity,fpr
-2.0,0.50,0.99,0.5
-1.0,0.70,0.90,0.3
0.0,0.85,0.75,0.1
1.0,0.95,0.50,0.02
2.0,0.99,0.20,0.001
"""


def mods(pkg):
    def m(name):
        return importlib.import_module(f'{pkg}.{name}')
    return SimpleNamespace(
        pkg=pkg, det=m('write.detections'), trim=m('write.trim'),
        act=m('write.activity'), thr=m('write.thresholds'),
        manifest=m('manifest'), convert=m('models.convert'),
        cfg=m('config'), validation=m('validation'), audio=m('audio'),
        ffi=m('audio.ffi'))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_tool_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_tool(pkg, name, argv):
    """One package's tool in process -> (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            if pkg == 'buzzdetect_torch':
                importlib.import_module(
                    f'buzzdetect_torch.tools.{name}').main(argv)
            else:
                saved = sys.argv
                sys.argv = [f'{name}.py'] + list(argv)
                try:
                    _jax_tool(name).main()
                finally:
                    sys.argv = saved
        except SystemExit as e:
            if isinstance(e.code, str):
                print(e.code, file=sys.stderr)
                code = 1
            else:
                code = e.code or 0
    return code, out.getvalue(), err.getvalue()


def _tree(root):
    """{relative path: content} of every file under ``root``, with ``root``
    itself written as ``<d>`` (a bundle's provenance names its sources);
    an npz as {member: bytes} (its zip container stamps the time of
    writing)."""
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            rel = os.path.relpath(path, root)
            if f.endswith('.npz') and zipfile.is_zipfile(path):
                with zipfile.ZipFile(path) as z:
                    out[rel] = {n: z.read(n) for n in sorted(z.namelist())}
            else:
                with open(path, 'rb') as fh:
                    out[rel] = fh.read().replace(str(root).encode(), b'<d>')
    return out


def _max_abs(a, b):
    """Max |a - b| over the numbers of two equal-shaped results (0 when
    they hold none)."""
    if isinstance(a, dict):
        return max([_max_abs(a[k], b[k]) for k in a] or [0.0])
    if isinstance(a, (list, tuple)):
        return max([_max_abs(x, y) for x, y in zip(a, b)] or [0.0])
    if isinstance(a, np.ndarray):
        if a.size == 0 or not np.issubdtype(a.dtype, np.number):
            return 0.0
        return float(np.abs(a.astype(np.float64) - b).max())
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return abs(float(a) - float(b))
    return 0.0


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def both(tmp_path, act, make_inputs=None):
    """Run ``act(m, d)`` once per package, each in its own copy ``d`` of
    the inputs ``make_inputs(dir)`` writes; the results (with the copy's
    path replaced by ``<d>``) must be equal and the two trees
    byte-identical. Returns the port's result."""
    src = tmp_path / 'inputs'
    src.mkdir()
    if make_inputs is not None:
        make_inputs(src)
    results, trees = [], []
    for pkg in PKGS:
        d = tmp_path / pkg
        shutil.copytree(src, d)
        res = act(mods(pkg), d)
        results.append(_replace(res, str(d), '<d>'))
        trees.append(_tree(d))
    ref, got = results
    print(f'max |port - reference| = {_max_abs(got, ref)}; files '
          f'{sorted(trees[1])}')
    assert _equal(got, ref), (got, ref)
    assert trees[1].keys() == trees[0].keys()
    for rel in trees[0]:
        assert trees[1][rel] == trees[0][rel], f'{rel} differs'
    return got


def _replace(x, old, new):
    if isinstance(x, str):
        return x.replace(old, new)
    if isinstance(x, dict):
        return {k: _replace(v, old, new) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_replace(v, old, new) for v in x)
    return x


def _write_result(path, starts, buzz, noise=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        f.write('start,' + ','.join(f'activation_{c}' for c in CLASSES)
                + '\n')
        for i, s in enumerate(starts):
            n = noise[i] if noise is not None else -5.0
            f.write(f'{s},{buzz[i]},{n}\n')


def _event(ident, start, end, cls='ins_buzz'):
    return {'ident': ident, 'class': cls, 'start': start, 'end': end,
            'duration': end - start, 'n_frames': 1,
            'activation_max': 1.0, 'activation_mean': 0.5}


# --- tests/test_detections.py ------------------------------------------------

def test_frames_to_events_coalesces_runs(tmp_path):
    def act(m, d):
        starts = np.arange(10) * 0.96
        acts = np.full(10, -5.0)
        acts[2:5] = 1.0
        acts[8] = 2.0
        return m.det.frames_to_events(starts, acts, threshold=0.0)
    events = both(tmp_path, act)
    assert len(events) == 2
    assert events[0]['n_frames'] == 3 and events[1]['n_frames'] == 1
    assert events[0]['end'] == pytest.approx(5 * 0.96)


def test_frames_to_events_merge_gap_and_order(tmp_path):
    def act(m, d):
        starts = np.array([1.92, 0.0, 0.96, 2.88])
        acts = np.array([-9.0, 1.0, -9.0, 1.0])
        return (m.det.frames_to_events(starts, acts, threshold=0.0),
                m.det.frames_to_events(starts, acts, threshold=0.0,
                                       merge_gap_s=3.0 * 0.96))
    apart, merged = both(tmp_path, act)
    assert len(apart) == 2 and len(merged) == 1
    assert merged[0]['n_frames'] == 2
    assert merged[0]['activation_mean'] == 1.0


def test_frames_to_events_empty(tmp_path):
    def act(m, d):
        return m.det.frames_to_events([0.0, 0.96], [-9.0, -9.0],
                                      threshold=0.0)
    assert both(tmp_path, act) == []


def test_call_detections_file_missing_class(tmp_path):
    def inputs(d):
        _write_result(str(d / 'a_buzzdetect.csv'), [0.0], [1.0])

    def act(m, d):
        with pytest.raises(KeyError, match='frog') as e:
            m.det.call_detections_file(str(d / 'a_buzzdetect.csv'),
                                       threshold=0.0, classes=('frog',))
        return str(e.value)
    both(tmp_path, act, inputs)


def test_call_detections_directory_csv_and_trimmed(tmp_path):
    starts = list(np.arange(6) * 0.96)

    def inputs(d):
        _write_result(str(d / 'out' / 'a_buzzdetect.csv'), starts,
                      [2.0, 2.0, -5.0, -5.0, -5.0, -5.0])
        _write_result(str(d / 'out' / 'sub' / 'b_buzzdetect.csv'), starts,
                      [-5.0] * 6)
        _write_result(str(d / 'out' / 'c_buzzdetect.csv'), starts,
                      [-5.0, -5.0, -5.0, 3.0, 3.0, 3.0])

    def act(m, d):
        out = str(d / 'out')
        m.trim.trim_directory(out, classes_keep=('ins_buzz',), decimals=1)
        os.remove(os.path.join(out, 'c_buzzdetect.csv'))
        # a stray archive trimmed to OTHER classes is skipped and reported
        stray = os.path.join(out, 'stray_buzzdetect.csv')
        _write_result(stray, starts, [9.0] * 6)
        np.savez_compressed(
            os.path.join(out, 'stray_buzztrim.npz'),
            **m.trim.trim_results(stray, classes_keep=('ambient_noise',)))
        os.remove(stray)
        skipped = []
        rows = m.det.call_detections_directory(
            out, threshold=0.0, path_out=str(d / 'events.csv'),
            on_skip=lambda p, why: skipped.append(p))
        return rows, skipped
    rows, skipped = both(tmp_path, act, inputs)
    assert len(skipped) == 1 and skipped[0].endswith('stray_buzztrim.npz')
    assert sorted({r['ident'] for r in rows}) == ['a', 'c']
    lines = (tmp_path / 'buzzdetect_torch' / 'events.csv').read_text() \
        .splitlines()
    assert lines[0].startswith('ident,class,start,end,duration')
    assert len(lines) == 3


def test_export_audacity_labels(tmp_path):
    def inputs(d):
        starts = list(np.arange(6) * 0.96)
        _write_result(str(d / 'out' / 'a_buzzdetect.csv'), starts,
                      [2.0, 2.0, -5.0, -5.0, 3.0, -5.0])
        _write_result(str(d / 'out' / 'sub' / 'b_buzzdetect.csv'), starts,
                      [-5.0, -5.0, 1.0, -5.0, -5.0, -5.0])

    def act(m, d):
        rows = m.det.call_detections_directory(str(d / 'out'), threshold=0.0)
        written = m.det.write_audacity_labels(rows, str(d / 'labels'))
        return [os.path.relpath(p, d) for p in written]
    written = both(tmp_path, act, inputs)
    assert written == [os.path.join('labels', 'a_labels.txt'),
                       os.path.join('labels', 'sub', 'b_labels.txt')]


def test_export_raven_selection_tables(tmp_path):
    def inputs(d):
        starts = list(np.arange(4) * 0.96)
        _write_result(str(d / 'out' / 'a_buzzdetect.csv'), starts,
                      [1.5, -5.0, -5.0, 4.5])
        _write_result(str(d / 'out' / 'sub' / 'b_buzzdetect.csv'), starts,
                      [-5.0, -5.0, 2.5, -5.0])

    def act(m, d):
        rows = m.det.call_detections_directory(str(d / 'out'), threshold=0.0)
        written = m.det.write_raven_tables(rows, str(d / 'sel'))
        return [os.path.relpath(p, d) for p in written], m.det.RAVEN_FIELDS
    written, fields = both(tmp_path, act, inputs)
    assert len(written) == 2 and fields[0] == 'Selection'
    lines = (tmp_path / 'buzzdetect_torch' / 'sel' /
             'a_selections.txt').read_text().splitlines()
    assert lines[2].split('\t')[-1] == 'ins_buzz max=4.50'


def _install_metrics(d, cfg_module, monkeypatch, modelname='recmodel'):
    tests = d / 'models' / modelname / 'tests'
    os.makedirs(tests, exist_ok=True)
    (tests / 'metrics.csv').write_text(METRICS_SYNTH)
    monkeypatch.setattr(cfg_module, 'DIR_MODELS', str(d / 'models'))


def test_call_detections_threshold_from_manifest_precision(tmp_path,
                                                           monkeypatch):
    """precision= resolves the threshold from the metrics table bundled
    with the model the manifest names (a seeded bundle with the synthetic
    table)."""
    def inputs(d):
        (d / 'metrics.csv').write_text(METRICS_SYNTH)
        _write_result(str(d / 'out' / 'a_buzzdetect.csv'),
                      [0.0, 0.96], [5.0, -9.0])

    def act(m, d):
        m.convert.build_model_bundle(str(d / 'models' / 'detmodel'),
                                     classes=CLASSES, seed=7,
                                     metrics_csv=str(d / 'metrics.csv'))
        monkeypatch.setattr(m.cfg, 'DIR_MODELS', str(d / 'models'))
        m.manifest.write_manifest(str(d / 'out'), m.manifest.build_manifest(
            'detmodel', 1.0, None, CLASSES))
        rows = m.det.call_detections_directory(str(d / 'out'),
                                               precision=0.95)
        errors = []
        for kw in ({'precision': 0.95, 'threshold': -1.0}, {}):
            with pytest.raises(ValueError, match='exactly one') as e:
                m.det.call_detections_directory(str(d / 'out'), **kw)
            errors.append(str(e.value))
        return rows, errors
    rows, _ = both(tmp_path, act, inputs)
    assert len(rows) == 1 and rows[0]['n_frames'] == 1


def test_threshold_at_recall_picks_most_precise_qualifying_row(
        tmp_path, monkeypatch):
    def act(m, d):
        _install_metrics(d, m.cfg, monkeypatch)
        return [m.thr.threshold_at_recall('recmodel', r)
                for r in (0.90, 0.80, 0.20)]
    got = both(tmp_path, act)
    assert got[0] == {'threshold': -1.0, 'sensitivity': 0.90,
                      'precision': 0.70}
    assert got[2]['threshold'] == 2.0


def test_threshold_at_recall_rejects_unattainable_and_invalid(
        tmp_path, monkeypatch):
    def act(m, d):
        _install_metrics(d, m.cfg, monkeypatch)
        errors = []
        for bad, msg in ((0.995, 'highest measured sensitivity'),
                         (0.0, 'recall must be'), (-0.5, 'recall must be'),
                         (1.5, 'recall must be')):
            with pytest.raises(ValueError, match=msg) as e:
                m.thr.threshold_at_recall('recmodel', bad)
            errors.append(str(e.value))
        return errors
    assert len(both(tmp_path, act)) == 4


def test_call_detections_recall_from_manifest(tmp_path, monkeypatch):
    def inputs(d):
        _write_result(str(d / 'out' / 'a_buzzdetect.csv'),
                      [0.0, 0.96], [5.0, -1.5])

    def act(m, d):
        _install_metrics(d, m.cfg, monkeypatch)
        m.manifest.write_manifest(str(d / 'out'), m.manifest.build_manifest(
            'recmodel', 1.0, None, CLASSES))
        rows = m.det.call_detections_directory(str(d / 'out'), recall=0.9)
        for kw in ({'precision': 0.95}, {'threshold': -1.0}):
            with pytest.raises(ValueError, match='exactly one'):
                m.det.call_detections_directory(str(d / 'out'), recall=0.9,
                                                **kw)
        return rows
    rows = both(tmp_path, act, inputs)
    assert len(rows) == 1 and rows[0]['n_frames'] == 1


def test_export_event_clips_sample_accurate(tmp_path):
    sr = 16000

    def inputs(d):
        (d / 'audio').mkdir()
        write_wav(d / 'audio' / 'rec1.wav', pcm_pattern(0, 10 * sr), sr)

    def act(m, d):
        written = m.det.write_event_clips(
            [_event('rec1', 2.0, 3.0)], str(d / 'audio'), str(d / 'clips'),
            pad_s=0.5, rate=sr)
        return [os.path.relpath(p, d) for p in written]
    written = both(tmp_path, act, inputs)
    import wave
    with wave.open(str(tmp_path / 'buzzdetect_torch' / written[0])) as w:
        data = np.frombuffer(w.readframes(w.getnframes()), '<i2')
    assert len(data) == 2 * sr
    assert pattern_position(data / 32768.0) == int(1.5 * sr)


def test_export_event_clips_clamps_and_mirrors_subdirs(tmp_path):
    sr = 16000

    def inputs(d):
        (d / 'audio' / 'sub').mkdir(parents=True)
        write_wav(d / 'audio' / 'sub' / 'rec2.wav', pcm_pattern(0, 4 * sr),
                  sr)

    def act(m, d):
        written = m.det.write_event_clips(
            [_event('sub/rec2', 0.2, 1.0), _event('sub/rec2', 3.5, 3.9)],
            str(d / 'audio'), str(d / 'clips'), pad_s=1.0, rate=sr)
        return [os.path.relpath(p, d) for p in written]
    assert both(tmp_path, act, inputs) == [
        os.path.join('clips', 'sub', 'rec2_ins_buzz_0.20-1.00s.wav'),
        os.path.join('clips', 'sub', 'rec2_ins_buzz_3.50-3.90s.wav')]


def test_export_event_clips_native_rate_and_skips(tmp_path):
    def inputs(d):
        (d / 'audio').mkdir()
        write_wav(d / 'audio' / 'hi.wav', pcm_pattern(0, 2 * 32000), 32000)

    def act(m, d):
        skipped = []
        written = m.det.write_event_clips(
            [_event('hi', 0.5, 1.0), _event('ghost', 0.0, 1.0)],
            str(d / 'audio'), str(d / 'clips'), pad_s=0.0, rate=0,
            on_skip=lambda ident, why: skipped.append((ident, why)))
        return [os.path.relpath(p, d) for p in written], skipped
    written, skipped = both(tmp_path, act, inputs)
    assert len(written) == 1 and skipped[0][0] == 'ghost'


def test_export_event_clips_from_called_events(tmp_path):
    sr = 16000

    def inputs(d):
        (d / 'audio').mkdir()
        write_wav(d / 'audio' / 'a.wav', pcm_pattern(0, 6 * sr), sr)
        _write_result(str(d / 'out' / 'a_buzzdetect.csv'),
                      list(np.arange(6) * 0.96),
                      [-5.0, 2.0, 2.0, -5.0, -5.0, -5.0])

    def act(m, d):
        rows = m.det.call_detections_directory(str(d / 'out'), threshold=0.0)
        written = m.det.write_event_clips(rows, str(d / 'audio'),
                                          str(d / 'clips'), pad_s=0.25)
        return rows, [os.path.relpath(p, d) for p in written]
    _rows, written = both(tmp_path, act, inputs)
    assert len(written) == 1
    assert os.path.basename(written[0]).startswith('a_ins_buzz_0.96-')


class _FakeTrack:
    """A decode driver that hands back zeros, with an unknown duration
    (``frames=-1``) or a read that fails."""

    def __init__(self, frames, error=None, fail_at_read=None, sr=16000,
                 empty=False):
        self.samplerate = sr
        self.frames = frames
        self._error, self._fail_at_read = error, fail_at_read
        self._reads = 0
        self._empty = empty

    def seek(self, sample):
        pass

    def read(self, n, dtype=None):
        self._reads += 1
        if self._fail_at_read is not None \
                and self._reads >= self._fail_at_read:
            raise self._error('bit rot')
        return np.zeros(0 if self._empty else int(n), np.int16)

    def close(self):
        pass


def test_export_event_clips_unknown_duration_and_midstream_failure(
        tmp_path, monkeypatch):
    sr = 16000

    def inputs(d):
        (d / 'audio').mkdir()
        for ident in ('nodur', 'rot', 'good'):
            (d / 'audio' / f'{ident}.wav').write_bytes(b'placeholder')

    def act(m, d):
        tracks = {'nodur': _FakeTrack(-1),
                  'rot': _FakeTrack(10 * sr, m.ffi.DecodeError, 1),
                  'good': _FakeTrack(10 * sr)}
        monkeypatch.setattr(
            m.audio, 'build_track', lambda path, target_rate=16000: tracks[
                os.path.splitext(os.path.basename(path))[0]])
        skipped = []
        written = m.det.write_event_clips(
            [_event('nodur', 1.0, 2.0), _event('rot', 1.0, 2.0),
             _event('good', 1.0, 2.0)],
            str(d / 'audio'), str(d / 'clips'), pad_s=0.5,
            on_skip=lambda ident, why: skipped.append(ident))
        return sorted(os.path.relpath(p, d) for p in written), skipped
    written, skipped = both(tmp_path, act, inputs)
    assert [os.path.basename(p) for p in written] == [
        'good_ins_buzz_1.00-2.00s.wav', 'nodur_ins_buzz_1.00-2.00s.wav']
    assert skipped == ['rot']


def test_classes_out_rejects_empty_list(tmp_path):
    def act(m, d):
        v = m.validation
        return [v.validate_classes_out([]).valid,
                v.validate_alert_classes([]).valid,
                v.validate_classes_out(['ins_buzz']).valid]
    assert both(tmp_path, act) == [False, False, True]


AMBIGUOUS = ([], ['--threshold', '-1', '--precision', '0.9'],
             ['--precision', '0.9', '--recall', '0.9'],
             ['--threshold', '-1', '--recall', '0.9'],
             ['--threshold', '-1', '--precision', '0.9', '--recall', '0.9'])


@pytest.mark.parametrize('tool,extra,msg', [
    ('call_detections', e, 'exactly one of') for e in AMBIGUOUS] + [
    ('activity_report', [], 'exactly one of'),
    ('activity_report', ['--threshold', '0', '--recall', '0.9'],
     'exactly one of'),
    ('activity_report', ['--recall', '1.2'], 'must be in (0, 1]')])
def test_tool_calibration_flag_contract(tmp_path, tool, extra, msg):
    """The cases of test_call_detections_cli_rejects_ambiguous_threshold
    and test_activity_report_tool_threshold_flag_contract, one contract:
    a parser error (exit 2) naming it, no traceback."""
    def act(m, d):
        code, out, err = run_tool(m.pkg, tool,
                                  ['--dir_results', str(d)] + extra)
        assert code == 2 and msg in err and 'Traceback' not in err
        return code, out
    both(tmp_path, act)


def test_call_detections_directory_survives_corrupt_archive(tmp_path):
    def inputs(d):
        _write_result(str(d / 'res' / 'good_buzzdetect.csv'),
                      [0.0, 0.96, 1.92], [1.5, 1.5, -3.0])
        (d / 'res' / 'bad_buzztrim.npz').write_bytes(
            b'PK\x03\x04 truncated garbage')

    def act(m, d):
        skipped = []
        rows = m.det.call_detections_directory(
            str(d / 'res'), threshold=0.0,
            on_skip=lambda p, why: skipped.append((p, why)))
        return rows, skipped
    rows, skipped = both(tmp_path, act, inputs)
    assert [r['ident'] for r in rows] == ['good'] and len(skipped) == 1


def test_event_clips_skip_past_eof_event(tmp_path, monkeypatch):
    def inputs(d):
        (d / 'audio').mkdir()
        (d / 'audio' / 'rec.aac').write_bytes(b'\xff\xf1' + b'\0' * 64)

    def act(m, d):
        monkeypatch.setattr(m.audio, 'build_track',
                            lambda *a, **k: _FakeTrack(-1, empty=True))
        skipped = []
        written = m.det.write_event_clips(
            [{'ident': 'rec', 'class': 'ins_buzz', 'start': 100.0,
              'end': 101.0}],
            str(d / 'audio'), str(d / 'clips'),
            on_skip=lambda i, why: skipped.append((i, why)))
        return written, skipped
    written, skipped = both(tmp_path, act, inputs)
    assert written == [] and 'past the end' in skipped[0][1]


# --- tests/test_activity.py --------------------------------------------------

def test_parse_ident_timestamp_conventions(tmp_path):
    def act(m, d):
        p = m.act.parse_ident_timestamp
        return [p('20240601_123000'), p('HIVE3_20240601_123000'),
                p('site_a/HIVE3_20240601_123000_cut'),
                p('rec-2024-06-01T12-30-00', fmt='%Y-%m-%dT%H-%M-%S'),
                p('no_timestamp_here'), p('99999999_999999')]
    got = both(tmp_path, act)
    want = datetime(2024, 6, 1, 12, 30, 0)
    assert got == [want] * 4 + [None, None]


def test_bin_events_splits_boundaries_exactly(tmp_path):
    def act(m, d):
        return m.act.bin_events(
            [_event('a', 30.0, 105.0)],
            {'a': datetime(2024, 6, 1, 11, 59, 0)}, bin_s=3600.0)
    binned = both(tmp_path, act)
    assert binned[(datetime(2024, 6, 1, 11), 'ins_buzz')]['seconds'] == \
        pytest.approx(30.0)
    assert binned[(datetime(2024, 6, 1, 12), 'ins_buzz')]['n_events'] == 0


def test_bin_events_day_bins_align_to_midnight(tmp_path):
    def act(m, d):
        return m.act.bin_events(
            [_event('a', 0.0, 10.0), _event('b', 0.0, 5.0)],
            {'a': datetime(2024, 6, 1, 23), 'b': datetime(2024, 6, 2, 1)},
            bin_s=86400.0)
    assert {b for b, _ in both(tmp_path, act)} == {
        datetime(2024, 6, 1), datetime(2024, 6, 2)}


def test_bin_events_missing_ident_and_empty(tmp_path):
    def act(m, d):
        with pytest.raises(KeyError, match='ghost') as e:
            m.act.bin_events([_event('ghost', 0.0, 1.0)], {}, bin_s=60.0)
        return m.act.bin_events([], {}, bin_s=60.0), str(e.value)
    assert both(tmp_path, act)[0] == {}


def test_bin_events_rejects_nonpositive_width(tmp_path):
    def act(m, d):
        errors = []
        for bad in (-3600.0, 0.0):
            with pytest.raises(ValueError, match='positive') as e:
                m.act.bin_events([_event('r', 0.0, 1.0)],
                                 {'r': datetime(2024, 6, 1)}, bin_s=bad)
            errors.append(str(e.value))
        return errors
    assert len(both(tmp_path, act)) == 2


def test_render_activity_csv(tmp_path):
    def act(m, d):
        binned = m.act.bin_events([_event('a', 0.0, 2.5)],
                                  {'a': datetime(2024, 6, 1, 10)},
                                  bin_s=3600.0)
        return os.path.relpath(
            m.act.render_activity_csv(binned, str(d / 'act.csv')), d)
    both(tmp_path, act)
    lines = (tmp_path / 'buzzdetect_torch' / 'act.csv').read_text() \
        .splitlines()
    assert lines == ['bin_start,class,n_events,detected_seconds',
                     '2024-06-01 10:00:00,ins_buzz,1,2.5']


def _recorder_results(d):
    starts = [i * 0.96 for i in range(6)]
    for name, buzz in (('HIVE1_20240601_120000',
                        [2.0, 2.0, -5.0, -5.0, -5.0, -5.0]),
                       ('HIVE1_20240601_130000',
                        [-5.0, -5.0, -5.0, 3.0, -5.0, -5.0])):
        _write_result(str(d / 'out' / f'{name}_buzzdetect.csv'), starts,
                      buzz)


def test_activity_report_tool_end_to_end(tmp_path, monkeypatch):
    """The table CSV and the SVG chart, byte-identical: matplotlib's SVG
    date comes from SOURCE_DATE_EPOCH and its ids from svg.hashsalt."""
    import matplotlib
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '0')
    monkeypatch.setitem(matplotlib.rcParams, 'svg.hashsalt', 'buzz')

    def act(m, d):
        code, out, err = run_tool(
            m.pkg, 'activity_report',
            ['--dir_results', str(d / 'out'), '--threshold', '0',
             '--out', str(d / 'activity.csv'), '--plot',
             str(d / 'activity.svg')])
        assert code == 0, err
        return code, out
    both(tmp_path, act, _recorder_results)
    lines = (tmp_path / 'buzzdetect_torch' / 'activity.csv').read_text() \
        .splitlines()
    assert lines[1].startswith('2024-06-01 12:00:00,ins_buzz,1,')
    assert lines[2].startswith('2024-06-01 13:00:00,ins_buzz,1,')


def test_activity_report_tool_missing_timestamps(tmp_path):
    def inputs(d):
        (d / 'out').mkdir()
        (d / 'out' / 'noname_buzzdetect.csv').write_text(
            'start,activation_ins_buzz\n0.0,2.0\n')

    def act(m, d):
        base = ['--dir_results', str(d / 'out'), '--threshold', '0']
        first = run_tool(m.pkg, 'activity_report', base)
        second = run_tool(m.pkg, 'activity_report',
                          base + ['--allow_missing'])
        assert first[0] != 0 and 'timestamp' in first[2]
        assert second[0] == 0, second[2]
        return first, second
    both(tmp_path, act, inputs)


# --- the trim cases of tests/test_train.py ----------------------------------

def test_trim_directory_roundtrip(tmp_path):
    def inputs(d):
        (d / 'results').mkdir()
        rng = np.random.default_rng(0)
        acts = rng.normal(-2, 1, (2000, 2)).round(2)
        with open(d / 'results' / 'x_buzzdetect.csv', 'w') as f:
            f.write('start,activation_ins_buzz,activation_human\n')
            for k, (a, b) in enumerate(acts):
                f.write(f'{round(k * 0.96, 2)},{a},{b}\n')

    def act(m, d):
        n_files, before, after = m.trim.trim_directory(
            str(d / 'results'), classes_keep=('ins_buzz',), decimals=1)
        starts, cols = m.trim.read_trimmed(
            str(d / 'results' / ('x' + m.trim.SUFFIX_TRIMMED)))
        return n_files, before, after, starts, cols
    n_files, before, after, _starts, cols = both(tmp_path, act, inputs)
    assert n_files == 1 and before / after > 5
    assert list(cols) == ['activation_ins_buzz']


def test_trim_start_grid_exact_past_36h(tmp_path):
    starts = [round(140000.0 + k * 0.96, 2) for k in range(50)]

    def inputs(d):
        (d / 'results').mkdir()
        with open(d / 'results' / 'long_buzzdetect.csv', 'w') as f:
            f.write('start,activation_ins_buzz\n')
            for s in starts:
                f.write(f'{s},-1.23\n')
        np.savez_compressed(d / 'results' / 'old_buzztrim.npz',
                            starts=np.array([0.0, 0.96], np.float32),
                            decimals=np.int16(1),
                            activation_ins_buzz=np.array([-12, -10],
                                                         np.int16))

    def act(m, d):
        m.trim.trim_directory(str(d / 'results'), classes_keep=('ins_buzz',),
                              decimals=1)
        return (m.trim.read_trimmed(str(d / 'results' /
                                        'long_buzztrim.npz')),
                m.trim.read_trimmed(str(d / 'results' /
                                        'old_buzztrim.npz')))
    (got, _cols), (old, _old_cols) = both(tmp_path, act, inputs)
    assert got.tolist() == starts
    np.testing.assert_allclose(old, [0.0, 0.96], atol=1e-6)


def _big_results(d):
    (d / 'results').mkdir()
    with open(d / 'results' / 'big_buzzdetect.csv', 'w') as f:
        f.write('start,activation_ins_buzz,activation_human\n')
        for k in range(3000):
            f.write(f'{round(k * 0.96, 2)},-1.23,-0.5\n')


def test_trim_results_cli(tmp_path):
    def act(m, d):
        done = run_tool(m.pkg, 'trim_results',
                        ['--dir_results', str(d / 'results'),
                         '--remove_original'])
        missing = run_tool(m.pkg, 'trim_results',
                           ['--dir_results', str(d / 'nope')])
        return done, missing
    done, missing = both(tmp_path, act, _big_results)
    assert done[0] == 0 and 'trimmed 1 file(s)' in done[1]
    assert 'EXPANDED' not in done[1]
    assert missing[0] != 0 and 'no finalized' in missing[2]
    assert not (tmp_path / 'buzzdetect_torch' / 'results' /
                'big_buzzdetect.csv').exists()


def test_trim_survives_header_only_csv(tmp_path):
    def inputs(d):
        (d / 'results').mkdir()
        (d / 'results' / 'empty_buzzdetect.csv').write_text(
            'start,activation_ins_buzz\n')
        (d / 'results' / 'real_buzzdetect.csv').write_text(
            'start,activation_ins_buzz\n0.0,-1.25\n0.96,-2.5\n')

    def act(m, d):
        n_files, _b, _a = m.trim.trim_directory(str(d / 'results'),
                                                decimals=2)
        return n_files, [m.trim.read_trimmed(str(d / 'results' / (
            n + m.trim.SUFFIX_TRIMMED))) for n in ('empty', 'real')]
    n_files, ((s0, c0), (_s1, c1)) = both(tmp_path, act, inputs)
    assert n_files == 2 and len(s0) == 0
    np.testing.assert_allclose(c1['activation_ins_buzz'], [-1.25, -2.5])


def _bad_and_ok(d):
    (d / 'res').mkdir()
    (d / 'res' / 'ok_buzzdetect.csv').write_text(
        'start,activation_ins_buzz\n0.0,-1.2\n0.96,-1.0\n')
    (d / 'res' / 'bad_buzzdetect.csv').write_text(
        'start,activation_ins_buzz\n0.0,nan\n0.96,-1.0\n')


def test_trim_skips_nonfinite_and_keeps_original(tmp_path):
    def act(m, d):
        skipped = []
        n, _b, _a = m.trim.trim_directory(
            str(d / 'res'), classes_keep=('ins_buzz',), remove_original=True,
            on_skip=lambda p, why: skipped.append((p, why)))
        return n, skipped
    n, skipped = both(tmp_path, act, _bad_and_ok)
    assert n == 1 and 'non-finite' in skipped[0][1]
    d = tmp_path / 'buzzdetect_torch' / 'res'
    assert sorted(os.listdir(d)) == ['bad_buzzdetect.csv', 'ok_buzztrim.npz']


def test_trim_directory_failed_write_leaves_no_tmp_debris(tmp_path,
                                                          monkeypatch):
    def inputs(d):
        (d / 'results').mkdir()
        (d / 'results' / 'x_buzzdetect.csv').write_text(
            'start,activation_ins_buzz\n0.0,-1.2\n')

    def boom(path, **arrays):
        with open(path, 'wb') as fh:
            fh.write(b'half-written')
        raise OSError(28, 'No space left on device')

    def act(m, d):
        monkeypatch.setattr(m.trim.np, 'savez_compressed', boom)
        skips = []
        try:
            n, _b, _a = m.trim.trim_directory(
                str(d / 'results'), remove_original=True,
                on_skip=lambda path, why: skips.append((path, why)))
        finally:
            monkeypatch.undo()
        return n, skips
    n, skips = both(tmp_path, act, inputs)
    assert n == 0 and 'No space left' in skips[0][1]
    assert os.listdir(tmp_path / 'buzzdetect_torch' / 'results') == [
        'x_buzzdetect.csv']


def test_trim_results_cli_all_skipped_is_a_data_error(tmp_path):
    def inputs(d):
        (d / 'results').mkdir()
        (d / 'results' / 'bad_buzzdetect.csv').write_text(
            'start,activation_ins_buzz\n0.0,nan\n')

    def act(m, d):
        return run_tool(m.pkg, 'trim_results',
                        ['--dir_results', str(d / 'results')])
    code, _out, err = both(tmp_path, act, inputs)
    assert code != 0 and 'non-finite' in err and 'were skipped' in err
    assert 'no finalized' not in err
