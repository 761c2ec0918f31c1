"""tests/test_detections.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). Edits: the reference's metrics
table is found beside ``TESTBUZZ``; the tool runs as
``python -m buzzdetect_torch.tools.call_detections`` from the repository's
root (the JAX case runs ``tools/call_detections.py``); the precision case
builds its bundle with the port's ``build_model_bundle``. The writers
are host code (``tests/test_torch_writers.py`` holds both packages'
output trees byte for byte); the cases that call events from numbers also
run the JAX package's function on the same input and print
max |port - JAX| over the events' numbers.

The JAX package's docstring:
Offline detection calling: archived activations -> events.

The capability the reference delegates to its buzzr companion
(the reference's `docs/source/result_files.rst:76`): threshold archived
activations at any precision after the fact and coalesce detected frames
into events.
"""

import os

import numpy as np
import pytest

from buzzdetect_torch.write.detections import (call_detections_directory,
                                               call_detections_file,
                                               frames_to_events)
from tests.test_reference_equivalence import TESTBUZZ

CLASSES = ['ins_buzz', 'ambient_noise']
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = 'buzzdetect_torch.tools.call_detections'
# the reference snapshot's metrics table, where the snapshot is mounted
METRICS_CSV = os.path.join(os.path.dirname(os.path.dirname(TESTBUZZ)),
                           'models', 'model_general_v3', 'tests',
                           'metrics.csv')


def _write_result(path, starts, buzz, noise=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        f.write('start,' + ','.join(f'activation_{c}' for c in CLASSES)
                + '\n')
        for i, s in enumerate(starts):
            n = noise[i] if noise is not None else -5.0
            f.write(f'{s},{buzz[i]},{n}\n')


def _events_vs_jax(events, ref):
    """The same events, field for field; prints max |port - JAX| over
    their numbers."""
    assert len(events) == len(ref)
    err = 0.0
    for got, want in zip(events, ref):
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, str):
                assert got[k] == v
            else:
                err = max(err, abs(float(got[k]) - float(v)))
    print(f'{len(events)} events: max |port - JAX| = {err}')
    return err


def test_frames_to_events_coalesces_runs():
    starts = np.arange(10) * 0.96
    acts = np.full(10, -5.0)
    acts[2:5] = 1.0   # one 3-frame bout
    acts[8] = 2.0     # one isolated frame
    events = frames_to_events(starts, acts, threshold=0.0)
    assert len(events) == 2
    a, b = events
    assert a['start'] == pytest.approx(2 * 0.96)
    assert a['end'] == pytest.approx(5 * 0.96)  # last start + framelength
    assert a['n_frames'] == 3
    assert a['activation_max'] == 1.0
    assert b['n_frames'] == 1
    assert b['duration'] == pytest.approx(0.96)
    from buzzdetect_tpu.write.detections import frames_to_events as jfn
    _events_vs_jax(events, jfn(starts, acts, threshold=0.0))


def test_frames_to_events_merge_gap_and_order():
    # unsorted input, detected frames at 0.0 and 2.88 separated by two cold
    # frames: default gap (1.5x hop) keeps them apart; a gap tolerance
    # covering the 2.88 s spacing merges them into one bout
    starts = np.array([1.92, 0.0, 0.96, 2.88])
    acts = np.array([-9.0, 1.0, -9.0, 1.0])
    apart = frames_to_events(starts, acts, threshold=0.0)
    assert len(apart) == 2
    merged = frames_to_events(starts, acts, threshold=0.0,
                              merge_gap_s=3.0 * 0.96)
    assert len(merged) == 1
    assert merged[0]['n_frames'] == 2          # cold gap frame not counted
    assert merged[0]['activation_mean'] == 1.0  # cold frame excluded
    from buzzdetect_tpu.write.detections import frames_to_events as jfn
    _events_vs_jax(apart, jfn(starts, acts, threshold=0.0))
    _events_vs_jax(merged, jfn(starts, acts, threshold=0.0,
                               merge_gap_s=3.0 * 0.96))


def test_frames_to_events_empty():
    assert frames_to_events([0.0, 0.96], [-9.0, -9.0], threshold=0.0) == []


def test_call_detections_file_missing_class(tmp_path):
    path = str(tmp_path / 'a_buzzdetect.csv')
    _write_result(path, [0.0], [1.0])
    with pytest.raises(KeyError, match='frog'):
        call_detections_file(path, threshold=0.0, classes=('frog',))


def test_call_detections_directory_csv_and_trimmed(tmp_path):
    """Walks CSVs and trimmed archives (CSV preferred when both exist),
    applies one threshold, writes the combined events CSV."""
    from buzzdetect_torch.write.trim import trim_directory
    d = str(tmp_path / 'out')
    starts = list(np.arange(6) * 0.96)
    _write_result(os.path.join(d, 'a_buzzdetect.csv'), starts,
                  [2.0, 2.0, -5.0, -5.0, -5.0, -5.0])
    _write_result(os.path.join(d, 'sub', 'b_buzzdetect.csv'), starts,
                  [-5.0] * 6)
    # c exists ONLY trimmed (original CSV removed after compaction)
    _write_result(os.path.join(d, 'c_buzzdetect.csv'), starts,
                  [-5.0, -5.0, -5.0, 3.0, 3.0, 3.0])
    trim_directory(d, classes_keep=('ins_buzz',), decimals=1)
    os.remove(os.path.join(d, 'c_buzzdetect.csv'))

    # a stray archive trimmed to OTHER classes must be skipped+reported,
    # not abort the whole batch
    _write_result(os.path.join(d, 'stray_buzzdetect.csv'), starts,
                  [9.0] * 6)
    from buzzdetect_torch.write.trim import trim_results
    np.savez_compressed(
        os.path.join(d, 'stray_buzztrim.npz'),
        **trim_results(os.path.join(d, 'stray_buzzdetect.csv'),
                       classes_keep=('ambient_noise',)))
    os.remove(os.path.join(d, 'stray_buzzdetect.csv'))

    out_csv = str(tmp_path / 'events.csv')
    skipped = []
    rows = call_detections_directory(
        d, threshold=0.0, path_out=out_csv,
        on_skip=lambda p, why: skipped.append(p))
    assert len(skipped) == 1 and skipped[0].endswith('stray_buzztrim.npz')
    by_ident = {}
    for r in rows:
        by_ident.setdefault(r['ident'], []).append(r)
    assert set(by_ident) == {'a', 'c'}
    assert by_ident['a'][0]['n_frames'] == 2
    assert by_ident['c'][0]['n_frames'] == 3
    assert by_ident['c'][0]['start'] == pytest.approx(3 * 0.96)
    assert os.path.exists(out_csv)
    lines = open(out_csv).read().splitlines()
    assert lines[0].startswith('ident,class,start,end,duration')
    assert len(lines) == 3
    from buzzdetect_tpu.write.detections import (
        call_detections_directory as jfn)
    _events_vs_jax(rows, jfn(d, threshold=0.0, on_skip=lambda p, why: None))


def test_export_audacity_labels(tmp_path):
    """Audacity label tracks: one tab-separated headerless file per ident
    (incl. nested idents), labels sorted by time, class + peak in the
    text."""
    from buzzdetect_torch.write.detections import write_audacity_labels
    d = str(tmp_path / 'out')
    starts = list(np.arange(6) * 0.96)
    _write_result(os.path.join(d, 'a_buzzdetect.csv'), starts,
                  [2.0, 2.0, -5.0, -5.0, 3.0, -5.0])
    _write_result(os.path.join(d, 'sub', 'b_buzzdetect.csv'), starts,
                  [-5.0, -5.0, 1.0, -5.0, -5.0, -5.0])
    rows = call_detections_directory(d, threshold=0.0)

    d_labels = str(tmp_path / 'labels')
    written = write_audacity_labels(rows, d_labels)
    assert sorted(os.path.relpath(p, d_labels) for p in written) == \
        ['a_labels.txt', os.path.join('sub', 'b_labels.txt')]
    lines = open(os.path.join(d_labels, 'a_labels.txt')).read().splitlines()
    assert len(lines) == 2  # two bouts in 'a'
    t0, t1, text = lines[0].split('\t')
    assert float(t0) == pytest.approx(0.0)
    assert float(t1) == pytest.approx(2 * 0.96)  # 2-frame bout
    assert text == 'ins_buzz max=2.00'
    assert float(lines[1].split('\t')[0]) == pytest.approx(4 * 0.96)


def test_export_raven_selection_tables(tmp_path):
    """Raven selection tables: one per recording (Raven's Begin Time is a
    position on the opened sound, so per-file tables are the only layout
    that places selections correctly), standard columns, per-table
    selection numbering, analysis band as the frequency bounds."""
    from buzzdetect_torch.write.detections import (write_raven_tables,
                                                   RAVEN_FIELDS)
    d = str(tmp_path / 'out')
    starts = list(np.arange(4) * 0.96)
    _write_result(os.path.join(d, 'a_buzzdetect.csv'), starts,
                  [1.5, -5.0, -5.0, 4.5])
    _write_result(os.path.join(d, 'sub', 'b_buzzdetect.csv'), starts,
                  [-5.0, -5.0, 2.5, -5.0])
    rows = call_detections_directory(d, threshold=0.0)

    d_sel = str(tmp_path / 'sel')
    written = write_raven_tables(rows, d_sel)
    assert sorted(os.path.relpath(p, d_sel) for p in written) == \
        ['a_selections.txt', os.path.join('sub', 'b_selections.txt')]

    lines = open(os.path.join(d_sel, 'a_selections.txt')).read().splitlines()
    assert lines[0].split('\t') == list(RAVEN_FIELDS)
    assert len(lines) == 3  # two events in 'a'
    sel1 = dict(zip(RAVEN_FIELDS, lines[1].split('\t')))
    sel2 = dict(zip(RAVEN_FIELDS, lines[2].split('\t')))
    assert (sel1['Selection'], sel2['Selection']) == ('1', '2')
    assert float(sel1['Begin Time (s)']) == pytest.approx(0.0)
    assert float(sel1['End Time (s)']) == pytest.approx(0.96)
    assert float(sel2['Begin Time (s)']) == pytest.approx(3 * 0.96)
    assert (sel1['Low Freq (Hz)'], sel1['High Freq (Hz)']) == ('125', '7500')
    assert sel1['View'] == 'Spectrogram 1'
    assert sel2['Annotation'] == 'ins_buzz max=4.50'

    # b's table numbers from 1 again (per-table numbering) with b's times
    lines_b = open(os.path.join(
        d_sel, 'sub', 'b_selections.txt')).read().splitlines()
    sel_b = dict(zip(RAVEN_FIELDS, lines_b[1].split('\t')))
    assert sel_b['Selection'] == '1'
    assert float(sel_b['Begin Time (s)']) == pytest.approx(2 * 0.96)


def test_call_detections_threshold_from_manifest_precision(tmp_path,
                                                           monkeypatch):
    """precision= resolves the threshold via the metrics table of the
    model recorded in the results directory's manifest."""
    metrics = METRICS_CSV
    if not os.path.exists(metrics):
        pytest.skip('reference metrics not mounted')
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.manifest import build_manifest, write_manifest
    from buzzdetect_torch.models.convert import build_model_bundle
    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'detmodel'), classes=CLASSES,
                       seed=7, metrics_csv=metrics)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))

    d = str(tmp_path / 'out')
    _write_result(os.path.join(d, 'a_buzzdetect.csv'),
                  [0.0, 0.96], [5.0, -9.0])
    write_manifest(d, build_manifest('detmodel', 1.0, None, CLASSES))
    rows = call_detections_directory(d, precision=0.95)
    assert len(rows) == 1 and rows[0]['n_frames'] == 1

    with pytest.raises(ValueError, match='exactly one'):
        call_detections_directory(d, precision=0.95, threshold=-1.0)
    with pytest.raises(ValueError, match='exactly one'):
        call_detections_directory(d)


METRICS_SYNTH = """threshold,precision,sensitivity,fpr
-2.0,0.50,0.99,0.5
-1.0,0.70,0.90,0.3
0.0,0.85,0.75,0.1
1.0,0.95,0.50,0.02
2.0,0.99,0.20,0.001
"""


def _install_metrics(tmp_path, monkeypatch, modelname='recmodel'):
    from buzzdetect_torch import config as cfg
    d = tmp_path / 'models' / modelname / 'tests'
    os.makedirs(d, exist_ok=True)
    (d / 'metrics.csv').write_text(METRICS_SYNTH)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))


def test_threshold_at_recall_picks_most_precise_qualifying_row(
        tmp_path, monkeypatch):
    """The recall calibration returns the HIGHEST threshold whose measured
    sensitivity still meets the floor — maximum precision subject to the
    recall constraint, with the achieved numbers from that measured row
    (no interpolation: an unmeasured recall is not a promise to make)."""
    from buzzdetect_torch.write.thresholds import threshold_at_recall
    _install_metrics(tmp_path, monkeypatch)

    got = threshold_at_recall('recmodel', 0.90)
    assert got == {'threshold': -1.0, 'sensitivity': 0.90,
                   'precision': 0.70}
    # a floor between rows resolves DOWN the threshold axis (the next row
    # that still meets it), never up to a row that would miss events
    got = threshold_at_recall('recmodel', 0.80)
    assert got['threshold'] == -1.0 and got['sensitivity'] == 0.90
    # the loosest floor picks the table's most precise row
    got = threshold_at_recall('recmodel', 0.20)
    assert got == {'threshold': 2.0, 'sensitivity': 0.20,
                   'precision': 0.99}


def test_threshold_at_recall_rejects_unattainable_and_invalid(
        tmp_path, monkeypatch):
    from buzzdetect_torch.write.thresholds import threshold_at_recall
    _install_metrics(tmp_path, monkeypatch)
    with pytest.raises(ValueError, match='highest measured sensitivity'):
        threshold_at_recall('recmodel', 0.995)
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match='recall must be'):
            threshold_at_recall('recmodel', bad)


def test_call_detections_recall_from_manifest(tmp_path, monkeypatch):
    """recall= resolves the threshold via the manifest's model like
    precision= does, and joins the exactly-one-of contract."""
    from buzzdetect_torch.manifest import build_manifest, write_manifest
    _install_metrics(tmp_path, monkeypatch)

    d = str(tmp_path / 'out')
    # threshold resolves to -1.0 (recall 0.9): frame at 5.0 detected,
    # frame at -1.5 not
    _write_result(os.path.join(d, 'a_buzzdetect.csv'),
                  [0.0, 0.96], [5.0, -1.5])
    write_manifest(d, build_manifest('recmodel', 1.0, None, CLASSES))
    rows = call_detections_directory(d, recall=0.9)
    assert len(rows) == 1 and rows[0]['n_frames'] == 1

    with pytest.raises(ValueError, match='exactly one'):
        call_detections_directory(d, recall=0.9, precision=0.95)
    with pytest.raises(ValueError, match='exactly one'):
        call_detections_directory(d, recall=0.9, threshold=-1.0)


def _event(ident, start, end, cls='ins_buzz'):
    return {'ident': ident, 'class': cls, 'start': start, 'end': end,
            'duration': end - start, 'n_frames': 1,
            'activation_max': 1.0, 'activation_mean': 0.5}


def test_export_event_clips_sample_accurate(tmp_path):
    """Clip export cuts the EXACT padded span out of the recording: the
    deterministic PCM pattern proves both position and length of the cut
    (the clip's samples identify where in the file they came from)."""
    import wave

    from tests.audio_fixtures import pcm_pattern, write_wav, \
        pattern_position
    from buzzdetect_torch.write.detections import write_event_clips

    sr = 16000
    d_audio = tmp_path / 'audio'
    d_audio.mkdir()
    write_wav(d_audio / 'rec1.wav', pcm_pattern(0, 10 * sr), sr)

    d_clips = str(tmp_path / 'clips')
    written = write_event_clips([_event('rec1', 2.0, 3.0)], str(d_audio),
                                d_clips, pad_s=0.5, rate=sr)
    assert [os.path.basename(p) for p in written] == \
        ['rec1_ins_buzz_2.00-3.00s.wav']
    with wave.open(written[0], 'rb') as w:
        assert w.getframerate() == sr
        assert w.getnchannels() == 1
        data = np.frombuffer(w.readframes(w.getnframes()), dtype='<i2')
    # padded span [1.5, 3.5): 2 s of audio starting at sample 1.5*sr
    assert len(data) == 2 * sr
    assert pattern_position(data / 32768.0) == int(1.5 * sr)
    # position/length are exact; the sample values may differ from the
    # numpy reference quantization by 1 LSB (the native stage's own
    # int16 rounding) — inaudible, and irrelevant to the cut's accuracy
    expected = np.round(pcm_pattern(int(1.5 * sr), 2 * sr) * 32768)
    assert np.abs(data - expected.astype(np.int64)).max() <= 1


def test_export_event_clips_clamps_and_mirrors_subdirs(tmp_path):
    """Pads clamp to the recording's bounds (no negative seek, no
    phantom tail past EOF) and nested idents mirror their subdirectory
    under the clip dir."""
    import wave

    from tests.audio_fixtures import pcm_pattern, write_wav
    from buzzdetect_torch.write.detections import write_event_clips

    sr = 16000
    d_audio = tmp_path / 'audio'
    (d_audio / 'sub').mkdir(parents=True)
    write_wav(d_audio / 'sub' / 'rec2.wav', pcm_pattern(0, 4 * sr), sr)

    d_clips = str(tmp_path / 'clips')
    written = write_event_clips(
        [_event('sub/rec2', 0.2, 1.0), _event('sub/rec2', 3.5, 3.9)],
        str(d_audio), d_clips, pad_s=1.0, rate=sr)
    rels = [os.path.relpath(p, d_clips) for p in written]
    assert rels == [os.path.join('sub', 'rec2_ins_buzz_0.20-1.00s.wav'),
                    os.path.join('sub', 'rec2_ins_buzz_3.50-3.90s.wav')]
    with wave.open(written[0], 'rb') as w:
        # [max(0, -0.8), 2.0) -> 2.0 s
        assert w.getnframes() == 2 * sr
    with wave.open(written[1], 'rb') as w:
        # [2.5, min(4.9, 4.0)) -> 1.5 s
        assert w.getnframes() == int(1.5 * sr)


def test_export_event_clips_native_rate_and_skips(tmp_path):
    """rate=0 keeps the recording's own samplerate; events with no
    matching audio are reported through on_skip, not silently dropped."""
    import wave

    from tests.audio_fixtures import pcm_pattern, write_wav
    from buzzdetect_torch.write.detections import write_event_clips

    d_audio = tmp_path / 'audio'
    d_audio.mkdir()
    write_wav(d_audio / 'hi.wav', pcm_pattern(0, 2 * 32000), 32000)

    skipped = []
    written = write_event_clips(
        [_event('hi', 0.5, 1.0), _event('ghost', 0.0, 1.0)],
        str(d_audio), str(tmp_path / 'clips'), pad_s=0.0, rate=0,
        on_skip=lambda ident, why: skipped.append((ident, why)))
    assert len(written) == 1
    with wave.open(written[0], 'rb') as w:
        assert w.getframerate() == 32000
        assert w.getnframes() == int(0.5 * 32000)
    assert skipped and skipped[0][0] == 'ghost'
    assert 'no matching audio' in skipped[0][1]


def test_export_event_clips_from_called_events(tmp_path):
    """End to end: archived activations -> called events -> reviewable
    clips, idents matching across the three stages."""
    from tests.audio_fixtures import pcm_pattern, write_wav
    from buzzdetect_torch.write.detections import write_event_clips

    sr = 16000
    d_audio = tmp_path / 'audio'
    d_audio.mkdir()
    write_wav(d_audio / 'a.wav', pcm_pattern(0, 6 * sr), sr)

    d_res = str(tmp_path / 'out')
    starts = list(np.arange(6) * 0.96)
    _write_result(os.path.join(d_res, 'a_buzzdetect.csv'), starts,
                  [-5.0, 2.0, 2.0, -5.0, -5.0, -5.0])
    rows = call_detections_directory(d_res, threshold=0.0)
    written = write_event_clips(rows, str(d_audio),
                                str(tmp_path / 'clips'), pad_s=0.25)
    assert len(written) == 1
    assert os.path.basename(written[0]).startswith('a_ins_buzz_0.96-')


def test_export_event_clips_unknown_duration_and_midstream_failure(
        tmp_path, monkeypatch):
    """Two decode-robustness contracts: a container with no duration
    header (native stage reports frames < 0) must export unclamped rather
    than silently skipping every event; a recording that fails MID-export
    must skip via on_skip (removing the partial clip in flight) without
    aborting the recordings after it."""
    import wave

    import buzzdetect_torch.write.detections as det
    from buzzdetect_torch.audio.ffi import DecodeError

    sr = 16000

    class FakeTrack:
        def __init__(self, frames, fail_at_read=None):
            self.samplerate = sr
            self.frames = frames
            self._fail_at_read = fail_at_read
            self._reads = 0
            self._pos = 0

        def seek(self, sample):
            self._pos = sample

        def read(self, n, dtype=None):
            self._reads += 1
            if self._fail_at_read is not None \
                    and self._reads >= self._fail_at_read:
                raise DecodeError('bit rot')
            return np.zeros(int(n), dtype=np.int16)

        def close(self):
            pass

    tracks = {'nodur': FakeTrack(frames=-1),
              'rot': FakeTrack(frames=10 * sr, fail_at_read=1),
              'good': FakeTrack(frames=10 * sr)}
    audio = tmp_path / 'audio'
    audio.mkdir()
    for ident in tracks:
        (audio / f'{ident}.wav').write_bytes(b'placeholder')
    monkeypatch.setattr(
        det, 'build_track',
        lambda path, target_rate=16000: tracks[
            os.path.splitext(os.path.basename(path))[0]],
        raising=False)
    monkeypatch.setattr(
        'buzzdetect_torch.audio.build_track',
        lambda path, target_rate=16000: tracks[
            os.path.splitext(os.path.basename(path))[0]])

    skipped = []
    written = det.write_event_clips(
        [_event('nodur', 1.0, 2.0), _event('rot', 1.0, 2.0),
         _event('good', 1.0, 2.0)],
        str(audio), str(tmp_path / 'clips'), pad_s=0.5,
        on_skip=lambda ident, why: skipped.append((ident, why)))

    names = sorted(os.path.basename(p) for p in written)
    # 'nodur' exported (frames=-1 means unknown, not "duration -1/sr")
    assert names == ['good_ins_buzz_1.00-2.00s.wav',
                     'nodur_ins_buzz_1.00-2.00s.wav']
    with wave.open([p for p in written if 'nodur' in p][0], 'rb') as w:
        assert w.getnframes() == 2 * sr  # unclamped padded span
    # 'rot' skipped with a reason; its partial clip was removed
    assert [s[0] for s in skipped] == ['rot']
    assert 'mid-export' in skipped[0][1]
    assert not [f for f in os.listdir(tmp_path / 'clips') if 'rot' in f]


def test_classes_out_rejects_empty_list():
    """An empty classes_out list passes membership checks vacuously and
    would archive zero activation columns — both the validator (CLI/GUI
    path, e.g. `--classes_out ,` flattening to []) and the API must
    reject it."""
    from buzzdetect_torch.validation import (validate_classes_out,
                                             validate_alert_classes)
    assert not validate_classes_out([]).valid
    assert not validate_alert_classes([]).valid
    assert validate_classes_out(['ins_buzz']).valid


def test_call_detections_cli_rejects_ambiguous_threshold(tmp_path):
    """The tool mirrors the library's 'exactly one of threshold/precision'
    contract as a parser error (was a raw ValueError traceback)."""
    import subprocess
    import sys
    for extra in ([], ['--threshold', '-1', '--precision', '0.9'],
                  ['--precision', '0.9', '--recall', '0.9'],
                  ['--threshold', '-1', '--recall', '0.9'],
                  ['--threshold', '-1', '--precision', '0.9',
                   '--recall', '0.9']):
        proc = subprocess.run(
            [sys.executable, '-m', TOOL, '--dir_results', str(tmp_path)]
            + extra, capture_output=True, text=True, timeout=120, cwd=REPO)
        assert proc.returncode == 2, proc.stderr  # argparse error exit
        assert 'exactly one of' in proc.stderr
        assert 'Traceback' not in proc.stderr


def test_call_detections_directory_survives_corrupt_archive(tmp_path):
    """One truncated trimmed archive (crash mid-copy between field
    machines) must be skipped+reported, not abort the whole batch with
    zipfile.BadZipFile — the healthy files' events must still land."""
    d = tmp_path / 'res'
    d.mkdir()
    _write_result(str(d / 'good_buzzdetect.csv'),
                  [0.0, 0.96, 1.92], [1.5, 1.5, -3.0])
    (d / 'bad_buzztrim.npz').write_bytes(b'PK\x03\x04 truncated garbage')
    skipped = []
    rows = call_detections_directory(
        str(d), threshold=0.0,
        on_skip=lambda p, why: skipped.append((p, why)))
    assert [r['ident'] for r in rows] == ['good']
    assert len(skipped) == 1 and 'bad_buzztrim.npz' in skipped[0][0]


def test_event_clips_skip_past_eof_event(tmp_path, monkeypatch):
    """An event past the real audio end of a no-duration-header container
    must be skipped loudly, not exported as a silent zero-frame WAV the
    listener would mistake for a successful clip."""
    import buzzdetect_torch.audio as audio_mod
    from buzzdetect_torch.write.detections import write_event_clips

    class StubTrack:
        samplerate = 16000
        frames = -1  # container reports no duration

        def seek(self, i):
            pass

        def read(self, n, dtype=None):
            return np.zeros(0, np.int16)  # nothing decodes: past EOF

        def close(self):
            pass

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    (dir_audio / 'rec.aac').write_bytes(b'\xff\xf1' + b'\0' * 64)
    monkeypatch.setattr(audio_mod, 'build_track',
                        lambda *a, **k: StubTrack())
    skipped = []
    written = write_event_clips(
        [{'ident': 'rec', 'class': 'ins_buzz',
          'start': 100.0, 'end': 101.0}],
        str(dir_audio), str(tmp_path / 'clips'),
        on_skip=lambda i, why: skipped.append((i, why)))
    assert written == []
    assert skipped and 'past the end' in skipped[0][1]
    clips = tmp_path / 'clips'
    leftover = ([f for f in os.listdir(clips) if f.endswith('.wav')]
                if clips.exists() else [])
    assert not leftover, f'zero-frame clip left behind: {leftover}'
