"""tests/test_durability.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). Edits: every run is the port's
``analyze()`` on ``device='cpu'`` (the module's ``analyze`` wrapper;
``Analyzer(device='cpu')`` where a case builds one), and bundles come from
``buzzdetect_torch.models.convert``.

The JAX package's docstring:

Durability of the checkpoint/finalization machinery under faults:
mid-file decode failures, SIGKILL-torn appends, non-atomic promotion, and
resume coverage at non-default framehops. (Review-driven regression tests;
the happy paths live in test_pipeline.py / test_writer_unit.py.)
"""

import os

import numpy as np
import pytest

from buzzdetect_torch import config as cfg
from buzzdetect_torch.models.convert import build_model_bundle
from buzzdetect_torch.write.coverage import (coverage_from_csv, get_gaps,
                                           subtract_interval)
from tests.audio_fixtures import make_tone, write_wav


def analyze(**kw):
    """The port's analyze(), on the CPU unless the case names a device."""
    from buzzdetect_torch import analysis
    kw.setdefault('device', 'cpu')
    return analysis.analyze(**kw)


CLASSES = ['ins_buzz', 'ambient_noise']


@pytest.fixture(scope='module')
def dir_models(tmp_path_factory):
    root = tmp_path_factory.mktemp('dur_models')
    build_model_bundle(str(root / 'durmodel'), classes=CLASSES, seed=13)
    return str(root)


@pytest.fixture()
def patched_models(dir_models, monkeypatch):
    monkeypatch.setattr(cfg, 'DIR_MODELS', dir_models)


# --- coverage math ----------------------------------------------------------

def _write_csv(path, lines, newline_terminated=True):
    """Every real append is newline-terminated (formatting.render_csv);
    pass newline_terminated=False to simulate a mid-append tear."""
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + ('\n' if newline_terminated else ''))


def _adopt_dir_out(dir_out):
    """Write the manifest a default activations-mode durmodel run produces.

    Tests that pre-plant result files need it: a manifest-less folder with
    results refuses admission outright (unattestable provenance)."""
    from buzzdetect_torch.manifest import build_manifest, write_manifest
    write_manifest(str(dir_out), build_manifest(
        'durmodel', framehop_prop=1, precision=None,
        classes_out=list(CLASSES)))


def test_parseable_torn_tail_not_adopted(tmp_path):
    """A tear can land mid-cell and still leave a line with the right
    column count and float-parseable cells ('19.2,0.53' torn to '19.2,0.5'):
    the missing trailing newline is the only evidence. Such a line must be
    treated as torn — adopting it would bake the corrupt value into the
    finalized CSV and never re-analyze the frame."""
    from buzzdetect_torch.write.coverage import read_result_rows
    p = str(tmp_path / 'x_buzzpart.csv')
    _write_csv(p, ['start,activation_a', '0.0,1.0', '19.2,0.5'],
               newline_terminated=False)
    header, rows, torn = read_result_rows(p)
    assert [r[0] for r in rows] == ['0.0']
    assert torn == [19.2]
    # the same file cleanly terminated is fully adopted
    _write_csv(p, ['start,activation_a', '0.0,1.0', '19.2,0.5'])
    header, rows, torn = read_result_rows(p)
    assert [r[0] for r in rows] == ['0.0', '19.2']
    assert torn == []


def test_writer_truncates_parseable_torn_tail(tmp_path):
    """The writer must TRUNCATE a newline-less final line before appending,
    not just glue a '\\n': gluing launders a parseable-torn tear into a
    valid terminated row that survives to finalization with the corrupt
    value (the tear '19.2,0.53' -> '19.2,0.5' parses clean)."""
    from buzzdetect_torch.runtime.writer import WorkerWriter
    p = str(tmp_path / 'x_buzzpart.csv')
    _write_csv(p, ['start,activation_a', '0.0,1.0', '19.2,0.5'],
               newline_terminated=False)
    assert WorkerWriter._truncate_torn_tail(p) == ''
    assert open(p).read() == 'start,activation_a\n0.0,1.0\n'
    # clean tail: untouched
    assert WorkerWriter._truncate_torn_tail(p) == ''
    assert open(p).read() == 'start,activation_a\n0.0,1.0\n'
    # pathological: no newline anywhere — keep the glue-guard fallback
    # instead of emptying the file under a header the caller won't rewrite
    with open(p, 'w') as f:
        f.write('start,activation_a')
    assert WorkerWriter._truncate_torn_tail(p) == '\n'
    assert open(p).read() == 'start,activation_a'


def test_torn_row_span_subtracted_for_overlapping_framehop(tmp_path):
    """At framehop < 1 the torn frame's neighbors cover its span, so without
    explicit subtraction the torn row would never be re-analyzed and
    finalization would drop it forever."""
    p = str(tmp_path / 'x_buzzpart.csv')
    _write_csv(p, ['start,activation_a', '0.0,1.0', '0.48,1.0', '1.44,1.0',
                   '0.96,'])  # torn final append at start=0.96
    coverage = coverage_from_csv(p, framelength=0.96, framehop=0.48)
    gaps = get_gaps((0, 2.4), coverage)
    assert any(lo <= 0.96 < hi for lo, hi in gaps), \
        f'torn frame 0.96 not re-analyzable: coverage={coverage} gaps={gaps}'


def test_sparse_framehop_rows_attest_their_stride(tmp_path):
    """framehop > framelength (sparse sampling): resume must not read the
    stride between consecutive rows as a gap — that would re-analyze the
    whole already-sampled run off-grid."""
    p = str(tmp_path / 'x_buzzpart.csv')
    _write_csv(p, ['start,activation_a', '0.0,1.0', '1.44,1.0', '2.88,1.0'])
    coverage = coverage_from_csv(p, framelength=0.96, framehop=1.44)
    assert coverage == [(0.0, 2.88 + 1.44)]
    assert get_gaps((0, 4.32), coverage) == []


def test_subtract_interval_splits_and_clips():
    cov = [(0.0, 5.0), (7.0, 9.0)]
    assert subtract_interval(cov, 2.0, 3.0) == [(0.0, 2.0), (3.0, 5.0),
                                                (7.0, 9.0)]
    assert subtract_interval(cov, 4.0, 8.0) == [(0.0, 4.0), (8.0, 9.0)]
    assert subtract_interval(cov, 10.0, 11.0) == cov


# --- writer append/promotion -------------------------------------------------

def _writer(coordinator=None):
    import queue
    import threading
    from buzzdetect_torch.runtime.writer import WorkerWriter

    class Coord:
        def __init__(self):
            self.q_log = queue.Queue()
            self.q_write = queue.Queue()
            self.writer_done = threading.Event()

        def record_written(self, seconds):
            pass

        def record_finalized(self):
            pass

        def stream_failed(self, ident):
            return False

    return WorkerWriter(classes_out=['a'], threshold=None, classes=['a'],
                        framehop_s=0.96, digits_time=2, digits_results=2,
                        coordinator=coordinator or Coord())


def test_append_after_torn_line_inserts_newline(tmp_path):
    """A torn append leaves no trailing newline; the next append must not
    glue its first row (the torn frame's REPLACEMENT) onto the torn line."""
    from buzzdetect_torch.runtime.assignments import AssignFile, AssignChunk
    from buzzdetect_torch.runtime.writer import finalize_partial

    a_file = AssignFile(path_audio=str(tmp_path / 'x.wav'),
                        dir_audio=str(tmp_path),
                        dir_results=str(tmp_path / 'out'))
    os.makedirs(tmp_path / 'out')
    partial = a_file.path_results_partial
    with open(partial, 'w') as f:
        f.write('start,activation_a\n0.0,1.0\n0.96,')  # torn, no newline

    w = _writer()
    chunk = AssignChunk(file=a_file, chunk=(0.96, 1.92),
                        samples=None, last_chunk=True)
    chunk.results = np.array([[0.5]], dtype=np.float32)
    chunk.n_valid = 1
    w.write_results(chunk, fully_analyzed=False)

    lines = open(partial).read().splitlines()
    assert lines[0] == 'start,activation_a'
    assert any(line.startswith('0.96,0.5') for line in lines), lines
    finalize_partial(partial, a_file.path_results_complete)
    final = open(a_file.path_results_complete).read().splitlines()
    starts = [line.split(',')[0] for line in final[1:]]
    assert starts == ['0.0', '0.96']  # torn dropped, replacement kept


def test_finalize_failure_leaves_consistent_state(tmp_path, monkeypatch):
    """A crash mid-promotion (simulated at the rename) must leave NO
    complete file — a truncated complete would be trusted forever — and
    keep the partial for a later retry."""
    from buzzdetect_torch.runtime.writer import finalize_partial
    partial = str(tmp_path / 'x_buzzpart.csv')
    complete = str(tmp_path / 'x_buzzdetect.csv')
    _write_csv(partial, ['start,activation_a', '0.96,1.0', '0.0,1.0'])

    real_replace = os.replace
    monkeypatch.setattr(os, 'replace',
                        lambda *a: (_ for _ in ()).throw(OSError('boom')))
    with pytest.raises(OSError):
        finalize_partial(partial, complete)
    assert not os.path.exists(complete)
    assert os.path.exists(partial)

    monkeypatch.setattr(os, 'replace', real_replace)
    finalize_partial(partial, complete)
    rows = open(complete).read().splitlines()
    assert [r.split(',')[0] for r in rows[1:]] == ['0.0', '0.96']  # sorted
    assert not os.path.exists(partial)


# --- streamer mid-file failure ----------------------------------------------

def test_midfile_decode_error_never_finalizes_truncated(patched_models,
                                                        tmp_path,
                                                        monkeypatch):
    """A transient decode error after some chunks were analyzed must leave
    the file a resumable PARTIAL — promoting it would permanently skip the
    never-analyzed tail on every later run. The rerun then completes it,
    matching a clean fresh analysis."""
    from buzzdetect_torch import analysis as analysis_mod
    from buzzdetect_torch.runtime import streamer as streamer_mod
    from buzzdetect_torch.audio import build_track as real_build_track

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(6.0, 16000, 260), 16000)
    dir_out = str(tmp_path / 'out')

    class FailingTrack:
        """Delegates to the real track; read() dies on the second call."""

        def __init__(self, inner):
            self._t = inner
            self._reads = 0

        def __getattr__(self, name):
            return getattr(self._t, name)

        def _maybe_fail(self):
            self._reads += 1
            if self._reads == 2:
                raise RuntimeError('simulated transient decode failure')

        def read(self, n, dtype=None):
            self._maybe_fail()
            return self._t.read(n, dtype=dtype or np.float32)

        def read_s16(self, n):  # the fused wire path the streamer prefers
            self._maybe_fail()
            return self._t.read_s16(n)

    def failing_build_track(path, **kw):
        return FailingTrack(real_build_track(path, **kw))

    monkeypatch.setattr(streamer_mod, 'build_track', failing_build_track)
    analyze(modelname='durmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, n_streamers=1, verbosity_print='ERROR')

    partial = os.path.join(dir_out, 'rec_buzzpart.csv')
    complete = os.path.join(dir_out, 'rec_buzzdetect.csv')
    assert os.path.exists(partial), 'first chunk should have checkpointed'
    assert not os.path.exists(complete), \
        'truncated result must NOT be promoted to complete'

    # recovery run (healthy decode) completes the file
    monkeypatch.setattr(streamer_mod, 'build_track', real_build_track)
    analyze(modelname='durmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, verbosity_print='ERROR')
    assert os.path.exists(complete) and not os.path.exists(partial)

    dir_oracle = str(tmp_path / 'oracle')
    analyze(modelname='durmodel', dir_audio=str(dir_audio),
            dir_out=dir_oracle, chunklength=2.0, verbosity_print='ERROR')
    got = open(complete).read()
    want = open(os.path.join(dir_oracle, 'rec_buzzdetect.csv')).read()
    assert got == want


# --- header durability (torn first append) ----------------------------------

def _result_chunk(a_file, chunk, results):
    from buzzdetect_torch.runtime.assignments import AssignChunk
    c = AssignChunk(file=a_file, chunk=chunk, samples=None, last_chunk=True)
    c.results = np.asarray(results, dtype=np.float32)
    c.n_valid = len(c.results)
    return c


def _assign_file(tmp_path, name='x.wav'):
    from buzzdetect_torch.runtime.assignments import AssignFile
    a_file = AssignFile(path_audio=str(tmp_path / name),
                        dir_audio=str(tmp_path),
                        dir_results=str(tmp_path / 'out'))
    os.makedirs(tmp_path / 'out', exist_ok=True)
    return a_file


def test_torn_header_partial_quarantined_and_rebuilt(tmp_path):
    """A SIGKILL can cut the very FIRST append mid-header. Appending data
    rows under the truncated header makes every row column-mismatch (all
    read as torn) and finalization would promote an EMPTY complete file —
    total silent data loss. The writer must quarantine and rebuild."""
    a_file = _assign_file(tmp_path)
    partial = a_file.path_results_partial
    with open(partial, 'w') as f:
        f.write('start,activ')  # torn mid-header, no newline

    w = _writer()
    w.write_results(_result_chunk(a_file, (0.0, 0.96), [[0.5]]),
                    fully_analyzed=True)

    complete = open(a_file.path_results_complete).read().splitlines()
    assert complete[0] == 'start,activation_a'
    assert complete[1].startswith('0.0,0.5')
    assert os.path.exists(partial + '.corrupt')
    assert not os.path.exists(partial)


def test_zero_byte_partial_gets_header(tmp_path):
    """A SIGKILL between creating the partial and flushing the header leaves
    a 0-byte file; the next append must write the header — headerless data
    rows poison the file for every later parse and finalize."""
    a_file = _assign_file(tmp_path)
    open(a_file.path_results_partial, 'w').close()  # 0 bytes

    w = _writer()
    w.write_results(_result_chunk(a_file, (0.0, 0.96), [[0.5]]),
                    fully_analyzed=False)
    lines = open(a_file.path_results_partial).read().splitlines()
    assert lines[0] == 'start,activation_a'
    assert lines[1].startswith('0.0,0.5')


def test_finalize_refuses_unusable_partial(tmp_path):
    """Promotion of a partial with no usable header would write a complete
    file carrying none of the analysis and skip the file forever."""
    from buzzdetect_torch.runtime.writer import finalize_partial
    partial = str(tmp_path / 'x_buzzpart.csv')
    complete = str(tmp_path / 'x_buzzdetect.csv')
    _write_csv(partial, ['st'])  # torn header that lost even 'start'
    with pytest.raises(ValueError):
        finalize_partial(partial, complete)
    assert not os.path.exists(complete)


def test_coverage_tolerates_corrupt_header(tmp_path):
    """Resume must read a corrupt-header partial as empty coverage (full
    re-analysis), not raise — raising marks the stream failed on every
    run and the file is never analyzed again."""
    p = str(tmp_path / 'x_buzzpart.csv')
    _write_csv(p, ['st'])  # header lost 'start' entirely
    assert coverage_from_csv(p, framelength=0.96) == []
    _write_csv(p, ['start,activ', '0.0,1.0,2.0,3.0'])  # torn header + rows
    assert coverage_from_csv(p, framelength=0.96) == []


def test_stale_partial_behind_complete_removed(patched_models, tmp_path):
    """A crash between finalization's promote and partial removal leaves a
    stale partial behind the complete file; the next run must clean it so
    deleting the complete CSV later forces a genuinely fresh analysis."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 260), 16000)
    dir_out = tmp_path / 'out'
    dir_out.mkdir()
    _write_csv(str(dir_out / 'rec_buzzdetect.csv'),
               ['start,activation_ins_buzz,activation_ambient_noise',
                '0.0,1.0,2.0'])
    stale = str(dir_out / 'rec_buzzpart.csv')
    _write_csv(stale, ['start,activation_ins_buzz,activation_ambient_noise',
                       '0.0,9.0,9.0'])
    _adopt_dir_out(dir_out)

    analyze(modelname='durmodel', dir_audio=str(dir_audio),
            dir_out=str(dir_out), verbosity_print='ERROR')
    assert not os.path.exists(stale)
    # the complete result itself is untouched
    assert '0.0,1.0,2.0' in open(dir_out / 'rec_buzzdetect.csv').read()


def test_overstated_duration_still_finalizes(patched_models, tmp_path,
                                             monkeypatch):
    """Container metadata can overstate the duration (truncated recordings):
    the final gap's read returns ZERO samples. The empty last chunk must
    still flow to the writer so the file finalizes — otherwise the partial
    is re-probed on every run forever."""
    from buzzdetect_torch.runtime import streamer as streamer_mod
    from buzzdetect_torch.audio import get_duration as real_get_duration

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(4.0, 16000, 260), 16000)
    dir_out = str(tmp_path / 'out')

    monkeypatch.setattr(streamer_mod, 'get_duration',
                        lambda t: real_get_duration(t) + 2.0)
    analyze(modelname='durmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, n_streamers=1, verbosity_print='ERROR')

    complete = os.path.join(dir_out, 'rec_buzzdetect.csv')
    partial = os.path.join(dir_out, 'rec_buzzpart.csv')
    assert os.path.exists(complete), \
        'file with phantom tail must still finalize'
    assert not os.path.exists(partial)
    # all real audio was analyzed: 2 s chunks at hop 0.96 give frame
    # starts 0, 0.96 | 2.0, 2.96 — the phantom (4, 6) gap adds nothing
    starts = [line.split(',')[0]
              for line in open(complete).read().splitlines()[1:]]
    assert starts[0] == '0.0' and float(starts[-1]) >= 2.88


def test_resample_warmup_probes_native_rate(patched_models, tmp_path):
    """With resample_on_device the warmup must compile the program the run
    actually dispatches: the corpus's NATIVE rate, not the model rate."""
    from buzzdetect_torch.analysis import Analyzer
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(1.0, 44100, 260), 44100)
    an = Analyzer(modelname='durmodel', dir_audio=str(dir_audio),
                  dir_out=str(tmp_path / 'out'), resample_on_device=True,
                  device='cpu')
    assert an.queue_assignments()
    assert an.warmup_rate == 44100
    # drain what queue_assignments enqueued so nothing dangles
    while not an.coordinator.q_stream.empty():
        an.coordinator.q_stream.get()


def test_fully_unreadable_file_not_promoted_empty(patched_models, tmp_path,
                                                  monkeypatch):
    """A file whose container reports a duration but whose FIRST read
    returns zero samples (metadata-only container) must NOT be promoted to
    a header-only complete file — the stream fails so nothing promotes and
    a later, possibly healthy, run retries."""
    from buzzdetect_torch.runtime import streamer as streamer_mod
    from buzzdetect_torch.audio import build_track as real_build_track

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(4.0, 16000, 260), 16000)
    dir_out = str(tmp_path / 'out')

    class EmptyTrack:
        def __init__(self, inner):
            self._t = inner

        def __getattr__(self, name):
            return getattr(self._t, name)

        def read(self, n, dtype=None):
            return np.zeros(0, dtype or np.float32)

        def read_s16(self, n):
            return np.zeros(0, np.int16)

    monkeypatch.setattr(streamer_mod, 'build_track',
                        lambda p, **kw: EmptyTrack(real_build_track(p, **kw)))
    analyze(modelname='durmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, n_streamers=1, verbosity_print='ERROR')
    assert not os.path.exists(os.path.join(dir_out, 'rec_buzzdetect.csv')), \
        'unreadable file must not be marked complete'

    # a healthy later run analyzes it fully
    monkeypatch.setattr(streamer_mod, 'build_track', real_build_track)
    analyze(modelname='durmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, verbosity_print='ERROR')
    complete = os.path.join(dir_out, 'rec_buzzdetect.csv')
    assert os.path.exists(complete)
    assert len(open(complete).read().splitlines()) > 1


@pytest.mark.parametrize('debris', ['', 'start,activ'])
def test_subframe_file_with_unusable_partial_self_heals(patched_models,
                                                        tmp_path, debris):
    """Sub-framelength file + a partial that attests nothing (0-byte, or a
    torn header kept the 'start' cell): smooth_gaps drops the end-adjacent
    whole-file gap, landing in the self-heal path — which must quarantine
    the debris and analyze from scratch, not promote an empty complete or
    raise on every run."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(0.9, 16000, 260), 16000)
    dir_out = tmp_path / 'out'
    dir_out.mkdir()
    partial = str(dir_out / 'rec_buzzpart.csv')
    with open(partial, 'w') as f:
        f.write(debris)
    _adopt_dir_out(dir_out)

    analyze(modelname='durmodel', dir_audio=str(dir_audio),
            dir_out=str(dir_out), verbosity_print='ERROR')
    complete = str(dir_out / 'rec_buzzdetect.csv')
    assert os.path.exists(complete)
    lines = open(complete).read().splitlines()
    assert lines[0].startswith('start,activation_ins_buzz')
    assert len(lines) == 2  # one real analyzed frame (padded sub-frame file)
    assert os.path.exists(partial + '.corrupt')
    assert not os.path.exists(partial)


def test_foreign_schema_partial_never_counts_as_coverage(patched_models,
                                                         tmp_path):
    """A partial written under a DIFFERENT output schema (a foreign
    partial copied into the folder behind a valid manifest) must be
    quarantined BEFORE its rows count as resume coverage. Counting them
    used to be a silent data-loss path: the streamer scheduled only the
    gaps, the writer quarantined the mismatched partial on first append,
    and the file finalized as a complete result permanently missing the
    quarantined spans."""
    from buzzdetect_torch.write.coverage import read_result_rows

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(6.0, 16000), 16000)
    dir_out = tmp_path / 'out'
    dir_out.mkdir()
    # the manifest matches this run (ACTIVATIONS mode) — it admits the
    # run — but a detections-mode partial covering the first 4 frames was
    # hand-copied in behind it: only the streamer's header pin can catch it
    _adopt_dir_out(dir_out)
    _write_csv(dir_out / ('rec' + cfg.SUFFIX_RESULT_PARTIAL),
               ['start,detections_ins_buzz'] +
               [f'{round(k * 0.96, 2)},1' for k in range(4)])

    analyze(modelname='durmodel', dir_audio=str(dir_audio),
            dir_out=str(dir_out), verbosity_print='ERROR')

    header, rows, _ = read_result_rows(
        str(dir_out / ('rec' + cfg.SUFFIX_RESULT_COMPLETE)))
    assert header[1].startswith('activation_'), 'wrong schema finalized'
    starts = sorted(float(r[0]) for r in rows)
    # FULL coverage: every frame re-analyzed under the new schema (7
    # frames for 6 s — the final partial window scores zero padding)
    assert starts == [round(k * 0.96, 2) for k in range(7)], \
        f'foreign-schema rows leaked into coverage: {starts}'
    corrupt = [f for f in os.listdir(dir_out) if f.endswith('.corrupt')]
    assert corrupt, 'mismatched partial was not quarantined'


def test_orphan_results_without_manifest_refuse_the_run(patched_models,
                                                        tmp_path):
    """Results in a folder with NO manifest must refuse the run outright.

    The dangerous mismatches are invisible in the files: a partial from a
    detections run at a different precision, or an activations run at a
    different framehop, carries the SAME header — so once admitted, its
    rows would count as resume coverage and the finalized CSV would
    permanently interleave rows scored under incompatible settings. The
    only sound reaction to unattestable provenance is refusal (with the
    restore-the-manifest remedy in the message)."""
    from buzzdetect_torch.manifest import FNAME_MANIFEST

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(6.0, 16000), 16000)
    dir_out = tmp_path / 'out'
    dir_out.mkdir()
    # an ACTIVATIONS-mode partial whose header matches what this run would
    # write — the header pin CANNOT catch a framehop/threshold change, so
    # admission itself must be refused
    _write_csv(dir_out / ('rec' + cfg.SUFFIX_RESULT_PARTIAL),
               ['start,activation_ins_buzz,activation_ambient_noise'] +
               [f'{round(k * 0.96, 2)},0.5,0.5' for k in range(4)])

    analyzer = analyze(modelname='durmodel', dir_audio=str(dir_audio),
                       dir_out=str(dir_out), verbosity_print='CRITICAL')

    assert analyzer.coordinator.end_reason == 'manifest mismatch'
    # nothing ran: the partial is untouched (not quarantined, not grown),
    # no complete file appeared, and no manifest was adopted
    assert os.path.exists(dir_out / ('rec' + cfg.SUFFIX_RESULT_PARTIAL))
    assert not any(f.endswith('.corrupt') for f in os.listdir(dir_out))
    assert not os.path.exists(dir_out / ('rec' + cfg.SUFFIX_RESULT_COMPLETE))
    assert not os.path.exists(dir_out / FNAME_MANIFEST)
