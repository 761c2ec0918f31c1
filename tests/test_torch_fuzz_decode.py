"""Bounded mutation fuzz of the port's native decode stage.

The cases of tests/test_fuzz_decode.py on ``buzzdetect_torch.tools.
fuzz_decode``, whose subprocess workers import ``buzzdetect_torch`` and its
own build of the stage. Malformed recorder media must be rejected with
DecodeError or decoded as garbage PCM — never a segfault, abort, or hang.
Kept small: one mutant per codec family.
"""

import numpy as np

from buzzdetect_torch.tools.fuzz_decode import FAMILIES, fuzz, mutate, run_worker


def test_mutated_containers_never_crash(tmp_path):
    findings = fuzz(cases_per_family=1, seed=1234,
                    keep_dir=str(tmp_path / 'repro'))
    assert findings == []


def test_graceful_outcomes_tagged(tmp_path):
    """Decodable and rejected files both come back with outcome tags."""
    good = tmp_path / 'good.wav'
    from buzzdetect_torch.audio.ffi import encode_fixture
    encode_fixture(str(good), 'pcm_s16le', 16000, 1, 0.5)
    bad = tmp_path / 'absent.wav'  # open fails -> graceful DecodeError
    outcomes = run_worker([str(good), str(bad)])
    assert outcomes[str(good)].startswith('decoded')
    assert outcomes[str(bad)] == 'rejected-open'


def test_crash_attribution_respawns(tmp_path, monkeypatch):
    """A worker that DIES mid-batch (simulated SIGSEGV via the
    BZ_FUZZ_SELFCRASH test seam) must be attributed to the right file, and
    the remaining cases must still get real outcomes from a respawned
    worker."""
    from buzzdetect_torch.audio.ffi import encode_fixture
    first = tmp_path / 'first.wav'
    crash = tmp_path / 'crashme.wav'
    after = tmp_path / 'after.wav'
    for p in (first, crash, after):
        encode_fixture(str(p), 'pcm_s16le', 16000, 1, 0.5)
    monkeypatch.setenv('BZ_FUZZ_SELFCRASH', '1')
    outcomes = run_worker([str(first), str(crash), str(after)])
    assert outcomes[str(first)].startswith('decoded')
    assert outcomes[str(crash)].startswith('CRASH exit=-11')
    assert outcomes[str(after)].startswith('decoded')  # respawn covered it


def test_acked_pyerr_does_not_blame_pending_files(tmp_path, monkeypatch):
    """A worker that bails with exit 3 AFTER acking its PYERR (the clean
    unexpected-failure path, worker_main) must not pin a CRASH on the next
    pending file — that file was never exercised, and mislabeling it would
    mask a real crasher at that position. The respawn must give it a real
    outcome."""
    from buzzdetect_torch.audio.ffi import encode_fixture
    first = tmp_path / 'first.wav'
    pyerr = tmp_path / 'pyerrme.wav'
    after = tmp_path / 'after.wav'
    for p in (first, pyerr, after):
        encode_fixture(str(p), 'pcm_s16le', 16000, 1, 0.5)
    monkeypatch.setenv('BZ_FUZZ_SELFPYERR', '1')
    outcomes = run_worker([str(first), str(pyerr), str(after)])
    assert outcomes[str(first)].startswith('decoded')
    assert outcomes[str(pyerr)].startswith('PYERR RuntimeError')
    assert outcomes[str(after)].startswith('decoded'), outcomes


def test_paths_with_spaces_survive_the_ack_protocol(tmp_path):
    """Acks are by index, so a mutant path containing spaces is matched
    back to its outcome instead of being popped as a false crash."""
    from buzzdetect_torch.audio.ffi import encode_fixture
    spaced = tmp_path / 'two words dir' / 'a file.wav'
    spaced.parent.mkdir()
    encode_fixture(str(spaced), 'pcm_s16le', 16000, 1, 0.5)
    outcomes = run_worker([str(spaced)])
    assert outcomes[str(spaced)].startswith('decoded')


def test_mutate_is_deterministic_per_seed():
    data = bytearray(np.arange(4096, dtype=np.uint8).tobytes())
    a = mutate(data, np.random.default_rng(7))
    b = mutate(data, np.random.default_rng(7))
    assert a == b
    # the source buffer is never modified in place
    assert data == bytearray(np.arange(4096, dtype=np.uint8).tobytes())


def test_families_cover_every_reference_codec():
    # the reference's three bespoke drivers (mp4 fuzzed via its m4a
    # container alias) + its libsndfile families
    # (reference `src/stream/audio.py:22-34`)
    exts = {ext for _, ext in FAMILIES}
    assert {'m4a', 'wma', 'mts', 'wav', 'mp3', 'flac', 'ogg'} <= exts
