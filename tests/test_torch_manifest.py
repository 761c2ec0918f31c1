"""tests/test_manifest.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions). No edit beyond the import prefix.

The JAX package's docstring:

Unit tests for the output-folder manifest (schema-compatibility guard).
"""

import os

from buzzdetect_torch.manifest import (
    build_manifest, read_manifest, write_manifest, diff_manifests,
    check_or_write_manifest)


def test_build_activations_mode():
    m = build_manifest('m1', 1.0, None, ['b', 'a'])
    assert m['output_mode'] == 'activations'
    assert m['classes_out'] == ['a', 'b']  # sorted
    assert m['precision'] is None


def test_build_detections_mode_ignores_classes():
    m = build_manifest('m1', 1.0, 0.95, ['a'])
    assert m['output_mode'] == 'detections'
    assert m['classes_out'] is None


def test_diff_class_order_insensitive():
    a = build_manifest('m1', 1.0, None, ['a', 'b'])
    b = build_manifest('m1', 1.0, None, ['b', 'a'])
    assert diff_manifests(a, b) == []


def test_diff_reports_conflicts():
    a = build_manifest('m1', 1.0, None, ['a', 'b'])
    b = build_manifest('m2', 0.5, None, ['a', 'c'])
    conflicts = diff_manifests(a, b)
    joined = '\n'.join(conflicts)
    assert 'modelname' in joined
    assert 'framehop_prop' in joined
    assert 'added c' in joined and 'removed b' in joined


def test_check_writes_then_matches_then_conflicts(tmp_path):
    d = str(tmp_path / 'out')
    m = build_manifest('m1', 1.0, None, ['a'])
    ok, msg = check_or_write_manifest(d, m)
    assert ok and msg is None
    assert read_manifest(d) == m

    ok, msg = check_or_write_manifest(d, dict(m))
    assert ok

    bad = build_manifest('m1', 0.5, None, ['a'])
    ok, msg = check_or_write_manifest(d, bad)
    assert not ok
    assert 'framehop_prop' in msg
    # conflicting manifest must not overwrite the original
    assert read_manifest(d) == m


def test_write_creates_dir(tmp_path):
    d = str(tmp_path / 'nested' / 'out')
    write_manifest(d, {'x': 1})
    assert read_manifest(d) == {'x': 1}


def test_read_manifest_tolerates_corrupt_json(tmp_path):
    """A manifest truncated by a mid-write crash must read as None (no
    manifest) — a raw JSONDecodeError would crash the CLI reconcile prompt
    and fire inside the GUI's per-keystroke change handler."""
    from buzzdetect_torch.manifest import read_manifest
    d = str(tmp_path)
    with open(tmp_path / 'buzzdetect_manifest.json', 'w') as f:
        f.write('{"modelname": "m", "framehop')  # torn mid-write
    assert read_manifest(d) is None
    # dir_out pointing at a FILE is survivable too
    p_file = tmp_path / 'not_a_dir'
    p_file.write_text('x')
    assert read_manifest(str(p_file)) is None


def test_orphan_results_refuse_admission(tmp_path):
    """A manifest-less folder that already holds result files (partial OR
    finalized, at any depth) must refuse admission: their settings cannot
    be attested, and the dangerous mismatches (threshold, framehop) are
    invisible in the CSV header. The message must carry the remedy —
    the exact manifest JSON to restore."""
    import json
    import os

    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.manifest import FNAME_MANIFEST

    d = str(tmp_path / 'out')
    nested = tmp_path / 'out' / 'siteA'
    nested.mkdir(parents=True)
    (nested / ('rec' + cfg.SUFFIX_RESULT_PARTIAL)).write_text(
        'start,detections_ins_buzz\n0.0,1\n')

    m = build_manifest('m1', 1.0, None, ['a'])
    ok, msg = check_or_write_manifest(d, m)
    assert not ok
    assert 'rec' + cfg.SUFFIX_RESULT_PARTIAL in msg
    assert FNAME_MANIFEST in msg
    # the remedy: the message embeds this run's manifest JSON verbatim
    assert json.dumps(m, indent=2) in msg
    # refusal must not adopt a manifest behind the user's back
    assert not os.path.exists(os.path.join(d, FNAME_MANIFEST))

    # finalized files alone trigger it too (corpus-level consistency)
    d2 = tmp_path / 'out2'
    d2.mkdir()
    (d2 / ('rec' + cfg.SUFFIX_RESULT_COMPLETE)).write_text(
        'start,activation_a\n0.0,0.5\n')
    ok, msg = check_or_write_manifest(str(d2), m)
    assert not ok

    # restoring the manifest (the message's remedy) admits the run
    with open(d2 / FNAME_MANIFEST, 'w') as f:
        json.dump(m, f)
    ok, msg = check_or_write_manifest(str(d2), m)
    assert ok and msg is None

    # quarantined debris (.corrupt) alone must NOT block a fresh folder
    d3 = tmp_path / 'out3'
    d3.mkdir()
    (d3 / ('rec' + cfg.SUFFIX_RESULT_PARTIAL + '.corrupt')).write_text('x')
    ok, msg = check_or_write_manifest(str(d3), m)
    assert ok and msg is None


def test_unreadable_manifest_with_results_says_so(tmp_path):
    """Results plus a manifest that EXISTS but doesn't parse (truncated
    external copy) must refuse with an inspect-and-repair message — not
    claim the file is absent and hand the user overwrite-ready JSON
    that would re-attest wrong provenance."""
    import json

    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.manifest import FNAME_MANIFEST

    d = tmp_path / 'out'
    d.mkdir()
    (d / ('rec' + cfg.SUFFIX_RESULT_COMPLETE)).write_text(
        'start,activation_a\n0.0,0.5\n')
    (d / FNAME_MANIFEST).write_text('{"modelname": "m", "frameh')  # torn

    m = build_manifest('m1', 1.0, None, ['a'])
    ok, msg = check_or_write_manifest(str(d), m)
    assert not ok
    assert 'unreadable' in msg
    assert 'repair' in msg.lower()
    assert f'but no {FNAME_MANIFEST}' not in msg
    # no overwrite-ready JSON for this run's settings
    assert json.dumps(m, indent=2) not in msg
    # the damaged file is left untouched for inspection
    assert (d / FNAME_MANIFEST).read_text().startswith('{"modelname"')


def test_find_orphan_results_bound_counts_directories(tmp_path):
    """max_entries must bound directory visits, not just files: a tree of
    many nested file-less folders costs an opendir+stat per directory,
    and a files-only bound would walk all of them (freezing per-keystroke
    GUI validation — the caller this bound exists for)."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.manifest import find_orphan_results

    root = tmp_path / 'out'
    # 40 sibling dirs, then the only result file in the 41st
    for k in range(40):
        (root / f'site{k:02d}').mkdir(parents=True)
    deep = root / 'zz_last'
    deep.mkdir()
    (deep / ('rec' + cfg.SUFFIX_RESULT_PARTIAL)).write_text('start\n')

    # bounded walk gives up before reaching the file...
    assert find_orphan_results(str(root), max_entries=10) == []
    # ...the unbounded (run-time) walk finds it
    assert find_orphan_results(str(root)) == [
        os.path.join('zz_last', 'rec' + cfg.SUFFIX_RESULT_PARTIAL)]
