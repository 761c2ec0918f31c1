"""tests/test_cli.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions; ``test_torch_cli.py`` holds the port's own
CLI cases). No other edit: every case stops at the parser or the
validators, or replaces ``analysis.analyze``, so none reaches a device.

The JAX package's docstring:
CLI tests: argument surface and manifest reconciliation."""

import json
import os

import pytest

from buzzdetect_torch.cli import build_parser, reconcile_with_manifest, str2bool
from buzzdetect_torch.manifest import build_manifest, write_manifest


def test_parser_surface_matches_reference_flags():
    parser = build_parser()
    args = parser.parse_args(['--modelname', 'm'])
    # reference defaults (buzzdetect_cli.py:77-139)
    assert args.classes_out == 'all'
    assert args.precision is None
    assert args.framehop_prop == 1
    assert args.chunklength == 200
    assert args.analyzers_cpu == 1
    assert args.analyzers_gpu == 0
    assert args.n_streamers is None
    assert args.stream_buffer_depth is None
    assert args.dir_audio == './audio_in'
    assert args.dir_out is None
    assert args.verbosity_print == 'PROGRESS'
    assert args.verbosity_log == 'DEBUG'
    assert args.log_progress is False


def test_parser_classes_list():
    args = build_parser().parse_args(
        ['--modelname', 'm', '--classes_out', 'ins_buzz', 'human'])
    assert args.classes_out == ['ins_buzz', 'human']


def test_str2bool():
    assert str2bool('yes') and str2bool('TRUE') and str2bool('1')
    assert not str2bool('no') and not str2bool('f')
    with pytest.raises(Exception):
        str2bool('maybe')


def test_reconcile_no_manifest(tmp_path):
    out = reconcile_with_manifest('m', str(tmp_path), 'all', None, 1.0)
    assert out == ('m', 'all', None, 1.0)


def test_reconcile_matching_manifest(tmp_path, monkeypatch):
    from buzzdetect_torch import config as cfg
    dir_model = tmp_path / 'models' / 'm'
    dir_model.mkdir(parents=True)
    (dir_model / 'config_model.json').write_text(
        json.dumps({'classes': ['a', 'b']}))
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))

    dir_out = str(tmp_path / 'out')
    write_manifest(dir_out, build_manifest('m', 1.0, None, ['a', 'b']))
    out = reconcile_with_manifest('m', dir_out, 'all', None, 1.0)
    assert out == ('m', 'all', None, 1.0)


def test_reconcile_conflict_adopts_with_yes(tmp_path, monkeypatch, capsys):
    from buzzdetect_torch import config as cfg
    dir_model = tmp_path / 'models' / 'm'
    dir_model.mkdir(parents=True)
    (dir_model / 'config_model.json').write_text(
        json.dumps({'classes': ['a', 'b']}))
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))

    dir_out = str(tmp_path / 'out')
    write_manifest(dir_out, build_manifest('m', 0.5, None, ['a']))
    modelname, classes_out, precision, framehop = reconcile_with_manifest(
        'm', dir_out, 'all', None, 1.0, assume_yes=True)
    # adopted the folder's settings
    assert framehop == 0.5
    assert classes_out == ['a']
    out = capsys.readouterr().out
    assert 'different settings' in out


def test_reconcile_conflict_decline_exits(tmp_path, monkeypatch):
    from buzzdetect_torch import config as cfg
    dir_model = tmp_path / 'models' / 'm'
    dir_model.mkdir(parents=True)
    (dir_model / 'config_model.json').write_text(
        json.dumps({'classes': ['a']}))
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))
    monkeypatch.setattr('builtins.input', lambda *_: 'n')

    dir_out = str(tmp_path / 'out')
    write_manifest(dir_out, build_manifest('m', 0.5, None, ['a']))
    with pytest.raises(SystemExit):
        reconcile_with_manifest('m', dir_out, 'all', None, 1.0)


def test_malformed_manifest_reads_as_none(tmp_path):
    """Valid JSON that is not an object (hand-edited/corrupt) must read as
    no-manifest, not crash the reconcile prompt or the GUI handler."""
    from buzzdetect_torch.manifest import read_manifest
    (tmp_path / 'buzzdetect_manifest.json').write_text('["not", "a", "dict"]')
    assert read_manifest(str(tmp_path)) is None


def test_cli_rejects_out_of_range_settings(capsys):
    """The CLI runs the same validators as the GUI: out-of-range settings
    exit with a friendly message instead of a deep traceback."""
    import pytest as _pytest
    from buzzdetect_torch.cli import main
    with _pytest.raises(SystemExit) as e:
        main(['--modelname', 'model_general_v3', '--precision', '1.5'])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert 'precision' in err


def test_cli_rejects_bare_classes_out():
    """`--classes_out` with no values must be an argparse error, not a
    silently-locked zero-class output schema."""
    import pytest as _pytest
    from buzzdetect_torch.cli import main
    with _pytest.raises(SystemExit) as e:
        main(['--modelname', 'model_general_v3', '--classes_out'])
    assert e.value.code == 2


def test_cli_devices_flag_parsing(monkeypatch, tmp_path):
    """--devices accepts an int or 'all' and reaches analyze() normalized;
    garbage fails with a parser error, not a traceback."""
    import buzzdetect_torch.cli as cli

    seen = {}

    def fake_analyze(**kw):
        seen.update(kw)

    monkeypatch.setattr('buzzdetect_torch.analysis.analyze', fake_analyze)
    base = ['--modelname', 'model_general_v3',
            '--dir_audio', str(tmp_path), '--dir_out', str(tmp_path / 'out')]
    cli.main(base + ['--devices', '4'])
    assert seen['devices'] == 4
    cli.main(base + ['--devices', 'all'])
    assert seen['devices'] == 'all'
    cli.main(base)
    assert seen['devices'] is None

    import pytest as _pytest
    with _pytest.raises(SystemExit):
        cli.main(base + ['--devices', 'many'])
    with _pytest.raises(SystemExit):
        cli.main(base + ['--devices', '0'])  # parser error, not a traceback


def test_cli_host_shard_flag_parsing(monkeypatch, tmp_path):
    """--host_shard I/N reaches analyze() as a tuple; malformed or
    out-of-range specs fail with a parser error."""
    import buzzdetect_torch.cli as cli

    seen = {}
    monkeypatch.setattr('buzzdetect_torch.analysis.analyze',
                        lambda **kw: seen.update(kw))
    base = ['--modelname', 'model_general_v3',
            '--dir_audio', str(tmp_path), '--dir_out', str(tmp_path / 'out')]
    cli.main(base + ['--host_shard', '1/4'])
    assert seen['host_shard'] == (1, 4)
    cli.main(base)
    assert seen['host_shard'] is None

    import pytest as _pytest
    for bad in ('4/4', 'x/2', '3'):
        with _pytest.raises(SystemExit):
            cli.main(base + ['--host_shard', bad])


def test_cli_backend_timeout_flag(monkeypatch, tmp_path):
    """--backend_timeout reaches analyze(); non-positive values fail at
    the validator with a parser error, not deep inside the preflight."""
    import buzzdetect_torch.cli as cli

    seen = {}
    monkeypatch.setattr('buzzdetect_torch.analysis.analyze',
                        lambda **kw: seen.update(kw))
    base = ['--modelname', 'model_general_v3',
            '--dir_audio', str(tmp_path), '--dir_out', str(tmp_path / 'out')]
    cli.main(base + ['--backend_timeout', '90'])
    assert seen['backend_timeout'] == 90.0
    cli.main(base)
    assert seen['backend_timeout'] is None

    import pytest as _pytest
    for bad in ('0', '-5', 'soon'):
        with _pytest.raises(SystemExit):
            cli.main(base + ['--backend_timeout', bad])


def test_cli_exit_code_reflects_end_reason(monkeypatch, tmp_path, capsys):
    """Abnormal endings (fatal worker failure, device stall, interrupt)
    must not exit 0 — supervisors and `buzzdetect ... && next` pipelines
    key off the exit code."""
    import pytest as _pytest
    import buzzdetect_torch.cli as cli

    class _Result:
        def __init__(self, reason):
            class _C:
                end_reason = reason
            self.coordinator = _C()

    base = ['--modelname', 'model_general_v3',
            '--dir_audio', str(tmp_path), '--dir_out', str(tmp_path / 'out')]

    def run_with(reason):
        monkeypatch.setattr('buzzdetect_torch.analysis.analyze',
                            lambda **kw: _Result(reason))
        return cli.main(base)

    for healthy in ('completed', 'fully analyzed', 'no files'):
        run_with(healthy)  # returns, no SystemExit

    for reason, code in (('analyzer failure', 1), ('device stall', 1),
                         ('manifest mismatch', 1), ('interrupted', 130)):
        with _pytest.raises(SystemExit) as e:
            run_with(reason)
        assert e.value.code == code
        assert reason in capsys.readouterr().err


def test_cli_class_lists_accept_commas(monkeypatch, tmp_path):
    """One naming convention across surfaces: the GUI form splits class
    names on commas and/or whitespace (validation.split_names), so the
    CLI's nargs tokens must re-split on commas too — `--alert_classes a,b`
    is two classes, not the single (nonexistent) class 'a,b'."""
    import buzzdetect_torch.cli as cli

    seen = {}
    monkeypatch.setattr('buzzdetect_torch.analysis.analyze',
                        lambda **kw: seen.update(kw))
    base = ['--modelname', 'model_general_v3',
            '--dir_audio', str(tmp_path), '--dir_out', str(tmp_path / 'out')]

    cli.main(base + ['--classes_out', 'ins_buzz,mech_auto', 'frog',
                     '--alert_classes', 'ins_buzz,frog',
                     '--alert_threshold', '-2'])
    assert seen['classes_out'] == ['ins_buzz', 'mech_auto', 'frog']
    assert seen['alert_classes'] == ['ins_buzz', 'frog']

    # the 'all' sentinel survives either spelling
    cli.main(base + ['--classes_out', 'all'])
    assert seen['classes_out'] == 'all'

    # bare separators flatten to ZERO classes - fail fast (a zero-column
    # archive), don't launch
    import pytest as _pytest
    with _pytest.raises(SystemExit) as e:
        cli.main(base + ['--classes_out', ','])
    assert e.value.code == 2
    with _pytest.raises(SystemExit):
        cli.main(base + ['--alert_classes', ',', '--alert_threshold', '-2'])
