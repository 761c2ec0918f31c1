"""The port's entry points: the CLI (``python -m buzzdetect_torch``), the
convenience API and the doctor, against the JAX package where it has a
counterpart, on this machine's CPU (``--device cpu``; there is no card)."""

import csv
import json
import os
import shutil

import numpy as np
import pytest

import buzzdetect_tpu
from buzzdetect_tpu import api as japi
from buzzdetect_tpu import cli as jcli
from buzzdetect_torch import api as tapi
from buzzdetect_torch import cli as tcli
from buzzdetect_torch import config as tcfg
from buzzdetect_torch import doctor
from buzzdetect_torch.models.registry import load_model
from tests.audio_fixtures import make_tone, write_wav

MODEL = 'model_general_v3'
# CSV scores: one unit of the last printed digit, as test_torch_analyze.py
# (a value within f32 rounding of a rounding edge may print the other way).
ATOL_CSV = 0.01 + 1e-9
# API scores: the BASELINE.md parity budget.
ATOL_SCORE = 1e-3


def _options(parser):
    return {a.option_strings[0]: (a.dest, a.default, a.choices, a.nargs,
                                  a.required)
            for a in parser._actions if a.option_strings}


def test_parser_flags_match_jax():
    """Every flag of the JAX CLI, with its name, default, choices and arity,
    plus --device."""
    jopts = _options(jcli.build_parser())
    topts = _options(tcli.build_parser())
    assert set(topts) - set(jopts) == {'--device'}
    assert set(jopts) <= set(topts)
    assert {k: v for k, v in topts.items() if k != '--device'} == jopts
    assert topts['--device'][1:3] == ('cuda', ['cuda', 'cpu'])
    args = tcli.build_parser().parse_args(['--modelname', MODEL, '--bf16'])
    assert args.bf16 and args.device == 'cuda'


@pytest.fixture(scope='module')
def audio(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli_audio')
    rng = np.random.default_rng(21)
    mono = make_tone(11.9, 16000, 440) * 0.5
    mono = mono + rng.standard_normal(len(mono)).astype(np.float32) * 0.03
    write_wav(root / 'rec.wav', mono, 16000)
    return root


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _main(argv):
    """``tcli.main(argv)``, which returns None after a healthy end, and the
    Analyzer that its ``analyze()`` call returned, kept by a spy that wraps
    ``buzzdetect_torch.analysis.analyze`` for the call."""
    from buzzdetect_torch import analysis
    real, seen = analysis.analyze, []

    def spy(**kw):
        seen.append(real(**kw))
        return seen[-1]

    analysis.analyze = spy
    try:
        assert tcli.main(argv) is None
    finally:
        analysis.analyze = real
    return seen[-1]


def test_cli_cpu_run_matches_jax_analyze(audio, tmp_path):
    """``--device cpu`` end to end: the CSV matches the JAX package's
    analyze() on the same file; a finished run returns None (its Analyzer,
    read through a spy on analyze(), ended 'completed'), and a rerun over
    the finished folder ends 'fully analyzed' (both exit 0)."""
    dir_out = tmp_path / 'torch'
    argv = ['--modelname', MODEL, '--dir_audio', str(audio), '--dir_out',
            str(dir_out), '--chunklength', '5', '--verbosity_print',
            'ERROR', '--device', 'cpu']
    result = _main(argv)
    assert result.coordinator.end_reason == 'completed'
    buzzdetect_tpu.analyze(modelname=MODEL, dir_audio=str(audio),
                           dir_out=str(tmp_path / 'jax'), chunklength=5,
                           verbosity_print='ERROR')
    port = _csv(dir_out / 'rec_buzzdetect.csv')
    ref = _csv(tmp_path / 'jax' / 'rec_buzzdetect.csv')
    # 11.9 s: 12 whole frames and the zero-padded start of a 13th
    assert port[0] == ref[0] and len(port) == len(ref) == 1 + 13
    assert [r[0] for r in port] == [r[0] for r in ref]
    err = float(np.abs(np.array(port[1:], float)[:, 1:]
                       - np.array(ref[1:], float)[:, 1:]).max())
    print(f'CLI --device cpu vs JAX analyze: max |d| over CSV scores = '
          f'{err:.3g}')
    assert err <= ATOL_CSV
    again = _main(argv)
    assert again.coordinator.end_reason == 'fully analyzed'


@pytest.mark.parametrize('flags,item', [
    (['--devices', '1'], 'Multi-GPU layouts'),
    (['--host_shard', '0/2'], 'Multi-GPU layouts'),
])
def test_cli_unported_flags_exit_2_naming_the_roadmap_item(audio, tmp_path,
                                                           capsys, flags,
                                                           item):
    """The flags of ROADMAP's "Multi-GPU layouts" that exited 2 while
    unported now parse and reach analyze(): the run completes (a one-replica
    run, or host 0's shard of the fixture). A malformed value of the same
    flag still exits 2, before any work, with the JAX CLI's message."""
    dir_out = tmp_path / 'out'
    result = _main(['--modelname', MODEL, '--dir_audio', str(audio),
                    '--dir_out', str(dir_out), '--device', 'cpu',
                    '--chunklength', '5', '--verbosity_print', 'ERROR',
                    *flags])
    mine = True
    if flags[0] == '--devices':
        assert len(result.replica_models) == 1
        assert result.replica_models[0].device.type == 'cpu'
    else:
        from buzzdetect_torch.parallel import shard_files
        assert result.host_shard == (0, 2)
        mine = shard_files(['rec.wav'], 0, 2, root='') == ['rec.wav']
    assert result.coordinator.end_reason == ('completed' if mine
                                             else 'fully analyzed')
    assert (dir_out / 'rec_buzzdetect.csv').exists() == mine
    bad = {'--devices': '0', '--host_shard': '2/2'}[flags[0]]
    with pytest.raises(SystemExit) as e:
        tcli.main(['--modelname', MODEL, '--dir_audio', str(audio),
                   '--dir_out', str(tmp_path / 'bad'), '--device', 'cpu',
                   flags[0], bad])
    assert e.value.code == 2
    assert flags[0] in capsys.readouterr().err
    assert not (tmp_path / 'bad').exists()


@pytest.mark.parametrize('reason,code', [
    ('completed', None), ('fully analyzed', None), ('no files', None),
    ('analyzer failure', 1), ('device stall', 1), ('interrupted', 130),
])
def test_cli_exit_codes_follow_the_end_reason(monkeypatch, tmp_path, reason,
                                              code):
    """The scripting contract of buzzdetect_tpu/cli.py: a healthy end exits
    0 (``main`` returns None, as the JAX CLI's does), an abnormal one 1, an
    interrupt 130."""
    import types
    from buzzdetect_torch import analysis
    run = types.SimpleNamespace(
        coordinator=types.SimpleNamespace(end_reason=reason))
    monkeypatch.setattr(analysis, 'analyze', lambda **kw: run)
    argv = ['--modelname', MODEL, '--dir_audio', str(tmp_path),
            '--dir_out', str(tmp_path / 'out'), '--device', 'cpu']
    if code is None:
        assert tcli.main(argv) is None
    else:
        with pytest.raises(SystemExit) as e:
            tcli.main(argv)
        assert e.value.code == code


CONSOLE_SCRIPT = """
import sys
from buzzdetect_torch import analysis
from buzzdetect_torch.cli import main
force = sys.argv.pop(1)
if force:
    real = analysis.analyze

    def analyze(**kw):
        run = real(**kw)
        run.coordinator.end_reason = force
        return run
    analysis.analyze = analyze
sys.exit(main(sys.argv[1:]))
"""


@pytest.mark.parametrize('force,code', [('', 0), ('analyzer failure', 1)])
def test_console_script_exit_status(audio, tmp_path, force, code):
    """The installed ``buzzdetect-torch`` form, ``sys.exit(main(argv))``, in
    a child process: a healthy run exits 0 and prints no Analyzer on
    stderr; a run whose end reason the child patches to an abnormal one
    exits 1 and says so."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dir_out = tmp_path / 'out'
    proc = subprocess.run(
        [sys.executable, '-c', CONSOLE_SCRIPT, force, '--modelname', MODEL,
         '--dir_audio', str(audio), '--dir_out', str(dir_out),
         '--chunklength', '5', '--verbosity_print', 'ERROR', '--device',
         'cpu'],
        capture_output=True, text=True, timeout=300, cwd=repo,
        env={**os.environ, 'PYTHONPATH': repo})
    assert proc.returncode == code, proc.stderr[-2000:]
    assert 'Analyzer' not in proc.stderr
    assert (dir_out / 'rec_buzzdetect.csv').exists()
    if code:
        assert 'analysis ended abnormally: analyzer failure' in proc.stderr


def test_score_file_matches_jax(audio):
    starts, scores, classes = tapi.score_file(str(audio / 'rec.wav'),
                                              chunklength=5, device='cpu')
    j_starts, j_scores, j_classes = japi.score_file(str(audio / 'rec.wav'),
                                                    chunklength=5)
    assert classes == j_classes and len(classes) == 13
    np.testing.assert_array_equal(starts, j_starts)
    assert scores.shape == j_scores.shape == (13, 13)
    err = float(np.abs(scores - j_scores).max())
    print(f'score_file vs JAX: max |dscore| = {err:.3g}')
    assert err <= ATOL_SCORE
    rows = list(tapi.stream_scores(str(audio / 'rec.wav'), chunklength=5,
                                   device='cpu'))
    assert [t for t, _ in rows] == list(starts)


def test_doctor_json_without_a_card(capsys):
    """On a machine with no CUDA device the doctor reports, in the
    buzzdetect_doctor/1 schema, a failed CUDA check, skips the inference,
    runs the host-side checks, and exits 1."""
    code = doctor.main(json_mode=True)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 1
    assert report['schema'] == 'buzzdetect_doctor/1'
    assert report['modelname'] == MODEL and report['ok'] is False
    checks = {c['name']: c for c in report['checks']}
    assert checks['torch import']['ok'] is True
    assert checks['CUDA device']['ok'] is False and checks['CUDA device'][
        'error']
    assert checks['end-to-end inference'].get('skipped') is True
    for name in ('WAV round-trip', 'model bundle',
                 'threshold calibration (metrics table)'):
        assert checks[name]['ok'] is True, checks[name]
    assert any('UNTRAINED' in w for w in report['warnings'])


def test_doctor_human_output_without_a_card(capsys):
    assert doctor.main() == 1
    out = capsys.readouterr().out
    assert '[FAIL] CUDA device' in out and 'SOME CHECKS FAILED' in out


@pytest.fixture
def models_dir(tmp_path, monkeypatch):
    """A models folder with model_general_v3 and variants of it whose
    config_model.json differ in one key each."""
    src = os.path.join(tcfg.DIR_REPO, 'models', MODEL)
    root = tmp_path / 'models'
    for name, extra in ((MODEL, {}), ('v3_conv_xla', {'conv': 'xla'}),
                        ('v3_conv_pallas', {'conv': 'pallas'})):
        shutil.copytree(src, root / name, ignore=shutil.ignore_patterns(
            'model.npz'))
        os.symlink(os.path.join(src, 'model.npz'), root / name / 'model.npz')
        path = root / name / 'config_model.json'
        config = json.loads(path.read_text())
        path.write_text(json.dumps({**config, **extra}))
    monkeypatch.setattr(tcfg, 'DIR_MODELS', str(root))
    return root


def test_conv_config_key_is_honoured(models_dir, audio, tmp_path):
    """The bundle's "conv" key reaches the classifier: 'pallas' runs the
    conv kernels, 'xla' the XLA conv path (its 'auto' precision resolved
    to 'high'); the CLI runs the 'xla' bundle to a CSV that matches the
    JAX package's analyze() of the same bundle (its conv='xla')."""
    model = load_model('v3_conv_pallas', initialize=True, device='cpu')
    assert model.classifier.conv == 'pallas'
    model = load_model('v3_conv_xla', initialize=True, device='cpu')
    assert (model.classifier.conv, model.classifier.conv_precision) == (
        'xla', 'high')
    dir_out = tmp_path / 'out'
    result = _main(['--modelname', 'v3_conv_xla', '--dir_audio',
                    str(audio), '--dir_out', str(dir_out), '--device',
                    'cpu', '--chunklength', '5', '--verbosity_print',
                    'ERROR'])
    assert result.coordinator.end_reason == 'completed'
    from buzzdetect_tpu import config as jcfg
    jdir = jcfg.DIR_MODELS
    try:
        jcfg.DIR_MODELS = str(models_dir)
        buzzdetect_tpu.analyze(modelname='v3_conv_xla', dir_audio=str(audio),
                               dir_out=str(tmp_path / 'jax'), chunklength=5,
                               verbosity_print='ERROR')
    finally:
        jcfg.DIR_MODELS = jdir
    port = np.array(_csv(dir_out / 'rec_buzzdetect.csv')[1:], float)
    ref = np.array(_csv(tmp_path / 'jax' / 'rec_buzzdetect.csv')[1:], float)
    assert port.shape == ref.shape == (13, 14)
    err = float(np.abs(port - ref).max())
    print(f'CLI "conv": "xla" vs JAX analyze: max |d| over the CSV = '
          f'{err:.3g}')
    assert err <= ATOL_CSV


@pytest.mark.parametrize('precision', [None, 0.9])
def test_bf16_guardrail_warns_with_activations_output(tmp_path, precision):
    """bf16 with activations output warns (scores move by up to ~0.006
    against f32) through warnings.warn and the run log; detections mode,
    which that deviation does not move, does not."""
    import warnings
    import buzzdetect_torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        run = buzzdetect_torch.analyze(
            modelname=MODEL, dir_audio=str(tmp_path), device='cpu',
            dir_out=str(tmp_path / 'out'), compute_dtype='bfloat16',
            precision=precision, verbosity_print='ERROR')
    hits = [w for w in caught if 'bfloat16' in str(w.message)]
    assert len(hits) == (1 if precision is None else 0)
    assert run.coordinator.end_reason == 'no files'
