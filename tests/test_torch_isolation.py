"""The port stands alone: no JAX (nor optax, which would bring it),
nothing of buzzdetect_tpu, and no quiet fallback from CUDA to the CPU."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'optax', 'buzzdetect_tpu')


def _port_sources():
    root = os.path.join(REPO, 'buzzdetect_torch')
    for base, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(base, f)
    yield os.path.join(REPO, 'chip_smoke.py')


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split('.')[0]


def test_no_jax_or_reference_package_imports():
    sources = list(_port_sources())
    assert len(sources) > 20 and os.path.exists(sources[-1])
    bad = [f'{os.path.relpath(p, REPO)}:{line} imports {mod}'
           for p in sources for line, mod in _imported_roots(p)
           if mod in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize('first', [
    'buzzdetect_torch', 'buzzdetect_torch.ops.common',
    'buzzdetect_torch.ops.sepconv',
    'buzzdetect_torch.models.yamnet', 'buzzdetect_torch.models.classifier',
    'buzzdetect_torch.ops.logmel', 'buzzdetect_torch.cli',
    'buzzdetect_torch.ops.attention', 'buzzdetect_torch.models.ast',
    'buzzdetect_torch.ops.layer1',
    'buzzdetect_torch.api', 'buzzdetect_torch.doctor',
    'buzzdetect_torch.ops.probe', 'buzzdetect_torch.tools.capability_probe',
    'buzzdetect_torch.tools.roofline',
    'buzzdetect_torch.tools.profile_pipeline',
    'buzzdetect_torch.audio.ffi', 'buzzdetect_torch.ops.resample',
    'buzzdetect_torch.tools.decode_rate_probe',
    'buzzdetect_torch.tools.fuzz_decode',
    'buzzdetect_torch.tools.soak_resume', 'buzzdetect_torch.parallel',
    'buzzdetect_torch.tools.soak_watch', 'buzzdetect_torch.train',
    'buzzdetect_torch.train.clips', 'buzzdetect_torch.train.embed_corpus',
    'buzzdetect_torch.train.checkpoint', 'buzzdetect_torch.train.augment',
    'buzzdetect_torch.models.convert', 'buzzdetect_torch.write.detections',
    'buzzdetect_torch.write.activity', 'buzzdetect_torch.write.trim',
    'buzzdetect_torch.tools.call_detections',
    'buzzdetect_torch.tools.trim_results',
    'buzzdetect_torch.tools.activity_report',
    'buzzdetect_torch.tools.score_embeddings',
    'buzzdetect_torch.tools.embed_corpus',
    'buzzdetect_torch.tools.train_model',
    'buzzdetect_torch.tools.build_ensemble',
    'buzzdetect_torch.tools.import_reference_model',
    'buzzdetect_torch.ops.library', 'buzzdetect_torch.models.export',
    'buzzdetect_torch.tools.aot_probe', 'buzzdetect_torch.examples.serve_aot',
    'buzzdetect_torch.parallel.mesh', 'buzzdetect_torch.tools.int8_probe',
    'buzzdetect_torch.examples.quickstart',
    'buzzdetect_torch.examples.scale_out',
    'buzzdetect_torch.examples.field_monitoring',
    'buzzdetect_torch.examples.train_detector',
    'buzzdetect_torch.gui', 'buzzdetect_torch.gui.config',
    'buzzdetect_torch.gui.viewmodel', 'buzzdetect_torch.gui.widgets',
    'buzzdetect_torch.gui.splash', 'buzzdetect_torch.gui.settings',
    'buzzdetect_torch.gui.analysis'])
def test_importing_the_port_loads_no_jax(first):
    """Each module imports first without an import cycle, and the package
    with its orchestrator pulls in no JAX. A subprocess: tests/conftest.py
    imports jax into this process."""
    code = (f'import sys, {first}, buzzdetect_torch.analysis\n'
            'bad = sorted(m for m in sys.modules\n'
            f'             if m.split(".")[0] in {FORBIDDEN!r})\n'
            'print(bad)\n'
            'assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_without_a_card_raises(tmp_path):
    """Asking for the card where torch finds none raises at every entry
    point; nothing carries on on the CPU."""
    import torch
    import buzzdetect_torch
    from buzzdetect_torch.models.classifier import ChunkClassifier
    from buzzdetect_torch.models.registry import load_model
    assert not torch.cuda.is_available()  # tests/conftest.py hides the card
    with pytest.raises(RuntimeError, match='CUDA'):
        ChunkClassifier({}, device='cuda')
    with pytest.raises(RuntimeError, match='CUDA'):
        load_model('model_general_v3')
    with pytest.raises(RuntimeError, match='CUDA'):
        buzzdetect_torch.analyze(modelname='model_general_v3',
                                 dir_audio=str(tmp_path),
                                 dir_out=str(tmp_path / 'out'))
    from buzzdetect_torch import api, cli
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--modelname', 'model_general_v3', '--dir_audio',
                  str(tmp_path), '--dir_out', str(tmp_path / 'out')])
    with pytest.raises(RuntimeError, match='CUDA'):
        api.score_file(str(tmp_path / 'none.wav'))
    assert not (tmp_path / 'out').exists()
    x = torch.zeros(1, 48, 32, 32)
    from buzzdetect_torch.ops import common, sepconv
    with pytest.raises(ValueError, match='unsupported device'):
        common.route(x.to('meta'))
    assert sepconv.fused_front.launches == dict.fromkeys(
        sepconv.LAUNCH_KEYS, 0)


@pytest.mark.parametrize('kw', [
    {'mesh': ['cpu', 'cpu']}, {'devices': 2}, {'host_shard': (0, 2)},
    {'devices': 'all'},
])
def test_unported_analyze_options_raise(tmp_path, kw):
    """No layout is left unported. mesh= is a mesh of ``device``'s type: a
    CPU mesh under the default ``device='cuda'`` is a ValueError before any
    model loads, and with ``device='cpu'`` it runs; devices= counts the
    devices of ``device``'s type, so 2 CPUs, or every CUDA card of a
    machine without one, is a ValueError before any model loads;
    host_shard= runs."""
    import buzzdetect_torch
    from buzzdetect_torch.parallel import make_mesh
    run = dict(modelname='model_general_v3', dir_audio=str(tmp_path),
               dir_out=str(tmp_path / 'out'))
    if 'mesh' in kw:
        mesh = make_mesh(devices=kw['mesh'], device='cpu')
        with pytest.raises(ValueError, match="pass device='cpu'"):
            buzzdetect_torch.analyze(mesh=mesh, **run)
        result = buzzdetect_torch.analyze(device='cpu', mesh=mesh,
                                          verbosity_print='ERROR', **run)
        assert result.model._mesh is mesh
        assert result.coordinator.end_reason == 'no files'
    elif kw.get('devices') == 2:
        with pytest.raises(ValueError, match='only 1 local cpu device'):
            buzzdetect_torch.analyze(device='cpu', **run, **kw)
    elif 'devices' in kw:
        with pytest.raises(ValueError, match='no cuda device is attached'):
            buzzdetect_torch.analyze(**run, **kw)
    else:
        result = buzzdetect_torch.analyze(device='cpu',
                                          verbosity_print='ERROR', **run,
                                          **kw)
        assert result.host_shard == (0, 2)
        assert result.coordinator.end_reason == 'no files'


def test_load_exported_in_a_fresh_interpreter_imports_no_jax(tmp_path):
    """A serving process that loads and calls an exported artifact
    (``models/export.load_exported``) imports no JAX and nothing of
    buzzdetect_tpu. The artifact is built in a child too: tests/conftest.py
    imports jax into this process."""
    build = ('from buzzdetect_torch import config\n'
             'from buzzdetect_torch.models.convert import build_model_bundle\n'
             'from buzzdetect_torch.models.export import (export_classifier,\n'
             '                                            save_exported)\n'
             f'build_model_bundle({str(tmp_path / "m" / "t")!r},\n'
             '                   classes=["a", "b"], seed=1)\n'
             f'config.DIR_MODELS = {str(tmp_path / "m")!r}\n'
             'blob, meta = export_classifier("t", chunk_seconds=2.0,\n'
             '                               platforms=("cpu",))\n'
             f'save_exported({str(tmp_path / "s")!r}, blob, meta)\n')
    serve = ('import sys, numpy as np\n'
             'from buzzdetect_torch.models.export import load_exported\n'
             f'call, meta = load_exported({str(tmp_path / "s")!r}, '
             'device="cpu")\n'
             'out = call(np.zeros(meta["input_samples"], np.int16))\n'
             'assert out.shape == (meta["n_patches"], 2), out.shape\n'
             'bad = sorted(m for m in sys.modules\n'
             f'             if m.split(".")[0] in {FORBIDDEN!r})\n'
             'print(bad)\n'
             'assert not bad, bad\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    for code in (build, serve):
        out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
