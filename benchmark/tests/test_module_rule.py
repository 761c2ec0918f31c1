"""No run loads JAX or the JAX package; names are compared whole."""

import subprocess
import sys

from benchmark import run


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'buzzdetect_torch_extra', sys)
    assert 'buzzdetect_torch' not in run.FORBIDDEN
    monkeypatch.setitem(sys.modules, 'buzzdetect_tpu.ops', sys)
    assert run.forbidden_modules() == ['buzzdetect_tpu']


def test_a_rehearsal_loads_none(tmp_path):
    code = ('import sys; from benchmark import run; '
            'rc = run.main(["--workload", "f32.long_chunks.pinned", "--seed", "3", '
            '"--seconds", "1", "--rehearse"]); '
            'print("LOADED", run.forbidden_modules()); sys.exit(rc)')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600,
                         cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_no_card_no_result():
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                          'f32.long_chunks.pinned', '--seed', '3', '--seconds', '1',
                          '--trace', '0'], capture_output=True, text=True,
                         timeout=600, cwd=run.ROOT,
                         env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin'})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
