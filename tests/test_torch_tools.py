"""The port's developer tools on the CPU: the roofline table
(``buzzdetect_torch/tools/roofline.py``) against the JAX tool
(``tools/roofline.py``, loaded by path) and against ``chip_smoke.py``'s
work counts, ``analyze(profile_dir=)`` and the pipeline sampler
(``buzzdetect_torch/tools/profile_pipeline.py``), and the FMA chain kernel's
plain version against the same loop in JAX.
"""

import importlib.util
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import buzzdetect_torch
import chip_smoke
from buzzdetect_torch.ops import probe
from buzzdetect_torch.ops.sepconv import tail_specs
from buzzdetect_torch.tools import profile_pipeline, roofline
from buzzdetect_torch.utils import cuda_time_ms, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = 'model_general_v3'


def _jax_roofline():
    spec = importlib.util.spec_from_file_location(
        'jax_roofline_tool', os.path.join(REPO, 'tools', 'roofline.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('seconds', [960.0, 200.64])
@pytest.mark.parametrize('dtype_bytes', [4, 2])
def test_graph_stages_match_the_jax_tool(seconds, dtype_bytes):
    ref = list(_jax_roofline().graph_stages(seconds, dtype_bytes=dtype_bytes))
    got = list(roofline.graph_stages(seconds, dtype_bytes=dtype_bytes))
    assert len(got) == len(ref) == 3 + 1 + 2 * 13 + 2
    worst = 0
    for (name, _engine, flops, nbytes), (r_name, r_engine, r_flops,
                                         r_bytes) in zip(got, ref):
        assert (name, flops, nbytes) == (r_name, r_flops, r_bytes)
        worst = max(worst, abs(flops - r_flops), abs(nbytes - r_bytes))
    print(f'{seconds} s, {dtype_bytes} B: {len(got)} rows, max |port - jax| '
          f'over FLOPs and bytes = {worst}')


@pytest.mark.parametrize('start,stop,gap', [(2, 8, False), (8, None, True)])
def test_sep_layer_flops_equal_chip_smokes_stack_work(start, stop, gap):
    """At 200.64 s (209 patches, one default chunk) the roofline's pointwise
    and depthwise FLOPs of a layer range equal chip_smoke.stack_work's."""
    rows = {name: flops for name, _e, flops, _b in
            roofline.graph_stages(200.64)}
    specs = tail_specs(start, stop)
    pw = sum(rows[f'{s.name} pw 1x1 {s.c_in}->{s.c_out}'] for s in specs)
    dw = sum(rows[f'{s.name} dw 3x3/{s.stride} @{s.c_in}'] for s in specs)
    pw_ref, dw_ref, _bytes = chip_smoke.stack_work(specs, 209, gap,
                                                   'highest')
    print(f'layers {start}-{stop}: pointwise {pw} vs {pw_ref}, depthwise '
          f'{dw} vs {dw_ref}')
    assert (pw, dw) == (pw_ref, dw_ref)


def test_one_peak_table_names_the_h100_parts():
    assert roofline.peaks('NVIDIA H100 80GB HBM3') == (67e12, 989e12, 3.35e12)
    assert roofline.peaks('NVIDIA H100 PCIe') == (51.2e12, 756e12, 2.0e12)
    with pytest.raises(ValueError, match='no peak table'):
        roofline.peaks('NVIDIA A100-SXM4-80GB')


def test_roofline_table_on_the_cpu(capsys):
    assert roofline.main(['--device', 'cpu', '--seconds', '200.64']) == 0
    out = capsys.readouterr().out
    assert '209 patches' in out and 'layer14 pw 1x1 1024->1024' in out
    assert 'floor assumes an unfused graph' in out


def test_roofline_measures_only_on_the_card():
    with pytest.raises(SystemExit):
        roofline.main(['--device', 'cpu', '--measure'])
    with pytest.raises(RuntimeError, match='CUDA'):
        roofline.main([])
    with pytest.raises(RuntimeError, match='CUDA'):
        cuda_time_ms(lambda: None)


def test_fma_chain_plain_matches_the_jax_loop():
    """tools/roofline.py's FMA chain (``y = y * a + b``, 256 steps) in JAX,
    on the port's constants, against the kernel's plain version. The map
    contracts towards 1, so every value stays within max(|x|, 1); 256 steps
    of at most two roundings of half an f32 ulp each give 2 * 256 * 2**-24
    = 3.1e-5 of that, checked elementwise as 1e-4 * max(|x|, 1)."""
    a, b = roofline.FMA_A, roofline.FMA_B
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    y = jnp.asarray(x)
    for _ in range(256):
        y = y * np.float32(a) + np.float32(b)
    got = probe.fma_chain(torch.from_numpy(x), 256, a, b).numpy()
    ref = np.asarray(y)
    err = np.abs(got - ref)
    print(f'fma_chain: max |port - jax| = {err.max():.3g}')
    assert (err <= 1e-4 * np.maximum(np.abs(x), 1.0)).all()


@pytest.fixture
def recording(tmp_path):
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    rng = np.random.default_rng(7)
    write_wav(dir_audio / 'rec.wav', rng.standard_normal(16000 * 12) * 0.1,
              16000)
    return str(dir_audio)


def test_analyze_profile_dir_writes_a_trace(recording, tmp_path):
    """The counterpart of tests/test_pipeline.py's profile_dir test, and the
    trace holds the CPU ops of the thread that ran the model, not only the
    main thread's."""
    profile_dir = tmp_path / 'trace'
    a = buzzdetect_torch.analyze(modelname=MODEL, dir_audio=recording,
                                 dir_out=str(tmp_path / 'out'),
                                 chunklength=5.0, verbosity_print='ERROR',
                                 device='cpu', profile_dir=str(profile_dir))
    assert a.coordinator.end_reason == 'completed'
    found = [os.path.join(b, f) for b, _d, files in os.walk(profile_dir)
             for f in files]
    assert found, 'no profiler trace written'
    with open(found[0]) as f:
        events = json.load(f)['traceEvents']
    main = threading.main_thread().native_id
    tids = {e['tid'] for e in events
            if e.get('cat') == 'cpu_op' and e['name'] == 'aten::conv2d'}
    print(f'{found[0]}: {len(events)} events; aten::conv2d on threads '
          f'{sorted(tids)} (main {main})')
    assert tids and main not in tids


def test_sampler_sees_the_analyzer_and_writer_threads(recording, tmp_path):
    with profile_pipeline.Sampler() as s:
        a = buzzdetect_torch.analyze(modelname=MODEL, dir_audio=recording,
                                     dir_out=str(tmp_path / 'out'),
                                     chunklength=5.0, verbosity_print='ERROR',
                                     device='cpu')
    assert a.coordinator.end_reason == 'completed'
    lines = profile_pipeline.report(s, top=5)
    print('\n'.join(lines))
    assert s.per_role['analyzer'] > 0 and s.per_role['writer'] > 0
    assert s.total == sum(s.per_role.values()) >= s.busy_total
    assert any('analyzer' in ln for ln in lines)


def test_profile_pipeline_runs_on_the_cpu(capsys):
    assert profile_pipeline.main(['--device', 'cpu', '--files', '1',
                                  '--seconds-per-file', '6',
                                  '--chunklength', '5', '--top', '4']) == 0
    out = capsys.readouterr().out
    assert 'pipeline on cpu: 6 audio-seconds' in out
    assert 'share by role' in out and 'BUSY frames' in out
