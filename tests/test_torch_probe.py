"""The capability probe's kernels (``buzzdetect_torch/ops/probe.py``) and
tool (``buzzdetect_torch/tools/capability_probe.py``) on the CPU, where
every wrapper runs its plain PyTorch version.

The JAX probe's cases are closures inside its ``main()`` that no test can
call, so each layout case is held against the numpy expression that
``tools/mosaic_capability_probe.py`` checks it against (its line is cited),
with exact equality. The three products are held against the JAX functions
on the CPU: ``dot_f32`` against ``jnp.dot`` at HIGHEST (atol 1e-4, rtol
1e-5: exact f32 in another summation order), ``dot_high`` and
``dot_high_emulated`` against ``pallas_conv._pw_dot`` at HIGH on the
``_split_hi_lo`` weight (atol 2e-4, rtol 1e-5: the same three products,
f32 sums in another order); and all three against numpy's float64 product
within the JAX probe's own tolerances (atol 1e-4, 1e-3, 1e-3).
``remap_batch`` (the 20 cases in one launch on the card) is held to the same
numpy references and to ``remap`` case by case, exactly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buzzdetect_tpu.ops.pallas_conv import _pw_dot, _split_hi_lo
from buzzdetect_torch.ops import probe
from buzzdetect_torch.ops.sepconv import pack_pointwise
from buzzdetect_torch.tools import capability_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

X3 = np.arange(16 * 16 * 128, dtype=np.float32).reshape(16, 16, 128)
X4 = np.arange(4 * 16 * 16 * 128, dtype=np.float32).reshape(4, 16, 16, 128)
X2 = np.arange(64 * 256, dtype=np.float32).reshape(64, 256)
XF = np.arange(8 * 48 * 1024, dtype=np.float32).reshape(8, 48, 1024)
X5 = np.arange(2 * 384 * 512, dtype=np.float32).reshape(2, 384, 512)
XC = np.arange(32 * 96 * 128, dtype=np.float32).reshape(32, 96, 128)
WC = np.arange(32, dtype=np.float32).reshape(32, 1, 1)
POS = np.arange(16).reshape(1, 16, 1)

# case -> (inputs, the numpy reference of tools/mosaic_capability_probe.py)
REFS = {
    'stride_lane': ((X3,), lambda: X3[:, :, ::2]),                    # :63
    'stride_sublane': ((X3,), lambda: X3[:, ::2, :]),                 # :69
    'stride_leading': ((X4,), lambda: X4[::2]),                       # :75
    'reshape_leading_split': (
        (X4,), lambda: X4.reshape(2, 2, 16, 16, 128)[:, 0]),          # :82
    'reshape_leading_merge': ((X4,), lambda: X4.reshape(64, 16, 128)),  # :89
    'collapse_to_2d': ((X4,), lambda: X4.reshape(-1, 128)),           # :97
    'split_minor': ((X2,), lambda: X2.reshape(64, 2, 128)),           # :105
    'roll_sublane': ((X3,), lambda: np.roll(X3, 1, 1)),               # :113
    'roll_lane': ((X3,), lambda: np.roll(X3, 128, 2)),                # :119
    'pad_slice_shift': (
        (X3,), lambda: np.pad(X3, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]),  # :128
    'transpose_minor': ((X3,), lambda: np.swapaxes(X3, 1, 2)),        # :136
    'row_gather': ((X4,), lambda: X4.reshape(4, 16, 16, 128)[
        :, ::2, ::2].reshape(256, 128)),                              # :172
    'iota_mask': ((X3,), lambda: np.where(POS % 4 == 0, 0.0, X3)),    # :182-183
    'iota_mod24': ((X3,), lambda: np.where(POS % 3 == 0, 0.0, X3)),   # :192-193
    'split_sublane': ((X3,), lambda: X3.reshape(16, 8, 2, 128)[:, :, 0]),  # :201
    'roll_lane_32': ((XF,), lambda: np.roll(XF, 32, 2)),              # :218
    'pad_slice_lane': (
        (XF,), lambda: np.pad(XF, ((0, 0), (0, 0), (1, 0)))[:, :, :-1]),  # :225
    'split_minor_small': ((XF,), lambda: XF.reshape(8, 48, 32, 32)),  # :232
    'swap_nonminor_merge': ((X5,), lambda: np.swapaxes(
        X5.reshape(2, 384, 4, 128), 1, 2).reshape(8, 384, 128)),      # :242-243
    'outer_broadcast_mul': ((XC, WC), lambda: XC * WC),               # :253
}


def test_the_cases_are_the_probes_twenty():
    assert list(REFS) == list(probe.CASES)
    assert len(probe.CASES) == 20


@pytest.mark.parametrize('case', list(REFS))
def test_layout_case_plain_equals_numpy_reference(case):
    inputs, ref = REFS[case]
    want = ref()
    got = probe.remap(case, *[torch.from_numpy(a) for a in inputs]).numpy()
    err = (float(np.abs(got - want).max()) if got.shape == want.shape
           else float('inf'))
    print(f'{case}: {got.shape}, max |port - numpy| = {err}')
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _dot_inputs():
    """The JAX probe's product operands (``:140-145``)."""
    xs = np.random.default_rng(0).standard_normal(
        (4, 16, 16, 128)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((128, 128)).astype(
        np.float32)
    return xs.reshape(1024, 128), w


def _port_dot(name, flat, w):
    a, wt = torch.from_numpy(flat), torch.from_numpy(w)
    if name == 'dot_high_emulated':
        return probe.dot_high_emulated(a, pack_pointwise(wt, 'high')).numpy()
    return getattr(probe, name)(a, wt).numpy()


def test_dot_f32_matches_jax_highest():
    flat, w = _dot_inputs()
    ref = np.asarray(jnp.dot(flat, w, precision=jax.lax.Precision.HIGHEST))
    got = _port_dot('dot_f32', flat, w)
    print(f'dot_f32: max |port - jnp.dot HIGHEST| = '
          f'{np.abs(got - ref).max():.3g}')
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize('name', ['dot_high', 'dot_high_emulated'])
def test_dot_high_matches_jax_pw_dot(name):
    flat, w = _dot_inputs()
    ref = np.asarray(_pw_dot(jnp.asarray(flat), _split_hi_lo(jnp.asarray(w)),
                             jnp.float32, jax.lax.Precision.HIGH))
    got = _port_dot(name, flat, w)
    print(f'{name}: max |port - _pw_dot HIGH| = {np.abs(got - ref).max():.3g}')
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize('name,atol', [('dot_f32', 1e-4), ('dot_high', 1e-3),
                                       ('dot_high_emulated', 1e-3)])
def test_dot_within_the_probes_tolerance_of_float64(name, atol):
    flat, w = _dot_inputs()
    ref = flat.astype(np.float64) @ w.astype(np.float64)
    got = _port_dot(name, flat, w)
    print(f'{name}: max |port - float64| = {np.abs(got - ref).max():.3g} '
          f'(probe atol {atol})')
    assert np.allclose(got, ref, atol=atol)


def test_the_tool_on_the_cpu_passes_every_case():
    out = subprocess.run(
        [sys.executable, '-m', 'buzzdetect_torch.tools.capability_probe',
         '--device', 'cpu'], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    lines = out.stdout.splitlines()
    print(out.stdout[-2000:])
    assert out.returncode == 0, out.stdout + out.stderr
    assert sum(ln.startswith('  PASS ') for ln in lines) == 23
    assert not any(ln.startswith(('  WRONG', '  FAIL')) for ln in lines)


def test_the_tool_asks_for_the_card_by_default():
    assert not torch.cuda.is_available()  # tests/conftest.py hides the card
    with pytest.raises(RuntimeError, match='CUDA'):
        capability_probe.main([])


def test_cpu_tensors_leave_every_launch_counter_at_zero(capsys):
    results = capability_probe.run_probe(torch.device('cpu'))
    probe.fma_chain(torch.ones(8), 3, 2.0, 1.0)
    assert set(results.values()) == {'PASS'} and len(results) == 23
    assert {k.__name__: k.launches for k in probe.KERNELS} == dict.fromkeys(
        ['remap', 'dot_f32', 'dot_high', 'dot_high_emulated', 'fma_chain'], 0)


@pytest.mark.parametrize('call,match', [
    (lambda: probe.remap('stride_lane', torch.zeros(4, 16, 16, 128)), '3-d'),
    (lambda: probe.remap('roll_lane', torch.zeros(16, 16, 128),
                         torch.zeros(16, 1, 1)), 'weight'),
    (lambda: probe.remap('no_such_case', torch.zeros(2, 2, 2)), 'unknown'),
    (lambda: probe.dot_f32(torch.zeros(8, 32), torch.zeros(32, 48)), '64'),
    (lambda: probe.dot_high_emulated(torch.zeros(8, 32),
                                     torch.zeros(32, 64)), 'bfloat16'),
    (lambda: probe.fma_chain(torch.zeros(6), 2, 1.0, 0.0), 'multiple of 4'),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def _items(device='cpu'):
    """The 20 layout cases as ``remap_batch`` items, on REFS's inputs."""
    return [(case, torch.from_numpy(inputs[0]).to(device),
             torch.from_numpy(inputs[1]).to(device) if len(inputs) > 1
             else None) for case, (inputs, _ref) in REFS.items()]


def test_remap_batch_on_the_cpu_equals_the_references_and_remap():
    for kernel in probe.KERNELS:
        kernel.launches = 0
    items = _items()
    outs = probe.remap_batch(items)
    assert len(outs) == 20
    for (case, x, w), out in zip(items, outs):
        want = REFS[case][1]()
        single = probe.remap(case, x, w)
        got = out.numpy()
        err = (float(np.abs(got - want).max()) if got.shape == want.shape
               else float('inf'))
        print(f'remap_batch {case}: {got.shape}, max |port - numpy| = {err}')
        assert got.shape == want.shape and np.array_equal(got, want)
        assert torch.equal(out, single)
    assert probe.remap.launches == 0   # the CPU runs the plain versions


@pytest.mark.parametrize('bad,match', [
    (('no_such_case', torch.zeros(2, 2, 2), None), 'item 3: unknown'),
    (('stride_lane', torch.zeros(4, 16, 16, 128), None), 'item 3: .*3-d'),
    (('roll_lane', torch.zeros(16, 16, 128), torch.zeros(16, 1, 1)),
     'item 3: .*weight'),
    (('outer_broadcast_mul', torch.zeros(32, 96, 128), None),
     'item 3: .*weight'),
    (('outer_broadcast_mul', torch.zeros(32, 96, 128), torch.zeros(8, 1, 1)),
     'item 3: .*weight'),
    (('stride_lane', torch.zeros(16, 16, 128, device='meta'), None),
     'item 3: .*one device'),
])
def test_remap_batch_refuses_a_bad_item_naming_it(bad, match):
    items = _items()[:3] + [bad] + _items()[3:5]
    with pytest.raises(ValueError, match=match):
        probe.remap_batch(items)


def test_remap_batch_refuses_what_32_bit_indices_cannot_reach():
    big = torch.zeros(2, 1024, 1024, 1024, device='meta')   # 2**31
    with pytest.raises(ValueError, match='item 1: .*32 bits'):
        probe.remap_batch([('stride_leading', big[:, :8], None),
                           ('collapse_to_2d', big, None)])


@pytest.mark.parametrize('n', [0, probe.MAX_BATCH + 1])
def test_remap_batch_refuses_an_empty_or_oversized_batch(n):
    items = (_items() * 2)[:n]
    with pytest.raises(ValueError, match=f'1 to {probe.MAX_BATCH} items'):
        probe.remap_batch(items)


def test_a_failed_batch_fails_every_layout_case_and_the_products_run(
        monkeypatch):
    def broken(items):
        raise RuntimeError('bz_probe_remap_batch failed: CUDA error 1')
    monkeypatch.setattr(probe, 'remap_batch', broken)
    results = capability_probe.run_probe(torch.device('cpu'))
    layout = {name for name, *_ in capability_probe.layout_cases()}
    assert len(results) == 23 and list(results)[11] == 'collapsed_dot'
    assert {results[n] for n in layout} == {'FAIL'}
    assert {s for n, s in results.items() if n not in layout} == {'PASS'}


def test_the_probe_sends_its_layout_cases_as_one_batch(monkeypatch):
    batches = []
    real = probe.remap_batch

    def spy(items):
        batches.append([case for case, _x, _w in items])
        return real(items)
    monkeypatch.setattr(probe, 'remap_batch', spy)
    results = capability_probe.run_probe(torch.device('cpu'))
    assert set(results.values()) == {'PASS'}
    assert batches == [list(probe.CASES)]
