"""The port's int8 probe (``buzzdetect_torch/tools/int8_probe.py``) against
the JAX package's ``tools/int8_tpu_probe.py`` on the CPU.

The JAX tool's quantization, its int8 embed and its calibration are nested
in its ``main()`` and cannot be imported, so this file writes them out from
``tools/int8_tpu_probe.py:59-71`` (weights), ``:73-103`` (``embed_q8``) and
``:105-122`` (calibration), unchanged but for the names.

Tolerances, and why:

* the int8 weights and scales: equal (the same numpy formula);
* ``torch._int_mm`` against JAX's int8 ``dot_general``: equal (integer
  products summed in int32, no rounding);
* the static activation scales: rtol 1e-5 (one f32 forward pass each, the
  sums in another order);
* ``embed_q8``: both round every activation to bf16 and quantize it to
  int8. A bf16 conv output one ulp (2^-8 relative) apart moves one
  quantized input by a step, which moves a pointwise output by one
  s_a s_w |w_q| term and can flip the next rounding, so differences grow
  layer by layer, and static scales calibrated at rtol 1e-5 move the
  quantization edges. Held within 2e-2 of the largest |embedding|, about
  half the int8 embed's own distance from f32 (0.03-0.04 of it here);
  measured 7.6e-8 (dynamic) and 5.8e-3 (static) of it.

Each case prints its max |port - reference|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buzzdetect_tpu import config as jcfg
from buzzdetect_tpu.models import yamnet as jyam
from buzzdetect_torch.tools import int8_probe

BUNDLE = os.path.join(jcfg.DIR_REPO, 'models', 'model_general_v3',
                      'model.npz')
EMBED_RTOL = 2e-2


@pytest.fixture(scope='module')
def params():
    with np.load(BUNDLE) as z:
        raw = {k[len('yamnet_raw/'):]: z[k] for k in z.files
               if k.startswith('yamnet_raw/')}
    return jyam.fold_batchnorm(raw)


def _jax_quantize(params):
    """``tools/int8_tpu_probe.py:59-71``."""
    qparams = {}
    for key, kind, stride, shape in jyam._conv_shapes():
        kernel = params[f'{key}/kernel']
        if key.endswith('/pointwise_conv'):
            w = kernel.reshape(kernel.shape[2], kernel.shape[3])  # (Cin, Cout)
            s_w = np.max(np.abs(w), axis=0) / 127.0               # per out ch
            s_w = np.where(s_w == 0, 1.0, s_w)
            qparams[f'{key}/qkernel'] = np.clip(
                np.round(w / s_w), -127, 127).astype(np.int8)
            qparams[f'{key}/wscale'] = s_w.astype(np.float32)
        else:
            qparams[f'{key}/kernel'] = kernel
        qparams[f'{key}/bias'] = params[f'{key}/bias']
    return qparams


def _jax_embed_q8(qp, patches, act_scales=None):
    """``tools/int8_tpu_probe.py:73-103``."""
    x = patches.astype(jnp.bfloat16)
    if x.ndim == 3:
        x = x[..., None]
    for key, kind, stride, _shape in jyam._conv_shapes():
        bias = qp[f'{key}/bias'].astype(jnp.float32)
        if key.endswith('/pointwise_conv'):
            b, h, w, cin = x.shape
            if act_scales is None:
                amax = jnp.max(jnp.abs(x)).astype(jnp.float32)
                s_a = jnp.maximum(amax, 1e-12) / 127.0
            else:
                s_a = act_scales[key]
            qx = jnp.clip(jnp.round(x.astype(jnp.float32) / s_a),
                          -127, 127).astype(jnp.int8)
            y = jax.lax.dot_general(
                qx.reshape(b * h * w, cin), qp[f'{key}/qkernel'],
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
            y = (y.astype(jnp.float32)
                 * (s_a * qp[f'{key}/wscale'])).reshape(b, h, w, -1)
        else:
            kernel = qp[f'{key}/kernel'].astype(jnp.bfloat16)
            y = jyam._conv2d(x, kernel, stride,
                             depthwise=(kind == 'depthwise'))
        x = jax.nn.relu(y.astype(jnp.float32) + bias).astype(jnp.bfloat16)
    return jnp.mean(x.astype(jnp.float32), axis=(1, 2))


def _jax_calibrate(params, patches):
    """``tools/int8_tpu_probe.py:105-122``, returned as floats."""
    x = patches.astype(jnp.float32)
    if x.ndim == 3:
        x = x[..., None]
    scales = {}
    for key, kind, stride, _shape in jyam._conv_shapes():
        if key.endswith('/pointwise_conv'):
            scales[key] = float(jnp.max(jnp.abs(x)) / 127.0)
        y = jyam._conv2d(x, jnp.asarray(params[f'{key}/kernel']),
                         stride, depthwise=(kind == 'depthwise'))
        x = jax.nn.relu(y + params[f'{key}/bias'])
    return scales


def _patches(n, seed):
    """Log-mel-like patches, roughly [-4, +2], as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 96, 64)) * 1.5 - 1.0).astype(np.float32)


def test_quantized_weights_match_jax_formula(params):
    got = int8_probe.quantize_pointwise(params)
    want = _jax_quantize(params)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert np.array_equal(got[k], v), k
    n = sum(k.endswith('/qkernel') for k in got)
    assert n == 13
    print(f'{n} int8 kernels and scales equal; max |port - reference| = 0')


@pytest.mark.parametrize('layer', [2, 8, 14])
def test_int_mm_matches_jax_int8_dot(params, layer):
    """``torch._int_mm`` on one pointwise layer's int8 kernel (in the
    column-major layout ``to_device`` gives it) and random int8 rows of its
    input width, at 3 patches' rows, against JAX's int8 ``dot_general``."""
    key = f'layer{layer}/pointwise_conv'
    q = int8_probe.quantize_pointwise(params)[f'{key}/qkernel']
    rows = {2: 48 * 32, 8: 6 * 4, 14: 3 * 2}[layer] * 3
    a = np.random.default_rng(layer).integers(-127, 128, (rows, q.shape[0]),
                                              dtype=np.int8)
    kernel = int8_probe.to_device({f'{key}/qkernel': q}, 'cpu')[
        f'{key}/qkernel']
    assert kernel.stride() == (1, q.shape[0])
    got = torch._int_mm(torch.from_numpy(a), kernel).numpy()
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(q), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    print(f'{key}: ({rows}, {q.shape[0]}) x {q.shape}; max |port - '
          f'reference| = 0')


@pytest.mark.parametrize('static', [False, True], ids=['dynamic', 'static'])
def test_embed_q8_matches_jax(params, static):
    """The int8 embed with dynamic and with static (calibrated on another
    batch) activation scales, against the JAX tool's, on 4 patches."""
    pats = _patches(4, 0)
    q_np = int8_probe.quantize_pointwise(params)
    q_t = int8_probe.to_device(q_np, 'cpu')
    scales = j_scales = None
    if static:
        calib = _patches(4, 1)
        scales = int8_probe.calibrate_act_scales(params,
                                                 torch.from_numpy(calib))
        j_scales = _jax_calibrate(params, jnp.asarray(calib))
        for k, v in j_scales.items():
            assert scales[k] == pytest.approx(v, rel=1e-5), k
    with torch.inference_mode():
        got = int8_probe.embed_q8(q_t, torch.from_numpy(pats),
                                  scales).numpy()
    want = np.asarray(_jax_embed_q8(
        {k: jnp.asarray(v) for k, v in q_np.items()}, jnp.asarray(pats),
        j_scales))
    assert got.shape == want.shape == (4, 1024)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= EMBED_RTOL * scale
    print(f'max |port - reference| = {err} ({err / scale:.3g} of the '
          f'largest |embedding|)')


def test_probe_refuses_too_few_rows():
    """Two patches give the last layers 12 rows, too few for ``torch.
    _int_mm`` on CUDA: refused, not run through another product."""
    with pytest.raises(ValueError, match='--patches >= 3'):
        int8_probe.check_rows(2)
    int8_probe.check_rows(3)
    with pytest.raises(ValueError, match='at least 17'):
        int8_probe.main(['--device', 'cpu', '--patches', '2'])
    print('max |port - reference| = n/a (refusal)')


def test_probe_runs_on_the_cpu():
    """``main`` on the CPU at the smallest batch: the four rows, each with
    its deviation from f32 (0 for f32 itself), host time and sheet bound;
    an int8 row's bound is below the bf16 row's, which is below f32's."""
    lines = []
    out = int8_probe.run(3, 1, 'cpu', log=lines.append)
    rows = ('f32', 'bf16', 'int8-dynamic', 'int8-static')
    assert all(name in out for name in rows)
    assert out['f32']['dev'] == 0.0
    for name in rows[1:]:
        assert 0.0 < out[name]['dev'] <= 0.1 * out['scale'], name
    assert out['int8-dynamic']['bound_ms'] < out['bf16']['bound_ms'] \
        < out['f32']['bound_ms']
    assert not any('device_ms' in out[name] for name in rows)
    assert any('host clock' in line for line in lines)
    print(f'deviations from f32: '
          f'{[round(out[n]["dev"], 5) for n in rows]}; max |port - '
          f'reference| = n/a (a run)')
