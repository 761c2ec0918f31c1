"""The port's separable-conv stack (ops/sepconv.py) against the Pallas kernels.

The plain versions run here, on the CPU; the JAX side runs its Pallas
kernels in interpret mode, as tests/test_pallas_conv.py does. B = 5 is
ragged against every block size of both implementations. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from buzzdetect_tpu.models import yamnet as jyam
from buzzdetect_tpu.ops import pallas_conv as jpc
from buzzdetect_torch.models import yamnet as tyam
from buzzdetect_torch.models.weights import params_from_numpy
from buzzdetect_torch.ops import sepconv

# As tests/test_pallas_conv.py: both sides are exact f32 but sum the
# depthwise taps and the pointwise products (K up to 1024) in different
# orders, so activations of O(1) differ at ~1e-6; 2e-4 absolute plus 1e-5
# relative leaves room for the stack's 7 layers of accumulation.
ATOL, RTOL = 2e-4, 1e-5
B = 5


@pytest.fixture(scope='module')
def folded():
    return jyam.fold_batchnorm(jyam.init_raw_params(seed=7))


@pytest.fixture(scope='module')
def tparams(folded):
    return params_from_numpy(folded)['yamnet']


def _report(name, got, ref):
    err = float(np.abs(got - ref).max())
    print(f'{name}: max |port - pallas| = {err:.3g} '
          f'(max |ref| {np.abs(ref).max():.3g})')
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_fused_front_plain_matches_pallas(folded, tparams):
    patches = np.random.default_rng(1).standard_normal(
        (B, 96, 64, 1)).astype(np.float32)
    xp = jyam.packed_l1(folded, jnp.asarray(patches), 4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpc.fused_front(folded, xp, groups=4, block_packed=1,
                                         plain_through=8, interpret=True))[:B]
    l1 = tyam.layer1(tparams, torch.from_numpy(patches))
    assert tuple(l1.shape) == (B, 48, 32, 32)
    got = sepconv.fused_front_plain(tparams, l1).numpy()
    assert got.shape == ref.shape == (B, 24, 512)
    _report('fused_front (layers 2-7)', got, ref)


@pytest.mark.parametrize('start_layer,stop_layer,gap,shape', [
    (8, None, True, (B, 1024)),
    (4, 8, False, (B, 24, 512)),
])
def test_fused_tail_plain_matches_pallas(folded, tparams, start_layer,
                                         stop_layer, gap, shape):
    s0 = sepconv.tail_specs(start_layer, stop_layer)[0]
    x = np.random.default_rng(3).standard_normal(
        (B, s0.h, s0.w, s0.c_in)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpc.fused_tail(
            folded, jnp.asarray(x), start_layer=start_layer,
            stop_layer=stop_layer, block_patches=32 if gap else 8, gap=gap,
            interpret=True))
    got = sepconv.fused_tail_plain(tparams, torch.from_numpy(x),
                                   start_layer=start_layer,
                                   stop_layer=stop_layer, gap=gap).numpy()
    assert got.shape == ref.shape == shape
    last = (stop_layer or 15) - 1
    _report(f'fused_tail (layers {start_layer}-{last}, gap={gap})', got, ref)


def test_wrappers_on_cpu_take_the_plain_path(tparams):
    """A CPU tensor runs the plain version and never touches a counter."""
    before = (dict(sepconv.fused_front.launches),
              dict(sepconv.fused_tail.launches))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 48, 32, 32))
                         .astype(np.float32))
    np.testing.assert_array_equal(
        sepconv.fused_front(tparams, x).numpy(),
        sepconv.fused_front_plain(tparams, x).numpy())
    y = torch.from_numpy(rng.standard_normal((3, 6, 4, 512))
                         .astype(np.float32))
    np.testing.assert_array_equal(sepconv.fused_tail(tparams, y).numpy(),
                                  sepconv.fused_tail_plain(tparams, y).numpy())
    zero = dict.fromkeys(sepconv.MODES, 0)
    assert (sepconv.fused_front.launches,
            sepconv.fused_tail.launches) == before == (zero, zero)


def test_wrappers_reject_bad_inputs(tparams):
    x = torch.zeros(2, 48, 32, 32)
    with pytest.raises(ValueError, match='NHWC'):
        sepconv.fused_front(tparams, x.permute(0, 3, 1, 2))
    with pytest.raises(TypeError, match='float32'):
        sepconv.fused_front(tparams, x.double())
    with pytest.raises(ValueError, match='empty'):
        sepconv.fused_front(tparams, x[:0])
    with pytest.raises(ValueError, match='not a sep layer'):
        sepconv.fused_tail(tparams, x, start_layer=1)


@pytest.mark.parametrize('n,stride,pad', [
    (96, 2, (0, 1)), (64, 2, (0, 1)), (6, 2, (0, 1)), (4, 2, (0, 1)),
    (5, 2, (1, 1)), (48, 1, (1, 1)), (3, 1, (1, 1)),
])
def test_same_pad_is_tf_same(n, stride, pad):
    """TF-SAME: at stride 2 on even input only the bottom/right pads."""
    assert sepconv.same_pad(n, stride) == pad


@pytest.mark.parametrize('mode', sepconv.MODES)
@pytest.mark.parametrize('layer', range(2, 15))
def test_check_takes_every_sep_layer(tparams, mode, layer):
    """Every sep layer 2-14 fits the tiles of its mode's kernel in
    csrc/sepconv.cu (FFMA for 'highest', the tensor cores for 'bf16' and
    'high'), so _check hands its operands on."""
    s = sepconv.tail_specs(layer, layer + 1)[0]
    x = torch.zeros(1, s.h, s.w, s.c_in)
    (dw, dw_b, pw, pw_b), = sepconv._check(
        sepconv.pack_params(tparams, mode), x, (s,), mode)
    assert pw.dtype == (torch.float32 if mode == 'highest'
                        else torch.bfloat16)
    assert pw.shape[-2:] == (s.c_in, s.c_out)
    assert sepconv.layer_route(mode) == ('ffma' if mode == 'highest'
                                         else 'mma')


@pytest.mark.parametrize('mode,c_in,c_out', [
    ('bf16', 48, 64),      # C not in chunks of 32
    ('high', 64, 192),     # F neither 64, 128 nor a multiple of 256
    ('bf16', 256, 384),
    ('highest', 24, 64),   # C not in chunks of 16
    ('highest', 64, 96),   # F neither 64, 128 nor a multiple of 256
    ('highest', 512, 192),
    ('highest', 8, 128),
])
def test_check_refuses_shapes_the_kernels_do_not_take(monkeypatch, mode, c_in,
                                                      c_out):
    """A layer shape that the mode's kernel does not take raises in _check,
    before the wrapper picks a route: neither the launch nor the plain
    version is reached."""
    s = sepconv.SepSpec(15, 6, 4, c_in, c_out, 1)
    pw = torch.zeros(c_in, c_out)
    params = {'layer15/depthwise_conv/kernel': torch.zeros(9, c_in),
              'layer15/depthwise_conv/bias': torch.zeros(c_in),
              'layer15/pointwise_conv/kernel': pw,
              'layer15/pointwise_conv/bias': torch.zeros(c_out)}
    params[sepconv._packed_key(s, mode)] = sepconv.pack_pointwise(pw, mode)

    def reached(*args, **kwargs):
        raise AssertionError('a route was taken')
    monkeypatch.setattr(sepconv, 'tail_specs', lambda *args: (s,))
    monkeypatch.setattr(sepconv, '_launch', reached)
    monkeypatch.setattr(sepconv, 'fused_tail_plain', reached)
    with pytest.raises(ValueError, match='does not take'):
        sepconv.fused_tail(params, torch.zeros(2, 6, 4, c_in), gap=False,
                           mode=mode)


@pytest.mark.parametrize('mode', sepconv.MODES)
@pytest.mark.parametrize('start_layer,stop_layer', [(2, 8), (8, None),
                                                    (4, 8)])
def test_kernel_takes_every_layer_the_wrappers_launch(mode, start_layer,
                                                      stop_layer):
    """fused_front (layers 2-7), fused_tail (8-14) and fused_tail(4, 8)
    launch only layer shapes that their mode's kernel takes: C in chunks of
    16 (FFMA) or 32 (tensor cores), F = 64, 128 or a multiple of 256."""
    specs = sepconv.tail_specs(start_layer, stop_layer)
    assert [s.index for s in specs] == list(range(start_layer,
                                                  stop_layer or 15))
    for s in specs:
        assert sepconv._kernel_takes(s, mode), s


def test_stride2_layer_reads_odd_centres(tparams):
    """A depthwise tap that only reads the centre (kernel = one-hot centre,
    pointwise = identity, zero bias) must sample input (2i+1, 2j+1) at a
    stride-2 layer, as TF-SAME requires; a symmetric pad would give 2i."""
    s = sepconv.tail_specs(13, 14)[0]
    p = dict(tparams)
    dw = torch.zeros(9, s.c_in)
    dw[4] = 1.0
    p[f'{s.name}/depthwise_conv/kernel'] = dw
    p[f'{s.name}/depthwise_conv/bias'] = torch.zeros(s.c_in)
    pw = torch.zeros(s.c_in, s.c_out)
    pw[torch.arange(s.c_in), torch.arange(s.c_in)] = 1.0
    p[f'{s.name}/pointwise_conv/kernel'] = pw
    p[f'{s.name}/pointwise_conv/bias'] = torch.zeros(s.c_out)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (2, s.h, s.w, s.c_in)).astype(np.float32))
    y = sepconv.fused_tail_plain(p, x, start_layer=13, stop_layer=14,
                                 gap=False).reshape(2, s.h_out, s.w_out, -1)
    torch.testing.assert_close(y[..., :s.c_in], x[:, 1::2, 1::2, :])
