"""YAMNet's layer 1 (``buzzdetect_torch/ops/layer1.py``, the wrapper of
``csrc/layer1.cu``) on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it there to
``replay`` bit for bit and to the plain version). Here: ``replay``, the
kernel's own tap order and roundings in PyTorch, against ``yamnet.layer1``
(the plain version on a CPU tensor); the modes' mapping to the kernel's
two instantiations; the operator's fake implementation (the shapes a trace
on the card sees); the launcher's refusals; the blocks a launch gives the
card; and that the library stays out of ``sepconv_roofline``'s kernels.
"""

import os

import numpy as np
import pytest
import torch

from buzzdetect_torch.models import yamnet
from buzzdetect_torch.models.weights import params_from_numpy
from buzzdetect_torch.ops import frontend, library
from buzzdetect_torch.ops import layer1 as l1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -7        # a bf16 ulp at [1, 2): 7 stored bits
# output rows and columns that read the TF-SAME padding (input row 96 and
# column 64), checked on their own beside the whole output
REGIONS = {'all': (slice(None), slice(None)),
           'bottom row': (slice(47, 48), slice(None)),
           'right column': (slice(None), slice(31, 32))}


@pytest.fixture(scope='module')
def params():
    arrays = dict(np.load(os.path.join(REPO, 'models', 'model_general_v3',
                                       'model.npz')))
    return params_from_numpy(arrays, 'cpu')['yamnet']


def _patches(batch, seed=0):
    """``batch`` log-mel patches of seeded noise, as the frontend frames
    them."""
    cfg = frontend.FrontendConfig()
    n = (frontend.min_waveform_samples(cfg)
         + (batch - 1) * cfg.patch_hop_samples)
    wav = np.random.default_rng(seed).standard_normal(n) * 0.1
    x = frontend.log_mel_patches(torch.from_numpy(wav.astype(np.float32)),
                                 cfg)
    assert tuple(x.shape) == (batch, *l1.IN_SHAPE) and x.is_contiguous()
    return x


def _magnitudes(params, x):
    """Per output value, the sum of its nine products' and its bias's
    magnitudes: the scale of a summation-order difference."""
    k = params['layer1/conv/kernel'].abs()
    return l1.replay(k, params['layer1/conv/bias'].abs(), x.abs(), 'highest')


def _bf16_ulp(v):
    """The bf16 ulp at each |v| (v already a bf16 value; 0 for 0)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(1e-30)))
    return torch.where(v == 0, torch.zeros_like(v), torch.exp2(e - 7))


@pytest.mark.parametrize('region', REGIONS)
@pytest.mark.parametrize('batch', [1, 3])
def test_replay_matches_layer1_in_f32(params, batch, region):
    """Exact f32: the kernel's order of the nine sums against the plain
    convolution's, within 1e-6 of the terms' magnitude (nine roundings of
    2^-24 each bound the difference by ~5.4e-7)."""
    x = _patches(batch)
    got = l1.replay(params['layer1/conv/kernel'],
                    params['layer1/conv/bias'], x, 'highest')
    ref = yamnet.layer1(params, x, 'highest')
    assert got.shape == ref.shape == (batch, *l1.OUT_SHAPE)
    assert got.dtype == torch.float32
    rows, cols = REGIONS[region]
    gap = (got - ref)[:, rows, cols].abs()
    scale = _magnitudes(params, x)[:, rows, cols]
    assert bool((gap <= 1e-6 * scale).all()), float((gap / scale).max())
    # the region holds live values, not only ReLU's zeros
    assert float(ref[:, rows, cols].max()) > 0.1


@pytest.mark.parametrize('region', REGIONS)
@pytest.mark.parametrize('batch', [1, 3])
def test_replay_matches_layer1_in_bf16(params, batch, region):
    """bf16: the products are exact, so only the sum order differs, and a
    value may round to the other bf16 neighbour: within one bf16 ulp of
    the larger of the two values."""
    x = _patches(batch, seed=1)
    got = l1.replay(params['layer1/conv/kernel'],
                    params['layer1/conv/bias'], x, 'bf16')
    ref = yamnet.layer1(params, x, 'bf16')
    assert torch.equal(got, got.to(torch.bfloat16).to(torch.float32))
    rows, cols = REGIONS[region]
    a, b = got[:, rows, cols], ref[:, rows, cols]
    ulp = _bf16_ulp(torch.maximum(a.abs(), b.abs()))
    assert bool(((a - b).abs() <= ulp).all())
    assert float(b.max()) > 0.1


def test_bf16_ulp_is_two_to_the_minus_seven_at_one():
    v = torch.tensor([1.0, 1.5, 2.0, 0.25, 0.0])
    assert _bf16_ulp(v).tolist() == [BF16_ULP, BF16_ULP, 2 * BF16_ULP,
                                     BF16_ULP / 4, 0.0]


@pytest.mark.parametrize('ho,wo', [(0, 0), (47, 31), (47, 0), (0, 31)])
def test_replay_pads_bottom_and_right_only(params, ho, wo):
    """Output (ho, wo) reads input rows 2ho..2ho+2 and columns 2wo..2wo+2,
    row 96 and column 64 zero (TF-SAME at stride 2): each corner against
    its nine taps summed in float64 from the patch itself."""
    x = _patches(1)
    k, b = params['layer1/conv/kernel'], params['layer1/conv/bias']
    y = l1.replay(k, b, x, 'highest')[0, ho, wo]
    want = b.double().clone()
    for ky in range(3):
        for kx in range(3):
            r, c = 2 * ho + ky, 2 * wo + kx
            if r < 96 and c < 64:
                want += float(x[0, r, c]) * k[:, 0, ky, kx].double()
    want = torch.relu(want)
    assert torch.allclose(y.double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('mode,code', [('highest', 0), ('high', 0),
                                       ('bf16', 1)])
def test_modes_map_to_the_kernels_two_instantiations(params, mode, code):
    """'high' takes the exact-f32 instantiation, as 'highest' does."""
    assert l1._MODE_CODE[mode] == code
    x = _patches(1)
    k, b = params['layer1/conv/kernel'], params['layer1/conv/bias']
    same = 'bf16' if code else 'highest'
    assert torch.equal(l1.replay(k, b, x, mode), l1.replay(k, b, x, same))
    assert torch.equal(yamnet.layer1(params, x, mode),
                       yamnet.layer1(params, x, same))


def test_the_modes_are_the_conv_kernels_modes():
    from buzzdetect_torch.ops import sepconv
    assert set(l1._MODE_CODE) == set(sepconv.MODES)


def test_layer1_takes_a_trailing_channel_axis(params):
    x = _patches(2)
    assert torch.equal(yamnet.layer1(params, x[..., None], 'highest'),
                       yamnet.layer1(params, x, 'highest'))


def test_an_unknown_mode_raises(params):
    with pytest.raises(ValueError, match='mode'):
        yamnet.layer1(params, _patches(1), 'fp8')


def test_the_cpu_route_launches_nothing(params):
    before = l1.layer1.launches
    yamnet.layer1(params, _patches(1), 'bf16')
    assert l1.layer1.launches == before


@pytest.mark.parametrize('mode', ['highest', 'bf16'])
@pytest.mark.parametrize('batch', [1, 5])
def test_fake_layer1_is_the_plain_shape(params, batch, mode):
    """What a trace on the card sees: (B, 48, 32, 32) f32 on the card,
    through ``yamnet.layer1``'s route to the operator."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        p = {k: torch.empty(v.shape, device='cuda')
             for k, v in params.items() if k.startswith('layer1/')}
        x = torch.empty(batch, 96, 64, device='cuda')
        direct = library.layer1(x, p['layer1/conv/kernel'],
                                p['layer1/conv/bias'], mode)
        routed = yamnet.layer1(p, x, mode)
        shapes = [(tuple(t.shape), t.dtype, t.device.type)
                  for t in (direct, routed)]
    assert shapes == [((batch, 48, 32, 32), torch.float32, 'cuda')] * 2


def _operands(batch=2, dtype=torch.float32):
    return (torch.zeros(32, 1, 3, 3), torch.zeros(32),
            torch.zeros(batch, 96, 64, dtype=dtype))


@pytest.mark.parametrize('case', [
    'wrong shape', 'trailing axis', 'empty batch', 'float64', 'bfloat16',
    'not contiguous', 'kernel shape', 'bias dtype', 'kernel not contiguous'])
def test_the_launcher_refuses_what_the_kernel_does_not_take(case):
    """Each refusal comes from the check, before any build (there is no
    nvcc here): no input the kernel does not take reaches it."""
    kernel, bias, x = _operands()
    if case == 'wrong shape':
        x = torch.zeros(2, 96, 63)
    elif case == 'trailing axis':
        x = x[..., None]
    elif case == 'empty batch':
        x = x[:0]
    elif case == 'float64':
        x = x.double()
    elif case == 'bfloat16':
        x = x.bfloat16()
    elif case == 'not contiguous':
        x = torch.zeros(2, 64, 96).transpose(1, 2)
    elif case == 'kernel shape':
        kernel = torch.zeros(32, 9)
    elif case == 'bias dtype':
        bias = bias.double()
    else:
        kernel = torch.zeros(3, 3, 1, 32).permute(3, 2, 0, 1)
    with pytest.raises(ValueError):
        l1._launch(kernel, bias, x, 'highest')


def test_the_launcher_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match='mode'):
        l1._launch(*_operands(), 'fp8')


@pytest.mark.parametrize('batch,rows', [(1, 1), (5, 1), (22, 1), (44, 2),
                                        (88, 4), (176, 8), (209, 8),
                                        (1667, 8)])
def test_band_rows_fill_the_card(batch, rows):
    """At 132 SMs: the largest band that still gives 8 blocks an SM, and a
    small batch one block an output row (B = 5: 240 blocks)."""
    assert l1.band_rows(batch, 132) == rows


def test_every_band_gives_as_many_blocks_as_the_batch_allows():
    for sms in (1, 78, 132):
        for batch in range(1, 2000, 7):
            rows = l1.band_rows(batch, sms)
            blocks = batch * (48 // rows)
            assert 48 % rows == 0 and rows in l1.BAND_ROWS
            assert blocks >= min(48 * batch, l1.BLOCKS_PER_SM * sms)


def test_layer1_library_stays_out_of_the_conv_stack_kernels():
    """``sepconv_roofline`` counts the kernels of ``csrc/sepconv.cu``; the
    layer-1 kernel is a library of its own."""
    from benchmark import program
    assert program.kernel_names('layer1') == ['layer1_kernel']
    assert 'layer1_kernel' not in program.kernel_names('sepconv')
    match = program.kernel_matcher('sepconv')
    assert not match('void (anonymous namespace)::layer1_kernel<true>'
                     '(float4 const*, float const*, float const*, float4*, '
                     'int)')
