"""The port's separable-conv stack (ops/sepconv.py) against the Pallas kernels.

The plain versions run here, on the CPU; the JAX side runs its Pallas
kernels in interpret mode, as tests/test_pallas_conv.py does. B = 5 is
ragged against every block size of both implementations. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.

The tests marked ``card`` run the tensor-core tiles on a CUDA card and skip
without one (``tests/conftest.py`` hides it from the tier-1 run). They
import neither JAX nor the JAX package, which this file imports only
inside the tests that compare with it, so on the card they run with

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_sepconv.py
"""

import os

import numpy as np
import pytest
import torch

from buzzdetect_torch.models import yamnet as tyam
from buzzdetect_torch.models.weights import params_from_numpy
from buzzdetect_torch.ops import sepconv
from buzzdetect_torch.ops.common import count_launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# As tests/test_pallas_conv.py: both sides are exact f32 but sum the
# depthwise taps and the pointwise products (K up to 1024) in different
# orders, so activations of O(1) differ at ~1e-6; 2e-4 absolute plus 1e-5
# relative leaves room for the stack's 7 layers of accumulation.
ATOL, RTOL = 2e-4, 1e-5
B = 5


@pytest.fixture(scope='module')
def folded():
    from buzzdetect_tpu.models import yamnet as jyam
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
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from buzzdetect_tpu.models import yamnet as jyam
    from buzzdetect_tpu.ops import pallas_conv as jpc
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
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from buzzdetect_tpu.ops import pallas_conv as jpc
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
    zero = dict.fromkeys(sepconv.LAUNCH_KEYS, 0)
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


# The exact-f32 route's launch geometry (ops/sepconv.ffma_geometry, the
# mirror of csrc/sepconv.cu's rule; chip_smoke.py holds the library's own
# choice to it on the card). Three layer ranges of the wrappers: the main
# path's fused_front and fused_tail, and fused_tail(4, 8), a range of the
# JAX kernel's signature that no embed route takes.
ROUTES = [(2, 8), (8, None), (4, 8)]
# the wide tile's grid at B = 209 (one 200 s chunk), as csrc/sepconv.cu's
# note lists it (TM = 5 on every layer): the small-batch tiles leave it as
# it is
WIDE_BLOCKS_209 = {2: 2007, 3: 1004, 4: 1004, 5: 502, 6: 502, 7: 252, 8: 252,
                   9: 252, 10: 252, 11: 252, 12: 252, 13: 128, 14: 128}


@pytest.mark.parametrize('start_layer,stop_layer', ROUTES)
def test_ffma_geometry_keeps_the_wide_grid_at_209(start_layer, stop_layer):
    for s in sepconv.tail_specs(start_layer, stop_layer):
        g = sepconv.ffma_geometry(s, 209)
        assert (g.kernel, g.bn, g.blocks) == (
            'wide', min(s.c_out, 256), WIDE_BLOCKS_209[s.index]), s


@pytest.mark.parametrize('batch', range(1, 9))
@pytest.mark.parametrize('start_layer,stop_layer', ROUTES)
def test_ffma_geometry_fills_the_card_at_small_batches(start_layer,
                                                       stop_layer, batch):
    """At B = 1-8 the wide tile gives fewer blocks than the card has SMs on
    every layer whose C comes in chunks of 64, and each such layer takes a
    narrow tile, which launches more; every tail layer 8-14 at least 64
    (the wide tile: 2-4). Layer 2 (C = 32) keeps the wide tile. Each tile
    covers the batch, divides F and fits a block's shared memory."""
    sms, _, block_smem = sepconv.H100_CARD
    for s in sepconv.tail_specs(start_layer, stop_layer):
        m = batch * s.h_out * s.w_out
        g = sepconv.ffma_geometry(s, batch)
        wide = sepconv._wide_geometry(s, m, *sepconv.H100_CARD[:2])
        assert (g.grid[0] - 1) * g.bm < m <= g.grid[0] * g.bm, (s, g)
        assert g.grid[1] * g.bn == s.c_out and g.ring in (2, 3), (s, g)
        assert g.smem <= block_smem, (s, g)
        if s.c_in % 64:
            assert g == wide, (s, g)
            continue
        assert wide.blocks < sms, (s, wide)
        assert g.kernel == 'narrow' and g.blocks > wide.blocks, (s, g, wide)
        assert g.bm == 256 // g.bn * g.tm, (s, g)
        if s.index >= 8:
            assert g.blocks >= 64, (s, g)


# The wide tile's shared memory: two A tiles of BM rows of _ALD floats
# (sep_layer_kernel computes chunk k + 1's depthwise into one while it
# multiplies chunk k from the other) and `ring` stages, each a chunk's
# (16, BN) weights and the next chunk's 9 taps, bias and input window.
WIDE_BATCHES = list(range(1, 9)) + [16, 64, 209]


@pytest.mark.parametrize('batch', WIDE_BATCHES)
def test_wide_tile_leaves_room_for_a_second_block(batch):
    """At every B and on every layer 2-14 the wide tile's TM is one whose
    block leaves room for a second on an H100 SM (the kernel's
    __launch_bounds__(256, 2)), with a ring of 3 stages where 3 still do
    and 2 otherwise; its bytes are the two A tiles plus the ring's
    stages."""
    sms, sm_smem, block_smem = sepconv.H100_CARD
    for s in sepconv.tail_specs(2, None):
        m = batch * s.h_out * s.w_out
        g = sepconv._wide_geometry(s, m, sms, sm_smem)
        stage = 16 * g.bn + (10 + sepconv._ffma_window_rows(g.bm, s)) * 16
        assert g.smem == 4 * (2 * g.bm * 20 + g.ring * stage), (s, g)
        assert 2 * (g.smem + 1024) <= sm_smem, (s, g)
        assert g.smem <= block_smem, (s, g)
        three = 4 * (2 * g.bm * 20 + 3 * stage)
        assert g.ring == (3 if 2 * (three + 1024) <= sm_smem else 2), (s, g)
        assert g.bm == g.tm * 256 // (g.bn // 8), (s, g)


@pytest.mark.parametrize('batch', WIDE_BATCHES)
def test_wide_tile_takes_the_cheaper_tm(batch):
    """Of TM = 5 and 4, the wide tile takes the one that gives the busiest
    SM the least work, ceil(blocks / SMs) x (BM + 48), TM = 5 on a tie; a TM
    the caller names (tools/ffma_geometries.py) keeps the same BN and ring
    rule. Two blocks fit an SM at either TM on every layer."""
    sms, sm_smem, _ = sepconv.H100_CARD
    for s in sepconv.tail_specs(2, None):
        m = batch * s.h_out * s.w_out
        g = sepconv._wide_geometry(s, m, sms, sm_smem)
        forced = {t: sepconv._wide_geometry(s, m, sms, sm_smem, tm=t)
                  for t in (5, 4)}
        assert forced[g.tm] == g, (s, g)

        def price(h):
            return -(-h.blocks // sms) * (h.bm + 48)
        other = forced[9 - g.tm]
        assert price(g) < price(other) or (price(g) == price(other)
                                           and g.tm == 5), (s, g, other)
        assert all(2 * (h.smem + 1024) <= sm_smem
                   for h in forced.values()), (s, forced)


def _wide_a_reads(bn, tm, warp, i, k):
    """The shared-memory words the 32 lanes of ``warp`` read from the wide
    tile's A tile in one load: lane l is thread (tx, ty) = ((warp % WX) * 8
    + l % 8, (warp // WX) * 4 + l // 8), and reads 4 channels from k of its
    position i * TY + ty; the tile is (position, k), rows _ALD floats
    apart."""
    tx_n = bn // 8
    ty_n, wx = 256 // tx_n, tx_n // 8
    reads = set()
    for lane in range(32):
        ty = (warp // wx) * 4 + lane // 8
        start = (i * ty_n + ty) * sepconv._ALD + k
        reads.add(tuple(range(start, start + 4)))
    return reads


@pytest.mark.parametrize('tm', (5, 4))
@pytest.mark.parametrize('bn', (64, 128, 256))
def test_wide_tile_a_reads_fall_on_distinct_bank_quads(bn, tm):
    """Each load of the A tile by one warp is four float4s, 4 channels of
    four neighbouring positions (the lanes along N read the same words),
    whose 16 words fall on distinct banks of the 32: one wavefront, no bank
    conflict."""
    for warp in range(8):
        for i in range(tm):
            for k in range(0, 16, 4):
                reads = _wide_a_reads(bn, tm, warp, i, k)
                assert len(reads) == 4, (warp, i, k, reads)
                banks = [w % 32 for r in reads for w in r]
                assert len(set(banks)) == 16, (warp, i, k, reads)


def test_count_launch_by_batch():
    """A launch with its batch counts on the wrapper's ``batches`` beside
    ``launches`` and ``ranges``."""
    import collections

    def wrapper():
        pass
    wrapper.launches = dict.fromkeys(sepconv.MODES, 0)
    wrapper.ranges = collections.Counter()
    wrapper.batches = collections.Counter()
    for b in (2, 2, 209):
        count_launch(wrapper, 'highest', (8, 15), b)
    count_launch(wrapper, 'bf16', (8, 15))
    assert wrapper.launches == {'highest': 3, 'bf16': 1, 'high': 0}
    assert wrapper.ranges == {(8, 15, 'highest'): 3, (8, 15, 'bf16'): 1}
    assert wrapper.batches == {(8, 15, 'highest', 2): 2,
                               (8, 15, 'highest', 209): 1}


def test_count_launch_adds_the_tile_launches():
    """``tiles`` adds each entry's layers to the wrapper's ``launches``
    beside the one launch of its mode."""
    import collections

    def wrapper():
        pass
    wrapper.launches = dict.fromkeys(sepconv.LAUNCH_KEYS, 0)
    wrapper.ranges = collections.Counter()
    wrapper.batches = collections.Counter()
    count_launch(wrapper, 'bf16', (8, 15), 1667, {'mma_wide': 7})
    count_launch(wrapper, 'bf16', (8, 15), 5, {'mma_wide': 0})
    assert wrapper.launches == {'highest': 0, 'bf16': 2, 'high': 0,
                                'mma_wide': 7}


def test_wide_tile_is_a_kernel_of_the_conv_roofline():
    """``sepconv_roofline`` counts the kernels ``csrc/sepconv.cu`` declares,
    as ``benchmark/program.kernel_names`` parses them: the wide
    tensor-core tile is one of them, beside the tile it replaces at large
    batches, and a trace's name of it matches."""
    from benchmark import program
    names = program.kernel_names('sepconv')
    assert {'sep_mma_wide_kernel', 'sep_layer_mma_kernel'} <= set(names)
    match = program.kernel_matcher('sepconv')
    assert match('void (anonymous namespace)::sep_mma_wide_kernel<128>('
                 'float const*, float*, (anonymous namespace)::Layer, int, '
                 'int)')


# --- on the card -----------------------------------------------------------------

@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the tensor-core tiles of '
                    'csrc/sepconv.cu run only there')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def bundle(card):
    """The bundle's YAMNet weights on the card, packed for bf16 and HIGH."""
    with np.load(os.path.join(ROOT, 'models', 'model_general_v3',
                              'model.npz')) as z:
        params = params_from_numpy({k: z[k] for k in z.files},
                                   card)['yamnet']
    return sepconv.pack_params(sepconv.pack_params(params, 'bf16'), 'high')


@pytest.mark.card
@pytest.mark.parametrize('batch', [1667, 209])
@pytest.mark.parametrize('layer', range(5, 15))
def test_wide_tile_matches_the_mma_tile_bit_for_bit(card, bundle, layer,
                                                    batch):
    """On each bf16 layer 5-14, at the cells' 1,667 patches and a 200 s
    chunk's 209, the wide tile at 128 and at 64 rows gives
    sep_layer_mma_kernel's outputs bit for bit, on seeded inputs: a
    patch's scores do not depend on the tile its batch drew."""
    from buzzdetect_torch.tools import mma_tiles
    lib = sepconv.load_kernels()
    s = sepconv.tail_specs(layer, layer + 1)[0]
    ops = sepconv._check(bundle, torch.zeros(1, s.h, s.w, s.c_in,
                                             device=card), (s,), 'bf16')[0]
    gen = torch.Generator(device=card).manual_seed(1000 * layer + batch)
    x = torch.relu(torch.randn((batch, s.h, s.w, s.c_in), device=card,
                               generator=gen))
    outs = {}
    for tile in mma_tiles.TILES:
        y = torch.full((batch * s.h_out * s.w_out, s.c_out), float('nan'),
                       device=card)
        assert mma_tiles.layer_at(lib, x, y, ops, s, 'bf16', tile) == tile
        outs[tile] = y
    torch.cuda.synchronize(card)
    assert not outs[0].isnan().any()
    for tile in mma_tiles.TILES[1:]:
        assert torch.equal(outs[tile], outs[0]), (tile, float(
            (outs[tile] - outs[0]).abs().max()))


@pytest.mark.card
@pytest.mark.parametrize('mode,batch,wide', [('bf16', 1667, 10),
                                             ('bf16', 5, 0),
                                             ('high', 1667, 0)])
def test_classify_counts_its_wide_tile_launches(card, bundle, mode, batch,
                                                wide):
    """A bf16 embed at 1,667 patches runs layers 5-14 on the wide tile (10
    launches counted on the wrappers' ``launches['mma_wide']``); at B = 5,
    and in HIGH at any batch, none; each wrapper counts one launch in its
    mode all the same."""
    x = torch.relu(torch.randn((batch, 48, 32, 32), device=card,
                               generator=torch.Generator(device=card)
                               .manual_seed(batch)))
    wrappers = (sepconv.fused_front, sepconv.fused_tail)
    before = [dict(w.launches) for w in wrappers]
    with torch.inference_mode():
        mid = sepconv.fused_front(bundle, x, mode=mode)
        sepconv.fused_tail(bundle, mid.reshape(batch, 6, 4, 512), mode=mode)
    torch.cuda.synchronize(card)
    added = [{k: w.launches[k] - b[k] for k in b}
             for w, b in zip(wrappers, before)]
    assert sum(a['mma_wide'] for a in added) == wide, added
    assert all(a[mode] == 1 for a in added), added
