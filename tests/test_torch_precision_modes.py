"""The bf16 and emulated-HIGH modes of the port's conv kernels against the
JAX package's Pallas kernels (interpret mode), from the packers up to
whole-classifier scores on the real model_general_v3 bundle.

The plain versions run here, on the CPU; the CUDA kernels are held against
them on the card by chip_smoke.py. Inputs are numpy with fixed seeds; B = 5
is ragged against every block size of both implementations.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from buzzdetect_tpu import config as jcfg
from buzzdetect_tpu.models import yamnet as jyam
from buzzdetect_tpu.models.classifier import ChunkClassifier as JaxClassifier
from buzzdetect_tpu.ops import pallas_conv as jpc
from buzzdetect_torch.models import yamnet as tyam
from buzzdetect_torch.models.classifier import ChunkClassifier
from buzzdetect_torch.models.weights import params_from_numpy
from buzzdetect_torch.ops import sepconv

B = 5
BUNDLE = os.path.join(jcfg.DIR_REPO, 'models', 'model_general_v3',
                      'model.npz')
HIGH = jax.lax.Precision.HIGH
# HIGH: both sides are the same bf16 hi/lo products, exact in f32, summed
# in another order (exact-f32 arithmetic, as the 'highest' tests); the split
# itself gave 2.5e-6 in interpret mode (buzzdetect_tpu/models/yamnet.py).
ATOL_HIGH, RTOL_HIGH = 2e-4, 1e-5
# bf16: the products are exact on both sides, but a one-ulp f32 difference
# in a sum before the next layer rounds its input to bf16 can flip that
# input by one bf16 ulp (2^-8 relative). The O(1) layer-7 activations then
# differ by about one such ulp of the largest value: measured 5.4e-3 on the
# front (max 2.5) and 7.8e-4 on the tail at B = 5 (test output), so the
# bound is 4 ulps of the largest value plus 2 ulps relative. Scores above
# 5e-3 would be a fault to find.
ULP_BF16 = 2.0 ** -8
BF16_SCORE_FAULT = 5e-3
# Scores: the BASELINE.md parity budget for exact-f32 arithmetic.
ATOL_SCORE = 1e-3


@pytest.fixture(scope='module')
def folded():
    return jyam.fold_batchnorm(jyam.init_raw_params(seed=7))


@pytest.fixture(scope='module')
def tparams(folded):
    return params_from_numpy(folded)['yamnet']


def _check_bf16(name, got, ref):
    err = float(np.abs(got - ref).max())
    bound = 4 * ULP_BF16 * float(np.abs(ref).max())
    print(f'{name}: max |port - pallas| = {err:.3g} (bound {bound:.3g} + '
          f'2 ulp relative)')
    np.testing.assert_allclose(got, ref, atol=bound, rtol=2 * ULP_BF16)


def _check_high(name, got, ref):
    err = float(np.abs(got - ref).max())
    print(f'{name}: max |port - pallas| = {err:.3g}')
    np.testing.assert_allclose(got, ref, atol=ATOL_HIGH, rtol=RTOL_HIGH)


MODES = {  # mode -> (JAX compute_dtype, JAX precision, checker)
    'bf16': (jnp.bfloat16, None, _check_bf16),
    'high': (jnp.float32, HIGH, _check_high),
}


@pytest.mark.parametrize('mode', ['bf16', 'high'])
def test_fused_front_plain_matches_pallas(folded, tparams, mode):
    dtype, precision, check = MODES[mode]
    patches = np.random.default_rng(1).standard_normal(
        (B, 96, 64, 1)).astype(np.float32)
    # the JAX package's own layer 1 for the mode (yamnet.embed: patches and
    # kernel in the compute dtype, precision from conv_mxu_precision)
    jprec = jyam.conv_mxu_precision(dtype, 'high' if precision else
                                    'highest')
    xp = jyam.packed_l1(folded, jnp.asarray(patches).astype(dtype), 4,
                        dtype, precision=jprec)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpc.fused_front(
            folded, xp, groups=4, block_packed=1, plain_through=8,
            compute_dtype=dtype, precision=precision, interpret=True))[:B]
    p = sepconv.pack_params(tparams, mode)
    l1 = tyam.layer1(p, torch.from_numpy(patches), mode)
    got = sepconv.fused_front_plain(p, l1, mode=mode).numpy()
    assert got.shape == ref.shape == (B, 24, 512)
    check(f'fused_front[{mode}] (layers 2-7)', got, ref)


@pytest.mark.parametrize('mode', ['bf16', 'high'])
@pytest.mark.parametrize('start_layer,stop_layer,gap', [
    (8, None, True), (4, 8, False)])
def test_fused_tail_plain_matches_pallas(folded, tparams, mode, start_layer,
                                         stop_layer, gap):
    dtype, precision, check = MODES[mode]
    s0 = sepconv.tail_specs(start_layer, stop_layer)[0]
    x = np.random.default_rng(3).standard_normal(
        (B, s0.h, s0.w, s0.c_in)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpc.fused_tail(
            folded, jnp.asarray(x), start_layer=start_layer,
            stop_layer=stop_layer, block_patches=32 if gap else 8, gap=gap,
            compute_dtype=dtype, precision=precision, interpret=True))
    got = sepconv.fused_tail_plain(
        sepconv.pack_params(tparams, mode), torch.from_numpy(x),
        start_layer=start_layer, stop_layer=stop_layer, gap=gap,
        mode=mode).numpy()
    assert got.shape == ref.shape
    last = (stop_layer or 15) - 1
    check(f'fused_tail[{mode}] (layers {start_layer}-{last}, gap={gap})',
          got, ref)


def test_layer1_bf16_matches_packed_l1(folded, tparams):
    """Layer 1 under bf16 compute: bf16 patches and kernel, f32 sums, bias
    and ReLU, output rounded to bf16 — the JAX package's packed_l1."""
    patches = np.random.default_rng(4).standard_normal(
        (8, 96, 64, 1)).astype(np.float32)
    xp = np.asarray(jyam.packed_l1(
        folded, jnp.asarray(patches).astype(jnp.bfloat16), 4, jnp.bfloat16,
        precision=jax.lax.Precision.DEFAULT).astype(jnp.float32))
    # packed (B/4, 48, 32, 4*32): lane group g is patch 4*i + g
    ref = xp.reshape(2, 48, 32, 4, 32).transpose(0, 3, 1, 2, 4).reshape(
        8, 48, 32, 32)
    got = tyam.layer1(tparams, torch.from_numpy(patches), 'bf16').numpy()
    _check_bf16('layer1[bf16]', got, ref)
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))


@pytest.mark.parametrize('mode', ['bf16', 'high'])
def test_packers_match_jax(folded, tparams, mode):
    """The pointwise operands are bit-identical to pallas_conv._pack_pw's
    (bf16 rounding, and the _split_hi_lo halves)."""
    precision = HIGH if mode == 'high' else jax.lax.Precision.DEFAULT
    dtype = jnp.float32 if mode == 'high' else jnp.bfloat16
    packed = sepconv.pack_params(tparams, mode)
    for s in sepconv.tail_specs(2, None):
        pw = folded[f'{s.name}/pointwise_conv/kernel'].reshape(s.c_in,
                                                               s.c_out)
        ref = np.asarray(jpc._pack_pw(jnp.asarray(pw), dtype, precision))
        got = packed[f'{s.name}/pointwise_conv/kernel[{mode}]']
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(), ref.astype(np.float32))
    # 'highest' packs nothing: the f32 kernel is its own operand
    assert sepconv.pack_params(tparams, 'highest').keys() == tparams.keys()


@pytest.mark.parametrize('dtype,precision,mode', [
    (torch.float32, None, 'highest'), ('float32', 'highest', 'highest'),
    (None, 'high', 'high'), (torch.bfloat16, None, 'bf16'),
    ('bfloat16', 'default', 'bf16'), (torch.bfloat16, 'highest', 'bf16'),
    (torch.bfloat16, 'high', 'high'),
])
def test_resolve_mode_follows_resolve_precision(dtype, precision, mode):
    """None -> HIGHEST for f32 operands, DEFAULT (one bf16 product) for
    bf16; an explicit HIGH is the hi/lo split (pallas_conv._pw_dot)."""
    assert sepconv.resolve_mode(dtype, precision) == mode
    jdtype = jnp.bfloat16 if 'bfloat16' in str(dtype) else jnp.float32
    jprec = {None: None, 'highest': jax.lax.Precision.HIGHEST,
             'high': HIGH, 'default': jax.lax.Precision.DEFAULT}[precision]
    resolved = jpc._resolve_precision(jprec, jdtype)
    split = resolved == HIGH
    assert (mode == 'high') == split
    if not split:
        assert (mode == 'bf16') == (jdtype == jnp.bfloat16)


def test_resolve_mode_refuses_what_no_mode_computes():
    with pytest.raises(ValueError, match="'default'"):
        sepconv.resolve_mode(torch.float32, 'default')
    with pytest.raises(ValueError, match='compute_dtype'):
        sepconv.resolve_mode(torch.float16)
    with pytest.raises(ValueError, match='mode'):
        sepconv.fused_tail_plain({}, torch.zeros(1, 6, 4, 512), mode='fp8')


@pytest.fixture(scope='module')
def bundle():
    with np.load(BUNDLE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def clean_interpreter():
    """A whole-classifier reference computed from a clean process state.

    The TPU interpreter keeps one simulated memory per process, which a
    kernel that raised leaves behind and a kernel still running from
    another test shares (jax's ``reset_tpu_interpret_mode_state``); and the
    JAX classifier's jitted graph, once traced, is reused by any later
    classifier of the same static arguments, whatever module globals it
    was traced under. A worker of the tier-1
    run that had run other test files first scored 5.9e-3 here, against
    7.45e-4 on its own; that failure was not reproduced, so whether this
    state was its cause is not known. Against both suspects, wait for every
    outstanding side effect, reset the interpreter and drop the traced
    graphs before the reference runs."""
    jax.effects_barrier()
    pltpu.reset_tpu_interpret_mode_state()
    jax.clear_caches()


def _files_run_before(request):
    """This process's name under xdist and the test files of which it ran a
    test before this one, in collection order (pytest sets a test's
    ``funcargs`` to None once it has run): what to read when a test fails
    in the tier-1 run and passes on its own."""
    files = []
    for item in request.session.items:
        f = item.nodeid.split('::')[0]
        if getattr(item, 'funcargs', {}) is None and f not in files:
            files.append(f)
    return os.environ.get('PYTEST_XDIST_WORKER', 'no xdist'), files


def _wave(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    tone = 0.2 * np.sin(2 * np.pi * 330 * t) * (t % 2 < 1)
    return (tone + rng.standard_normal(len(t)) * 0.05).astype(np.float32)


@pytest.mark.parametrize('mode', ['bf16', 'high'])
def test_classifier_scores_match_jax(bundle, clean_interpreter, request,
                                     mode):
    """Whole-classifier scores on the real bundle against the JAX package's
    ChunkClassifier(conv='pallas') in the same mode (interpret mode)."""
    kw = ({'compute_dtype': jnp.bfloat16} if mode == 'bf16'
          else {'conv_precision': 'high'})
    tkw = ({'compute_dtype': torch.bfloat16} if mode == 'bf16'
           else {'conv_precision': 'high'})
    wav = _wave(7.7, seed=5)
    jclf = JaxClassifier(bundle, conv='pallas', transfer_dtype='int16', **kw)
    with pltpu.force_tpu_interpret_mode():
        ref = jclf.predict(wav)
    del jclf   # one interpreted classifier alive at a time
    tclf = ChunkClassifier(bundle, device='cpu', transfer_dtype='int16',
                           **tkw)
    assert tclf.mode == mode
    got = tclf.predict(wav)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    budget = BF16_SCORE_FAULT if mode == 'bf16' else ATOL_SCORE
    print(f'scores [{mode}] vs JAX conv=pallas: max |dscore| = {err:.3g} '
          f'(budget {budget})')
    worker, files = _files_run_before(request)
    assert err <= budget, (f'max |dscore| = {err:.3g} > {budget}; worker '
                           f'{worker} had run tests of {files}')


def test_bf16_scores_against_jax_default_bf16_and_f32(bundle,
                                                      clean_interpreter):
    """The port's bf16 is the JAX conv='pallas' bf16 function. Against the
    JAX package's default --bf16 (conv='xla' off the TPU, which rounds every
    layer's activations to bf16) and against f32 it differs as much as the
    JAX package's own conv='pallas' bf16 does, within the fault threshold:
    on this bundle the reference's two bf16 functions lie ~0.1 apart on its
    CPU oracle, far past the ~6e-3 it documents for the TPU."""
    wav = _wave(7.7, seed=6)
    got = ChunkClassifier(bundle, device='cpu',
                          compute_dtype='bfloat16').predict(wav)
    f32 = ChunkClassifier(bundle, device='cpu').predict(wav)
    j_xla = JaxClassifier(bundle, compute_dtype=jnp.bfloat16).predict(wav)
    j_f32 = JaxClassifier(bundle).predict(wav)
    with pltpu.force_tpu_interpret_mode():
        j_pallas = JaxClassifier(bundle, conv='pallas',
                                 compute_dtype=jnp.bfloat16).predict(wav)
    d = {k: float(np.abs(a - b).max()) for k, (a, b) in {
        'port bf16 vs JAX default bf16 (conv=xla)': (got, j_xla),
        'JAX pallas bf16 vs JAX default bf16': (j_pallas, j_xla),
        'port bf16 vs port f32': (got, f32),
        'JAX pallas bf16 vs JAX f32': (j_pallas, j_f32)}.items()}
    for k, v in d.items():
        print(f'{k}: max |dscore| = {v:.3g}')
    assert (d['port bf16 vs JAX default bf16 (conv=xla)']
            <= d['JAX pallas bf16 vs JAX default bf16'] + BF16_SCORE_FAULT)
    assert (d['port bf16 vs port f32']
            <= d['JAX pallas bf16 vs JAX f32'] + BF16_SCORE_FAULT)
