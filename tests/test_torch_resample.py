"""The port's polyphase resampler (buzzdetect_torch/ops/resample.py, one
strided F.conv1d) against the JAX package's (one conv_general_dilated at
Precision.HIGHEST), on seeded noise plus a tone: 1-D and batched inputs, six
rate pairs, the output length, and the float32 identity."""

import numpy as np
import pytest
import torch

from buzzdetect_tpu.ops.resample import resample as jax_resample
from buzzdetect_torch.ops import resample
from buzzdetect_torch.ops.resample import _polyphase_kernel

# both sides sum the same f32 products in f32, in different orders; the
# signals are O(1), observed differences ~1e-6 (see the test output)
ATOL = 1e-5
PAIRS = [(48000, 16000), (44100, 16000), (32000, 16000), (22050, 16000),
         (96000, 16000), (8000, 16000)]


def _signal(shape, orig, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / orig
    return (0.5 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize('shape', [(12345,), (3, 9000)], ids=['1d', 'batch'])
@pytest.mark.parametrize('orig,target', PAIRS)
def test_resample_matches_jax(orig, target, shape):
    x = _signal(shape, orig, seed=orig + len(shape))
    got = resample(torch.from_numpy(x), orig, target)
    ref = np.asarray(jax_resample(x, orig, target))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (*shape[:-1],
                                      -(-shape[-1] * target // orig))
    err = float(np.abs(got.numpy() - ref).max())
    print(f'{orig} -> {target} {shape}: max |port - jax| = {err:.3g}')
    assert err <= ATOL


def test_batch_rows_equal_single_rows():
    x = _signal((3, 32000), 32000, seed=1)
    batch = resample(torch.from_numpy(x), 32000, 16000)
    single = resample(torch.from_numpy(x[1]), 32000, 16000)
    assert batch.shape == (3, 16000)
    np.testing.assert_allclose(batch[1].numpy(), single.numpy(), atol=1e-6)


@pytest.mark.parametrize('dtype', [torch.float32, torch.int16,
                                   torch.float64])
def test_identity_returns_float32(dtype):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         * 1000).to(dtype)
    y = resample(x, 16000, 16000)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), x.to(torch.float32).numpy())


def test_44k_kernel_layout_is_the_jax_layout():
    """44.1 -> 16 kHz: 160 phases of 528 taps laid out, 89 nonzero per
    phase at most; the width the conv computes is 5.9x the useful taps."""
    K, i0_min, width = _polyphase_kernel(160, 441, 16)
    assert K.shape == (160, 1, 528) and width == 528 and i0_min <= 0
    nonzero = np.count_nonzero(K, axis=-1).max()
    assert nonzero == 89
    print(f'44.1 kHz kernel: {K.shape}, {nonzero} nonzero taps per phase, '
          f'{width / nonzero:.2f}x laid out')


def test_tf32_setting_is_restored():
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        resample(torch.zeros(4410), 44100, 16000)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
