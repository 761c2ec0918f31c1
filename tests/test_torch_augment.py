"""The port's training augmentation (``buzzdetect_torch/train/augment.py``)
against ``buzzdetect_tpu/train/augment.py``.

``jax.random``'s streams cannot be reproduced in torch, so each transform
is tested in two halves:

* the application: the JAX function's own draws (made here with
  ``jax.random`` through the same splits the JAX function makes) are fed
  to the port's application, whose output must equal the JAX function's
  bit for bit;
* the draws: the port's host draws against the JAX package's, in range and
  in distribution (two-sample Kolmogorov-Smirnov tests on a few thousand
  draws each, at p > 1e-3).

Then the augmented full train step on the port: live, finite, learning,
and an augmented run that resumes from its checkpoint lands on the same
bits. Each case prints its max |port - reference|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from buzzdetect_tpu.train import augment as jaug
from buzzdetect_torch.train import augment as taug

KEYS = [0, 7, 123]


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    """Two intra-op threads for this module's full-width CPU steps: the
    test run shares the machine's cores among its workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _jax_waveform_draws(key, b, gain_db=6.0, max_shift_s=0.25, sr=16000):
    """augment_waveforms' draws, as it makes them."""
    k_gain, k_shift = jax.random.split(key)
    gains = 10.0 ** (jax.random.uniform(
        k_gain, (b, 1), minval=-gain_db, maxval=gain_db) / 20.0)
    max_shift = int(max_shift_s * sr)
    shifts = jax.random.randint(k_shift, (b,), -max_shift, max_shift + 1)
    return np.asarray(gains), np.asarray(shifts)


def _jax_mixup_draws(key, b, alpha=0.3):
    k_perm, k_lam = jax.random.split(key)
    perm = jax.random.permutation(k_perm, b)
    lam = jax.random.beta(k_lam, alpha, alpha, (b,))
    return perm, jnp.maximum(lam, 1.0 - lam)


def _jax_mask_draws(key, n, t_dim=96, f_dim=64, max_time=16, max_freq=8):
    """spec_mask's per-patch draws (one time and one band mask each), as
    its ``mask_one`` makes them under ``vmap``."""
    def one(k):
        out = []
        for axis_len, max_width in ((t_dim, max_time), (f_dim, max_freq)):
            k, k_w, k_at = jax.random.split(k, 3)
            width = jax.random.randint(k_w, (), 0, max_width + 1)
            at = jax.random.randint(k_at, (), 0,
                                    jnp.maximum(axis_len - width, 1))
            out += [at, width]
        return out
    t_at, t_w, f_at, f_w = (np.array(a)[:, None] for a in jax.jit(
        jax.vmap(one))(jax.random.split(key, n)))
    return {'time': (t_at, t_w), 'freq': (f_at, f_w)}


def _report(got, ref):
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    print(f'max |port - reference| = {err}')
    return err


@pytest.mark.parametrize('seed', KEYS)
def test_augment_waveforms_application_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    w = (np.random.default_rng(seed).standard_normal((4, 16000)) * 0.1
         ).astype(np.float32)
    ref = np.asarray(jaug.augment_waveforms(key, jnp.asarray(w)))
    got = taug.augment_waveforms(torch.from_numpy(w),
                                 *_jax_waveform_draws(key, 4)).numpy()
    assert _report(got, ref) == 0.0


@pytest.mark.parametrize('seed', KEYS)
def test_mixup_application_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((6, 800)) * 0.1).astype(np.float32)
    y = (rng.random((6, 3)) > 0.5).astype(np.float32)
    ref_x, ref_y = jaug.mixup(key, jnp.asarray(w), jnp.asarray(y))
    got_x, got_y = taug.mixup(torch.from_numpy(w), torch.from_numpy(y),
                              *_jax_mixup_draws(key, 6))
    assert _report(got_x.numpy(), np.asarray(ref_x)) == 0.0
    assert _report(got_y.numpy(), np.asarray(ref_y)) == 0.0


@pytest.mark.parametrize('seed', KEYS)
def test_spec_mask_application_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    p = np.random.default_rng(seed).standard_normal((2, 3, 96, 64)) \
        .astype(np.float32)
    ref = np.asarray(jaug.spec_mask(key, jnp.asarray(p)))
    got = taug.spec_mask(torch.from_numpy(p),
                         _jax_mask_draws(key, 6)).numpy()
    assert _report(got, ref) == 0.0
    assert (got == 0).any()   # the draws masked something


def test_default_augment_application_matches_jax():
    """default_augment's two halves in the JAX order: gain + shift from the
    first key, mixup from the second."""
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((4, 15600)) * 0.1).astype(np.float32)
    y = (rng.random((4, 2)) > 0.5).astype(np.float32)
    ref_x, ref_y = jaug.default_augment(key, jnp.asarray(w), jnp.asarray(y))
    k1, k2 = jax.random.split(key)
    x = taug.augment_waveforms(torch.from_numpy(w),
                               *_jax_waveform_draws(k1, 4))
    got_x, got_y = taug.mixup(x, torch.from_numpy(y),
                              *_jax_mixup_draws(k2, 4))
    assert _report(got_x.numpy(), np.asarray(ref_x)) == 0.0
    assert _report(got_y.numpy(), np.asarray(ref_y)) == 0.0


N_DRAWS = 4000


def _ks(port, ref, what):
    p = stats.ks_2samp(port, ref).pvalue
    print(f'{what}: KS p = {p:.3g} over {len(port)} / {len(ref)} draws')
    assert p > 1e-3, what


def test_waveform_draws_range_and_distribution():
    gains, shifts = taug.draw_waveform_augment(
        np.random.default_rng(0), N_DRAWS)
    assert gains.shape == (N_DRAWS, 1) and gains.dtype == np.float32
    db = 20 * np.log10(gains[:, 0].astype(np.float64))
    assert db.min() >= -6.0 - 1e-5 and db.max() <= 6.0 + 1e-5
    assert shifts.min() >= -4000 and shifts.max() <= 4000
    ref_g, ref_s = _jax_waveform_draws(jax.random.PRNGKey(0), N_DRAWS)
    _ks(gains[:, 0], ref_g[:, 0], 'gains')
    _ks(shifts, ref_s, 'shifts')
    _report(sorted(gains[:, 0])[::400], np.sort(ref_g[:, 0])[::400])


def test_mixup_draws_range_and_distribution():
    lams = []
    for i in range(N_DRAWS // 8):
        perm, lam = taug.draw_mixup(np.random.default_rng(i), 8)
        assert sorted(perm) == list(range(8))
        lams.append(lam)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(N_DRAWS // 8))
    refs = np.asarray(jax.jit(jax.vmap(
        lambda k: _jax_mixup_draws(k, 8)[1]))(keys)).ravel()
    lams = np.concatenate(lams)
    assert lams.dtype == np.float32
    assert lams.min() >= 0.5 and lams.max() <= 1.0
    _ks(lams, refs, 'mixup lambda (Beta(0.3, 0.3), folded to >= 0.5)')


def test_spec_mask_draws_range_and_distribution():
    masks = taug.draw_spec_mask(np.random.default_rng(0), N_DRAWS)
    ref = _jax_mask_draws(jax.random.PRNGKey(0), 1000)
    for axis, axis_len, max_width in (('time', 96, 16), ('freq', 64, 8)):
        at, width = masks[axis]
        assert at.shape == width.shape == (N_DRAWS, 1)
        assert width.min() >= 0 and width.max() <= max_width
        assert (at >= 0).all() and (at < np.maximum(axis_len - width, 1)) \
            .all()
        _ks(width[:, 0], ref[axis][1][:, 0], f'{axis} mask widths')
        _ks(at[:, 0], ref[axis][0][:, 0], f'{axis} mask starts')


def test_full_train_step_with_augmentation_is_live_and_learns():
    """Augmented and clean steps give different losses on the same batch
    (the augmentation is live), the augmented loss is finite, and a short
    augmented run learns (the JAX package's case). Learning is read on the
    clean batch, before and after: each augmented step's own loss is
    taken on a freshly augmented batch, and over 6 steps that noise hides
    the trend (here 0.661, 0.674, ..., 0.651, 0.709)."""
    from buzzdetect_torch.ops.frontend import FrontendConfig
    from buzzdetect_torch.train.clips import train_full_model
    from buzzdetect_torch.train.trainer import (full_loss, init_full_train,
                                                make_full_train_step)
    from buzzdetect_torch.models.weights import train_state_from_numpy
    rng = np.random.default_rng(0)
    clips = torch.from_numpy((rng.standard_normal((4, 15600)) * 0.1)
                             .astype(np.float32))
    labels = torch.from_numpy((rng.random((4, 2)) > 0.5).astype(np.float32))
    losses = {}
    for augment in (False, True):
        params, opt = init_full_train(2, seed=0, learning_rate=1e-3,
                                      device='cpu')
        step = make_full_train_step(opt, params, augment=augment)
        args = (np.random.default_rng(7),) if augment else ()
        losses[augment] = float(step(clips, labels, *args))
    print(f'clean loss {losses[False]}, augmented {losses[True]}')
    assert np.isfinite(losses[True])
    assert losses[True] != pytest.approx(losses[False], abs=1e-9)

    raw, head, _ = train_full_model(clips.numpy(), labels.numpy(), epochs=6,
                                    batch_size=4, learning_rate=1e-3,
                                    augment=True, log=lambda *_: None,
                                    device='cpu')
    trained, _ = train_state_from_numpy({'yamnet_raw': raw, 'head': head})
    with torch.no_grad():
        after = float(full_loss(trained, clips, labels, FrontendConfig())[0])
    print(f'clean-batch loss {losses[False]} before, {after} after 6 '
          f'augmented steps')
    assert after < losses[False]


def test_augmented_checkpoint_resume_bit_identical(tmp_path):
    """The draws come from (seed, global step) and the step rides the
    checkpoint, so an interrupted augmented run resumes on the same draws
    and lands on the same bits."""
    from buzzdetect_torch.train.clips import train_full_model
    rng = np.random.default_rng(5)
    clips = (rng.standard_normal((4, 15600)) * 0.1).astype(np.float32)
    labels = (rng.random((4, 2)) > 0.5).astype(np.float32)
    kw = dict(batch_size=2, learning_rate=1e-3, augment=True,
              log=lambda *_: None, device='cpu')
    gold_raw, gold_head, gold_losses = train_full_model(clips, labels,
                                                        epochs=2, **kw)
    ckpt = str(tmp_path / 'work')
    train_full_model(clips, labels, epochs=1, checkpoint_dir=ckpt, **kw)
    raw, head, losses = train_full_model(clips, labels, epochs=2,
                                         checkpoint_dir=ckpt, **kw)
    assert losses == gold_losses
    for got, ref in ((raw, gold_raw), (head, gold_head)):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    print('max |resumed - uninterrupted| = 0.0')
