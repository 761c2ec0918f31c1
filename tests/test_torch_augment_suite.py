"""tests/test_augment.py, case for case, against ``buzzdetect_torch``
(same function names and assertions). Edits:

* a ``jax.random`` key becomes an explicit ``np.random.Generator`` seeded
  with the key's number: the port splits each transform into its draws
  (``draw_waveform_augment``, ``draw_mixup``, ``draw_spec_mask``, made on
  the host from the generator with the JAX package's distributions) and
  its application (``augment_waveforms``, ``mixup``, ``spec_mask``, on
  tensors). The transform cases assert ranges, bounds and determinism,
  which hold for any draws, on the port's own draws; each also feeds the
  JAX function's draws for its key (made as ``tests/test_torch_augment.py``
  makes them) to the port's application and prints max |port - JAX|
  against the JAX function's output;
* ``test_spec_mask_jits_once_for_any_width``: the port has no compilation
  to count. What it holds instead is one code path for any width, with no
  per-width state: the mask is a comparison against an index range, so
  widths from 0 to the maximum and starts at both edges give the same
  shape, zero exactly the drawn rows and bands, and leave the module's
  state as it was;
* the train step is the port's (``init_full_train`` returns the
  parameters and their optimizer; ``make_full_train_step(optimizer,
  params, augment=...)`` returns ``step(waveforms, labels[, rng])``, which
  updates the parameters in place, so each step gets its own fresh
  state, as the JAX case's ``fresh`` copies do);
* the short augmented run of ``test_full_train_step_with_augmentation_learns``
  asserts a loss trend that holds for the JAX package's key stream, so it
  runs on that stream: each step's draws are the JAX package's for
  ``fold_in(PRNGKey(seed), step)``, fed to the port's application through
  the train step's ``default_augment`` and ``draw_spec_mask`` (the port's
  own stream, ``np.random.default_rng((seed, step))``, gives per-step
  losses whose trend over 6 steps is hidden by the draws' noise;
  ``test_torch_augment.py`` reads learning there on the clean batch). The
  case prints max |port - JAX| over the 6 losses;
* every train call runs on the CPU (``device='cpu'``), with two intra-op
  threads (``two_torch_threads``, as in ``test_torch_train.py``).

The JAX package's docstring:
On-device training augmentation: pure key-driven transforms with
static shapes (train/augment.py), and their integration into the full
train step.
"""

import numpy as np
import pytest
import torch

from buzzdetect_torch.train.augment import (augment_waveforms, draw_mixup,
                                            draw_spec_mask,
                                            draw_waveform_augment, mixup,
                                            spec_mask)


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    """Two intra-op threads for this module's full-width CPU steps: the
    test run shares the machine's cores among its workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _print_vs_jax(what, got, ref):
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(ref, np.float64)).max())
    print(f'{what}: max |port - JAX| = {err}')
    return err


def _waveforms_vs_jax(seed, w, gain_db):
    """The JAX function on PRNGKey(seed), and the port's application of the
    same draws."""
    import jax
    import jax.numpy as jnp
    from buzzdetect_tpu.train.augment import augment_waveforms as jfn
    from tests.test_torch_augment import _jax_waveform_draws
    key = jax.random.PRNGKey(seed)
    ref = jfn(key, jnp.asarray(w.numpy()), gain_db=gain_db)
    got = augment_waveforms(w, *_jax_waveform_draws(key, w.shape[0],
                                                    gain_db=gain_db))
    return _print_vs_jax('augment_waveforms on the JAX draws', got, ref)


def test_augment_waveforms_gain_and_shift():
    rng = np.random.default_rng(0)
    w = torch.ones((4, 16000), dtype=torch.float32)
    draws = draw_waveform_augment(rng, 4, gain_db=6.0)
    out = augment_waveforms(w, *draws)
    assert out.shape == w.shape and out.dtype == w.dtype
    # a constant signal circular-shifts to itself: only gain remains, and
    # gain is bounded by +-6 dB
    per_clip = out.numpy()[:, 0]
    assert np.all(per_clip >= 10 ** (-6 / 20) - 1e-6)
    assert np.all(per_clip <= 10 ** (6 / 20) + 1e-6)
    # per-clip gains differ (it's per-sample randomness, not one scalar)
    assert len(np.unique(np.round(per_clip, 6))) > 1
    # deterministic per key
    again = augment_waveforms(
        w, *draw_waveform_augment(np.random.default_rng(0), 4, gain_db=6.0))
    np.testing.assert_array_equal(out.numpy(), again.numpy())
    _waveforms_vs_jax(0, w, 6.0)


def test_augment_waveforms_shift_is_circular():
    rng = np.random.default_rng(3)
    ramp = torch.arange(16000, dtype=torch.float32)[None, :].repeat(8, 1)
    out = augment_waveforms(ramp, *draw_waveform_augment(rng, 8,
                                                         gain_db=0.0))
    for row in out.numpy():
        # a circular shift of a permutation keeps the multiset intact
        np.testing.assert_array_equal(np.sort(row), np.arange(16000))
    _waveforms_vs_jax(3, ramp, 0.0)


def test_mixup_convexity_and_labels():
    rng = np.random.default_rng(1)
    w = torch.stack([torch.zeros(100), torch.ones(100)]).float()
    y = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    mx, my = mixup(w, y, *draw_mixup(rng, 2, alpha=0.3))
    mx, my = mx.numpy(), my.numpy()
    # every mixed sample is a convex combination: values within [0, 1],
    # labels rows sum to 1 (two one-hot parents)
    assert np.all(mx >= -1e-6) and np.all(mx <= 1 + 1e-6)
    np.testing.assert_allclose(my.sum(axis=1), 1.0, atol=1e-6)
    # lambda folded to >= 0.5: each clip remains its own majority component
    assert my[0, 0] >= 0.5 - 1e-6
    assert my[1, 1] >= 0.5 - 1e-6
    import jax
    import jax.numpy as jnp
    from buzzdetect_tpu.train.augment import mixup as jfn
    from tests.test_torch_augment import _jax_mixup_draws
    key = jax.random.PRNGKey(1)
    jx, jy = jfn(key, jnp.asarray(w.numpy()), jnp.asarray(y.numpy()),
                 alpha=0.3)
    px, py = mixup(w, y, *_jax_mixup_draws(key, 2, alpha=0.3))
    _print_vs_jax('mixup on the JAX draws', torch.cat([px, py], 1),
                  np.concatenate([np.asarray(jx), np.asarray(jy)], 1))


def test_spec_mask_zeroes_bounded_regions():
    rng = np.random.default_rng(2)
    p = torch.ones((3, 2, 96, 64), dtype=torch.float32)
    out = spec_mask(p, draw_spec_mask(rng, 6, max_time=16,
                                      max_freq=8)).numpy()
    assert out.shape == tuple(p.shape)
    zeroed = (out == 0.0).mean()
    # masks exist but are bounded (max_time*64 + max_freq*96 of 6144 cells)
    assert zeroed <= (16 * 64 + 8 * 96) / (96 * 64) + 1e-6
    # unmasked cells pass through untouched
    assert set(np.unique(out)) <= {0.0, 1.0}
    # patches get independent masks
    assert not np.array_equal(out[0, 0], out[1, 0]) or \
        not np.array_equal(out[0, 1], out[2, 1])
    import jax
    import jax.numpy as jnp
    from buzzdetect_tpu.train.augment import spec_mask as jfn
    from tests.test_torch_augment import _jax_mask_draws
    key = jax.random.PRNGKey(2)
    ref = jfn(key, jnp.ones((3, 2, 96, 64)), max_time=16, max_freq=8)
    got = spec_mask(p, _jax_mask_draws(key, 6, max_time=16, max_freq=8))
    _print_vs_jax('spec_mask on the JAX draws', got, ref)


def test_spec_mask_jits_once_for_any_width():
    import buzzdetect_torch.train.augment as taug
    state = dict(vars(taug))
    p = torch.ones((1, 1, 96, 64))
    a = spec_mask(p, draw_spec_mask(np.random.default_rng(4), 1))
    b = spec_mask(p, draw_spec_mask(np.random.default_rng(5), 1))
    assert a.shape == b.shape == p.shape
    # every width from 0 to the maximum, at both edges of each axis: the
    # same code path zeroes exactly the drawn rows and bands
    for width in range(17):
        for at in (0, 96 - width):
            masks = {'time': (np.array([[at]]), np.array([[width]])),
                     'freq': (np.array([[64 - width // 2]]),
                              np.array([[width // 2]]))}
            out = spec_mask(p, masks)[0, 0].numpy()
            assert out.shape == (96, 64)
            rows = (out == 0).all(axis=1)
            cols = (out == 0).all(axis=0)
            assert rows.sum() == width and rows[at:at + width].all()
            assert cols.sum() == width // 2
    assert dict(vars(taug)) == state


def test_full_train_step_with_augmentation_learns():
    """The augmented step runs inside one jitted program and still learns;
    augmented and clean steps produce different losses on the same batch
    (proof the augmentation is live)."""
    from buzzdetect_torch.train.trainer import (init_full_train,
                                                make_full_train_step)
    rng = np.random.default_rng(0)
    clips = (rng.standard_normal((4, 15600)) * 0.1).astype(np.float32)
    labels = (rng.random((4, 2)) > 0.5).astype(np.float32)

    def fresh(augment):  # each step updates its own parameters in place
        params, opt = init_full_train(2, seed=0, learning_rate=1e-3,
                                      device='cpu')
        return make_full_train_step(opt, params, augment=augment)

    loss_clean = fresh(False)(torch.from_numpy(clips),
                              torch.from_numpy(labels))
    loss_aug = fresh(True)(torch.from_numpy(clips), torch.from_numpy(labels),
                           np.random.default_rng(7))
    assert float(loss_clean) != pytest.approx(float(loss_aug), abs=1e-9)

    # and a short augmented training run reduces loss (on the JAX
    # package's key stream, fed to the port's application)
    import jax
    from buzzdetect_torch.train import trainer
    from buzzdetect_torch.train.clips import train_full_model
    from tests.test_torch_augment import (_jax_mask_draws, _jax_mixup_draws,
                                          _jax_waveform_draws)
    stream = {'step': 0}

    def jax_default_augment(_rng, waveforms, labels):
        key = jax.random.fold_in(jax.random.PRNGKey(0), stream['step'])
        stream['step'] += 1
        k_wave, stream['mask_key'] = jax.random.split(key)
        k1, k2 = jax.random.split(k_wave)
        b = waveforms.shape[0]
        waveforms = augment_waveforms(waveforms, *_jax_waveform_draws(k1, b))
        return mixup(waveforms, labels, *_jax_mixup_draws(k2, b))

    saved = trainer.default_augment, trainer.draw_spec_mask
    trainer.default_augment = jax_default_augment
    trainer.draw_spec_mask = lambda _rng, n: _jax_mask_draws(
        stream['mask_key'], n)
    try:
        _, _, losses = train_full_model(clips, labels, epochs=6,
                                        batch_size=4, learning_rate=1e-3,
                                        augment=True, log=lambda *_: None,
                                        device='cpu')
    finally:
        trainer.default_augment, trainer.draw_spec_mask = saved
    assert stream['step'] == 6
    from buzzdetect_tpu.train.clips import train_full_model as jtrain
    _, _, jlosses = jtrain(clips, labels, epochs=6, batch_size=4,
                           learning_rate=1e-3, augment=True,
                           log=lambda *_: None)
    print(f'augmented losses: port {losses}, JAX {jlosses}')
    _print_vs_jax('augmented run losses on the JAX key stream', losses,
                  jlosses)
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


def test_augmented_checkpoint_resume_bit_identical(tmp_path):
    """Per-step keys derive from (seed, global step) and the step counter
    rides the checkpoint, so an interrupted AUGMENTED run resumes on the
    exact key stream -> bit-identical parameters."""
    from buzzdetect_torch.train.clips import train_full_model
    rng = np.random.default_rng(5)
    clips = (rng.standard_normal((4, 15600)) * 0.1).astype(np.float32)
    labels = (rng.random((4, 2)) > 0.5).astype(np.float32)
    kw = dict(batch_size=2, learning_rate=1e-3, augment=True,
              log=lambda *_: None, device='cpu')

    gold_raw, _, gold_losses = train_full_model(clips, labels, epochs=2,
                                                **kw)
    ckpt = str(tmp_path / 'work')
    train_full_model(clips, labels, epochs=1, checkpoint_dir=ckpt, **kw)
    raw, _, losses = train_full_model(clips, labels, epochs=2,
                                      checkpoint_dir=ckpt, **kw)
    assert losses == gold_losses
    for k in gold_raw:
        np.testing.assert_array_equal(raw[k], gold_raw[k], err_msg=k)
