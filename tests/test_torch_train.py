"""The port's training path (``buzzdetect_torch/train/``, ``models/yamnet.
embed_train``, ``models/weights.train_state_from_numpy`` and the tools
``embed_corpus``, ``score_embeddings`` and ``train_model``) against the JAX
package's, on the CPU, at full width (14 conv layers, 1024-d embeddings).

Tolerances, and why:

* head step: loss rtol 1e-5, gradients within 1e-5 of each leaf's max |g|
  (a linear layer and BCE: f32 rounding);
* ``train_head`` over 3 epochs, the same batches from the same seed: each
  Adam step turns a relative gradient error d into an update error of at
  most about 2 d lr, so after k steps the parameters agree within
  2 k 1e-5 lr;
* one full step from the same state: loss rtol 1e-5; gradients within
  1e-4 of each leaf's max |g| of a float64 evaluation that takes the
  port's ReLU branches (f32 rounding: 7.4e-5 at most here, on BatchNorm
  over layers 13-14's 3 x 2 positions per patch). Against float64's own
  branches, and so against the JAX package, an f32 gradient differs
  wherever a pre-activation within rounding of 0 takes the other branch:
  the JAX package's lies up to ~4e-2 of a leaf's max |g| from float64's.
  So each leaf's port gradient must also be within 1e-4 of the JAX
  package's where the JAX package is itself within 1e-4 of float64, and
  on every leaf at least as close to float64 as the JAX package's (plus
  1e-4 of max |g|);
* k = 3 full steps: each step's gradients and Adam moments against
  float64's step from the port's state (the same rounding bounds), and
  the params element by element within the drift Adam's update allows
  for the two runs' gradient difference (``_adam_drift``: about
  2 lr |dg| / sqrt(v_hat) a step, plus an ulp of the param), against
  float64's step and against the JAX package's k steps;
* BN running statistics after one step: momentum 0.99 keeps 0.01 of the
  batch statistic, which the JAX package's f32 stack computes to ~1e-4 of
  its size, plus a few ulps of a statistic near 1: 2e-6 of max(1, |s|);
* embeddings (folded inference): the port within 1e-5 of the largest
  |embedding| of a float64 evaluation, and of the JAX package's within
  that plus the JAX package's own distance from float64 (3.8e-5 relative
  on the seeded bundle here: its f32 conv stack on the CPU).

Each case prints its max |port - reference|.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from buzzdetect_tpu.models import heads as jheads
from buzzdetect_tpu.models import yamnet as jyamnet
from buzzdetect_tpu.ops.frontend import FrontendConfig as JFrontend
from buzzdetect_tpu.ops.frontend import log_mel_patches as jlog_mel_patches
from buzzdetect_tpu.train import trainer as jtrainer
from buzzdetect_torch.models.weights import flatten, train_state_from_numpy
from buzzdetect_torch.ops.frontend import FrontendConfig, log_mel_patches
from buzzdetect_torch.ops.sepconv import same_pad
from buzzdetect_torch.train import trainer as ttrainer
from tests.audio_fixtures import make_tone, write_wav
from tests.test_torch_writers import run_tool

LR = 1e-4
K_STEPS = 3
ADAM_STEP_MAX = 1.004    # max |m_hat| / sqrt(v_hat) for t <= 3
B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults
# the largest |pre-activation| (BatchNorm output, O(1)) at which an f32
# evaluation may take the other ReLU branch than float64: f32 rounding
# through up to 27 layers is ~1e-5 of it
Z_EDGE = 1e-4


def _clips(n=4, seed=0):
    """n seeded 0.975 s clips (one patch each): tones on odd rows, noise
    throughout; and multi-hot labels for 2 classes."""
    rng = np.random.default_rng(seed)
    t = np.arange(15600) / 16000
    wav = np.stack([0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) * (i % 2)
                    + rng.standard_normal(15600) * 0.05 for i in range(n)])
    labels = (rng.random((n, 2)) > 0.5).astype(np.float32)
    return wav.astype(np.float32), labels


class _ReluMasks(TorchFunctionMode):
    """Records the branch (output > 0) of every ``torch.relu`` run inside
    it: the float64 referee then takes the same branch of each ReLU as the
    f32 evaluation it referees."""

    def __init__(self):
        super().__init__()
        self.masks = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.relu:
            self.masks.append((out > 0).detach())
        return out


def _embed_f64(raw, patches, masks=None):
    """embed_train written out in float64 with plain ``F.conv2d``: the
    referee for both packages' f32 gradients. With ``masks`` (one per
    layer, from ``_ReluMasks``) each ReLU takes the recorded branch.
    Returns (embeddings, every layer's pre-activation)."""
    x, zs = patches[:, None], []
    for i, (key, kind, stride, _shape) in enumerate(jyamnet._conv_shapes()):
        k = raw[f'{key}/kernel'].permute(3, 2, 0, 1)
        ph = same_pad(x.shape[2], stride, k.shape[-1])
        pw = same_pad(x.shape[3], stride, k.shape[-1])
        x = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), k,
                     stride=stride,
                     groups=x.shape[1] if kind == 'depthwise' else 1)
        mean = x.mean(dim=(0, 2, 3))[:, None, None]
        var = x.var(dim=(0, 2, 3), correction=0)[:, None, None]
        z = (x - mean) / torch.sqrt(var + 1e-4) \
            + raw[f'{key}/bn_beta'][:, None, None]
        zs.append(z.detach().numpy())
        x = torch.relu(z) if masks is None else z * masks[i].double()
    return x.mean(dim=(2, 3)), zs


def _adam_step_f64(p, m, v, t, patches, labels, masks=None):
    """Step ``t`` of optax.adam's update in float64 from the trainable
    leaves ``p`` and the moments ``m``, ``v`` (flat dicts), the gradient
    from ``_embed_f64`` (with ``masks`` if given). Returns the
    pre-activations and the flat dicts ``g``, ``m``, ``v``, ``r``
    (sqrt(v_hat)) and ``p`` after the step."""
    leaves = {k: torch.from_numpy(np.asarray(x, np.float64)).requires_grad_()
              for k, x in p.items()}
    raw = {k.split('.', 1)[1]: x for k, x in leaves.items()
           if k.startswith('yamnet_raw.')}
    emb, zs = _embed_f64(raw, patches, masks)
    logits = emb @ leaves['head.head/kernel'] + leaves['head.head/bias']
    ttrainer.bce_with_logits_loss(logits, labels).backward()
    g = {k: x.grad.numpy() for k, x in leaves.items()}
    m = {k: B1 * m[k] + (1 - B1) * g[k] for k in p}
    v = {k: B2 * v[k] + (1 - B2) * g[k] ** 2 for k in p}
    r = {k: np.sqrt(v[k] / (1 - B2 ** t)) for k in p}
    p = {k: p[k] - LR * m[k] / (1 - B1 ** t) / (r[k] + EPS) for k in p}
    return dict(zs=zs, g=g, m=m, v=v, r=r, p=p)


def _trainable(state):
    return {k: v.astype(np.float64) for k, v in flatten(state)
            if not k.endswith(('bn_mean', 'bn_var'))}


def _branch_edges(zs, masks):
    """(count, largest |z|) of the float64 pre-activations whose sign
    disagrees with the recorded f32 branch."""
    off = [(z > 0) != mask.numpy() for z, mask in zip(zs, masks)]
    return (int(sum(o.sum() for o in off)),
            max(float(np.abs(z[o]).max(initial=0.0)) for z, o in
                zip(zs, off)))


def _share(got, ref, scale):
    return float(np.abs(got - ref).max()) / float(np.abs(scale).max())


def _adam_drift(deltas, rs, p):
    """The per-element bound on |p' - p| after len(deltas) Adam steps from
    the same params, where at step s the two runs' gradients differ by at
    most deltas[s] (on the leaf) and rs[s] is one run's sqrt(v_hat); and
    the elements where it is tight (every rs[s] >= 10 D_s).

    With D_s = max(deltas[:s + 1]), both runs' m_hat and sqrt(v_hat) differ
    by at most D_s (weighted means of the gradients, and a weighted
    2-norm), so their updates m_hat / (sqrt(v_hat) + eps) differ by at
    most D_s (1 + 1.004) / (r_s - D_s) (|m_hat| <= 1.004 sqrt(v_hat) for
    t <= 3); each step adds the f32 rounding of the parameter and of its
    update, an ulp of |p| and lr 2^-20."""
    D = np.maximum.accumulate(deltas)
    tight = np.all([r >= 10 * d for r, d in zip(rs, D)], axis=0)
    drift = sum(LR * d * (1 + ADAM_STEP_MAX) / np.maximum(r - d, 1e-30)
                for r, d in zip(rs, D))
    rounding = len(deltas) * (np.spacing(np.abs(p).astype(np.float32))
                              + LR * 2.0 ** -20)
    return np.where(tight, drift + rounding,
                    2 * len(deltas) * ADAM_STEP_MAX * LR), tight


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    """Two intra-op threads for this module's full-width CPU steps: the
    test run shares the machine's cores among its workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def full_step():
    """From the seeded state: one full step's loss, gradients and BN
    statistics in the JAX package (jitted, f32); the JAX package's own
    K_STEPS train steps (params, Adam's mu, nu and count after each); the
    port's K_STEPS steps (loss, ReLU branches, gradients, Adam's moments,
    params and BN statistics after each); and K_STEPS of Adam in float64
    on the port's patches with float64's own ReLU branches (``own``); and
    float64's step t from the port's state before it, along the port's
    ReLU branches of that step (``same``)."""
    wav, labels = _clips()
    params, _opt, _tx = jtrainer.init_full_train(2, seed=0,
                                                 learning_rate=LR)
    state = jax.tree.map(np.asarray, params)

    def fwd(p, w, y):
        patches = jlog_mel_patches(w, JFrontend())
        b, n = patches.shape[:2]
        emb, new = jyamnet.embed_train(
            p['yamnet_raw'], patches.reshape(b * n, *patches.shape[2:]))
        logits = jheads.apply_head(p['head'], emb.reshape(b, n, -1).mean(1))
        return jtrainer.bce_with_logits_loss(logits, y), new

    (j_loss, j_new), j_grads = jax.jit(jax.value_and_grad(
        fwd, has_aux=True))(params, jnp.asarray(wav), jnp.asarray(labels))

    j_params, j_opt, tx = jtrainer.init_full_train(2, seed=0,
                                                   learning_rate=LR)
    j_step = jtrainer.make_full_train_step(tx)
    j_steps = []
    for _ in range(K_STEPS):
        j_params, j_opt, loss = j_step(j_params, j_opt, jnp.asarray(wav),
                                       jnp.asarray(labels))
        adam = j_opt[0]
        # copied now: the next step donates these buffers
        j_steps.append((float(loss), jax.tree.map(
            np.array, (j_params, adam.mu, adam.nu, adam.count))))

    tparams, opt = train_state_from_numpy(state, learning_rate=LR)
    t_step = ttrainer.make_full_train_step(opt, tparams)
    t_steps = []
    for _ in range(K_STEPS):
        with _ReluMasks() as rec:
            loss = t_step(torch.from_numpy(wav), torch.from_numpy(labels))
        leaves = ttrainer.trainable_leaves(tparams)
        t_steps.append(dict(
            loss=float(loss), masks=rec.masks,
            g={p: t.grad.numpy().copy() for p, t in leaves},
            m={p: opt.state[t]['exp_avg'].numpy().copy() for p, t in leaves},
            v={p: opt.state[t]['exp_avg_sq'].numpy().copy()
               for p, t in leaves},
            p={p: t.detach().numpy().copy() for p, t in leaves},
            stats={p.split('.', 1)[1]: t.numpy().copy()
                   for p, t in flatten(tparams) if not t.requires_grad}))

    patches = log_mel_patches(torch.from_numpy(wav), FrontendConfig())
    patches = patches.reshape(len(wav), 96, 64).double()
    y64 = torch.from_numpy(labels).double()
    p = _trainable(state)
    m = v = {k: np.zeros_like(x) for k, x in p.items()}
    own, same = [], []
    for t, port in enumerate(t_steps, 1):
        # float64's own run, and float64's step t on the port's state
        # before it, along the port's ReLU branches
        own.append(_adam_step_f64(*(own[-1][k] for k in 'pmv')
                                  if own else (p, m, v), t, patches, y64))
        before = (t_steps[t - 2] if t > 1 else dict(p=p, m=m, v=v))
        same.append(_adam_step_f64(*(before[k] for k in 'pmv'), t, patches,
                                   y64, port['masks']))
    return dict(
        wav=wav, labels=labels, state=state, j_steps=j_steps,
        t_steps=t_steps, own=own, same=same,
        j_loss=float(j_loss), t_loss=t_steps[0]['loss'],
        j_grads=dict(flatten(jax.tree.map(np.asarray, j_grads))),
        t_grads=t_steps[0]['g'], g64=own[0]['g'],
        j_new={k: np.asarray(v) for k, v in j_new.items()},
        t_new=t_steps[0]['stats'])


# --- head-only training -------------------------------------------------------

def _head_data(n=100, seed=0):
    rng = np.random.default_rng(seed)
    emb = (rng.standard_normal((n, 1024)) * 0.5).astype(np.float32)
    labels = (rng.random((n, 3)) > 0.7).astype(np.float32)
    return emb, labels, np.array([1.0, 2.0, 0.5], np.float32)


def test_head_step_loss_and_gradients_match_jax():
    emb, labels, cw = _head_data(64)
    head = jheads.init_head(1024, 3, seed=4)

    def loss_fn(p, e, y):
        return jtrainer.bce_with_logits_loss(
            jheads.apply_head(p, e), y, jnp.asarray(cw))
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(
        {k: jnp.asarray(v) for k, v in head.items()}, jnp.asarray(emb),
        jnp.asarray(labels))
    params, _opt = train_state_from_numpy(head)
    loss = ttrainer.head_loss(params, torch.from_numpy(emb),
                              torch.from_numpy(labels), torch.from_numpy(cw))
    loss.backward()
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    worst = 0.0
    for k, t in params.items():
        ref = np.asarray(j_grads[k])
        err = float(np.abs(t.grad.numpy() - ref).max())
        assert err <= 1e-5 * np.abs(ref).max(), k
        worst = max(worst, err / np.abs(ref).max())
    print(f'loss |port - reference| = {abs(float(loss) - float(j_loss))}; '
          f'gradients max |port - reference| / max |g| = {worst}')


def test_train_head_three_epochs_matches_jax():
    """The same batches (remainder wrapped to the next shuffle) and the
    same init: losses and parameters after 3 epochs of 4 steps."""
    emb, labels, cw = _head_data()
    lr = 1e-3
    j_params, j_losses = jtrainer.train_head(
        emb, labels, epochs=3, batch_size=32, learning_rate=lr,
        class_weights=cw, seed=0)
    t_params, t_losses = ttrainer.train_head(
        emb, labels, epochs=3, batch_size=32, learning_rate=lr,
        class_weights=cw, seed=0, device='cpu')
    assert len(t_losses) == len(j_losses) == 12
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    k = len(t_losses)
    worst = 0.0
    for key in j_params:
        err = float(np.abs(t_params[key] - j_params[key]).max())
        assert err <= 2 * k * 1e-5 * lr, key
        worst = max(worst, err)
    print(f'params after {k} steps: max |port - reference| = {worst} '
          f'(bound {2 * k * 1e-5 * lr})')


# --- full-model fine-tuning ----------------------------------------------------

def test_full_step_loss_matches_jax(full_step):
    s = full_step
    print(f'loss: port {s["t_loss"]}, reference {s["j_loss"]}, max |port - '
          f'reference| = {abs(s["t_loss"] - s["j_loss"])}')
    assert s['t_loss'] == pytest.approx(s['j_loss'], rel=1e-5)


def test_full_step_gradients_match_jax_and_float64(full_step):
    s = full_step
    assert set(s['t_grads']) == set(s['j_grads']) - {
        p for p in s['j_grads'] if p.endswith(('bn_mean', 'bn_var'))}
    same = s['same'][0]
    edges = _branch_edges(same['zs'], s['t_steps'][0]['masks'])
    assert edges[1] <= Z_EDGE
    held = 0
    worst_vs_jax = worst_port = worst_jax = worst_same = 0.0
    for path, got in s['t_grads'].items():
        ref, exact = s['j_grads'][path], s['g64'][path]
        jax_err = _share(ref, exact, exact)
        port_err = _share(got, exact, exact)
        vs_jax = _share(got, ref, exact)
        vs_same = _share(got, same['g'][path], same['g'][path])
        worst_port, worst_jax = max(worst_port, port_err), max(worst_jax,
                                                               jax_err)
        worst_same = max(worst_same, vs_same)
        assert vs_same <= 1e-4, path
        assert port_err <= jax_err + 1e-4, path
        if jax_err <= 1e-4:
            held += 1
            worst_vs_jax = max(worst_vs_jax, vs_jax)
            assert vs_jax <= 1e-4, path
    print(f'{held} of {len(s["t_grads"])} leaves where the reference is '
          f'within 1e-4 of float64: max |port - reference| / max |g| = '
          f'{worst_vs_jax}; against float64, port {worst_port}, reference '
          f'{worst_jax}; against float64 on the port\'s ReLU branches '
          f'({edges[0]} differ, all at |z| <= {edges[1]:.3g}), port '
          f'{worst_same}')
    assert held >= 2   # the head at least


def test_full_step_bn_statistics_match_jax(full_step):
    s = full_step
    assert set(s['t_new']) == {p for p in s['j_new']
                               if p.endswith(('bn_mean', 'bn_var'))}
    worst = 0.0
    for k, got in s['t_new'].items():
        ref = s['j_new'][k]
        err = float(np.abs(got - ref).max())
        assert err <= 2e-6 * max(1.0, float(np.abs(ref).max())), k
        worst = max(worst, err)
    print(f'BN running statistics: max |port - reference| = {worst}')


def _jax_gradients(mus):
    """Each step's gradients of the JAX package's run, from its first
    moments: g_t = (mu_t - b1 mu_(t-1)) / (1 - b1), in float64."""
    out, prev = [], None
    for mu in mus:
        mu = {p: v.astype(np.float64) for p, v in flatten(mu)}
        out.append({p: (v - B1 * (0.0 if prev is None else prev[p]))
                    / (1 - B1) for p, v in mu.items()})
        prev = mu
    return out


def _held_tightly(tight, deltas, grads):
    """Where the two runs' gradients agree within 1e-4 of the leaf's max
    |g| at every step, ``_adam_drift`` must hold at least half the leaf
    tightly: its elements whose gradient is 1e-3 of the max and more."""
    agree = all(d <= 1e-4 * float(np.abs(g).max())
                for d, g in zip(deltas, grads))
    return not agree or tight.mean() >= 0.5


def test_full_steps_match_jax_after_k_steps(full_step):
    """K_STEPS Adam steps from the same state on the same batch, each
    package's own step. After every step, leaf by leaf:

    * the port against float64's step from the port's state before it,
      along the port's ReLU branches: gradients, exp_avg and exp_avg_sq
      within 1e-4, 1e-4 and 2e-4 of the leaf's max (f32 rounding; a square
      doubles a relative error), and the params element by element within
      one step's ``_adam_drift``;
    * exp_avg and exp_avg_sq against the JAX package's mu and nu: at
      least as close to float64's own run as the JAX package's, plus 1e-4
      / 2e-4, and where the JAX package is itself that close, within its
      distance plus 1e-4 / 2e-4 of the JAX package's;
    * the params against the JAX package's within ``_adam_drift`` of the
      k steps' gradient differences (the JAX package's from its mu).

    ``_adam_drift`` is tight wherever sqrt(v_hat) is 10 times the
    gradients' difference; elsewhere (a gradient at the level of that
    difference) it is the bound of any two Adam runs, 2 k 1.004 lr."""
    s = full_step
    j_grads = _jax_gradients([st[1][1] for st in s['j_steps']])
    worst = dict(g=0.0, m=0.0, v=0.0, p=0.0, m_jax=0.0, v_jax=0.0,
                 p_jax=0.0)
    tight = dict(p=[0, 0], p_jax=[0, 0])
    n_edges, edge = 0, 0.0
    for t in range(K_STEPS):
        port, same, own = s['t_steps'][t], s['same'][t], s['own'][t]
        j_params, mu, nu, count = s['j_steps'][t][1]
        assert int(count) == t + 1
        jm, jv, jp = (dict(flatten(x)) for x in (mu, nu, j_params))
        n, z = _branch_edges(same['zs'], port['masks'])
        assert z <= Z_EDGE, (t, z)
        n_edges, edge = n_edges + n, max(edge, z)
        for path, got in port['p'].items():
            where = f'step {t + 1} {path}'
            for key, tol in (('g', 1e-4), ('m', 1e-4), ('v', 2e-4)):
                err = _share(port[key][path], same[key][path],
                             same[key][path])
                assert err <= tol, (where, key, err)
                worst[key] = max(worst[key], err)
            for key, jax_leaf, tol in (('m', jm, 1e-4), ('v', jv, 2e-4)):
                exact = own[key][path]
                port_err = _share(port[key][path], exact, exact)
                jax_err = _share(jax_leaf[path], exact, exact)
                assert port_err <= jax_err + tol, (where, key)
                if jax_err <= tol:
                    vs_jax = _share(port[key][path], jax_leaf[path], exact)
                    assert vs_jax <= jax_err + tol, (where, key, vs_jax)
                    worst[f'{key}_jax'] = max(worst[f'{key}_jax'], vs_jax)
            nu_steps = [dict(flatten(st[1][2]))[path].astype(np.float64)
                        for st in s['j_steps'][:t + 1]]
            cases = (
                ('p', same['p'][path], [port['g'][path] - same['g'][path]],
                 [same['r'][path]], [same['g'][path]]),
                ('p_jax', jp[path],
                 [s['t_steps'][i]['g'][path] - j_grads[i][path]
                  for i in range(t + 1)],
                 [np.sqrt(x / (1 - B2 ** (i + 1)))
                  for i, x in enumerate(nu_steps)],
                 [j_grads[i][path] for i in range(t + 1)]))
            for name, ref, diffs, rs, grads in cases:
                deltas = [float(np.abs(d).max()) for d in diffs]
                bound, held = _adam_drift(deltas, rs, got)
                d = np.abs(got.astype(np.float64) - ref)
                assert np.all(d <= bound), (where, name,
                                            float((d / bound).max()))
                assert _held_tightly(held, deltas, grads), (where, name)
                worst[name] = max(worst[name], float(
                    (d / bound)[held].max(initial=0.0)))
                tight[name][0] += int(held.sum())
                tight[name][1] += held.size
    share = {k: a / b for k, (a, b) in tight.items()}
    print(f'{K_STEPS} steps. Against float64 on the port\'s state and ReLU '
          f'branches ({n_edges} differ, all at |z| <= {edge:.3g}): max '
          f'|port - reference| / leaf max, gradients {worst["g"]}, exp_avg '
          f'{worst["m"]}, exp_avg_sq {worst["v"]}; params at most '
          f'{worst["p"]:.3g} of their bound on the {share["p"]:.1%} of '
          f'elements held tightly. Against the JAX package: exp_avg '
          f'{worst["m_jax"]}, exp_avg_sq {worst["v_jax"]} where it is '
          f'held; params at most {worst["p_jax"]:.3g} of their bound on '
          f'the {share["p_jax"]:.1%} held tightly')


def test_train_state_from_numpy_continues_a_jax_run(full_step):
    """The JAX state after one step (params, Adam's mu, nu and count) taken
    into the port: Adam starts from those moments (bit for bit), its
    second step updates them with the port's gradients, and the params
    land where the JAX package's second step puts them, within
    ``_adam_drift`` of the two steps' gradient difference (a port that
    dropped the moments would move 0.74 lr instead of about lr)."""
    s = full_step
    params, mu, nu, count = s['j_steps'][0][1]
    tparams, opt = train_state_from_numpy(params, mu=mu, nu=nu,
                                          count=int(count), learning_rate=LR)
    mu1, nu1 = dict(flatten(mu)), dict(flatten(nu))
    leaves = ttrainer.trainable_leaves(tparams)
    for p, t in leaves:
        st = opt.state[t]
        assert float(st['step']) == 1.0
        np.testing.assert_array_equal(st['exp_avg'].numpy(), mu1[p])
        np.testing.assert_array_equal(st['exp_avg_sq'].numpy(), nu1[p])
    ttrainer.make_full_train_step(opt, tparams)(torch.from_numpy(s['wav']),
                                                torch.from_numpy(s['labels']))
    assert all(float(opt.state[t]['step']) == 2.0 for _p, t in leaves)
    _p2, mu2, nu2, _c = s['j_steps'][1][1]
    j_grad = _jax_gradients([mu, mu2])[1]
    nu2, ref = dict(flatten(nu2)), dict(flatten(s['j_steps'][1][1][0]))
    worst_m = worst = 0.0
    tight_n = size = 0
    for p, t in leaves:
        g = t.grad.numpy().astype(np.float64)
        m, v = (opt.state[t][k].numpy() for k in ('exp_avg', 'exp_avg_sq'))
        # the moments continue the imported ones: b1 mu + (1 - b1) g and
        # b2 nu + (1 - b2) g^2 of the port's own gradient, to f32 rounding
        want_m = B1 * mu1[p] + (1 - B1) * g
        want_v = B2 * nu1[p] + (1 - B2) * g * g
        for got, want, size_of in ((m, want_m, np.maximum(np.abs(mu1[p]),
                                                          np.abs(g))),
                                   (v, want_v, np.maximum(nu1[p], g * g))):
            err = np.abs(got - want)
            assert np.all(err <= 4 * np.spacing(size_of.astype(
                np.float32))), p
            worst_m = max(worst_m, float(err.max()))
        r = np.sqrt(nu2[p].astype(np.float64) / (1 - B2 ** 2))
        bound, tight = _adam_drift([float(np.abs(g - j_grad[p]).max())],
                                   [r], t.detach().numpy())
        d = np.abs(t.detach().numpy().astype(np.float64) - ref[p])
        assert np.all(d <= bound), (p, float((d / bound).max()))
        assert _held_tightly(tight, [float(np.abs(g - j_grad[p]).max())],
                             [j_grad[p]]), p
        worst = max(worst, float((d / bound)[tight].max(initial=0.0)))
        tight_n, size = tight_n + tight.sum(), size + tight.size
    print(f'second step: moments within {worst_m:.3g} of the imported ones '
          f'updated; params at most {worst:.3g} of their bound on the '
          f'{tight_n / size:.1%} of elements held tightly')


def test_full_train_checkpoint_resume_bit_identical(tmp_path):
    """Interrupted after 1 of 2 epochs (2 steps each, a remainder batch
    wrapped), resumed from the checkpoint: the same losses and bits."""
    from buzzdetect_torch.train.clips import train_full_model
    rng = np.random.default_rng(5)
    clips = (rng.standard_normal((5, 15600)) * 0.1).astype(np.float32)
    labels = (rng.random((5, 2)) > 0.5).astype(np.float32)
    kw = dict(batch_size=3, learning_rate=1e-3, log=lambda *_: None,
              device='cpu')
    gold = train_full_model(clips, labels, epochs=2, **kw)
    ckpt = str(tmp_path / 'work')
    train_full_model(clips, labels, epochs=1, checkpoint_dir=ckpt, **kw)
    assert os.path.exists(os.path.join(ckpt, 'finetune_ckpt.npz'))
    got = train_full_model(clips, labels, epochs=2, checkpoint_dir=ckpt,
                           **kw)
    assert got[2] == gold[2]
    for g, r in zip(got[:2], gold[:2]):
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    print('max |resumed - uninterrupted| = 0.0')


def test_train_checkpoint_rejects_foreign_and_ahead_state(tmp_path):
    """A checkpoint of another seed, a garbage file and one ahead of the
    requested epochs are each ignored: the run trains fresh."""
    from buzzdetect_torch.train.clips import train_full_model
    rng = np.random.default_rng(5)
    clips = (rng.standard_normal((2, 15600)) * 0.1).astype(np.float32)
    labels = (rng.random((2, 2)) > 0.5).astype(np.float32)
    kw = dict(batch_size=2, learning_rate=1e-3, log=lambda *_: None,
              device='cpu')
    ckpt = str(tmp_path / 'work')
    path = os.path.join(ckpt, 'finetune_ckpt.npz')
    train_full_model(clips, labels, epochs=2, seed=0, checkpoint_dir=ckpt,
                     **kw)
    gold = {seed: train_full_model(clips, labels, epochs=1, seed=seed, **kw)
            for seed in (0, 1)}
    for seed in (0, 1):   # a checkpoint ahead (2 > 1), then a foreign seed
        got = train_full_model(clips, labels, epochs=1, seed=seed,
                               checkpoint_dir=ckpt, **kw)
        assert got[2] == gold[seed][2]
        for k in gold[seed][0]:
            np.testing.assert_array_equal(got[0][k], gold[seed][0][k])
    with open(path, 'wb') as f:
        f.write(b'not an npz at all')
    got = train_full_model(clips, labels, epochs=1, seed=1,
                           checkpoint_dir=ckpt, **kw)
    assert got[2] == gold[1][2]
    print('max |port - fresh run| = 0.0')


def test_checkpoint_layout_matches_jax(tmp_path):
    """The port writes the JAX package's npz layout, and a JAX checkpoint
    resumes in the port: one JAX epoch, then the port's second."""
    from buzzdetect_tpu.train.clips import train_full_model as j_train
    from buzzdetect_torch.train.clips import train_full_model as t_train
    rng = np.random.default_rng(5)
    clips = (rng.standard_normal((2, 15600)) * 0.1).astype(np.float32)
    labels = (rng.random((2, 2)) > 0.5).astype(np.float32)
    kw = dict(batch_size=2, learning_rate=1e-3, log=lambda *_: None)
    j_dir, t_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    j_train(clips, labels, epochs=1, checkpoint_dir=j_dir, **kw)
    t_train(clips, labels, epochs=1, checkpoint_dir=t_dir, device='cpu',
            **kw)
    metas = []
    for d in (j_dir, t_dir):
        with np.load(os.path.join(d, 'finetune_ckpt.npz')) as z:
            meta = json.loads(bytes(z['meta_json']).decode())
            shapes = {k: z[k].shape for k in z.files if k != 'meta_json'}
        metas.append((shapes, {k: meta[k] for k in
                               ('epoch', 'n_p', 'n_o', 'fingerprint')}))
    assert metas[0] == metas[1]
    log = []
    t_train(clips, labels, epochs=2, checkpoint_dir=j_dir, device='cpu',
            log=log.append, batch_size=2, learning_rate=1e-3)
    assert any('resuming fine-tune' in line for line in log)
    print(f'{len(metas[0][0])} arrays in both layouts; max |port - '
          f'reference| = 0 (shapes and meta equal)')


def test_training_on_cuda_without_a_card_raises():
    from buzzdetect_torch.train.clips import train_full_model
    emb, labels, _cw = _head_data(8)
    with pytest.raises(RuntimeError, match='CUDA'):
        ttrainer.train_head(emb, labels)
    with pytest.raises(RuntimeError, match='CUDA'):
        train_full_model(*_clips(2))
    print('max |port - reference| = n/a (refusals)')


# --- the copied host modules ---------------------------------------------------

@pytest.mark.parametrize('case', ['clip_spans', 'frames_to_labels',
                                  'translate_labels', 'class_weights',
                                  'threshold_sweep', 'metrics_csv'])
def test_host_helpers_match_jax(tmp_path, case):
    mods = {}
    for pkg in ('buzzdetect_tpu', 'buzzdetect_torch'):
        m = {n: importlib.import_module(f'{pkg}.train.{n}') for n in
             ('clips', 'annotations', 'data', 'evaluate')}
        if case == 'clip_spans':
            out = m['clips'].clip_spans(
                [(1.0, 3.0, 'bee'), (5.0, 5.05, 'tick')], duration=10.0,
                clip_seconds=0.975, negatives_per_positive=1.0, seed=3)
        elif case == 'frames_to_labels':
            out = m['annotations'].frames_to_labels(
                np.arange(10) * 0.96, [(1.0, 2.5, 'bee'), (5.0, 5.05, 'h')],
                ['ins_buzz', 'h'], translation={'bee': 'ins_buzz'})
        elif case == 'translate_labels':
            out = m['data'].translate_labels([['bee'], [], ['car', 'bee']],
                                             {'bee': 'ins_buzz', 'car': None},
                                             ['ins_buzz', 'mech_auto'])
        elif case == 'class_weights':
            out = m['data'].class_weights_from_counts([10, 100, 0, 5])
        elif case == 'threshold_sweep':
            rng = np.random.default_rng(1)
            out = m['evaluate'].threshold_sweep(rng.normal(size=200),
                                                rng.random(200) > 0.7)
        else:
            metrics = {'threshold': np.array([-1.0, 0.5]),
                       'precision': np.array([0.5, 0.75]),
                       'sensitivity': np.array([1.0, 0.5]),
                       'fpr': np.array([0.5, 0.1])}
            path = m['evaluate'].write_metrics_csv(
                str(tmp_path / pkg / 'metrics.csv'), metrics)
            out = open(path).read()
        mods[pkg] = out
    got, ref = mods['buzzdetect_torch'], mods['buzzdetect_tpu']
    if isinstance(ref, dict):
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref
    print(f'{case}: max |port - reference| = 0.0')


# --- corpus embedding, rescoring and the tools ---------------------------------

CLASSES = ['ins_buzz', 'ambient_noise', 'human']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """A seeded bundle and three recordings (one in a subdirectory, one
    longer than a chunk), embedded by each package at chunklength 1.92."""
    from buzzdetect_tpu import config as jcfg
    from buzzdetect_tpu.models.convert import build_model_bundle
    from buzzdetect_tpu.train.embed_corpus import embed_directory as j_embed
    from buzzdetect_torch import config as tcfg
    from buzzdetect_torch.train.embed_corpus import embed_directory as t_embed
    root = tmp_path_factory.mktemp('corpus')
    models = root / 'models'
    build_model_bundle(str(models / 'scoremodel'), classes=CLASSES, seed=7)
    audio = root / 'audio'
    (audio / 'sub').mkdir(parents=True)
    write_wav(audio / 'a.wav', make_tone(4.0, 16000, 220), 16000)
    write_wav(audio / 'sub' / 'b.wav', make_tone(3.0, 16000, 440), 16000)
    write_wav(audio / 'c.wav', (np.random.default_rng(2).standard_normal(
        5 * 16000) * 0.05).astype(np.float32), 16000)
    saved = jcfg.DIR_MODELS, tcfg.DIR_MODELS
    jcfg.DIR_MODELS = tcfg.DIR_MODELS = str(models)
    try:
        j_embed(str(audio), str(root / 'emb_jax'), modelname='scoremodel',
                chunklength=1.92, log=lambda *_: None)
        t_embed(str(audio), str(root / 'emb_port'), modelname='scoremodel',
                chunklength=1.92, log=lambda *_: None, device='cpu')
    finally:
        jcfg.DIR_MODELS, tcfg.DIR_MODELS = saved
    return root


class _FoldedF64:
    """A classifier whose ``embed`` is the folded conv stack in float64
    with plain ``F.conv2d``, on the port classifier's own wire samples and
    f32 log-mel patches: the referee for both packages' f32 conv stacks."""

    def __init__(self, arrays, classifier):
        raw = {k.split('/', 1)[1]: v for k, v in arrays.items()
               if k.startswith('yamnet_raw/')}
        self.folded = {k: torch.from_numpy(np.asarray(v, np.float64))
                       for k, v in jyamnet.fold_batchnorm(raw).items()}
        self.port = classifier
        self.cfg = classifier.cfg

    def embed(self, samples):
        from buzzdetect_torch.ops.frontend import num_patches, padded_length
        n = len(samples)
        wav = torch.from_numpy(self.port.to_wire(samples)).float() / 32768
        wav = F.pad(wav, (0, padded_length(n, self.cfg) - n))
        x = log_mel_patches(wav, self.cfg)[:, None].double()
        for key, kind, stride, _shape in jyamnet._conv_shapes():
            k = self.folded[f'{key}/kernel'].permute(3, 2, 0, 1)
            ph = same_pad(x.shape[2], stride, k.shape[-1])
            pw = same_pad(x.shape[3], stride, k.shape[-1])
            x = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), k,
                         stride=stride,
                         groups=x.shape[1] if kind == 'depthwise' else 1)
            x = torch.relu(x + self.folded[f'{key}/bias'][:, None, None])
        return x.mean(dim=(2, 3)).numpy()[:num_patches(n, self.cfg)]


def test_embed_directory_matches_jax(corpus, monkeypatch):
    from buzzdetect_torch import config as tcfg
    from buzzdetect_torch.models.registry import load_model
    from buzzdetect_torch.train.embed_corpus import embed_file, \
        load_embeddings
    monkeypatch.setattr(tcfg, 'DIR_MODELS', str(corpus / 'models'))
    model = load_model('scoremodel', initialize=True, device='cpu')
    with np.load(corpus / 'models' / 'scoremodel' / 'model.npz') as z:
        referee = _FoldedF64({k: z[k] for k in z.files}, model.classifier)
    names = sorted(os.path.relpath(os.path.join(b, f), corpus / 'emb_jax')
                   for b, _d, fs in os.walk(corpus / 'emb_jax') for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(b, f),
                                           corpus / 'emb_port')
                           for b, _d, fs in os.walk(corpus / 'emb_port')
                           for f in fs)
    worst = {'port - reference': 0.0, 'port - float64': 0.0,
             'reference - float64': 0.0}
    for name in names:
        if not name.endswith('_embeddings.npz'):
            continue
        s_ref, e_ref = load_embeddings(str(corpus / 'emb_jax' / name))
        s_got, e_got = load_embeddings(str(corpus / 'emb_port' / name))
        s_64, e_64 = embed_file(referee, str(
            corpus / 'audio' / name.replace('_embeddings.npz', '.wav')),
            chunklength=1.92)
        np.testing.assert_array_equal(s_got, s_ref)
        np.testing.assert_array_equal(s_got, s_64)
        assert s_got.dtype == np.float64 and e_got.shape == e_ref.shape
        tol = 1e-5 * float(np.abs(e_64).max())
        errs = {'port - reference': float(np.abs(e_got - e_ref).max()),
                'port - float64': float(np.abs(e_got - e_64).max()),
                'reference - float64': float(np.abs(e_ref - e_64).max())}
        assert errs['port - float64'] <= tol, name
        assert errs['port - reference'] <= errs['reference - float64'] \
            + tol, name
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
    print(f'{len(names) - 1} files: max |port - reference| = '
          f'{worst["port - reference"]}; against float64: port '
          f'{worst["port - float64"]}, reference '
          f'{worst["reference - float64"]}')


def test_embed_file_reads_streamer_sample_spans(tmp_path):
    """int(t1*rate) - int(t0*rate) samples per chunk, as the streamer
    reads them: 1.13 s at chunklength 0.96 reads 15360 then 2720."""
    from buzzdetect_torch.train.embed_corpus import embed_file
    wav = tmp_path / 'odd.wav'
    write_wav(wav, make_tone(1.13, 16000), 16000)
    reads = []

    class Capturing:
        cfg = FrontendConfig()

        def embed(self, samples):
            reads.append(len(samples))
            return np.zeros((max(1, len(samples) // 15360), 1024),
                            np.float32)

    embed_file(Capturing(), str(wav), chunklength=0.96)
    assert reads == [15360, 2720]
    print('max |port - reference| = 0 (sample spans equal)')


def _csvs(d):
    return {os.path.relpath(os.path.join(b, f), d): open(
        os.path.join(b, f), 'rb').read()
        for b, _dirs, fs in os.walk(d) for f in fs if f.endswith('.csv')}


def test_score_embeddings_matches_analyze_and_jax(corpus, tmp_path,
                                                  monkeypatch):
    """The port's rescored CSVs are byte-identical to the port's own
    analyze() at the same chunklength, and equal to the JAX package's
    rescored CSVs after their 2-digit rounding."""
    import buzzdetect_torch
    from buzzdetect_torch import config as tcfg
    from buzzdetect_tpu import config as jcfg
    monkeypatch.setattr(tcfg, 'DIR_MODELS', str(corpus / 'models'))
    monkeypatch.setattr(jcfg, 'DIR_MODELS', str(corpus / 'models'))
    buzzdetect_torch.analyze(modelname='scoremodel',
                             dir_audio=str(corpus / 'audio'),
                             dir_out=str(tmp_path / 'golden'),
                             chunklength=1.92, verbosity_print='ERROR',
                             device='cpu')
    outs = {}
    for pkg, emb in (('buzzdetect_torch', 'emb_port'),
                     ('buzzdetect_tpu', 'emb_jax')):
        argv = ['--dir_embeddings', str(corpus / emb), '--modelname',
                'scoremodel', '--dir_out', str(tmp_path / pkg)]
        if pkg == 'buzzdetect_torch':
            argv += ['--device', 'cpu']
        code, out, err = run_tool(pkg, 'score_embeddings', argv)
        assert code == 0, err
        outs[pkg] = _csvs(tmp_path / pkg)
    golden = _csvs(tmp_path / 'golden')
    assert set(golden) == set(outs['buzzdetect_torch']) == {
        'a_buzzdetect.csv', 'c_buzzdetect.csv',
        os.path.join('sub', 'b_buzzdetect.csv')}
    for name, data in golden.items():
        assert outs['buzzdetect_torch'][name] == data, name
    worst = 0.0
    for name, data in outs['buzzdetect_tpu'].items():
        got = np.genfromtxt(io_lines(outs['buzzdetect_torch'][name]),
                            delimiter=',', skip_header=1)
        ref = np.genfromtxt(io_lines(data), delimiter=',', skip_header=1)
        worst = max(worst, float(np.abs(got - ref).max()))
        assert outs['buzzdetect_torch'][name] == data, name
    print(f'{len(golden)} CSVs byte-identical to analyze(); against the '
          f'reference: max |port - reference| = {worst} after rounding')


def io_lines(data):
    import io
    return io.StringIO(data.decode())


def test_embed_corpus_tool_and_settings_pin(corpus, tmp_path, monkeypatch):
    from buzzdetect_torch import config as tcfg
    monkeypatch.setattr(tcfg, 'DIR_MODELS', str(corpus / 'models'))
    argv = ['--dir_audio', str(corpus / 'audio' / 'a.wav'), '--dir_out',
            str(tmp_path / 'emb'), '--modelname', 'scoremodel',
            '--device', 'cpu', '--chunklength', '1.92']
    code, out, err = run_tool('buzzdetect_torch', 'embed_corpus', argv)
    assert code == 0 and 'embedded 1 new file(s)' in out, err
    again = run_tool('buzzdetect_torch', 'embed_corpus', argv)
    assert again[0] == 0 and 'embedded 0 new file(s)' in again[1]
    clash = run_tool('buzzdetect_torch', 'embed_corpus',
                     argv + ['--framehop', '0.5'])
    assert clash[0] == 1 and 'conflicts' in clash[2]
    with np.load(corpus / 'emb_port' / 'a_embeddings.npz') as z, \
            np.load(tmp_path / 'emb' / 'a_embeddings.npz') as y:
        np.testing.assert_array_equal(y['embeddings'], z['embeddings'])
    print('max |tool - embed_directory| = 0.0')


def _train_corpus(root):
    audio = root / 'corpus'
    audio.mkdir()
    write_wav(audio / 'buzzy.wav', make_tone(4.0, 16000, 220), 16000)
    write_wav(audio / 'quiet.wav',
              (np.random.default_rng(1).standard_normal(4 * 16000) * 0.02
               ).astype(np.float32), 16000)
    ann = root / 'events.csv'
    ann.write_text('ident,start,end,label\nbuzzy,0,4,ins_buzz\n')
    return audio, ann


@pytest.mark.parametrize('full', [False, True])
def test_train_model_tool_bundle_loads_in_jax(tmp_path, monkeypatch, full):
    """The tool end to end on the CPU, head-only (5 epochs) and --full (2
    epochs): the bundle it writes loads in the JAX registry, whose scores
    are within 1e-3 of the port's on the same audio."""
    from buzzdetect_tpu import config as jcfg
    from buzzdetect_tpu.models.convert import build_model_bundle
    from buzzdetect_tpu.models.registry import load_model as j_load
    from buzzdetect_torch import config as tcfg
    from buzzdetect_torch.models.registry import load_model as t_load
    models = tmp_path / 'models'
    build_model_bundle(str(models / 'base'), classes=['x'], seed=2)
    monkeypatch.setattr(tcfg, 'DIR_MODELS', str(models))
    monkeypatch.setattr(jcfg, 'DIR_MODELS', str(models))
    audio, ann = _train_corpus(tmp_path)
    argv = ['--name', 'trained', '--dir-audio', str(audio), '--annotations',
            str(ann), '--classes', 'ins_buzz', 'ambient_background',
            '--base-model', 'base', '--holdout', '0', '--device', 'cpu',
            '--no-report', '--epochs', '2' if full else '5']
    code, out, err = run_tool('buzzdetect_torch', 'train_model',
                              argv + (['--full'] if full else []))
    assert code == 0, out + err
    assert 'wrote' in out and '(' in out   # stage wall times printed
    tone = make_tone(2.0, 16000, 220)
    ref = j_load('trained', initialize=True).predict(tone)
    got = t_load('trained', initialize=True, device='cpu').predict(tone)
    assert got.shape == ref.shape == (3, 2)
    err = float(np.abs(got - ref).max())
    print(f'{"--full" if full else "head-only"}: scores max |port - '
          f'reference| = {err}')
    assert err <= 1e-3


def test_train_model_tool_argument_rules(tmp_path):
    code, _out, err = run_tool(
        'buzzdetect_torch', 'train_model',
        ['--name', 'x', '--dir-audio', str(tmp_path), '--annotations',
         str(tmp_path / 'a.csv'), '--classes', 'a', '--augment'])
    assert code == 2 and '--augment requires --full' in err
    print('max |port - reference| = n/a (parser error)')


def test_evaluate_model_on_clips_matches_jax(corpus, monkeypatch):
    """Clips batched through each package's ChunkClassifier
    (predict_async_batch for equal lengths, predict_async for the odd
    one): the sweep's rows agree."""
    from buzzdetect_tpu import config as jcfg
    from buzzdetect_tpu.models.registry import load_model as j_load
    from buzzdetect_tpu.train.evaluate import \
        evaluate_model_on_clips as j_eval
    from buzzdetect_torch import config as tcfg
    from buzzdetect_torch.models.registry import load_model as t_load
    from buzzdetect_torch.train.evaluate import \
        evaluate_model_on_clips as t_eval
    monkeypatch.setattr(tcfg, 'DIR_MODELS', str(corpus / 'models'))
    monkeypatch.setattr(jcfg, 'DIR_MODELS', str(corpus / 'models'))
    rng = np.random.default_rng(3)
    clips = [make_tone(1.0, 16000, 220 + 30 * i) * (i % 2)
             + (rng.standard_normal(16000) * 0.05).astype(np.float32)
             for i in range(6)] + [make_tone(2.0, 16000, 300)]
    labels = np.zeros((7, 3), np.float32)
    labels[1::2, 0] = 1
    ref = j_eval(j_load('scoremodel', initialize=True).classifier, clips,
                 labels, CLASSES)
    got = t_eval(t_load('scoremodel', initialize=True,
                        device='cpu').classifier, clips, labels, CLASSES)
    worst = 0.0
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-12)
        worst = max(worst, float(np.abs(got[k] - ref[k]).max()))
    print(f'{len(ref["threshold"])} rows: max |port - reference| = {worst}')
