"""tests/test_pallas_conv.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions, every run on the CPU). Edits:

* each kernel case runs the port's kernel function on CPU tensors (its
  wrapper runs the plain version there) and holds it, as the JAX case does,
  against the port's XLA conv path (``models/yamnet._conv_same`` on OIHW
  kernels, ``embed_xla``); it also runs the JAX case's own function on the
  same numpy input (Pallas in interpret mode), prints max |port - JAX| and
  holds it to the JAX case's tolerance;
* ``block_patches``, ``block_packed`` and ``PALLAS_BLOCKS`` size the TPU
  kernel's blocks; the card's kernels have no such knob, so the port's
  calls leave them out (the JAX side keeps them);
* the packed front: the port's ``fused_front`` takes layer 1's unpacked
  output (``yamnet.layer1``), where the JAX one takes ``packed_l1``'s;
* ``_split_hi_lo`` is ``sepconv.pack_pointwise(w, 'high')``;
* the conv-'auto' rule is ``classifier.resolve_conv``: 'auto' runs the hand
  kernels at every compute dtype and 'xla' under a mesh;
* the execution-target rule: the port runs where ``device=`` says (no
  ambient default, no device list), and on the CPU its kernel functions run
  their plain versions, so a CPU reference classifier cannot reach a kernel;
* the conv-auto compile fallback: the port has none that hides a kernel,
  so the twin asserts the loud failure for 'auto' and explicit 'pallas';
* meshes repeat the CPU 8 times (the JAX tests count 8 virtual devices).

The JAX package's packed-front knob (a module dict and its environment
variable) picks one of three routes through its kernels; the port has one
route, the JAX package's default, and reads no knob. So the twins of the
knob's parsing, validation and lane-split rule have none, and the
whole-embed twin runs the default route alone. The port's own case,
``test_embed_route_matches_xla``, runs the embed in each mode, checks
which kernel functions it calls, directly and through a classifier, and
holds it against ``conv='xla'``.

The JAX package's docstring:

Fused Pallas conv tail: parity with the XLA sep-conv stack.

Interpreter mode on the CPU test mesh here; compiled-mode attestation on real
hardware lives in tools/pallas_conv_tpu_probe.py (results in docs/tuning.md).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from buzzdetect_tpu.models import yamnet as jyam
from buzzdetect_tpu.ops import pallas_conv as jpc
from buzzdetect_torch.models import yamnet as yam
from buzzdetect_torch.models.weights import params_from_numpy
from buzzdetect_torch.ops import sepconv
from buzzdetect_torch.ops.sepconv import fused_tail, tail_specs

RNG = np.random.default_rng(11)


def _params(seed, mode='highest'):
    """(numpy folded params for the JAX side, the port's tensors packed
    for ``mode``)."""
    folded = yam.fold_batchnorm(yam.init_raw_params(seed=seed))
    return folded, sepconv.pack_params(params_from_numpy(folded)['yamnet'],
                                       mode)


def _against_jax(name, got, ref, atol=2e-4, rtol=1e-5):
    """Print max |port - JAX| and hold it to the JAX case's tolerance."""
    got, ref = np.asarray(got), np.asarray(ref)
    print(f'{name}: max |port - JAX| = {np.abs(got - ref).max():.3g}')
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def _conv(x, params, key, kind, stride, shape):
    kernel = yam._xla_kernel(params, key, kind, shape, False)
    groups = x.shape[1] if kind == 'depthwise' else 1
    return torch.relu(yam._conv_same(x, kernel, stride, groups)
                      + params[f'{key}/bias'][:, None, None])


def xla_tail(params, x, start_layer=8, stop_layer=None, gap=True):
    """Reference: the same layers run through the port's XLA conv path
    (NHWC in, NHWC out)."""
    shapes = {key: (kind, stride, shape)
              for key, kind, stride, shape in yam._conv_shapes()}
    x = torch.as_tensor(x).permute(0, 3, 1, 2)
    for s in tail_specs(start_layer, stop_layer):
        for part in ('depthwise_conv', 'pointwise_conv'):
            key = f'{s.name}/{part}'
            x = _conv(x, params, key, *shapes[key])
    x = x.permute(0, 2, 3, 1)
    return x.mean(dim=(1, 2)) if gap else x


def xla_layers(params, patches, stop_layer):
    """Reference: the layers before ``stop_layer`` through the port's XLA
    conv path (NCHW out)."""
    x = torch.from_numpy(patches)[:, None]
    for key, kind, stride, shape in yam._conv_shapes():
        if int(key.split('/')[0][len('layer'):]) < stop_layer:
            x = _conv(x, params, key, kind, stride, shape)
    return x


def tail_input(b, start_layer=8, seed=3):
    s0 = tail_specs(start_layer)[0]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s0.h, s0.w, s0.c_in)).astype(np.float32)


def _jax_tail(folded, x, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jpc.fused_tail(folded, jnp.asarray(x),
                                         block_patches=4, interpret=True,
                                         **kw))


@pytest.mark.parametrize('start_layer', [8, 13])
def test_fused_tail_matches_xla(start_layer):
    folded, params = _params(7)
    x = tail_input(5, start_layer)
    ref = xla_tail(params, x, start_layer).numpy()
    got = fused_tail(params, torch.from_numpy(x),
                     start_layer=start_layer).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)
    _against_jax(f'fused_tail({start_layer})', got,
                 _jax_tail(folded, x, start_layer=start_layer))


def test_fused_tail_emulated_high_tracks_f32():
    """Precision.HIGH inside the kernel: the port's 'high' mode computes the
    JAX package's emulated HIGH (``_pw_dot``: hi/lo bf16 operand splits and
    the same three one-pass products). The result must track the exact-f32
    reference to ~HIGH-grade error (far tighter than bf16), and the hi/lo
    weight split (``pack_pointwise(w, 'high')``, the port's
    ``_split_hi_lo``) must be byte-neutral (2xbf16 = 1xf32)."""
    folded, params = _params(7, 'high')
    x = tail_input(5, 8)
    ref = xla_tail(params, x, 8).numpy()
    got = fused_tail(params, torch.from_numpy(x), start_layer=8,
                     mode='high').numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    _against_jax('fused_tail(8) HIGH', got,
                 _jax_tail(folded, x, start_layer=8,
                           precision=jax.lax.Precision.HIGH),
                 atol=1e-4, rtol=1e-4)
    # the split reconstructs the weight to ~16 mantissa bits and carries
    # the same bytes as the f32 original
    w = torch.from_numpy(RNG.standard_normal((64, 128)).astype(np.float32))
    s = sepconv.pack_pointwise(w, 'high')
    assert s.dtype == torch.bfloat16 and tuple(s.shape) == (2, 64, 128)
    recon = s[0].to(torch.float32) + s[1].to(torch.float32)
    np.testing.assert_allclose(recon.numpy(), w.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_embed_high_precision_pallas_tracks_xla():
    """The product wiring: embed(conv='pallas', conv_precision='high')
    reaches the emulated-HIGH kernels on the front and the tail, staying
    at HIGH-grade distance from the f32 oracle."""
    folded, params = _params(7, 'high')
    patches = RNG.standard_normal((8, 96, 64)).astype(np.float32) * 0.5
    ref = yam.embed(yam.pack_xla(params), torch.from_numpy(patches),
                    conv='xla').numpy()
    got = yam.embed(params, torch.from_numpy(patches), conv='pallas',
                    conv_precision='high').numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    with pltpu.force_tpu_interpret_mode():
        jref = np.asarray(jyam.embed(folded, jnp.asarray(patches),
                                     conv='pallas', conv_precision='high'))
    _against_jax('embed pallas HIGH', got, jref, atol=1e-4, rtol=1e-4)


def test_fused_tail_bf16_compiles_and_tracks_f32():
    """bf16 compute: the kernel keeps the depthwise work f32 and runs only
    the pointwise products on bf16 operands, so its output tracks the f32
    reference within bf16 rounding."""
    folded, params = _params(7, 'bf16')
    x = tail_input(4, 13)
    ref = xla_tail(params, x, 13).numpy()
    got = fused_tail(params, torch.from_numpy(x), start_layer=13,
                     mode='bf16')
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=0.02)
    _against_jax('fused_tail(13) bf16', got.numpy(),
                 _jax_tail(folded, x, start_layer=13,
                           compute_dtype=jnp.bfloat16), atol=0.02, rtol=0)


def test_fused_tail_no_gap_and_padding():
    """gap=False returns the last layer's activations; a batch of 3 (not a
    multiple of the JAX side's block_patches=4) still yields exactly 3
    rows."""
    folded, params = _params(7)
    x = tail_input(3, 13)
    ref = xla_tail(params, x, 13, gap=False).numpy()
    got = fused_tail(params, torch.from_numpy(x), start_layer=13,
                     gap=False).numpy()
    assert got.shape == (3, ref.shape[1] * ref.shape[2], ref.shape[3])
    np.testing.assert_allclose(
        got, ref.reshape(got.shape), atol=2e-4, rtol=1e-5)
    _against_jax('fused_tail(13, gap=False)', got,
                 _jax_tail(folded, x, start_layer=13, gap=False))


def test_fused_mid_block_matches_xla():
    """The layers-4..7 block (stop_layer) matches XLA, flattened-spatial out."""
    folded, params = _params(7)
    s0 = tail_specs(4, 8)[0]
    x = RNG.standard_normal((5, s0.h, s0.w, s0.c_in)).astype(np.float32)
    ref = xla_tail(params, x, 4, 8, gap=False).numpy()
    got = fused_tail(params, torch.from_numpy(x), start_layer=4,
                     stop_layer=8, gap=False).numpy()
    assert got.shape == (5, ref.shape[1] * ref.shape[2], ref.shape[3])
    np.testing.assert_allclose(
        got, ref.reshape(got.shape), atol=2e-4, rtol=1e-5)
    _against_jax('fused_tail(4, 8)', got,
                 _jax_tail(folded, x, start_layer=4, stop_layer=8, gap=False))


def test_two_block_embed_matches_xla(monkeypatch):
    """embed(conv='pallas') matches the all-XLA embed. The JAX case sets
    ``PALLAS_BLOCKS`` (TPU block sizes, no counterpart here) on its side."""
    folded, params = _params(9)
    patches = RNG.standard_normal((5, 96, 64)).astype(np.float32) * 0.5
    ref = yam.embed(yam.pack_xla(params), torch.from_numpy(patches),
                    conv='xla').numpy()
    got = yam.embed(params, torch.from_numpy(patches),
                    conv='pallas').numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)
    monkeypatch.setattr(jyam, 'PALLAS_BLOCKS', ((4, 8, 4), (8, None, 4)))
    with pltpu.force_tpu_interpret_mode():
        jref = np.asarray(jyam.embed(folded, jnp.asarray(patches),
                                     conv='pallas'))
    _against_jax('embed pallas', got, jref)


def test_tail_specs_validation():
    with pytest.raises(ValueError, match='empty layer range'):
        tail_specs(8, 8)
    with pytest.raises(ValueError, match='not a sep layer'):
        tail_specs(1, 3)
    specs = tail_specs(4, 8)
    assert [s.index for s in specs] == [4, 5, 6, 7]
    assert (specs[0].h, specs[0].w, specs[0].c_in) == (24, 16, 128)
    assert (specs[-1].h_out, specs[-1].w_out, specs[-1].c_out) == (6, 4, 512)


def test_fused_tail_whole_model_parity():
    """Full embed with the tail swapped in matches embed() end to end."""
    folded, params = _params(9)
    patches = RNG.standard_normal((4, 96, 64)).astype(np.float32) * 0.5
    ref = yam.embed(yam.pack_xla(params), torch.from_numpy(patches),
                    conv='xla').numpy()

    # run layers 1-7 through the XLA path, then the fused tail
    x = xla_layers(params, patches, 8).permute(0, 2, 3, 1).contiguous()
    got = fused_tail(params, x, start_layer=8).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)
    _against_jax('fused_tail(8) after XLA layers 1-7', got,
                 _jax_tail(folded, x.numpy(), start_layer=8))


def _bundle_arrays(seed=6, n_classes=3):
    from buzzdetect_torch.models.heads import init_head
    folded = yam.fold_batchnorm(yam.init_raw_params(seed=seed))
    arrays = {f'yamnet/{k}': v for k, v in folded.items()}
    arrays.update(init_head(1024, n_classes, seed=seed))
    return arrays


def test_classifier_conv_pallas_matches_xla():
    """ChunkClassifier(conv='pallas') scores match conv='xla' on the single,
    batch, and embed paths (the plain versions on the CPU), and the JAX
    classifier's conv='pallas' (interpret mode) on the same input."""
    from buzzdetect_tpu.models.classifier import ChunkClassifier as JClf
    from buzzdetect_torch.models.classifier import ChunkClassifier
    arrays = _bundle_arrays()
    wav = (RNG.standard_normal(int(3.0 * 16000)) * 0.1).astype(np.float32)
    wav2 = (RNG.standard_normal(int(3.0 * 16000)) * 0.1).astype(np.float32)

    ref_cls = ChunkClassifier(arrays, framehop_prop=1.0, conv='xla',
                              device='cpu')
    pl_cls = ChunkClassifier(arrays, framehop_prop=1.0, conv='pallas',
                             device='cpu')
    assert pl_cls.conv == 'pallas'

    got = pl_cls.predict(wav)
    np.testing.assert_allclose(got, ref_cls.predict(wav), atol=1e-4)
    got_b, nv = pl_cls.predict_async_batch([wav, wav2])
    ref_b, _ = ref_cls.predict_async_batch([wav, wav2])
    np.testing.assert_allclose(np.asarray(got_b.cpu()),
                               np.asarray(ref_b.cpu()), atol=1e-4)
    got_e = pl_cls.embed(wav)
    np.testing.assert_allclose(got_e, ref_cls.embed(wav), atol=1e-4)

    jclf = JClf(arrays, framehop_prop=1.0, conv='pallas')
    with pltpu.force_tpu_interpret_mode():
        _against_jax('classifier predict', got, jclf.predict(wav),
                     atol=1e-4, rtol=0)
        _against_jax('classifier embed', got_e, jclf.embed(wav),
                     atol=1e-4, rtol=0)


def test_conv_auto_resolution_rule():
    """The port's 'auto' rule (``resolve_conv``): the hand kernels at every
    compute dtype (the card has no Mosaic limit on 16-bit vectors, so the
    JAX package's bf16 -> 'xla' rule does not apply; the classifier resolves
    the dtype separately); 'xla' under a mesh or sharding."""
    from buzzdetect_torch.models.classifier import (ChunkClassifier,
                                                    resolve_conv)
    from buzzdetect_torch.parallel.mesh import data_sharding, make_mesh
    assert resolve_conv('auto') == 'pallas'
    assert ChunkClassifier(_bundle_arrays(), compute_dtype=torch.bfloat16,
                           device='cpu').conv == 'pallas'
    assert resolve_conv('xla') == 'xla'
    mesh = make_mesh(devices=['cpu'] * 8, device='cpu')
    assert resolve_conv('auto', mesh=object()) == 'xla'
    assert ChunkClassifier(_bundle_arrays(), device='cpu',
                           sharding=data_sharding(mesh)).conv == 'xla'


def test_execution_target_rule():
    """conv='auto' must run where the model EXECUTES: the port's classifier
    runs on its ``device=`` pin (no ambient default device, no device
    list), and on the CPU its kernel functions run their plain versions, so
    a CPU reference classifier under 'auto' scores instead of crashing (the
    regression the JAX case pins). Asking for CUDA without a card raises,
    with a pin given as a string or as a ``torch.device``."""
    from buzzdetect_torch.models.classifier import (ChunkClassifier,
                                                    resolve_device)
    assert resolve_device(torch.device('cpu')) == torch.device('cpu')
    assert resolve_device('cpu') == torch.device('cpu')
    # an ambient default device does not move the pin
    with torch.device('meta'):
        clf = ChunkClassifier(_bundle_arrays(), device='cpu')
    assert clf.conv == 'pallas' and clf.device == torch.device('cpu')
    wav = np.zeros(int(2 * 0.96 * 16000), np.float32)
    assert clf.predict(wav).shape == (2, 3)
    for pin in ('cuda', torch.device('cuda')):
        with pytest.raises(RuntimeError, match='no CUDA'):
            resolve_device(pin)


def test_conv_auto_compile_failure_falls_back_to_xla(monkeypatch):
    """The JAX package degrades an AUTO-resolved fused conv that fails to
    compile to its XLA stack. The port has no such fallback: a kernel that
    fails fails the call, under 'auto' and explicit 'pallas' alike, and
    the classifier keeps its conv and precision (no silent substitution)."""
    import warnings
    from buzzdetect_torch.models import classifier as clf_mod

    real = clf_mod._classify

    def fake(params, wavs, cfg, frontend, compute_dtype, conv_precision,
             resample_args=None, conv='pallas', *a):
        if conv == 'pallas':
            raise RuntimeError('kernel failed to launch (simulated)')
        return real(params, wavs, cfg, frontend, compute_dtype,
                    conv_precision, resample_args, conv, *a)

    monkeypatch.setattr(clf_mod, '_classify', fake)
    arrays = _bundle_arrays()
    wav = np.zeros(int(2 * 0.96 * 16000) + 240, np.float32)
    for conv in ('auto', 'pallas'):
        clf = clf_mod.ChunkClassifier(arrays, framehop_prop=1.0, conv=conv,
                                      device='cpu')
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            with pytest.raises(RuntimeError, match='simulated'):
                clf.predict_async(wav)
        assert clf.conv == 'pallas'
        assert clf.conv_precision == 'highest'
        assert not any('falling back' in str(x.message) for x in w)
    # the XLA conv path is untouched by the fake
    out, n_valid = clf_mod.ChunkClassifier(
        arrays, framehop_prop=1.0, conv='xla', device='cpu'
    ).predict_async(wav)
    assert np.asarray(out.cpu()).shape[1] == 3 and n_valid == 2


def test_classifier_conv_validation():
    """'auto' resolves to the hand kernels (their plain versions on the
    CPU); explicit 'pallas' + mesh/sharding fails loudly; bad names
    rejected."""
    from buzzdetect_torch.models.classifier import ChunkClassifier
    from buzzdetect_torch.parallel.mesh import make_mesh
    arrays = _bundle_arrays()

    assert ChunkClassifier(arrays, device='cpu').conv == 'pallas'

    with pytest.raises(ValueError, match='conv must be'):
        ChunkClassifier(arrays, conv='fused', device='cpu')

    mesh = make_mesh(devices=['cpu'] * 8, device='cpu')
    with pytest.raises(ValueError, match='mesh'):
        ChunkClassifier(arrays, conv='pallas', mesh=mesh, device='cpu')
    # auto + mesh quietly stays on the portable path
    assert ChunkClassifier(arrays, mesh=mesh, device='cpu').conv == 'xla'


# --- the front block (layers 2-3) ------------------------------------------

def xla_front(params, patches):
    """Reference: layers 1-3 through the port's XLA conv path (NHWC out)."""
    return xla_layers(params, patches, 4).permute(0, 2, 3, 1)


def _jax_front(folded, patches, **kw):
    with pltpu.force_tpu_interpret_mode():
        xp = jyam.packed_l1(folded, jnp.asarray(patches)[..., None], 4)
        return np.asarray(jpc.fused_front(folded, xp, groups=4,
                                          block_packed=1, interpret=True,
                                          **kw))[:len(patches)]


@pytest.mark.parametrize('b', [1, 3, 8])
def test_fused_front_matches_xla(b):
    """layer1 + fused_front == XLA layers 1-3, at batches that are ragged
    against the JAX side's packing groups."""
    folded, params = _params(7)
    patches = RNG.standard_normal((b, 96, 64)).astype(np.float32)
    ref = xla_front(params, patches).reshape(b, 24 * 16, 128).numpy()
    x = yam.layer1(params, torch.from_numpy(patches))
    got = sepconv.fused_front(params, x, start_layer=2, stop_layer=4).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)
    _against_jax(f'fused_front(2, 4) B={b}', got, _jax_front(folded, patches))


def test_fused_front_tail_matches_xla():
    """The fuse-through variant (layers 2-7 in one fused_front) matches XLA
    layers 1-7."""
    folded, params = _params(7)
    b = 5
    patches = RNG.standard_normal((b, 96, 64)).astype(np.float32)
    x = xla_front(params, patches)
    ref = xla_tail(params, x, 4, 8, gap=False).numpy()
    ref = ref.reshape(b, -1, ref.shape[-1])
    got = sepconv.fused_front(params,
                              yam.layer1(params, torch.from_numpy(patches)),
                              start_layer=2, stop_layer=8).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)
    _against_jax('fused_front(2, 8)', got,
                 _jax_front(folded, patches, plain_through=8))


def test_embed_default_front_matches_xla():
    """Whole-embed parity on the JAX package's default front route (layers
    2-7 in one fused_front), the port's one route."""
    folded, params = _params(7)
    patches = RNG.standard_normal((6, 96, 64)).astype(np.float32)
    ref = yam.embed(yam.pack_xla(params), torch.from_numpy(patches),
                    conv='xla').numpy()
    got = yam.embed(params, torch.from_numpy(patches),
                    conv='pallas').numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        jref = np.asarray(jyam.embed(folded, jnp.asarray(patches),
                                     conv='pallas'))
    _against_jax('embed pallas, default front', got, jref)


# --- the port's own cases ----------------------------------------------------

@pytest.mark.parametrize('mode', ['highest', 'bf16', 'high'])
def test_embed_route_matches_xla(mode, monkeypatch):
    """The embed calls layer 1, fused_front(2, 8) and fused_tail(8) and
    nothing else, through ``yamnet.embed`` and through a classifier's
    embed; and it matches conv='xla' (exact f32 and HIGH at 2e-4 / 1e-5 and
    1e-4; bf16 against the XLA path's bf16 at 0.02, as the bf16 cases)."""
    from buzzdetect_torch.models.classifier import ChunkClassifier
    dtype = torch.bfloat16 if mode == 'bf16' else torch.float32
    precision = 'high' if mode == 'high' else 'highest'
    folded = yam.fold_batchnorm(yam.init_raw_params(seed=7))
    params = sepconv.pack_params(params_from_numpy(folded)['yamnet'], mode)
    patches = torch.from_numpy(
        RNG.standard_normal((3, 96, 64)).astype(np.float32))
    seen = []

    def spy(name, fn):
        def wrapped(p, x, *, start_layer, stop_layer=None, **kw):
            seen.append((name, start_layer, stop_layer))
            return fn(p, x, start_layer=start_layer, stop_layer=stop_layer,
                      **kw)
        return wrapped

    layer1 = yam.layer1

    def spy_layer1(p, x, m):
        seen.append(('layer1', m))
        return layer1(p, x, m)
    monkeypatch.setattr(yam, 'layer1', spy_layer1)
    monkeypatch.setattr(yam, 'fused_front', spy('front', yam.fused_front))
    monkeypatch.setattr(yam, 'fused_tail', spy('tail', yam.fused_tail))
    calls = [('layer1', mode), ('front', 2, 8), ('tail', 8, None)]
    got = yam.embed(params, patches, dtype, precision, conv='pallas')
    assert seen == calls
    ref = yam.embed(yam.pack_xla(params, dtype), patches, dtype, precision,
                    conv='xla')
    err = float((got - ref).abs().max())
    print(f'mode {mode}: max |kernels - xla| = {err:.3g}')
    if mode == 'bf16':
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0.02)
    else:
        np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                   atol=2e-4 if mode == 'highest' else 1e-4,
                                   rtol=1e-5 if mode == 'highest' else 1e-4)
    seen.clear()
    clf = ChunkClassifier(_bundle_arrays(), compute_dtype=dtype,
                          conv_precision=precision, device='cpu')
    assert clf.embed(np.zeros(16000, np.float32)).shape[1] == 1024
    assert seen == calls
