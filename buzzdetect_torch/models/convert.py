"""Weight conversion: external checkpoint formats -> this framework's bundles.

A *bundle* is a single ``model.npz`` holding flat-named float arrays (the
embedder's raw conv/BN params under ``yamnet_raw/...``, the head under
``head/...``, optional evaluation metrics under ``metrics_*``) plus a JSON
``config_model.json`` with classes and formatting metadata. BatchNorm
folding for inference happens once at load time (ChunkClassifier), so the
bundle stores each parameter exactly once.

Sources understood:
* the reference classifier head — a TF SavedModel variables checkpoint
  (Dense 1024x13 kernel + bias), read with ``tf.train.load_checkpoint``
  (reference `models/model_general_v3/variables`);
* the public AudioSet YAMNet release ``yamnet.h5`` (Keras-2 layer layout,
  URL recorded at reference `embedders/yamnet/BUILD.py:11`), read with h5py —
  the snapshot mounted here lacks the blob, so conversion falls back to
  deterministic seeded initialization with the same shapes.

* the Audio Spectrogram Transformer's published checkpoint (a PyTorch state
  dict, e.g. ``audioset_10_10_0.4593.pth``: ``module.v.blocks.{i}.attn.
  qkv.weight``, ``module.mlp_head.1.bias``, ...), by ``ast_npz_from_state_
  dict`` and ``convert_ast_checkpoint`` (``python -m buzzdetect_torch.models.
  convert ast <checkpoint.pth> <model dir>``): the arrays under the names
  ``models/ast.param_shapes`` gives, and a ``config_model.json`` naming
  ``"architecture": "ast"`` with the sizes the shapes give.

Beside the AST branch, a copy of ``buzzdetect_tpu/models/convert.py``,
import prefix changed: the arrays are numpy, so a bundle written by either
package loads in the other. ``tensorflow`` and ``h5py`` are imported only by the readers that
need them, so a machine without them still builds seeded bundles and
merges ensembles.
"""

import json
import os

import numpy as np

from buzzdetect_torch.models import yamnet as yamnet_lib
from buzzdetect_torch.models.heads import init_head


# --- head: TF SavedModel variables checkpoint -------------------------------

def head_from_savedmodel_checkpoint(prefix: str):
    """Extract Dense kernel/bias from a Keras SavedModel variables checkpoint.

    ``prefix`` is the checkpoint prefix, e.g. ``<model_dir>/variables/variables``.
    """
    import tensorflow as tf
    reader = tf.train.load_checkpoint(prefix)
    kernel = reader.get_tensor(
        'layer_with_weights-0/kernel/.ATTRIBUTES/VARIABLE_VALUE')
    bias = reader.get_tensor(
        'layer_with_weights-0/bias/.ATTRIBUTES/VARIABLE_VALUE')
    return {
        'head/kernel': np.asarray(kernel, np.float32),
        'head/bias': np.asarray(bias, np.float32),
    }


# --- embedder: Keras-2 yamnet.h5 ---------------------------------------------

def _h5_find(group, names):
    """Depth-first search an h5 group for the first dataset whose BASENAME
    equals any of ``names``. Exact-basename matching matters: Keras nests
    weight datasets under doubled layer-name paths (the dataset name repeats
    the layer path), and an endswith match would confuse ``kernel:0`` with
    ``depthwise_kernel:0``."""
    import h5py
    hits = {}

    def visit(path, obj):
        if isinstance(obj, h5py.Dataset):
            base = path.rsplit('/', 1)[-1]
            if base in names and base not in hits:
                hits[base] = np.asarray(obj)
    group.visititems(visit)
    return hits


def _first_present(root, candidates):
    for name in candidates:
        if name in root:
            return root[name]
    return None


def yamnet_from_keras_h5(path: str):
    """Read the public yamnet.h5 into this framework's raw parameter layout.

    Handles the layouts the blob has shipped in:
    * Keras-2 ``save_weights`` (the published file): top-level layer groups
      named with slashes (``layer1/conv``) so h5py nests them, the weight
      dataset repeating the path (``layer1/conv/layer1/conv/kernel:0``), and
      each BatchNorm a sibling layer whose slash name (``layer1/conv/bn``)
      physically nests it INSIDE the conv group;
    * full ``model.save`` h5 (same structure under a ``model_weights`` root);
    * underscore-renamed layer names (``layer1_conv`` / ``layer1_conv_bn``),
      the Keras-3-compatible rename used by the reference's modified model
      definition (`embedders/yamnet/yamnet.py:39-72`).

    Depthwise kernels convert from Keras HWCM (3,3,C,1) to lax HWIO (3,3,1,C).
    YAMNet's BatchNorm is center-only (no gamma), so only beta/mean/var load.
    """
    import h5py
    params = {}
    with h5py.File(path, 'r') as f:
        root = f['model_weights'] if 'model_weights' in f else f
        for key, kind, _stride, shape in yamnet_lib._conv_shapes():
            layer, conv = key.split('/')   # layerN, conv|depthwise_conv|pointwise_conv
            conv_group = _first_present(
                root, (f'{layer}/{conv}', f'{layer}_{conv}'))
            if conv_group is None:
                raise KeyError(f'no group for {layer}/{conv} in {path}')
            want_kernel = ('depthwise_kernel:0' if kind == 'depthwise'
                           else 'kernel:0')
            hits = _h5_find(conv_group, [want_kernel])
            kernel = hits[want_kernel]
            if kind == 'depthwise':
                kernel = np.transpose(kernel, (0, 1, 3, 2))  # HWCM -> HWIO
            assert kernel.shape == shape, (key, kernel.shape, shape)
            params[f'{key}/kernel'] = kernel.astype(np.float32)

            bn_group = _first_present(
                root, (f'{layer}/{conv}/bn',      # keras-2 slash naming
                       f'{layer}/{conv}_bn',
                       f'{layer}_{conv}_bn'))     # keras-3 rename
            if bn_group is None:
                # keras-2 nests the bn group inside the conv group; searching
                # the conv group (never the whole layer — a separable layer
                # holds TWO BatchNorms) keeps the match unambiguous
                bn_group = conv_group
            bn = _h5_find(bn_group,
                          ['beta:0', 'moving_mean:0', 'moving_variance:0'])
            ch = shape[3]
            params[f'{key}/bn_beta'] = bn['beta:0'].astype(np.float32).reshape(ch)
            params[f'{key}/bn_mean'] = bn['moving_mean:0'].astype(np.float32).reshape(ch)
            params[f'{key}/bn_var'] = bn['moving_variance:0'].astype(np.float32).reshape(ch)
    return params


# --- bundle IO ----------------------------------------------------------------

def save_bundle(dir_model: str, arrays: dict, config: dict):
    os.makedirs(dir_model, exist_ok=True)
    np.savez(os.path.join(dir_model, 'model.npz'), **arrays)
    with open(os.path.join(dir_model, 'config_model.json'), 'w') as f:
        json.dump(config, f, indent=2)


def load_bundle(dir_model: str):
    with np.load(os.path.join(dir_model, 'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(dir_model, 'config_model.json')) as f:
        config = json.load(f)
    return arrays, config


def metrics_from_csv(path: str):
    """Pack a threshold/precision/sensitivity/fpr CSV into bundle arrays.

    atleast_1d: a single-row CSV parses as a 0-d structured scalar, and 0-d
    metrics arrays crash threshold calibration's bracketing indexers."""
    data = np.genfromtxt(path, delimiter=',', names=True)
    return {f'metrics_{n}': np.atleast_1d(np.asarray(data[n], np.float64))
            for n in data.dtype.names}


# --- end-to-end builder ---------------------------------------------------------

def build_model_bundle(dir_out: str,
                       classes: list,
                       yamnet_h5: str = None,
                       head_checkpoint_prefix: str = None,
                       metrics_csv: str = None,
                       embeddername: str = 'yamnet',
                       digits_results: int = 2,
                       seed: int = 0,
                       provenance: str = ''):
    """Assemble a complete inference bundle for a model directory.

    An OMITTED source (None) falls back to deterministic seeded
    initialization (the graph is then structurally complete but untrained —
    documented in the bundle's provenance). An explicitly NAMED source that
    does not exist raises: silently substituting random weights for a
    typo'd path would produce a bundle that loads and 'works' while scoring
    garbage, with the downgrade recorded only in a provenance string.
    """
    notes = []
    if yamnet_h5:
        if not os.path.exists(yamnet_h5):
            raise FileNotFoundError(
                f'yamnet_h5 was explicitly given but does not exist: '
                f'{yamnet_h5} (omit it to build with seeded-init weights)')
        raw = yamnet_from_keras_h5(yamnet_h5)
        notes.append(f'yamnet weights from {yamnet_h5}')
    else:
        raw = yamnet_lib.init_raw_params(seed=seed)
        notes.append('yamnet weights: deterministic seeded init '
                     '(pretrained blob not available in this environment)')

    if head_checkpoint_prefix:
        if not os.path.exists(head_checkpoint_prefix + '.index'):
            raise FileNotFoundError(
                f'head_checkpoint_prefix was explicitly given but '
                f'{head_checkpoint_prefix}.index does not exist (omit it '
                f'to build with seeded-init head weights)')
        head = head_from_savedmodel_checkpoint(head_checkpoint_prefix)
        notes.append(f'head weights from {head_checkpoint_prefix}')
    else:
        head = init_head(yamnet_lib.N_EMBEDDINGS, len(classes), seed=seed)
        notes.append('head weights: deterministic seeded init')

    # store the raw (trainable) parameters only; inference folding happens
    # once at load (ChunkClassifier) — halves the bundle size
    arrays = {}
    arrays.update({f'yamnet_raw/{k}': v for k, v in raw.items()})
    arrays.update(head)
    if metrics_csv:
        if not os.path.exists(metrics_csv):
            raise FileNotFoundError(
                f'metrics_csv was explicitly given but does not exist: '
                f'{metrics_csv} (omit it to build without a metrics table)')
        arrays.update(metrics_from_csv(metrics_csv))
        notes.append(f'metrics from {metrics_csv}')

    config = {
        'classes': list(classes),
        'embeddername': embeddername,
        'digits_results': digits_results,
        'n_embeddings': yamnet_lib.N_EMBEDDINGS,
        'provenance': (provenance + ' | ' if provenance else '') + '; '.join(notes),
    }
    save_bundle(dir_out, arrays, config)
    return arrays, config


def build_ensemble_bundle(member_dirs: list, dir_out: str):
    """Merge several bundles sharing ONE embedder into a single multi-head
    bundle: one pass over the corpus scores every member's classes at
    near-zero extra compute (the embedder dominates; each extra head is one
    (1024, n_classes) matmul column block). The expert-parallel analog the
    reference README sketches as future work, realized as plain head
    concatenation over shared embeddings.

    Members MUST carry identical embedder weights — heads are only
    meaningful in the embedding space they were trained in; mismatched
    embedders raise. Output classes are prefixed ``<membername>.<class>``
    (so column names never collide), and metrics tables are not carried
    over: detections-mode threshold calibration is per-member, so run
    detections mode against the member bundle instead.
    """
    if len(member_dirs) < 2:
        raise ValueError('an ensemble needs at least two member bundles')
    ref_arrays = ref_name = None
    kernels, biases, classes, notes = [], [], [], []
    digits = None
    seen_names = set()
    for d in member_dirs:
        arrays, config = load_bundle(d)
        name = os.path.basename(os.path.normpath(d))
        if name in seen_names:
            raise ValueError(
                f'two ensemble members share the directory name "{name}"; '
                f'prefixed class columns would collide — rename one')
        seen_names.add(name)
        emb = {k: v for k, v in arrays.items()
               if k.startswith(('yamnet_raw/', 'yamnet/'))}
        if not emb:
            # without this, two embedder-less members would vacuously pass
            # the identical-embedder check and the merged bundle would only
            # fail later, at load time, with a confusing message
            raise ValueError(f'{name} carries no embedder arrays '
                             f'(yamnet_raw/ or yamnet/); cannot ensemble it')
        if ref_arrays is None:
            ref_arrays, ref_name = emb, name
        else:
            same = (set(emb) == set(ref_arrays)
                    and all(np.array_equal(emb[k], ref_arrays[k])
                            for k in emb))
            if not same:
                raise ValueError(
                    f'{name} and {ref_name} carry different embedder '
                    f'weights; ensemble heads must share one embedding '
                    f'space')
        if 'head/kernel' not in arrays:
            raise ValueError(f'{name} has no classifier head')
        kernels.append(np.asarray(arrays['head/kernel'], np.float32))
        biases.append(np.asarray(arrays['head/bias'], np.float32))
        classes.extend(f'{name}.{c}' for c in config['classes'])
        digits = (config.get('digits_results', 2) if digits is None
                  else min(digits, config.get('digits_results', 2)))
        notes.append(f'{name}: {len(config["classes"])} classes')

    arrays = dict(ref_arrays)
    arrays['head/kernel'] = np.concatenate(kernels, axis=1)
    arrays['head/bias'] = np.concatenate(biases)
    config = {
        'classes': classes,
        'embeddername': 'yamnet',
        'digits_results': digits,
        'n_embeddings': yamnet_lib.N_EMBEDDINGS,
        'provenance': 'ensemble of [' + '; '.join(notes) + ']',
    }
    save_bundle(dir_out, arrays, config)
    return arrays, config


# --- the Audio Spectrogram Transformer ----------------------------------------

def ast_config_from_state_dict(state: dict, num_heads: int = 12,
                               input_fdim: int = 128, input_tdim: int = 1024,
                               fstride: int = 10, tstride: int = 10):
    """The ``models/ast.ASTConfig`` of a published AST state dict: width,
    depth, MLP, classes and patch size from its shapes; the heads, the input
    frames and bins and the strides, which no shape gives, as published
    unless stated, and held to the position embedding's token count."""
    from buzzdetect_torch.models.ast import ASTConfig
    w = _ast_arrays(state)
    cfg = ASTConfig(
        embed_dim=w['v.pos_embed'].shape[-1],
        depth=1 + max(int(k.split('.')[2]) for k in w
                      if k.startswith('v.blocks.')),
        num_heads=num_heads, mlp_dim=w['v.blocks.0.mlp.fc1.weight'].shape[0],
        label_dim=w['mlp_head.1.weight'].shape[0], input_fdim=input_fdim,
        input_tdim=input_tdim,
        patch_size=w['v.patch_embed.proj.weight'].shape[-1],
        fstride=fstride, tstride=tstride)
    if cfg.tokens != w['v.pos_embed'].shape[1]:
        raise ValueError(f'the position embedding holds '
                         f'{w["v.pos_embed"].shape[1]} tokens; {input_fdim} x '
                         f'{input_tdim} at strides ({fstride}, {tstride}) '
                         f'give {cfg.tokens}')
    return cfg


def _ast_arrays(state: dict) -> dict:
    """A state dict's tensors as f32 numpy arrays, DataParallel's
    ``module.`` prefix taken off."""
    out = {}
    for k, v in state.items():
        name = k[len('module.'):] if k.startswith('module.') else k
        out[name] = np.asarray(v.detach().cpu().float().numpy()
                               if hasattr(v, 'detach') else v, np.float32)
    return out


def ast_npz_from_state_dict(state: dict, cfg) -> dict:
    """The port's AST arrays from a published state dict: every name of
    ``models/ast.param_shapes(cfg)``, at its shape; DeiT's unused heads
    (``v.head``, ``v.head_dist``) left out; a missing name or a wrong shape
    raises."""
    from buzzdetect_torch.models.ast import check_params, param_shapes
    arrays = _ast_arrays(state)
    out = {name: arrays[name] for name in param_shapes(cfg)
           if name in arrays}
    check_params(out, cfg)
    return out


def convert_ast_checkpoint(path: str, dir_out: str, **sizes):
    """``torch.load`` a published AST checkpoint (a state dict) and write
    ``dir_out/model.npz`` and ``config_model.json``; returns the config.
    ``sizes``: what ``ast_config_from_state_dict`` takes beside the state."""
    import dataclasses

    import torch
    state = torch.load(path, map_location='cpu', weights_only=True)
    cfg = ast_config_from_state_dict(state, **sizes)
    arrays = ast_npz_from_state_dict(state, cfg)
    config = {
        'architecture': 'ast',
        'embeddername': 'ast',
        'digits_results': 2,
        'sizes': dataclasses.asdict(cfg),
        'provenance': f'converted from {os.path.basename(path)} '
                      f'(models/convert.convert_ast_checkpoint)',
    }
    save_bundle(dir_out, arrays, config)
    return config


def main(argv=None):
    """``python -m buzzdetect_torch.models.convert ast <checkpoint.pth>
    <model dir> [--heads 12] [--tdim 1024]``."""
    import argparse
    ap = argparse.ArgumentParser(description='convert a published '
                                 'checkpoint into a model directory')
    ap.add_argument('architecture', choices=['ast'])
    ap.add_argument('checkpoint')
    ap.add_argument('dir_out')
    ap.add_argument('--heads', type=int, default=12)
    ap.add_argument('--tdim', type=int, default=1024,
                    help='frames a window (the model\'s input_tdim)')
    args = ap.parse_args(argv)
    config = convert_ast_checkpoint(args.checkpoint, args.dir_out,
                                    num_heads=args.heads,
                                    input_tdim=args.tdim)
    print(f'wrote {args.dir_out}: AST {config["sizes"]}')


if __name__ == '__main__':
    main()
