"""Ahead-of-time model export: the classify graph as a serialized
``torch.export`` program.

Counterpart of ``buzzdetect_tpu/models/export.py`` (same three functions,
arguments and meta keys). Serving deployments load the artifact and run
inference without the bundle or the model code's tracing: the weights are
baked into the program as buffers and the input shape is fixed at export
time. The artifact is ``classify.pt2`` (``torch.export.save`` of an
``ExportedProgram``) beside ``export_meta.json``; the traced function is
``models/classifier._classify`` on a fixed ``(input_samples,)`` wire
tensor, the counterpart of the JAX package's ``_classify_padded``.

Edits against the JAX module:

* ``platforms`` are ``'cpu'`` and ``'cuda'`` (default both). The program is
  traced on the CPU when ``'cpu'`` is listed, else on the card, and
  ``load_exported`` moves it to the device it is asked for.
* ``conv='pallas'``, or a bundle whose frontend is ``'pallas'``, records the
  hand kernels as the custom operators of ``ops/library.py``
  (``buzzdetect::fused_front``, ``fused_tail``, ``log_mel``); they have no
  CPU implementation, so such an export needs ``platforms=('cuda',)``, as
  the JAX package's Mosaic export needs ``('tpu',)``.
* Serving dependency: a program that names those operators loads only
  where ``buzzdetect_torch`` is importable, because the operators are
  referenced by name and their CUDA implementations build the kernels from
  the package's ``csrc/`` sources. A ``conv='xla'`` artifact with the
  matmul frontend needs only torch, like the JAX package's artifacts.
* A bundle's ``frontend`` ``'auto'`` exports the matmul frontend
  (``'xla'``), as in the JAX package, wherever the artifact is traced: the
  live classifier's per-device rule (``classifier.resolve_frontend``,
  the fused log-mel on a card) does not carry into an artifact that may
  be served on the CPU.
* The classifier packs its conv operands once, for its mode
  (``ChunkClassifier.__init__``), so the export builds its own classifier
  with the export's resolved ``conv`` and ``conv_precision`` instead of
  passing raw parameters into the traced function.
* The TF32 switches are process state, not graph: the loaded callable
  turns TF32 off (``common.exact_f32``) before each call.
"""

import io
import json
import os

import numpy as np
import torch

FNAME_PROGRAM = 'classify.pt2'
FNAME_META = 'export_meta.json'
PLATFORMS = ('cpu', 'cuda')
_WIRE_DTYPES = {'int16': (np.int16, torch.int16),
                'mulaw': (np.int8, torch.int8),
                'float32': (np.float32, torch.float32)}


class _Reads(dict):
    """A parameter dict that records the keys read from it."""

    def __init__(self, tensors, read):
        super().__init__(tensors)
        self.read = read

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _settings(clf):
    return clf.cfg, clf.frontend, clf.compute_dtype, clf.conv_precision


def _used_params(clf, wire):
    """The classifier's parameters that its path reads (its packing keeps
    the f32 originals beside each mode's operands), found by one eager call.
    The call also fills the per-device constant caches (the frontend's DFT
    and mel matrices) with real tensors, which the trace bakes in."""
    from buzzdetect_torch.models.classifier import _classify
    read = set()
    _classify({group: _Reads(tensors, read)
               for group, tensors in clf.params.items()},
              wire, *_settings(clf), None, clf.conv)
    return {group: {key: t for key, t in tensors.items() if key in read}
            for group, tensors in clf.params.items()}


class _Classify(torch.nn.Module):
    """``_classify`` of one classifier as a module: the parameters its path
    reads are buffers (baked into the program), its settings constants."""

    def __init__(self, clf, wire):
        super().__init__()
        self.settings, self.conv = _settings(clf), clf.conv
        self.names = {}
        for group, tensors in _used_params(clf, wire).items():
            self.names[group] = {}
            for i, (key, t) in enumerate(tensors.items()):
                self.register_buffer(f'{group}_{i}', t)
                self.names[group][key] = f'{group}_{i}'

    def forward(self, wire):
        from buzzdetect_torch.models.classifier import _classify
        params = {group: {key: getattr(self, name)
                          for key, name in names.items()}
                  for group, names in self.names.items()}
        return _classify(params, wire, *self.settings, None, self.conv)


def export_classifier(modelname: str, chunk_seconds: float,
                      framehop_prop: float = 1.0,
                      platforms=PLATFORMS,
                      transfer_dtype: str = 'int16',
                      conv: str = 'xla',
                      conv_precision: str = 'auto'):
    """Build and export the waveform->scores graph for a fixed chunk shape.

    ``conv='pallas'`` records the hand conv kernels as custom operators
    (``ops/library.py``): CUDA-only, so it requires
    ``platforms=('cuda',)``, as does a bundle whose frontend is
    ``'pallas'``.

    ``conv_precision`` ('auto'|'high'|'highest') is resolved against THIS
    export's ``conv`` argument — 'highest' on 'pallas', 'high' on 'xla' —
    not the live model's auto-resolved path; an explicit pin in the
    bundle's config_model.json survives into the artifact.

    Returns (serialized_bytes, meta_dict).
    """
    from buzzdetect_torch.models.classifier import ChunkClassifier
    from buzzdetect_torch.models.registry import load_model
    from buzzdetect_torch.ops.common import exact_f32
    from buzzdetect_torch.ops.frontend import padded_length, num_patches

    platforms = tuple(platforms)
    if not platforms or not set(platforms) <= set(PLATFORMS):
        raise ValueError(f"platforms must name 'cpu' and/or 'cuda', got "
                         f"{platforms!r}")
    if conv not in ('xla', 'pallas'):
        raise ValueError("conv must be 'xla' or 'pallas'")
    if conv_precision not in ('auto', 'high', 'highest'):
        raise ValueError("conv_precision must be 'auto', 'high' or "
                         "'highest'")
    device = 'cpu' if 'cpu' in platforms else 'cuda'
    model = load_model(modelname, framehop_prop=framehop_prop,
                       initialize=False, transfer_dtype=transfer_dtype,
                       device=device)
    frontend = 'xla' if model._frontend == 'auto' else model._frontend
    if (conv == 'pallas' or frontend == 'pallas') \
            and set(platforms) != {'cuda'}:
        raise ValueError("conv='pallas' and frontend='pallas' exports run "
                         "the hand CUDA kernels; pass platforms=('cuda',)")
    model.initialize()
    clf = model.classifier
    cfg = clf.cfg
    fl = model.embedder.framelength_s
    n_frames = round(chunk_seconds / fl)
    if n_frames < 1:
        raise ValueError(f'chunk_seconds={chunk_seconds} snaps to zero '
                         f'frames (framelength {fl}s)')
    # integer sample math: int(n_frames * 0.96 * 16000) would truncate a
    # sample off the inexact binary product (960.0 -> 15359999)
    chunk_seconds = round(n_frames * fl, 6)
    n_samples = n_frames * int(round(fl * 16000))
    target = padded_length(n_samples, cfg)

    if conv_precision == 'auto':
        if not clf._conv_precision_auto:
            # an EXPLICIT pin (config_model.json conv_precision) survives
            # into the artifact — the operator validated the bundle under
            # that precision
            conv_precision = clf.conv_precision
        else:
            # the per-path rule, applied to the export's own conv path
            conv_precision = 'highest' if conv == 'pallas' else 'high'

    with np.load(os.path.join(model.dir_model, 'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    # honour the model's configured frontend/compute dtype: an export built
    # with defaults would silently diverge from the live model the user
    # validated
    served = ChunkClassifier(arrays, framehop_prop=framehop_prop,
                             compute_dtype=clf.compute_dtype, device=device,
                             transfer_dtype=clf.transfer_name,
                             frontend=frontend, conv=conv,
                             conv_precision=conv_precision)
    wire = torch.zeros(target, dtype=_WIRE_DTYPES[clf.transfer_name][1],
                       device=device)
    exact_f32()
    with torch.no_grad():
        module = _Classify(served, wire).eval()
        exported = torch.export.export(module, (wire,))
    # the zero wire the trace ran on is no part of the artifact
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    meta = {
        'modelname': modelname,
        'classes': model.config['classes'],
        'chunk_seconds': chunk_seconds,
        'input_samples': target,
        'input_dtype': clf.transfer_name,
        'framehop_prop': framehop_prop,
        # the EFFECTIVE patch stride in seconds (snapped to the 10 ms
        # spectrogram grid) — consumers must derive timestamps from this,
        # not framehop_prop * 0.96, or they drift off the analyzed frames
        # whenever 96*framehop_prop is not an integer
        'framehop_s': cfg.patch_hop_seconds,
        'n_patches': num_patches(n_samples, cfg),
        'platforms': list(platforms),
        'conv': conv,
        'conv_precision': conv_precision,
        'samplerate': 16000,
    }
    return buf.getvalue(), meta


def save_exported(dir_out: str, blob: bytes, meta: dict):
    os.makedirs(dir_out, exist_ok=True)
    with open(os.path.join(dir_out, FNAME_PROGRAM), 'wb') as f:
        f.write(blob)
    with open(os.path.join(dir_out, FNAME_META), 'w') as f:
        json.dump(meta, f, indent=2)
    return dir_out


def load_exported(dir_in: str, device='cuda'):
    """Load a serving artifact onto ``device`` (``'cuda'`` unless the caller
    asks for ``'cpu'``) -> (callable(waveform)->scores, meta).

    The callable takes a ``(input_samples,)`` numpy wire array of the
    artifact's ``input_dtype`` and returns numpy scores
    ``(n_patches, n_classes)``; its ``program`` attribute is the loaded
    program itself (a device-resident wire in, every padded patch's scores
    out, on ``device``)."""
    # registers the buzzdetect:: operators a conv='pallas' program names
    from buzzdetect_torch.ops import library  # noqa: F401
    from buzzdetect_torch.models.classifier import resolve_device
    from buzzdetect_torch.ops.common import exact_f32
    from torch.export.passes import move_to_device_pass

    with open(os.path.join(dir_in, FNAME_META)) as f:
        meta = json.load(f)
    device = resolve_device(device)
    if device.type not in meta['platforms']:
        raise ValueError(f"this artifact was exported for "
                         f"{meta['platforms']}, not {device.type}")
    program = torch.export.load(os.path.join(dir_in, FNAME_PROGRAM))
    module = move_to_device_pass(program, device).module()
    wire_dtype = np.dtype(_WIRE_DTYPES[meta['input_dtype']][0])

    def call(waveform):
        waveform = np.asarray(waveform)
        if waveform.shape != (meta['input_samples'],):
            raise ValueError(f"expected {meta['input_samples']} samples, got "
                             f"shape {waveform.shape}")
        if waveform.dtype != wire_dtype:
            raise TypeError(f'expected a {wire_dtype} wire array, got '
                            f'{waveform.dtype}')
        exact_f32()
        with torch.inference_mode():
            out = module(torch.from_numpy(np.ascontiguousarray(waveform))
                         .to(device))
        # slice to the real patch count, exactly like the live predict()
        # path: at framehop_prop > 1 the padded graph emits one extra
        # pure-padding patch whose score row is not real audio
        return out.cpu().numpy()[:meta['n_patches']]

    # the program alone, for a caller that holds the wire on the device
    call.program = module
    return call, meta
