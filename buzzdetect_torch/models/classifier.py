"""The end-to-end chunk classifier: waveform -> log-mel patches -> embed ->
head, on one torch device or split over a device mesh.

``WireClassifier`` holds what every architecture shares: the wire format,
the padding to whole frames, the pinned upload and the dispatch
(``predict_async``, ``predict_async_batch``) with their spans and chunk
ids. ``ChunkClassifier`` is YAMNet's classify on it; the Audio
Spectrogram Transformer's is ``models/ast.ASTClassifier``.

Counterpart of ``buzzdetect_tpu/models/classifier.py`` with the same surface
(``predict``, ``predict_async``, ``predict_async_batch``, ``embed``,
``warmup``, ``to_wire``, ``classify_resident``) and the same ``n_valid``
semantics: each waveform is zero-padded to ``padded_length`` and the patch
rows past the chunk's true patch count are discarded by the caller. Zero
padding matches the reference's pad_waveform, so those rows are the only
difference. PyTorch runs eagerly, so there is no shape bucketing. With
``input_rate``, chunks ship at their native rate and are resampled on the
device (``ops/resample.py``) ahead of the frontend.

On a CUDA device the conv stack runs through the hand-written kernels of
``ops/sepconv.py`` (or, with ``conv='xla'``, through cuDNN), the log-mel
through the fused FFT kernel of ``ops/logmel.py`` (``frontend`` ``'auto'``
or ``'pallas'``), and results stay on the card until the pipeline copies
them back (runtime/inferer.py). On the CPU every op runs its plain
version. Nothing falls back: an option runs its kernel or raises.

The knobs, and how they resolve here:

* ``frontend`` (``resolve_frontend``): ``'pallas'`` is the fused log-mel
  kernel, on the single-chunk and the batch path alike, which reads the
  int16 wire itself; ``'xla'`` is the matmul frontend
  (``ops/frontend.py``). ``'auto'`` is ``'pallas'`` on a CUDA device
  without a mesh and ``'xla'`` on the CPU and under a mesh (whose frontend
  stays on the first device, as the JAX package keeps it replicated). The
  JAX package resolves ``'auto'`` to its matmul frontend on every backend:
  on a TPU the matmul unit computes the DFT faster than an FFT could; on
  the card the FFT kernel takes a tenth of the matmul frontend's time or
  less.
* ``conv``: ``'auto'`` and ``'pallas'`` run the hand-written conv kernels at
  every compute dtype. The JAX package's ``resolve_conv_auto`` sends bf16
  to its XLA conv, because Mosaic cannot rotate 16-bit vectors and the f32
  depthwise work then dominates on a TPU; the card has no such limit, so
  the port's bf16 computes the JAX package's ``conv='pallas'`` bf16
  function. ``'xla'`` is the XLA conv path (``yamnet.embed_xla``: every
  conv a library ``F.conv2d``, TF32 off; no hand conv kernel launches), at
  every compute dtype, independent of ``frontend``.
* ``conv_precision``: ``'auto'`` resolves per path, as the JAX package
  resolves it: ``'highest'`` on the kernels, ``'high'`` on ``'xla'``. On
  the kernels ``'high'`` selects the emulated-HIGH mode; on ``'xla'`` both
  ``'high'`` and ``'highest'`` run exact f32 (cuDNN has no three-pass bf16
  convolution, and TF32 is refused). bf16 compute ignores it (one bf16
  product).
* ``compute_dtype``: float32 (``None``, ``torch.float32``, ``'float32'``)
  or bfloat16 (``torch.bfloat16``, ``'bfloat16'``).
* ``mesh`` (``parallel.make_mesh``): each call's patch axis (the flattened
  B x P axis of a batch) splits over the mesh's ``'data'`` axis
  (``parallel.split``), each data device runs the embed and the head on
  its slice with its own copy of the parameters, and the rows come back
  in order to the mesh's first device (``parallel.gather``). The wire,
  the resampler and the frontend stay on the first device, once per call,
  as the JAX package keeps them replicated. A 2-D mesh's other axes are
  replicated. ``conv`` ``'auto'`` then resolves to ``'xla'`` and its
  ``'auto'`` precision to ``'high'``, as in the JAX package, whose GSPMD
  cannot split a ``pallas_call``; an explicit ``'pallas'`` raises.
  ``sharding`` (``parallel.data_sharding``) runs exactly as
  ``mesh=sharding.mesh``.
"""

import itertools

import numpy as np
import torch

from buzzdetect_torch.models import yamnet as yamnet_lib
from buzzdetect_torch.models.heads import apply_head
from buzzdetect_torch.models.weights import params_from_numpy
from buzzdetect_torch.ops import _build, logmel, sepconv
from buzzdetect_torch.ops.resample import resample
from buzzdetect_torch.parallel.mesh import gather, mesh_device, split
from buzzdetect_torch.ops.frontend import (
    FrontendConfig, padded_length, num_patches, log_mel_patches,
    patches_from_log_mel)
from buzzdetect_torch.runtime.spans import mark, span, tag
from buzzdetect_torch.utils import encode_mulaw, quantize_int16

_LN256 = float(np.log(256.0))
FRONTENDS = ('auto', 'xla', 'pallas')


def resolve_device(device) -> torch.device:
    """'cuda' (the default everywhere) or 'cpu'. Asking for CUDA without a
    CUDA device raises: nothing quietly carries on on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch finds no CUDA "
                f"device; pass device='cpu' to run on the CPU")
    elif device.type != 'cpu':
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device}")
    return device


def resolve_conv(conv, mesh=None) -> str:
    """'auto' and 'pallas' -> 'pallas' (the CUDA conv kernels, at every
    compute dtype); 'xla' -> 'xla' (the XLA conv path); anything else
    raises ValueError. With a mesh 'auto' -> 'xla', and 'pallas' raises,
    as the JAX package's ``resolve_conv_auto`` rules."""
    if conv not in ('auto', 'xla', 'pallas'):
        raise ValueError("conv must be 'auto', 'xla' or 'pallas'")
    if mesh is not None:
        if conv == 'pallas':
            raise ValueError(
                "conv='pallas' does not compose with mesh/sharding (the "
                "JAX package's GSPMD cannot partition the fused kernel); "
                "use conv='xla'")
        return 'xla'
    return 'xla' if conv == 'xla' else 'pallas'


def resolve_frontend(frontend, device, mesh=None) -> str:
    """'auto' -> 'pallas' (the fused log-mel kernel) on a CUDA device
    without a mesh, else 'xla' (the matmul frontend); 'xla' and 'pallas'
    as they are; anything else raises ValueError. ``device`` is the
    classifier's device (a ``torch.device`` or its name)."""
    if frontend not in FRONTENDS:
        raise ValueError("frontend must be 'auto', 'xla' or 'pallas'")
    if frontend != 'auto':
        return frontend
    on_card = torch.device(device).type == 'cuda' and mesh is None
    return 'pallas' if on_card else 'xla'


def _to_float(waveform: torch.Tensor) -> torch.Tensor:
    """Undo the wire format on the device: int16 is linear PCM; int8 is
    continuous mu-law (mu=255, utils.encode_mulaw), expanded with one
    expm1."""
    if waveform.dtype == torch.int16:
        return waveform.to(torch.float32) * (1.0 / 32768.0)
    if waveform.dtype == torch.int8:
        y = waveform.to(torch.float32) * (1.0 / 127.0)
        mag = torch.expm1(torch.abs(y) * _LN256) * (1.0 / 255.0)
        return torch.sign(y) * mag
    return waveform


def _patches(wavs: torch.Tensor, cfg: FrontendConfig, frontend: str):
    """(..., L) padded waveforms -> (..., P, 96, 64) log-mel patches
    through the selected frontend: 'xla' (the matmul frontend, f32 input)
    or 'pallas' (the fused log-mel kernel, which takes (L,) or (B, L) f32
    samples or the int16 wire)."""
    if frontend == 'pallas':
        return patches_from_log_mel(
            logmel.log_mel_spectrogram_fused(wavs, cfg), cfg)
    return log_mel_patches(wavs, cfg)


def _frontend_input(wavs: torch.Tensor, frontend: str, direct: bool = True):
    """The wire as the frontend takes it: the fused log-mel reads the int16
    wire itself (``direct``: nothing resamples it first), so it skips
    ``_to_float``'s pass; every other case is ``_to_float``."""
    if direct and frontend == 'pallas' and wavs.dtype == torch.int16:
        return wavs
    return _to_float(wavs)


def _resample_in_graph(wav: torch.Tensor, cfg: FrontendConfig,
                       resample_from: int, resample_to: int, valid_len):
    """Rational-resample the float waveform to the model rate on its device
    (``ops/resample.py``: polyphase as one strided conv), then fix its
    length to ``resample_to``, the model-rate padded length the caller
    planned for.

    ``valid_len`` (an int, or a (B, 1) tensor for a batch) is the chunk's
    true model-rate sample count: samples past it are forced to exact
    zero, matching the host path's zero padding. The anti-aliasing filter
    otherwise rings about half a filter width of low-level energy into the
    padding, which the log-mel of near-silent frames amplifies."""
    wav = resample(wav, resample_from, cfg.sample_rate)
    n = wav.shape[-1]
    if n < resample_to:
        wav = torch.nn.functional.pad(wav, (0, resample_to - n))
    else:
        wav = wav[..., :resample_to]
    keep = torch.arange(resample_to, device=wav.device) < valid_len
    return torch.where(keep, wav, 0.0)


def _over_data(fn, params, x: torch.Tensor, mesh=None, replicas=None):
    """``fn(params, x)``; with a mesh, ``fn`` of each data device's
    ``replicas[device]`` on its slice of ``x``'s leading axis (empty slices
    skipped), rows gathered back in order to ``x``'s device."""
    if mesh is None:
        return fn(params, x)
    return gather([fn(replicas[part.device], part)
                   for part in split(x, mesh, 'data', 0) if len(part)],
                  0, x.device)


def _classify(params, wavs: torch.Tensor, cfg: FrontendConfig,
              frontend: str = 'xla', compute_dtype=torch.float32,
              conv_precision: str = 'highest', resample_args=None,
              conv: str = 'pallas', mesh=None, replicas=None):
    """(..., L) padded wire waveforms -> (..., n_patches, n_classes).

    With ``resample_args`` = ``(input_rate, resample_to, valid_len)`` the
    waveforms arrive at their native rate and are resampled on the device
    first (``_resample_in_graph``). ``conv`` picks the embed's path
    (``yamnet.embed``). With a mesh, the flattened patch axis splits over
    its ``'data'`` axis (``_over_data``; ``replicas`` maps each data device
    to its copy of ``params``)."""
    with span('buzzdetect.classify'):
        with span('buzzdetect.frontend'):
            wav = _frontend_input(wavs, frontend, resample_args is None)
            if resample_args is not None:
                wav = _resample_in_graph(wav, cfg, *resample_args)
            patches = _patches(wav, cfg, frontend)       # (..., P, 96, 64)
        lead = patches.shape[:-2]

        def embed_head(p, x):
            with span('buzzdetect.embed'):
                emb = yamnet_lib.embed(p['yamnet'], x, compute_dtype,
                                       conv_precision, conv)
            with span('buzzdetect.head'):
                return apply_head(p['head'], emb)
        return _over_data(embed_head, params, patches.reshape(-1, 96, 64),
                          mesh, replicas).reshape(*lead, -1)


class WireClassifier:
    """What every architecture's chunk classifier shares: the wire
    (``to_wire``, ``_pad_to``), the pinned upload (``_upload``), the
    dispatch (``predict_async``, ``predict_async_batch``) with its spans and
    chunk ids, ``predict``, ``classify_resident`` and ``warmup``. A subclass
    sets ``device``, ``sample_rate`` and the wire (``_init_wire``) and gives
    its frames: ``_valid(n)`` (frames a chunk of n samples yields),
    ``_padded(n)`` (the samples it is padded to) and ``_classify(wavs,
    resample_args)`` ((..., L) padded wire waveforms -> (..., frames,
    classes))."""

    sample_rate = 16000

    def _init_wire(self, transfer_dtype):
        """The wire format: 'float32', 'int16' or 'mulaw' (int8)."""
        # 'mulaw' rides int8 on the wire; linear int8 is not offered
        self.transfer_name = str(transfer_dtype)
        if self.transfer_name not in ('float32', 'int16', 'mulaw'):
            raise ValueError('transfer_dtype must be float32, int16 or mulaw')
        self.transfer_dtype = np.dtype(
            'int8' if self.transfer_name == 'mulaw' else self.transfer_name)
        # each dispatched chunk's id in a profiler trace (runtime/spans.py)
        self._chunk_ids = itertools.count()

    def _valid(self, n_samples: int) -> int:
        raise NotImplementedError

    def _padded(self, n_samples: int) -> int:
        raise NotImplementedError

    def _classify(self, wavs: torch.Tensor,
                  resample_args=None) -> torch.Tensor:
        raise NotImplementedError

    def _need_head(self):
        pass

    def to_wire(self, samples: np.ndarray) -> np.ndarray:
        """Convert host samples to this classifier's wire dtype (no-op when
        the decode stage already emitted it). int8 input is always mu-law;
        int16 is linear PCM."""
        if samples.dtype == self.transfer_dtype:
            return samples
        if samples.dtype == np.int16:
            samples = samples.astype(np.float32) * (1.0 / 32768.0)
        elif samples.dtype == np.int8:
            y = samples.astype(np.float32) * (1.0 / 127.0)
            samples = np.sign(y) * np.expm1(np.abs(y) * _LN256,
                                            dtype=np.float32) * (1.0 / 255.0)
        elif samples.dtype != np.float32:
            samples = samples.astype(np.float32)
        if self.transfer_name == 'int16':
            return quantize_int16(samples)
        if self.transfer_name == 'mulaw':
            return encode_mulaw(samples)
        return samples

    def _pad_to(self, samples: np.ndarray, target: int) -> np.ndarray:
        """Zero-pad to ``target`` samples, converting to the wire dtype."""
        with span('buzzdetect.wire'):
            samples = self.to_wire(samples)
            if len(samples) == target:
                return samples
            out = np.zeros(target, dtype=samples.dtype)
            out[:len(samples)] = samples
            return out

    def _upload(self, wire: np.ndarray) -> torch.Tensor:
        """Host wire buffer -> device tensor (pinned, non-blocking on CUDA)."""
        with span('buzzdetect.upload'):
            t = torch.from_numpy(np.ascontiguousarray(wire))
            if self.device.type == 'cuda':
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

    def _plan_native(self, n_native: int, input_rate: int):
        """Shape plan for a native-rate chunk resampled on the device: the
        valid frame count and padded target in the MODEL-rate domain, plus
        the native-rate length the host pads the wire buffer to so the
        resampler produces at least ``target_model`` samples."""
        sr = self.sample_rate
        n_model = -(-n_native * sr // input_rate)  # ceil
        n_valid = self._valid(n_model)
        target_model = self._padded(n_model)
        target_native = -(-target_model * input_rate // sr)
        return n_valid, n_model, target_model, target_native

    def _native_rate(self, input_rate):
        """True when chunks at ``input_rate`` need resampling here."""
        return bool(input_rate) and input_rate != self.sample_rate

    # --- public API ------------------------------------------------------------
    def predict(self, samples: np.ndarray,
                input_rate: int = None) -> np.ndarray:
        """Mono samples -> (n_frames, n_classes) activations.

        Samples are 16 kHz unless ``input_rate`` says otherwise, in which
        case they ship at that rate and are resampled on the device."""
        out, n_valid = self.predict_async(samples, input_rate=input_rate)
        return out.cpu().numpy()[:n_valid]

    @torch.inference_mode()
    def predict_async(self, samples: np.ndarray, input_rate: int = None):
        """Dispatch without waiting; returns (device_tensor, n_valid).

        On CUDA the kernels run asynchronously on the current stream; the
        pipeline starts the copy back at once (runtime/inferer.py) and the
        writer waits for it, so host decode overlaps device compute. The
        tensor carries the chunk's id (``runtime/spans.py``).
        """
        self._need_head()
        chunk = next(self._chunk_ids)
        with span('buzzdetect.dispatch'):
            mark(chunk)
            samples = np.asarray(samples)
            if self._native_rate(input_rate):
                n_valid, n_model, t_model, t_native = self._plan_native(
                    len(samples), input_rate)
                wav = self._upload(self._pad_to(samples, t_native))
                out = self._classify(wav, (int(input_rate), t_model, n_model))
            else:
                n_valid = self._valid(len(samples))
                wav = self._pad_to(samples, self._padded(len(samples)))
                out = self.classify_resident(self._upload(wav))
        return tag(out, chunk), n_valid

    @torch.inference_mode()
    def predict_async_batch(self, samples_list, input_rate: int = None):
        """Dispatch several chunks as ONE batched call. All chunks pad to the
        largest needed length and, with ``input_rate``, share that native
        rate. Returns (scores (B, P, C), [n_valid each]); the scores carry
        the chunks' ids, one a row (``runtime/spans.py``)."""
        self._need_head()
        arrs = [np.asarray(s) for s in samples_list]
        chunks = [next(self._chunk_ids) for _ in arrs]
        with span('buzzdetect.dispatch'):
            mark(chunks)
            if self._native_rate(input_rate):
                sr = self.sample_rate
                n_models = [-(-len(a) * sr // input_rate) for a in arrs]
                n_valids = [self._valid(n) for n in n_models]
                t_model = self._padded(max(n_models))
                t_native = -(-t_model * input_rate // sr)
                batch = self._upload(
                    np.stack([self._pad_to(a, t_native) for a in arrs]))
                valid = torch.tensor(n_models, device=self.device)[:, None]
                out = self._classify(batch, (int(input_rate), t_model, valid))
            else:
                n_valids = [self._valid(len(a)) for a in arrs]
                target = self._padded(max(len(a) for a in arrs))
                batch = np.stack([self._pad_to(a, target) for a in arrs])
                out = self._classify(self._upload(batch))
        return tag(out, chunks), n_valids

    @torch.inference_mode()
    def classify_resident(self, wav_device: torch.Tensor) -> torch.Tensor:
        """Classify an already device-resident padded wire-format waveform
        (no host staging): (n_frames, n_classes) on the device."""
        self._need_head()
        return self._classify(wav_device)

    def warmup(self, chunk_samples: int):
        """Run the nominal chunk length once (first-use allocations)."""
        self.predict(np.zeros(chunk_samples, np.float32))


class ChunkClassifier(WireClassifier):
    """Callable classifier over variable-length chunks: YAMNet and a head.

    ``arrays`` are numpy parameters as a bundle holds them (see
    ``models/weights.params_from_numpy``). ``device`` is ``'cuda'`` unless
    the caller asks for ``'cpu'``; on CUDA the kernels are built and loaded
    here, at construction, not at the first dispatch. With ``mesh`` (or
    ``sharding``, which runs as ``mesh=sharding.mesh``) ``device`` names
    the mesh's device type, and the classifier's ``device`` is the mesh's
    first device; each further data device gets its own parameter copy
    here.
    """

    def __init__(self, arrays: dict, framehop_prop: float = 1.0,
                 compute_dtype=None, device='cuda', transfer_dtype='float32',
                 frontend='auto', conv='auto', conv_precision='auto',
                 sharding=None, mesh=None):
        self.cfg = FrontendConfig().with_framehop(framehop_prop)
        self.compute_dtype = sepconv.resolve_compute_dtype(compute_dtype)
        if frontend not in FRONTENDS:
            raise ValueError("frontend must be 'auto', 'xla' or 'pallas'")
        self._frontend_auto = frontend == 'auto'
        if sharding is not None:
            if mesh is not None and mesh is not sharding.mesh:
                raise ValueError('mesh and sharding name different meshes')
            mesh = sharding.mesh
        self.mesh, self.sharding = mesh, sharding
        self.conv = resolve_conv(conv, mesh)
        if self.conv == 'pallas':
            # the BUZZDETECT_PALLAS_FRONT override resolves now, so a
            # malformed value fails at model init (its ValueError names the
            # variable), not at import and not mid-dispatch
            yamnet_lib.check_front(yamnet_lib.resolve_front())
        if conv_precision not in ('auto', 'high', 'highest'):
            raise ValueError(
                "conv_precision must be 'auto', 'high' or 'highest'")
        # whether the precision was left to the per-path rule: an export
        # applies the rule to its own conv path, but keeps a bundle's pin
        # (models/export.py), as the JAX classifier records it
        self._conv_precision_auto = conv_precision == 'auto'
        if conv_precision == 'auto':
            conv_precision = 'high' if self.conv == 'xla' else 'highest'
        self.conv_precision = conv_precision
        # what the conv products compute ('highest' | 'bf16' | 'high'): on
        # the kernels their mode; on 'xla' exact f32 or bf16 operands
        precision = yamnet_lib.conv_mxu_precision(self.compute_dtype,
                                                  self.conv_precision)
        self.mode = (sepconv.resolve_mode(self.compute_dtype, precision)
                     if self.conv == 'pallas' else
                     'bf16' if precision == 'default' else 'highest')
        self._init_wire(transfer_dtype)
        self.device = resolve_device(
            device if mesh is None else mesh_device(mesh, device))
        self.frontend = resolve_frontend(frontend, self.device, mesh)
        sepconv.exact_f32()
        if self.device.type == 'cuda':
            kernels = {'sepconv': sepconv} if self.conv == 'pallas' else {}
            if self.frontend == 'pallas':
                kernels['logmel'] = logmel
            # a fresh checkout builds them at once, one nvcc per source
            _build.build_all(list(kernels))
            for module in kernels.values():
                module.load_kernels()
        self.params = params_from_numpy(arrays, self.device)
        # the path's conv operands, packed once beside the f32 params
        self.params['yamnet'] = (
            sepconv.pack_params(self.params['yamnet'], self.mode)
            if self.conv == 'pallas' else
            yamnet_lib.pack_xla(self.params['yamnet'], self.compute_dtype))
        # one parameter copy per distinct data device of the mesh
        self._replicas = None if mesh is None else {
            d: self.params if d == self.device else
            {g: {k: v.to(d) for k, v in group.items()}
             for g, group in self.params.items()}
            for d in mesh.axis_devices('data')}

    def _valid(self, n_samples: int) -> int:
        return num_patches(n_samples, self.cfg)

    def _padded(self, n_samples: int) -> int:
        return padded_length(n_samples, self.cfg)

    def _need_head(self):
        if 'head' not in self.params:
            raise ValueError('this bundle has no classifier head; use embed()')

    def _classify(self, wavs: torch.Tensor,
                  resample_args=None) -> torch.Tensor:
        return _classify(self.params, wavs, self.cfg, self.frontend,
                         self.compute_dtype, self.conv_precision,
                         resample_args, self.conv, self.mesh, self._replicas)

    @torch.inference_mode()
    def embed(self, samples: np.ndarray) -> np.ndarray:
        """16 kHz mono samples -> (n_patches, 1024) embeddings."""
        samples = np.asarray(samples)
        n_valid = num_patches(len(samples), self.cfg)
        wav = self._upload(self._pad_to(samples,
                                        padded_length(len(samples), self.cfg)))
        patches = _patches(_frontend_input(wav, self.frontend), self.cfg,
                           self.frontend)
        out = _over_data(
            lambda p, x: yamnet_lib.embed(p['yamnet'], x, self.compute_dtype,
                                          self.conv_precision, self.conv),
            self.params, patches, self.mesh, self._replicas)
        return out.cpu().numpy()[:n_valid]
