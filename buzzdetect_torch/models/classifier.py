"""The end-to-end chunk classifier: waveform -> log-mel patches -> embed ->
head, on one torch device.

Counterpart of ``buzzdetect_tpu/models/classifier.py`` with the same surface
(``predict``, ``predict_async``, ``predict_async_batch``, ``embed``,
``warmup``, ``to_wire``, ``classify_resident``) and the same ``n_valid``
semantics: each waveform is zero-padded to ``padded_length`` and the patch
rows past the chunk's true patch count are discarded by the caller. Zero
padding matches the reference's pad_waveform, so those rows are the only
difference. PyTorch runs eagerly, so there is no shape bucketing.

On a CUDA device the conv stack runs through the hand-written kernels of
``ops/sepconv.py`` (and the log-mel through ``ops/logmel.py`` with
``frontend='pallas'``), and results stay on the card until the pipeline
copies them back (runtime/inferer.py). On the CPU every op runs its plain
version. Nothing falls back: an option the port computes runs its kernel or
raises, and an option it does not compute raises NotImplementedError naming
the ROADMAP item that brings it.

The knobs, and how they resolve here:

* ``frontend``: ``'auto'`` and ``'xla'`` are the matmul frontend
  (``ops/frontend.py``); ``'pallas'`` is the fused log-mel kernel, on the
  single-chunk and the batch path alike.
* ``conv``: ``'auto'`` and ``'pallas'`` run the hand-written conv kernels at
  every compute dtype. The JAX package's ``resolve_conv_auto`` sends bf16
  to its XLA conv, because Mosaic cannot rotate 16-bit vectors and the f32
  depthwise work then dominates on a TPU; the card has no such limit, so
  the port's bf16 computes the JAX package's ``conv='pallas'`` bf16
  function. ``'xla'`` (the XLA conv path) is not ported and raises.
* ``conv_precision``: ``'auto'`` resolves to ``'highest'`` on the kernels,
  as the JAX package resolves it for ``conv='pallas'``; ``'high'`` selects
  the emulated-HIGH mode. bf16 compute ignores it (one bf16 product).
* ``compute_dtype``: float32 (``None``, ``torch.float32``, ``'float32'``)
  or bfloat16 (``torch.bfloat16``, ``'bfloat16'``).
"""

import numpy as np
import torch

from buzzdetect_torch.models import yamnet as yamnet_lib
from buzzdetect_torch.models.heads import apply_head
from buzzdetect_torch.models.weights import params_from_numpy
from buzzdetect_torch.ops import logmel, sepconv
from buzzdetect_torch.ops.frontend import (
    FrontendConfig, padded_length, num_patches, log_mel_patches,
    patches_from_log_mel)
from buzzdetect_torch.utils import encode_mulaw, quantize_int16

_LN256 = float(np.log(256.0))


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


def resolve_conv(conv) -> str:
    """'auto' and 'pallas' -> 'pallas' (the CUDA conv kernels, at every
    compute dtype); 'xla' raises NotImplementedError naming its ROADMAP
    item; anything else raises ValueError."""
    if conv not in ('auto', 'xla', 'pallas'):
        raise ValueError("conv must be 'auto', 'xla' or 'pallas'")
    if conv == 'xla':
        raise NotImplementedError(
            "conv='xla': the XLA conv path is not ported to "
            "buzzdetect_torch yet (ROADMAP, \"The XLA conv path "
            "(conv='xla')\"); 'auto' and 'pallas' run the CUDA conv kernels")
    return 'pallas'


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
    """(..., L) padded f32 waveforms -> (..., P, 96, 64) log-mel patches
    through the selected frontend: 'xla' (the matmul frontend) or 'pallas'
    (the fused log-mel kernel, which takes (L,) or (B, L))."""
    if frontend == 'pallas':
        return patches_from_log_mel(
            logmel.log_mel_spectrogram_fused(wavs, cfg), cfg)
    return log_mel_patches(wavs, cfg)


def _classify(params, wavs: torch.Tensor, cfg: FrontendConfig,
              frontend: str = 'xla', compute_dtype=torch.float32,
              conv_precision: str = 'highest'):
    """(..., L) padded wire waveforms -> (..., n_patches, n_classes)."""
    patches = _patches(_to_float(wavs), cfg, frontend)   # (..., P, 96, 64)
    lead = patches.shape[:-2]
    emb = yamnet_lib.embed(params['yamnet'], patches.reshape(-1, 96, 64),
                           compute_dtype, conv_precision)
    return apply_head(params['head'], emb).reshape(*lead, -1)


class ChunkClassifier:
    """Callable classifier over variable-length chunks.

    ``arrays`` are numpy parameters as a bundle holds them (see
    ``models/weights.params_from_numpy``). ``device`` is ``'cuda'`` unless
    the caller asks for ``'cpu'``; on CUDA the kernels are built and loaded
    here, at construction, not at the first dispatch.
    """

    def __init__(self, arrays: dict, framehop_prop: float = 1.0,
                 compute_dtype=None, device='cuda', transfer_dtype='float32',
                 frontend='auto', conv='auto', conv_precision='auto'):
        self.cfg = FrontendConfig().with_framehop(framehop_prop)
        self.compute_dtype = sepconv.resolve_compute_dtype(compute_dtype)
        if frontend not in ('auto', 'xla', 'pallas'):
            raise ValueError("frontend must be 'auto', 'xla' or 'pallas'")
        self.frontend = 'xla' if frontend == 'auto' else frontend
        self.conv = resolve_conv(conv)
        if conv_precision not in ('auto', 'high', 'highest'):
            raise ValueError(
                "conv_precision must be 'auto', 'high' or 'highest'")
        self.conv_precision = ('highest' if conv_precision == 'auto'
                               else conv_precision)
        # the conv kernels' mode ('highest' | 'bf16' | 'high')
        self.mode = sepconv.resolve_mode(
            self.compute_dtype, yamnet_lib.conv_mxu_precision(
                self.compute_dtype, self.conv_precision))
        # 'mulaw' rides int8 on the wire; linear int8 is not offered
        self.transfer_name = str(transfer_dtype)
        if self.transfer_name not in ('float32', 'int16', 'mulaw'):
            raise ValueError('transfer_dtype must be float32, int16 or mulaw')
        self.transfer_dtype = np.dtype(
            'int8' if self.transfer_name == 'mulaw' else self.transfer_name)
        self.device = resolve_device(device)
        sepconv.exact_f32()
        if self.device.type == 'cuda':
            sepconv.load_kernels()
            if self.frontend == 'pallas':
                logmel.load_kernels()
        self.params = params_from_numpy(arrays, self.device)
        # the mode's pointwise operands, packed once beside the f32 params
        self.params['yamnet'] = sepconv.pack_params(self.params['yamnet'],
                                                    self.mode)

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
        samples = self.to_wire(samples)
        if len(samples) == target:
            return samples
        out = np.zeros(target, dtype=samples.dtype)
        out[:len(samples)] = samples
        return out

    def _upload(self, wire: np.ndarray) -> torch.Tensor:
        """Host wire buffer -> device tensor (pinned, non-blocking on CUDA)."""
        t = torch.from_numpy(np.ascontiguousarray(wire))
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _check_rate(self, input_rate):
        if input_rate and input_rate != self.cfg.sample_rate:
            raise NotImplementedError(
                f'input_rate={input_rate}: on-device resampling is not '
                f'ported yet (ROADMAP "Modules to port"); decode at '
                f'{self.cfg.sample_rate} Hz')

    def _need_head(self):
        if 'head' not in self.params:
            raise ValueError('this bundle has no classifier head; use embed()')

    # --- public API ------------------------------------------------------------
    def predict(self, samples: np.ndarray,
                input_rate: int = None) -> np.ndarray:
        """Mono 16 kHz samples -> (n_patches, n_classes) activations."""
        out, n_valid = self.predict_async(samples, input_rate=input_rate)
        return out.cpu().numpy()[:n_valid]

    @torch.inference_mode()
    def predict_async(self, samples: np.ndarray, input_rate: int = None):
        """Dispatch without waiting; returns (device_tensor, n_valid).

        On CUDA the kernels run asynchronously on the current stream; the
        pipeline starts the copy back at once (runtime/inferer.py) and the
        writer waits for it, so host decode overlaps device compute.
        """
        self._need_head()
        self._check_rate(input_rate)
        samples = np.asarray(samples)
        n_valid = num_patches(len(samples), self.cfg)
        wav = self._pad_to(samples, padded_length(len(samples), self.cfg))
        return self.classify_resident(self._upload(wav)), n_valid

    @torch.inference_mode()
    def predict_async_batch(self, samples_list, input_rate: int = None):
        """Dispatch several chunks as ONE batched call. All chunks pad to the
        largest needed length. Returns (scores (B, P, C), [n_valid each])."""
        self._need_head()
        self._check_rate(input_rate)
        arrs = [np.asarray(s) for s in samples_list]
        n_valids = [num_patches(len(a), self.cfg) for a in arrs]
        target = padded_length(max(len(a) for a in arrs), self.cfg)
        batch = np.stack([self._pad_to(a, target) for a in arrs])
        return self._classify(self._upload(batch)), n_valids

    @torch.inference_mode()
    def classify_resident(self, wav_device: torch.Tensor) -> torch.Tensor:
        """Classify an already device-resident padded wire-format waveform
        (no host staging): (n_patches, n_classes) on the device."""
        self._need_head()
        return self._classify(wav_device)

    def _classify(self, wavs: torch.Tensor) -> torch.Tensor:
        return _classify(self.params, wavs, self.cfg, self.frontend,
                         self.compute_dtype, self.conv_precision)

    @torch.inference_mode()
    def embed(self, samples: np.ndarray) -> np.ndarray:
        """16 kHz mono samples -> (n_patches, 1024) embeddings."""
        samples = np.asarray(samples)
        n_valid = num_patches(len(samples), self.cfg)
        wav = self._upload(self._pad_to(samples,
                                        padded_length(len(samples), self.cfg)))
        patches = _patches(_to_float(wav), self.cfg, self.frontend)
        out = yamnet_lib.embed(self.params['yamnet'], patches,
                               self.compute_dtype, self.conv_precision)
        return out.cpu().numpy()[:n_valid]

    def warmup(self, chunk_samples: int):
        """Run the nominal chunk length once (first-use allocations)."""
        self.predict(np.zeros(chunk_samples, np.float32))
