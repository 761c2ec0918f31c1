"""What the hand kernels' modules share, below all of them.

Each kernel module, ``ops/<name>.py`` for the source ``csrc/<name>.cu``
(``sepconv``, ``layer1``, ``logmel``, ``attention``, ``epilogue``,
``probe``), declares its library's C interface once, as its ``LIBRARY``:
entry name -> (restype, argtypes).
``Library.load`` builds, loads and binds it (once); ``Library.bind`` binds
another build of the same source (``tools/compare_builds.py``);
``Library.check`` turns a nonzero return code into a ``RuntimeError``
that names the entry, the code and the library's own message; and
``Library.launch`` runs an entry on a device's current stream, the one
way every launcher makes its device current and passes its stream.
``load_libraries`` builds the libraries a path names at once and loads
them (a classifier calls it at its construction, so that a run's set-up
holds the build).

Beside them, what the wrappers share: ``route`` (plain version on the
CPU, kernel on CUDA), ``count_launch`` (the wrappers' launch counters),
and the precision helpers ``exact_f32``, ``round_bf16`` and
``resolve_compute_dtype``.
"""

import contextlib
import ctypes
import importlib
import threading

import torch

from buzzdetect_torch.ops import _build

# every pointer and the stream pass as c_void_p: an untyped int argument
# would be cut to 32 bits
PTR, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)


class Library:
    """The C interface of ``csrc/<name>.cu``: ``entries`` maps each entry
    to its (restype, argtypes); ``errors`` names the entry that turns a
    return code into its message (``const char* (int)``), which joins the
    entries."""

    def __init__(self, name: str, entries: dict, errors: str):
        self.name, self.errors = name, errors
        self.entries = {**entries, errors: (ctypes.c_char_p, [I32])}
        self._lib = None

    def bind(self, lib):
        """Declare every entry on ``lib`` (a ctypes CDLL of this source,
        this checkout's build or another's); returns it. An entry that
        ``lib`` lacks (an older build) stays unbound, and calling it
        raises AttributeError naming it."""
        for entry, (restype, argtypes) in self.entries.items():
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, restype
        return lib

    def load(self):
        """This checkout's library: built on first use, loaded and bound
        once."""
        if self._lib is None:
            self._lib = self.bind(_build.load(self.name))
        return self._lib

    def check(self, lib, entry: str, code: int):
        """Raise on a nonzero ``code`` from ``lib.<entry>``."""
        if code != 0:
            message = getattr(lib, self.errors)(code).decode()
            raise RuntimeError(f'{entry} failed: CUDA error {code} '
                               f'({message})')

    def launch(self, lib, entry: str, device, *args, after=()):
        """``lib.<entry>(*args, stream, *after)`` with ``device`` current
        and its current stream; raises on a nonzero return code."""
        with device_scope(device):
            # the raw handle: torch.cuda.current_stream() builds a Stream
            # object, ~7 us a call on the H100 machine's host against
            # ~0.2 us
            stream = torch._C._cuda_getCurrentRawStream(
                torch.cuda.current_device())
            code = getattr(lib, entry)(*args, stream, *after)
        if code:
            self.check(lib, entry, code)


def load_libraries(names):
    """Build the libraries of ``csrc/<name>.cu`` for each of ``names`` at
    once (one ``nvcc`` each, ``_build.build_all``), then load and bind each
    through the ``LIBRARY`` of ``ops/<name>.py``; returns them."""
    names = list(names)
    _build.build_all(names)
    return [importlib.import_module(f'buzzdetect_torch.ops.{name}')
            .LIBRARY.load() for name in names]


def route(x: torch.Tensor) -> str:
    """'cpu' -> plain version; 'cuda' -> kernel. Anything else raises."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    return x.device.type


def device_scope(device):
    """A context that makes CUDA ``device`` current: a no-op where it is
    current already, which spares a launch the switch there and back."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_count_lock = threading.Lock()


def count_launch(wrapper, mode=None, layers=None, batch=None, tiles=None):
    """One more launch on ``wrapper.launches`` (or on its ``mode`` entry),
    and with ``layers`` = (start, stop) on ``wrapper.ranges[(start, stop,
    mode)]``, which tells the layer ranges of one wrapper apart, and with
    ``batch`` also on ``wrapper.batches[(start, stop, mode, batch)]``, which
    tells the batch sizes apart; ``tiles`` ({entry: n}) adds n to each such
    entry of ``wrapper.launches``. Inferer threads share the wrappers, and
    ``+=`` is not atomic."""
    with _count_lock:
        if mode is None:
            wrapper.launches += 1
        else:
            wrapper.launches[mode] += 1
        for entry, n in (tiles or {}).items():
            wrapper.launches[entry] += n
        if layers is not None:
            wrapper.ranges[(*layers, mode)] += 1
            if batch is not None:
                wrapper.batches[(*layers, mode, batch)] += 1


def exact_f32():
    """Keep float32 convolutions and matrix products out of TF32 on the card:
    cuDNN allows TF32 for convolutions by default, which keeps about three
    decimal digits and breaks the 1e-3 score budget."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def resolve_compute_dtype(compute_dtype) -> torch.dtype:
    """None, float32 (or 'float32') -> torch.float32; bfloat16 (or
    'bfloat16') -> torch.bfloat16; anything else raises."""
    if compute_dtype in (None, torch.float32, 'float32'):
        return torch.float32
    if compute_dtype in (torch.bfloat16, 'bfloat16'):
        return torch.bfloat16
    raise ValueError(f'compute_dtype must be float32 or bfloat16, got '
                     f'{compute_dtype!r}')
