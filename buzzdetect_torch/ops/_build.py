"""Build and load the port's CUDA kernels (``buzzdetect_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ctypes; ``csrc/*.cuh`` are headers the sources
share. The build goes to ``csrc/build/`` (listed in .gitignore), keyed by a
hash of the source and the headers, and is serialized across threads
and processes with a file lock, so concurrent first users build once.
Nothing here runs at import: callers build at first use (model
initialization for ``sepconv`` and ``logmel``, the tools for ``probe``).
``build_all`` starts one ``nvcc`` per source at once, for callers that need
several libraries (the doctor, ``chip_smoke.py``).
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

DIR_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
DIR_BUILD = os.path.join(DIR_CSRC, 'build')
# every kernel source of the port, csrc/<name>.cu
SOURCES = ('sepconv', 'logmel', 'probe')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_loaded = {}
_lock = threading.Lock()


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin): '
                           'the CUDA kernels are built from source at first '
                           'use and need the CUDA toolkit')
    return path


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: the file name carries a hash of
    the source, of every shared header (``csrc/*.cuh``, which a source
    includes) and of the flags, so an edited source or header never loads
    a stale library."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(DIR_CSRC) if f.endswith('.cuh'))
    for part in [f'{name}.cu'] + headers:
        with open(os.path.join(DIR_CSRC, part), 'rb') as f:
            digest.update(part.encode() + b'\0' + f.read())
    return os.path.join(DIR_BUILD, f'lib{name}_{digest.hexdigest()[:16]}.so')


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path. Raises with nvcc's output on failure."""
    out = library_path(name)
    os.makedirs(DIR_BUILD, exist_ok=True)
    with open(os.path.join(DIR_BUILD, f'.{name}.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
               os.path.join(DIR_CSRC, f'{name}.cu')]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed building {name}.cu '
                               f'(exit {proc.returncode}):\n{proc.stdout}'
                               f'{proc.stderr}')
        os.replace(tmp, out)
    return out


def build_all(names=SOURCES):
    """Build several sources at once, one ``nvcc`` (in its own thread) per
    source; returns their library paths. Raises the first failure after
    every build has ended."""
    paths, errors = {}, []

    def one(name):
        try:
            paths[name] = build(name)
        except Exception as e:  # collected, re-raised below
            errors.append(e)
    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return [paths[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, built on first call."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
