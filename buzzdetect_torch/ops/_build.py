"""Build and load the port's CUDA kernels (``buzzdetect_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ctypes; ``csrc/*.cuh`` are headers the sources
share. The build goes to ``csrc/build/`` (listed in .gitignore), keyed by a
hash of the source and the headers, and is serialized across threads
and processes with a file lock, so concurrent first users build once.
Nothing here runs at import: callers build at first use (model
initialization for ``sepconv``, ``layer1`` and ``logmel``, and for
``attention`` and ``epilogue`` under the Audio Spectrogram Transformer and
BEATs; the tools for ``probe``), through ``ops/common.py``, which binds
each library to its interface.
``build_all`` starts one ``nvcc`` per source at once, for callers that need
several libraries (``common.load_libraries``).
"""

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

DIR_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
DIR_BUILD = os.path.join(DIR_CSRC, 'build')
# every kernel source of the port, csrc/<name>.cu
SOURCES = tuple(sorted(f[:-3] for f in os.listdir(DIR_CSRC)
                       if f.endswith('.cu')))
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


def _demangle(symbol: str) -> str:
    """A kernel's mangled name as ``name<1,2>``: the last of its nested
    names, with its integer template arguments."""
    i, name = 3 if symbol.startswith('_ZN') else 2, symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        name, i = symbol[j:j + n], j + n
    args = re.match(r'I((?:Li-?\d+E)+)E', symbol[i:])
    return (f'{name}<{",".join(re.findall(r"Li(-?[0-9]+)E", args[1]))}>'
            if args else name)


def parse_ptxas(text: str):
    """``nvcc -Xptxas -v``'s report as one dict per kernel: its name with
    template arguments (``sep_layer_kernel<256,5>``), registers a thread,
    and spill stores and loads in bytes."""
    kernels, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _demangle(m[1])
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            kernels.append(dict(kernel=name, spill_stores=int(m[1]),
                                spill_loads=int(m[2])))
            name = None
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and kernels and 'registers' not in kernels[-1]:
            kernels[-1]['registers'] = int(m[1])
    return kernels


def resources(name: str):
    """Compile ``csrc/<name>.cu`` once more with ``-Xptxas -v`` into a
    throwaway file and return ``parse_ptxas`` of its report: each kernel's
    registers and spills, as the build that loads runs them."""
    os.makedirs(DIR_BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=DIR_BUILD) as tmp:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, '-Xptxas', '-v', '-o',
             os.path.join(tmp, f'{name}.so'),
             os.path.join(DIR_CSRC, f'{name}.cu')],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed building {name}.cu (exit '
                           f'{proc.returncode}):\n{proc.stdout}{proc.stderr}')
    return parse_ptxas(proc.stdout + proc.stderr)


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, built on first call."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
