"""The hand kernels' ctypes plumbing (``buzzdetect_torch/ops/common.py``) on
the CPU: each library's interface table against its C source, binding,
the return-code check, the launch, the one load call, and the import graph
of ``buzzdetect_torch/ops``. Nothing here builds or loads a library: a
table that has drifted from its C prototype breaks only on the card, so
it is read against the source here."""

import ast
import ctypes
import importlib
import os
import re
import types

import pytest
import torch

from buzzdetect_torch.ops import _build, common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR_OPS = os.path.join(REPO, 'buzzdetect_torch', 'ops')
# a C parameter's type -> the ctypes types that pass it
C_TYPES = {'int': (ctypes.c_int,), 'long long': (ctypes.c_longlong,),
           'float': (ctypes.c_float,)}
C_RESTYPES = {'int': ctypes.c_int, 'const char*': ctypes.c_char_p}


def _library(name):
    return importlib.import_module(f'buzzdetect_torch.ops.{name}').LIBRARY


def _prototypes(name):
    """{entry: (return type, [parameter types])} of every function defined
    in the ``extern "C"`` block of ``csrc/<name>.cu``."""
    with open(os.path.join(_build.DIR_CSRC, f'{name}.cu')) as f:
        src = f.read()
    block = src[src.index('extern "C" {'):]
    block = re.sub(r'//[^\n]*', '', block)
    out = {}
    for m in re.finditer(r'^(const char\*|int)\s+(bz_\w+)\(([^)]*)\)\s*\{',
                         block, re.M):
        # each parameter's type: all but its trailing name
        params = [' '.join(re.match(r'(.*?)\s*\w+$', p.strip())[1].split())
                  .replace(' *', '*') for p in m[3].split(',') if p.strip()]
        out[m[2]] = (m[1], params)
    return out


@pytest.mark.parametrize('name', _build.SOURCES)
def test_interface_table_matches_the_c_prototypes(name):
    """Every entry the module's table declares is defined in the source's
    ``extern "C"`` block with as many parameters, each of a type its
    ctypes type passes (a pointer as c_void_p or a ctypes pointer), and
    the same return type."""
    library = _library(name)
    assert library.name == name
    protos = _prototypes(name)
    for entry, (restype, argtypes) in library.entries.items():
        assert entry in protos, f'{entry} is not in csrc/{name}.cu'
        c_ret, c_params = protos[entry]
        assert C_RESTYPES[c_ret] is restype, entry
        assert len(argtypes) == len(c_params), (entry, c_params)
        for c_type, t in zip(c_params, argtypes):
            if c_type.endswith('*'):
                assert t is ctypes.c_void_p or issubclass(
                    t, ctypes._Pointer), (entry, c_type, t)
            else:
                bare = c_type.replace('const ', '')
                assert t in C_TYPES[bare], (entry, c_type, t)


@pytest.mark.parametrize('name', _build.SOURCES)
def test_bind_sets_every_entry_from_the_table(name):
    """Binding a stand-in library sets each entry's argtypes and restype
    from the table; an entry the stand-in lacks (an older build) stays
    absent."""
    library = _library(name)
    entries = list(library.entries)
    missing = entries[0]
    lib = types.SimpleNamespace(**{e: types.SimpleNamespace()
                                   for e in entries[1:]})
    assert library.bind(lib) is lib
    for entry in entries[1:]:
        restype, argtypes = library.entries[entry]
        fn = getattr(lib, entry)
        assert fn.argtypes == argtypes and fn.restype is restype
    assert not hasattr(lib, missing)
    assert library.errors in entries


def test_check_raises_naming_entry_code_and_message():
    library = common.Library('x', {'bz_x': (common.I32, [])},
                             errors='bz_x_error_string')
    lib = types.SimpleNamespace(
        bz_x_error_string=lambda code: f'message {code}'.encode())
    library.check(lib, 'bz_x', 0)
    with pytest.raises(RuntimeError,
                       match=r'^bz_x failed: CUDA error 7 \(message 7\)$'):
        library.check(lib, 'bz_x', 7)


def test_launch_passes_the_current_stream_last(monkeypatch):
    """``Library.launch`` calls the entry with the device's current stream
    after its arguments, and checks the code."""
    calls = []
    library = common.Library('x', {'bz_x': (common.I32, [])},
                             errors='bz_x_error_string')
    lib = types.SimpleNamespace(
        bz_x=lambda *args: calls.append(args) or args[0],
        bz_x_error_string=lambda code: b'invalid argument')
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(torch._C, '_cuda_getCurrentRawStream',
                        {0: 1234}.__getitem__, raising=False)
    library.launch(lib, 'bz_x', torch.device('cuda'), 0, 5)
    assert calls == [(0, 5, 1234)]
    with pytest.raises(RuntimeError, match='bz_x failed: CUDA error 3'):
        library.launch(lib, 'bz_x', torch.device('cuda'), 3)


def test_load_libraries_builds_at_once_and_binds_each(monkeypatch):
    """One call builds the named sources together, then loads and binds
    each through its module's table, once."""
    built, loaded = [], []
    monkeypatch.setattr(_build, 'build_all', built.append)

    def load(name):
        loaded.append(name)
        return types.SimpleNamespace(**{e: types.SimpleNamespace()
                                        for e in _library(name).entries})
    monkeypatch.setattr(_build, 'load', load)
    for name in ('sepconv', 'logmel'):
        monkeypatch.setattr(_library(name), '_lib', None)
    libs = common.load_libraries(['sepconv', 'logmel'])
    assert built == [['sepconv', 'logmel']] and loaded == built[0]
    assert libs[0].bz_sep_stack.restype is ctypes.c_int
    assert libs[1].bz_logmel_error_string.restype is ctypes.c_char_p
    assert common.load_libraries(['sepconv']) == libs[:1]
    assert loaded == ['sepconv', 'logmel']


def test_route_refuses_devices_other_than_cpu_and_cuda():
    assert common.route(torch.zeros(1)) == 'cpu'
    with pytest.raises(ValueError, match='unsupported device meta'):
        common.route(torch.zeros(1, device='meta'))


def _imports(path):
    """(module, names) of every import in ``path``, at any depth; a plain
    ``import`` gives no names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, ()
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ''
            for a in node.names:
                # ``from package import module`` imports the module itself
                yield f'{module}.{a.name}', ()
                yield module, (a.name,)


OPS_MODULES = sorted(f[:-3] for f in os.listdir(DIR_OPS)
                     if f.endswith('.py'))


@pytest.mark.parametrize('module', OPS_MODULES)
def test_ops_import_nothing_above_them(module):
    """No module under ``buzzdetect_torch/ops`` imports the models, the
    runtime or any other layer above the kernels."""
    bad = [m for m, _ in _imports(os.path.join(DIR_OPS, f'{module}.py'))
           if m.startswith('buzzdetect_torch.')
           and not m.startswith(('buzzdetect_torch.ops',
                                 'buzzdetect_torch.utils'))]
    assert bad == []


def test_no_kernel_module_imports_another_ones_private_names():
    """A kernel module (``ops/<name>.py`` for each ``csrc/<name>.cu``)
    takes from another kernel module only its public names; what they
    share lives in ``ops/common.py``."""
    bad = []
    for name in _build.SOURCES:
        for module, names in _imports(os.path.join(DIR_OPS, f'{name}.py')):
            other = module.rpartition('.')[2]
            if other in _build.SOURCES and other != name:
                bad += [f'{name}: {other}.{n}' for n in names
                        if n.startswith('_')]
    assert bad == []
