"""The port's kernel build (``buzzdetect_torch/ops/_build.py``) on the CPU:
where each library goes, and what its name is keyed by. Nothing here runs
``nvcc``: the build itself happens on the card's machine (``chip_smoke.py``).
"""

import os
import re
import shutil

import pytest
import torch

from buzzdetect_torch.ops import _build
from buzzdetect_torch.tools import compare_builds


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` (sources and headers) that the test may edit."""
    root = tmp_path / 'csrc'
    root.mkdir()
    for f in os.listdir(_build.DIR_CSRC):
        if f.endswith(('.cu', '.cuh')):
            shutil.copy(os.path.join(_build.DIR_CSRC, f), root / f)
    monkeypatch.setattr(_build, 'DIR_CSRC', str(root))
    monkeypatch.setattr(_build, 'DIR_BUILD', str(root / 'build'))
    return root


def test_every_source_and_included_header_is_in_csrc():
    for name in _build.SOURCES:
        path = os.path.join(_build.DIR_CSRC, f'{name}.cu')
        with open(path) as f:
            for header in re.findall(r'#include "([^"]+)"', f.read()):
                assert header.endswith('.cuh'), (name, header)
                assert os.path.exists(os.path.join(_build.DIR_CSRC, header))


@pytest.mark.parametrize('name', _build.SOURCES)
def test_library_path_is_stable_and_in_the_build_dir(csrc, name):
    path = _build.library_path(name)
    assert path == _build.library_path(name)
    assert os.path.dirname(path) == str(csrc / 'build')
    assert os.path.basename(path).startswith(f'lib{name}_')


@pytest.mark.parametrize('name', _build.SOURCES)
def test_editing_a_shared_header_changes_every_library_path(csrc, name):
    """A source that includes csrc/*.cuh must not load a library built
    against the header's old bytes."""
    before = _build.library_path(name)
    with open(csrc / 'ptx.cuh', 'a') as f:
        f.write('\n// edited\n')
    assert _build.library_path(name) != before


@pytest.mark.parametrize('name', _build.SOURCES)
def test_editing_a_source_changes_only_its_library_path(csrc, name):
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(csrc / f'{name}.cu', 'a') as f:
        f.write('\n// edited\n')
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if after[n] != before[n]} == {name}


def test_compare_builds_asks_for_the_card():
    assert not torch.cuda.is_available()  # tests/conftest.py hides the card
    with pytest.raises(RuntimeError, match='CUDA'):
        compare_builds.main(['--against', os.path.join(
            _build.DIR_CSRC, 'sepconv.cu')])


def test_compare_builds_covers_every_mode_and_both_batches():
    modes = {m for _layers, _gap, ms in compare_builds.CASES.values()
             for m in ms}
    assert modes == set(compare_builds.sepconv.MODES)
    assert compare_builds.BATCHES == (209, 5)


def test_compare_builds_asks_for_the_card_with_the_probe_flag():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='CUDA'):
        compare_builds.main(['--against-probe', os.path.join(
            _build.DIR_CSRC, 'probe.cu')])


def test_compare_builds_asks_for_the_card_with_the_logmel_flag():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='CUDA'):
        compare_builds.main(['--against-logmel', os.path.join(
            _build.DIR_CSRC, 'logmel.cu')])


def test_compare_builds_logmel_cases_are_both_batches_and_a_ragged_batch():
    """B = 209 and B = 5 are the first 20,064 and 480 frames of one
    waveform; the ragged batch is two waveforms with samples past their
    last frame."""
    from buzzdetect_torch.ops import logmel
    xs = compare_builds.logmel_inputs(torch.device('cpu'))
    assert list(xs) == list(compare_builds.LOGMEL_CASES)
    frames = {k: (x.shape[0], 1 + (x.shape[1] - 400) // 160)
              for k, x in xs.items()}
    assert frames == compare_builds.LOGMEL_CASES == {
        'B=209': (1, 20064), 'B=5': (1, 480), 'ragged batch of 2': (2, 1001)}
    assert torch.equal(xs['B=5'][0], xs['B=209'][0, :xs['B=5'].shape[1]])
    ragged = xs['ragged batch of 2']
    assert (ragged.shape[1] - logmel.WINDOW) % logmel.HOP == 97
    assert not torch.equal(ragged[0], ragged[1])


def test_compare_builds_probe_covers_the_three_products():
    from buzzdetect_torch.ops import probe
    assert compare_builds.PRODUCTS == ('dot_f32', 'dot_high',
                                       'dot_high_emulated')
    assert set(compare_builds.PRODUCTS) == set(probe._DOT_PLANES)
    w = torch.randn(64, 128)
    assert compare_builds._product_operand('dot_high', w) is w
    assert tuple(compare_builds._product_operand(
        'dot_high_emulated', w).shape) == (2, 64, 128)


def test_logmel_geometries_asks_for_the_card():
    from buzzdetect_torch.tools import logmel_geometries
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='CUDA'):
        logmel_geometries.main([])


def test_compare_builds_needs_a_source_to_compare():
    with pytest.raises(SystemExit):
        compare_builds.main([])


def test_compare_builds_probe_cases_are_the_layout_cases_and_three_dots():
    from buzzdetect_torch.ops import probe
    from buzzdetect_torch.tools.capability_probe import layout_items
    device = torch.device('cpu')
    assert [case for case, _x, _w in layout_items(device)] == list(
        probe.CASES)
    ops = compare_builds.dot_operands(device)
    shapes = [(a.shape[0], a.shape[1], w.shape[1]) for a, w in ops.values()]
    assert shapes == [(1024, 128, 128), (5016, 512, 512), (1254, 1024, 1024)]
    assert shapes == [v[:3] for v in compare_builds.DOT_SHAPES.values()]
    yam = compare_builds._weights(device)
    assert torch.equal(ops['layer 14'][1],
                       yam['layer14/pointwise_conv/kernel'])


def test_probe_bind_declares_what_a_build_has():
    """An older build of csrc/probe.cu lacks bz_probe_remap_batch: binding
    it declares the rest and leaves that one absent."""
    from buzzdetect_torch.ops import probe

    class Lib:
        pass
    lib = Lib()
    for name in [*probe._INTERFACE, 'bz_probe_error_string']:
        if name != 'bz_probe_remap_batch':
            setattr(lib, name, Lib())
    assert probe.bind(lib) is lib
    assert lib.bz_probe_dot_f32.argtypes == probe._INTERFACE[
        'bz_probe_dot_f32']
    assert lib.bz_probe_remap.restype is probe._I32
    assert not hasattr(lib, 'bz_probe_remap_batch')


@pytest.mark.parametrize('new', [True, False])
def test_logmel_bind_takes_the_geometry_where_the_build_has_it(new):
    """A build with bz_logmel_clusters takes (ft, cs) before the stream; an
    older build of csrc/logmel.cu (one fixed geometry) does not."""
    import ctypes
    from buzzdetect_torch.ops import logmel

    class Lib:
        pass
    lib = Lib()
    names = ['bz_logmel', 'bz_logmel_error_string'] + (
        ['bz_logmel_clusters'] if new else [])
    for name in names:
        setattr(lib, name, Lib())
    assert logmel.bind(lib) is lib
    args = lib.bz_logmel.argtypes
    assert len(args) == (12 if new else 10)
    assert args[-1] is ctypes.c_void_p
    if new:
        assert lib.bz_logmel_clusters.argtypes[:2] == [ctypes.c_int] * 2
    else:
        assert not hasattr(lib, 'bz_logmel_clusters')
