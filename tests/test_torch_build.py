"""The port's kernel build (``buzzdetect_torch/ops/_build.py``) on the CPU:
where each library goes, and what its name is keyed by. Nothing here runs
``nvcc``: the build itself happens on the card's machine (``chip_smoke.py``).
"""

import ctypes
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
    # one 200 s chunk, then the small batches of ragged last chunks and
    # short chunk lengths (B = 2: the 1.92 s embed)
    assert compare_builds.BATCHES == (209, 1, 2, 3, 5, 8)


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
    for name in probe.LIBRARY.entries:
        if name != 'bz_probe_remap_batch':
            setattr(lib, name, Lib())
    assert probe.bind(lib) is lib
    assert lib.bz_probe_dot_f32.argtypes == probe.LIBRARY.entries[
        'bz_probe_dot_f32'][1]
    assert lib.bz_probe_remap.restype is ctypes.c_int
    assert not hasattr(lib, 'bz_probe_remap_batch')


@pytest.mark.parametrize('new', [True, False])
def test_logmel_bind_takes_the_geometry_where_the_build_has_it(new):
    """A build of the FFT kernel (bz_logmel_blocks) takes its wire type
    after the waveform, the row stride after the length and its tile before
    the stream; a build of the
    dense-DFT design (bz_logmel_clusters, other operands) is refused."""
    from buzzdetect_torch.ops import logmel

    class Lib:
        pass
    lib = Lib()
    names = ['bz_logmel', 'bz_logmel_error_string'] + (
        ['bz_logmel_blocks'] if new else ['bz_logmel_clusters'])
    for name in names:
        setattr(lib, name, Lib())
    if not new:
        with pytest.raises(ValueError, match='dense-DFT'):
            logmel.bind(lib)
        return
    assert logmel.bind(lib) is lib
    args = lib.bz_logmel.argtypes
    assert len(args) == 12
    assert args[1] is ctypes.c_int and args[-2] is ctypes.c_int
    assert args[-1] is ctypes.c_void_p
    assert lib.bz_logmel_blocks.argtypes[0] is ctypes.c_int


def test_compare_builds_conv_shares():
    """Each wrapper's launches at each B, priced by its device time there,
    over the run's conv device time."""
    hist = {'fused_front': {209: 3, 2: 1}, 'fused_tail': {209: 3, 2: 1}}
    times = {'fused_front': {209: 0.5, 2: 0.1},
             'fused_tail': {209: 0.6, 2: 0.3}}
    shares = compare_builds.conv_shares(hist, times)
    total = 3 * 0.5 + 0.1 + 3 * 0.6 + 0.3
    assert shares['fused_front'] == pytest.approx({209: 1.5 / total,
                                                   2: 0.1 / total})
    assert shares['fused_tail'] == pytest.approx({209: 1.8 / total,
                                                  2: 0.3 / total})
    assert sum(v for sh in shares.values() for v in sh.values()) == \
        pytest.approx(1.0)


def test_ffma_geometries_asks_for_the_card():
    from buzzdetect_torch.tools import ffma_geometries
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='CUDA'):
        ffma_geometries.main(['--layers', '8', '--batches', '1'])


def test_ffma_geometries_prices_the_rule_against_the_fastest_tile():
    """``regret`` prices the mirror's pick at a LOAD_COST against the
    fastest tile measured, and names the thin tail grids at B <= 8."""
    from buzzdetect_torch.ops import sepconv
    from buzzdetect_torch.tools import ffma_geometries as fg
    s8 = sepconv.tail_specs(8, 9)[0]
    pick = fg.tile_of(sepconv.ffma_geometry(s8, 1))
    times = {(8, 1): {t: 2.0 for t in fg.TILES}}
    times[8, 1][pick] = 3.0
    times[8, 1][fg.WIDE] = 1.0
    mean, worst, thin = fg.regret(times, sepconv._LOAD_COST,
                                  sepconv.H100_CARD)
    assert (mean, worst, thin) == (3.0, 3.0, [])
    assert sepconv._LOAD_COST == 16
    # with loads priced at nothing, layer 8 at B = 1 takes 4-position tiles
    # of 64 channels: 48 blocks
    assert fg.regret(times, 0, sepconv.H100_CARD)[2] == [(8, 1, 48)]


def test_mma_tiles_asks_for_the_card():
    from buzzdetect_torch.tools import mma_tiles
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='CUDA'):
        mma_tiles.main(['--layers', '8', '--batches', '209'])


@pytest.mark.parametrize('layer', range(5, 15))
def test_mma_tiles_floor_is_the_layers_f32_activations(layer):
    """A row's floor is the layer's f32 input read once and its f32 output
    written once, at the bandwidth given: at 1,667 patches layers 5-14
    move 2.09 GB, and layers 8-12 164 MB each."""
    from buzzdetect_torch.ops import sepconv
    from buzzdetect_torch.tools import mma_tiles
    s = sepconv.tail_specs(layer, layer + 1)[0]
    n = 1667 * (s.h * s.w * s.c_in + s.h_out * s.w_out * s.c_out) * 4
    assert mma_tiles.floor_ms(s, 1667, 1e12) == pytest.approx(n / 1e9)
    if 8 <= layer <= 12:
        assert n == 1667 * 24 * 512 * 8
    total = sum(mma_tiles.floor_ms(t, 1667, 1e9)
                for t in sepconv.tail_specs(5, None))
    assert total == pytest.approx(1667 * 313344 * 4 / 1e6)


def test_mma_tiles_names_each_tile_as_the_library_does():
    """``bz_mma_layer_at`` names sep_layer_mma_kernel's tile 0 and the wide
    tile by its rows; a row line marks the library's pick against the
    fastest tile, each tile's time against the floor, and the plain check
    where it was made."""
    from buzzdetect_torch.tools import mma_tiles
    assert mma_tiles.TILES == (0, 128, 64)
    assert [mma_tiles.label(t) for t in mma_tiles.TILES] == [
        'mma', 'wide128', 'wide64']
    line = mma_tiles.row_line(dict(layer=14, b=1667, pick=64,
                                   ms={0: 0.25, 128: 0.2, 64: 0.21},
                                   floor_ms=0.025, differ=[],
                                   plain=(0.004, 0.031, True)))
    assert line.startswith('layer 14 B=1667: pick wide64 0.2100 ms (1.050x '
                           'the fastest, wide128)')
    assert 'mma 0.2500 (10.00x floor)' in line and 'DIFFERENT' not in line
    assert line.endswith('max |mma - plain| 0.004 (atol 0.031)')
    line = mma_tiles.row_line(dict(layer=8, b=1, pick=0,
                                   ms={0: 0.01, 128: 0.02}, floor_ms=0.001,
                                   differ=[128]))
    assert '(1.000x the fastest, mma)' in line and 'plain' not in line
    assert line.endswith("DIFFERENT: ['wide128']")


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__ab893dda_16_sepconv_cu_2c3154fb16sep_layer_kernelILi256ELi5EEEvPKfPfNS_5LayerEii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__ab893dda_16_sepconv_cu_2c3154fb16sep_layer_kernelILi256ELi5EEEvPKfPfNS_5LayerEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__ab893dda_16_sepconv_cu_2c3154fb20sep_layer_mma_kernelILi64ELi2ELi2EEEvPKfPfNS_5LayerEi' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__ab893dda_16_sepconv_cu_2c3154fb20sep_layer_mma_kernelILi64ELi2ELi2EEEvPKfPfNS_5LayerEi
    160 bytes stack frame, 152 bytes spill stores, 152 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 160 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__ab893dda_16_sepconv_cu_2c3154fb10gap_kernelEPKfPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__ab893dda_16_sepconv_cu_2c3154fb10gap_kernelEPKfPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_parse_ptxas_names_each_kernel_with_its_registers_and_spills():
    """``_build.parse_ptxas`` reads ``nvcc -Xptxas -v``: one entry per
    kernel, named with its template arguments, the anonymous namespace
    dropped."""
    assert _build.parse_ptxas(PTXAS) == [
        dict(kernel='sep_layer_kernel<256,5>', registers=127,
             spill_stores=0, spill_loads=0),
        dict(kernel='sep_layer_mma_kernel<64,2,2>', registers=128,
             spill_stores=152, spill_loads=152),
        dict(kernel='gap_kernel', registers=32, spill_stores=0,
             spill_loads=0)]


def test_resources_needs_nvcc(csrc, monkeypatch):
    """Without a CUDA toolkit ``_build.resources`` raises, naming nvcc."""
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build.os.path, 'exists',
                        lambda p: False if p.endswith('nvcc') else True)
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.resources('sepconv')
