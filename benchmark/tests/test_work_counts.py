"""The frozen work counts against the port's roofline tool."""

import pytest

from benchmark import roofline


def _tool(b):
    from buzzdetect_torch.tools.roofline import graph_stages
    stages = list(graph_stages((b + 0.5) * 0.96))
    conv = [s for s in stages if s[0].startswith('layer')
            and not s[0].startswith('layer1 ')]
    pool = [s for s in stages if s[0] == 'global avg pool'][0]
    layer1 = [s for s in stages if s[0].startswith('layer1 ')][0]
    head = [s for s in stages if s[0].startswith('head')][0]
    return conv, pool, layer1, head


@pytest.mark.parametrize('b', [209, 32])
def test_conv_stack_flops_match_the_tool(b):
    conv, pool, _l1, _head = _tool(b)
    dw, pw, pooled, _bytes = roofline.conv_stack(b)
    assert dw == sum(s[2] for s in conv if ' dw ' in s[0])
    assert pw == sum(s[2] for s in conv if ' pw ' in s[0])
    assert pooled == pool[2]


@pytest.mark.parametrize('b', [209, 32])
def test_layer1_and_head_match_the_tool(b):
    _conv, _pool, layer1, head = _tool(b)
    n = (b - 1) * 15360 + 15600
    per = roofline.classify_s_at_peak(n, 'f32', {'f32': 1.0, 'bf16': 1.0,
                                                 'bytes': 1.0})
    assert per == roofline.frontend_flops(n) + layer1[2] + head[2] + sum(
        roofline.conv_stack(b)[:3])


def test_the_numbers_the_metrics_use():
    peak = roofline.PEAKS['H100 SXM']
    assert roofline.patches(3_200_000) == 209
    assert roofline.patches(480_000) == 32
    dw, pw, pool, nbytes = roofline.conv_stack(209)
    assert abs((dw + pw + pool) / 1e9 - 28.50) < 0.01
    assert abs(roofline.conv_bound_s(209, "f32", peak) * 1e3 - 0.4254) < 0.001
    assert roofline.conv_bound_s(209, 'bf16', peak) < 0.03e-3
    assert abs(roofline.frontend_flops(3_200_000) / 1e9 - 0.92) < 0.05
    assert roofline.peaks('NVIDIA H100 80GB HBM3') == peak
    with pytest.raises(ValueError):
        roofline.peaks('cpu')
