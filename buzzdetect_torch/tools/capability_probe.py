"""Do the probe's kernels compute what numpy computes, on this card?

Counterpart of ``tools/mosaic_capability_probe.py``. There, each case asked
whether the TPU's Mosaic compiler lowers one tensor-shape operation inside a
kernel at all. On the card every form compiles, so here each case runs one
of the hand-written kernels of ``csrc/probe.cu`` (via ``ops/probe.py``) on
the JAX probe's inputs and holds the result against the same numpy
expression: the 20 layout cases exactly (all 20 in one ``remap_batch``
launch), the three products within the JAX
probe's tolerances (1e-4 for exact f32, 1e-3 for HIGH). ``dot_high`` runs
HIGH natively on the tensor cores (it failed to lower on the TPU), and
``dot_high_emulated`` runs the conv kernels' emulation of it, also on the
tensor cores (``mma.sync`` on a pre-split weight, two accumulators).

Run on the card (the default), or on the CPU through the plain versions:

    python -m buzzdetect_torch.tools.capability_probe [--device cpu]

Each case prints ``PASS``, ``WRONG`` or ``FAIL`` (an exception, reported
and carried past; set ``PROBE_TRACE=1`` for its traceback). The exit code
is 0 only when every case passes.
"""

import argparse
import os
import sys
import traceback

import numpy as np
import torch


def probe(name, fn):
    """Run one case; print its line and return 'PASS', 'WRONG' or 'FAIL'."""
    try:
        ok, detail = fn()
        status = 'PASS' if ok else 'WRONG'
        print(f'  {status:6s} {name}  {detail}', flush=True)
    except Exception as e:  # noqa: BLE001 — report and continue
        status = 'FAIL'
        msg = str(e).split('\n')[0][:110]
        print(f'  FAIL   {name}  [{type(e).__name__}] {msg}', flush=True)
        if os.environ.get('PROBE_TRACE'):
            traceback.print_exc()
    return status


def layout_cases():
    """(name, inputs, numpy reference, detail) of the 20 layout cases: the
    JAX probe's inputs and reference expressions."""
    x3 = np.arange(16 * 16 * 128, dtype=np.float32).reshape(16, 16, 128)
    x4 = np.arange(4 * 16 * 16 * 128, dtype=np.float32).reshape(
        4, 16, 16, 128)
    x2 = np.arange(64 * 256, dtype=np.float32).reshape(64, 256)
    xf = np.arange(8 * 48 * 1024, dtype=np.float32).reshape(8, 48, 1024)
    x5 = np.arange(2 * 384 * 512, dtype=np.float32).reshape(2, 384, 512)
    xc = np.arange(32 * 96 * 128, dtype=np.float32).reshape(32, 96, 128)
    wc = np.arange(32, dtype=np.float32).reshape(32, 1, 1)
    rows = np.arange(16).reshape(1, 16, 1)
    return [
        ('stride_lane', (x3,), x3[:, :, ::2], 'x[:, :, ::2] (lane dim)'),
        ('stride_sublane', (x3,), x3[:, ::2, :],
         'x[:, ::2, :] (sublane dim)'),
        ('stride_leading', (x4,), x4[::2], 'x[::2] (leading dim)'),
        ('reshape_leading_split', (x4,),
         x4.reshape(2, 2, 16, 16, 128)[:, 0],
         '(4,16,16,128)->(2,2,16,16,128) + index'),
        ('reshape_leading_merge', (x4,), x4.reshape(64, 16, 128),
         '(4,16,16,128)->(64,16,128)'),
        ('collapse_to_2d', (x4,), x4.reshape(-1, 128),
         '(4,16,16,128)->(1024,128)'),
        ('split_minor', (x2,), x2.reshape(64, 2, 128),
         '(64,256)->(64,2,128) (split lanes)'),
        ('roll_sublane', (x3,), np.roll(x3, 1, 1), 'roll axis=1'),
        ('roll_lane', (x3,), np.roll(x3, 128, 2), 'roll axis=2 (by 128)'),
        ('pad_slice_shift', (x3,),
         np.pad(x3, ((0, 0), (1, 0), (0, 0)))[:, :-1, :],
         'pad+slice shift (sublane)'),
        ('transpose_minor', (x3,), np.swapaxes(x3, 1, 2),
         'swapaxes(sublane, lane)'),
        ('row_gather', (x4,),
         x4.reshape(4, 16, 16, 128)[:, ::2, ::2].reshape(256, 128),
         'rows p*256 + 2*ho*16 + 2*wo'),
        ('iota_mask', (x3,), np.where(rows % 4 == 0, 0.0, x3),
         'mask rows where pos%4==0'),
        ('iota_mod24', (x3,), np.where(rows % 3 == 0, 0.0, x3),
         'mask rows where pos%3==0'),
        ('split_sublane', (x3,), x3.reshape(16, 8, 2, 128)[:, :, 0],
         '(16,16,128)->(16,8,2,128)[:, :, 0]'),
        ('roll_lane_32', (xf,), np.roll(xf, 32, 2), 'roll axis=2 by 32'),
        ('pad_slice_lane', (xf,),
         np.pad(xf, ((0, 0), (0, 0), (1, 0)))[:, :, :-1],
         'lane shift via pad+slice'),
        ('split_minor_small', (xf,), xf.reshape(8, 48, 32, 32),
         'split lanes -> new minor 32'),
        ('swap_nonminor_merge', (x5,),
         np.swapaxes(x5.reshape(2, 384, 4, 128), 1, 2).reshape(8, 384, 128),
         'swap(1,2)+merge un-interleave'),
        ('outer_broadcast_mul', (xc, wc), xc * wc, '(C,1,1)*(C,HW,pb)'),
    ]


def dot_inputs():
    """The JAX probe's product inputs: (1024, 128) activations from
    ``default_rng(0)`` and a (128, 128) weight from ``default_rng(1)``."""
    xs = np.random.default_rng(0).standard_normal(
        (4, 16, 16, 128)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((128, 128)).astype(
        np.float32)
    return xs.reshape(4 * 16 * 16, 128), w


def _on(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def layout_items(device):
    """The 20 layout cases as ``remap_batch`` items ``(case, x, w)`` on
    ``device``."""
    return [(name, _on(inputs[0], device),
             _on(inputs[1], device) if len(inputs) > 1 else None)
            for name, inputs, _ref, _detail in layout_cases()]


def run_probe(device):
    """Run the 23 cases on ``device``, in the JAX probe's order; returns
    {name: status}. The 20 layout cases go to the card as one
    ``remap_batch`` launch; if it raises, each of them reports ``FAIL``
    with its message."""
    from buzzdetect_torch.ops import probe as kernels
    from buzzdetect_torch.ops.sepconv import pack_pointwise

    def on(a):
        return _on(a, device)

    try:
        items = layout_items(device)
        outs = kernels.remap_batch(items)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        batch = {case: out for (case, _x, _w), out in zip(items, outs)}
    except Exception as e:  # noqa: BLE001 — every layout case reports it
        batch = e

    def layout(case, _inputs, ref, detail):
        def fn():
            if isinstance(batch, Exception):
                raise batch
            return np.array_equal(batch[case].cpu().numpy(), ref), detail
        return fn

    flat, w = dot_inputs()
    ref = flat @ w

    def dot(kernel, weight, atol, detail):
        def fn():
            out = kernel(on(flat), weight())
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            return np.allclose(out.cpu().numpy(), ref, atol=atol), detail
        return fn

    fns = {name: layout(name, *rest) for name, *rest in layout_cases()}
    dots = {
        'collapsed_dot': dot(kernels.dot_f32, lambda: on(w), 1e-4,
                             'reshape(B*H*W,C) @ (C,F), exact f32 (FFMA)'),
        'dot_high': dot(kernels.dot_high, lambda: on(w), 1e-3,
                        'dot @HIGH (native: bf16 hi/lo x3 on the tensor '
                        'cores)'),
        'dot_high_emulated': dot(kernels.dot_high_emulated,
                                 lambda: pack_pointwise(on(w), 'high'), 1e-3,
                                 'dot @HIGH emulated (hi/lo bf16 x3, mma)'),
    }
    order = ['stride_lane', 'stride_sublane', 'stride_leading',
             'reshape_leading_split', 'reshape_leading_merge',
             'collapse_to_2d', 'split_minor', 'roll_sublane', 'roll_lane',
             'pad_slice_shift', 'transpose_minor', 'collapsed_dot',
             'row_gather', 'iota_mask', 'iota_mod24', 'split_sublane',
             'roll_lane_32', 'pad_slice_lane', 'split_minor_small',
             'swap_nonminor_merge', 'outer_broadcast_mul', 'dot_high',
             'dot_high_emulated']
    fns.update(dots)
    return {name: probe(name, fns[name]) for name in order}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Run the capability probe\'s 23 cases through the '
                    'kernels of csrc/probe.cu and check them against numpy.')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help='cuda (default): launch the kernels; cpu: run the '
                         'plain PyTorch versions')
    args = ap.parse_args(argv)
    from buzzdetect_torch.models.classifier import resolve_device
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'CPU (plain PyTorch versions)')
    print(f'device: {device} ({name}), torch {torch.__version__}', flush=True)
    results = run_probe(device)
    bad = [n for n, s in results.items() if s != 'PASS']
    print(f'{len(results) - len(bad)} of {len(results)} cases pass'
          + (f'; not passing: {", ".join(bad)}' if bad else ''), flush=True)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
