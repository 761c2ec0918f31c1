"""Work and peaks: the yardstick of the roofline and mfu metrics.

The counts follow the work YAMNet needs, not one implementation of it, so
they do not go stale when a later change fuses layers or changes the
frontend:

* the conv stack (layers 2-14 and pooling; the same counts as
  ``buzzdetect_torch/tools/roofline.graph_stages``, frozen here): 2 x 9
  flops a depthwise output and 2 x C a pointwise output, one add a pooled
  value; its bytes are the stack's own input, weights and output, each
  once, at the narrowest type the configuration's function allows (bf16
  activations and pointwise weights under bf16), no intermediate;
* the frontend: a 512-point real FFT a 10 ms frame (2.5 N log2 N flops),
  the window, the magnitude and the 257 x 64 mel product;
* layer 1 (2 x 9 flops an output) and the head (2 x 1024 an output).

Peaks: NVIDIA's data sheets, dense, at the full power limit.
"""

import math

# (f32 outside the tensor cores, bf16 tensor cores) FLOP/s, device bytes/s
PEAKS = {'H100 SXM': {'f32': 67e12, 'bf16': 989e12, 'bytes': 3.35e12},
         'H100 PCIe': {'f32': 51.2e12, 'bf16': 756e12, 'bytes': 2.0e12}}

# (kind, stride, filters) of YAMNet's layers
LAYERS = ((('conv', 2, 32),) + (('sep', 1, 64), ('sep', 2, 128),
                                ('sep', 1, 128), ('sep', 2, 256),
                                ('sep', 1, 256), ('sep', 2, 512))
          + (('sep', 1, 512),) * 5 + (('sep', 2, 1024), ('sep', 1, 1024)))
PATCH = (96, 64)
N_CLASSES = 13
FRAME, HOP, FFT, MEL = 400, 160, 512, 64
MIN_SAMPLES, PATCH_SAMPLES = 15600, 15360


def peaks(card: str) -> dict:
    """The peak table of the card ``torch.cuda.get_device_name`` names."""
    if 'H100' not in card:
        raise ValueError(f'no peak table for {card!r}')
    return PEAKS['H100 PCIe' if 'PCIe' in card else 'H100 SXM']


def patches(n_samples: int) -> int:
    """Patches of a chunk of ``n_samples`` at 16 kHz, framehop 1."""
    extra = max(0, n_samples - MIN_SAMPLES)
    n = 1 + -(-extra // PATCH_SAMPLES)
    return max(1, min(n, (n_samples - 1) // PATCH_SAMPLES + 1))


def sep_layers(b: int):
    """Per separable layer: (index, depthwise flops, pointwise flops, input
    elements, C, F) at ``b`` patches; and the pooled elements."""
    h, w = (math.ceil(PATCH[0] / 2), math.ceil(PATCH[1] / 2))
    c, out = 32, []
    for i, (_kind, stride, f) in enumerate(LAYERS[1:], start=2):
        ho, wo = math.ceil(h / stride), math.ceil(w / stride)
        out.append((i, 2 * b * ho * wo * c * 9, 2 * b * ho * wo * c * f,
                    b * h * w * c, c, f))
        h, w, c = ho, wo, f
    return out, b * h * w * c


def conv_stack(b: int, function: str = 'f32'):
    """(depthwise flops, pointwise flops, pooling flops, bytes) of layers
    2-14 and pooling at ``b`` patches under ``function`` ('f32' or 'bf16')."""
    layers, pooled = sep_layers(b)
    act = 2 if function == 'bf16' else 4
    weights = sum(9 * c * 4 + c * 4 + c * f * act + f * 4
                  for _i, _d, _p, _n, c, f in layers)
    nbytes = layers[0][3] * act + weights + b * layers[-1][5] * 4
    return (sum(x[1] for x in layers), sum(x[2] for x in layers), pooled,
            nbytes)


def conv_bound_s(b: int, function: str, peak: dict) -> float:
    """The least time the card could take for the conv stack: the larger
    of its flops at the configuration's product peak (all of them, the
    depthwise too) and its bytes at the memory's."""
    dw, pw, pool, nbytes = conv_stack(b, function)
    rate = peak['bf16' if function == 'bf16' else 'f32']
    return max((dw + pw + pool) / rate, nbytes / peak['bytes'])


def frontend_flops(n_samples: int) -> float:
    """Frontend work of one chunk: its frames' FFTs, windows, magnitudes and
    mel products."""
    b = patches(n_samples)
    frames = b * PATCH[0]
    bins = FFT // 2 + 1
    return frames * (2.5 * FFT * math.log2(FFT) + FRAME + 3 * bins
                     + 2 * bins * MEL)


def classify_s_at_peak(n_samples: int, function: str, peak: dict) -> float:
    """One chunk's classify, each stage's work at its own engine's peak:
    frontend, layer 1, depthwise, pooling and head on the f32 pipes; the
    pointwise products on the tensor cores under bf16, else the f32 pipes."""
    b = patches(n_samples)
    dw, pw, pool, _bytes = conv_stack(b, function)
    layer1 = 2 * b * 48 * 32 * 32 * 9
    head = 2 * b * 1024 * N_CLASSES
    f32 = frontend_flops(n_samples) + layer1 + dw + pool + head
    if function == 'bf16':
        return f32 / peak['f32'] + pw / peak['bf16']
    return (f32 + pw) / peak['f32']
