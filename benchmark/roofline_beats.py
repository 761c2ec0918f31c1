"""Work of BEATs (the fine-tuned AudioSet tagger): the yardstick of the
``mfu.stream.beats``, ``attention_roofline.beats`` and
``postln_roofline.beats`` readers.

The counts follow the architecture at the configuration's ``sizes`` (the
checkpoint ``cfg``'s names), not one implementation of it:

* the fbank, a 10 ms frame: as ``roofline_ast.fbank_flops`` counts it (the
  Povey window costs what the Hann window does); its bytes the wire read
  once and the f32 fbank written once;
* a window's products: the patch embedding (2 T p^2 E), the projection
  (2 T E C), the position convolution (2 T C (C / groups) K), each block's
  q, k and v (2 T C 3C), out_proj (2 T C^2), fc1 and fc2 (2 x 2 T C F),
  attention's QK^T and PV (4 T^2 C over its heads) and its gate (2 x 2 T d
  a head: G q, two rows), the head (2 C classes: the predictor of the
  tokens' mean);
* attention's bytes, a block's launch: q, k and v read and o written once,
  2 bytes each in bf16, and the bias rows (heads x (2T - 1) f32) once;
* the post-LN's bytes, a call (two a block): the product's f32 output and
  the f32 residual read, the f32 residual and its bf16 copy written, once;
* the LayerNorms, GELU, softmax, biases and residual adds are not counted
  as work: they are not products.

Windows of a chunk as ``roofline_ast.windows`` counts them (``sizes``'
``input_tdim``). Peaks: ``roofline.PEAKS`` (``roofline.peaks``).
"""

from benchmark import roofline_ast


def tokens(sizes: dict) -> int:
    p = sizes['input_patch_size']
    return (sizes['input_tdim'] // p) * (sizes['input_fdim'] // p)


def attention_flops(sizes: dict) -> float:
    """QK^T, PV and the gate of one window, one block, every head."""
    t, c = tokens(sizes), sizes['encoder_embed_dim']
    return 4.0 * t * t * c + 4.0 * t * c


def attention_bound_s(n_windows: int, sizes: dict, peak: dict) -> float:
    """The least time of ``n_windows`` windows' attention in bf16, every
    block: each block's flops at the bf16 peak or its bytes at the
    memory's, the larger."""
    t, c = tokens(sizes), sizes['encoder_embed_dim']
    nbytes = (n_windows * 4.0 * t * c * 2
              + sizes['encoder_attention_heads'] * (2 * t - 1) * 4)
    return sizes['encoder_layers'] * max(
        n_windows * attention_flops(sizes) / peak['bf16'],
        nbytes / peak['bytes'])


def postln_bound_s(n_windows: int, sizes: dict, peak: dict) -> float:
    """The least time of ``n_windows`` windows' post-LNs (two a block):
    4 + 4 + 4 + 2 bytes a value at the memory's peak."""
    values = n_windows * tokens(sizes) * sizes['encoder_embed_dim']
    return 2 * sizes['encoder_layers'] * values * 14.0 / peak['bytes']


def linear_flops(sizes: dict) -> float:
    """One window's products other than attention's."""
    t, c = tokens(sizes), sizes['encoder_embed_dim']
    e, f, p = sizes['embed_dim'], sizes['encoder_ffn_embed_dim'], \
        sizes['input_patch_size']
    front = (2.0 * t * p * p * e + 2.0 * t * e * c
             + 2.0 * t * c * (c // sizes['conv_pos_groups'])
             * sizes['conv_pos'])
    block = 2.0 * t * c * 3 * c + 2.0 * t * c * c + 4.0 * t * c * f
    return front + sizes['encoder_layers'] * block \
        + 2.0 * c * sizes['predictor_class']


def chunk_s_at_peak(n_samples: int, config: dict, peak: dict) -> float:
    """One chunk's work, each part at its engine's peak: the fbank at f32,
    the products at bf16 under the bf16 function (else f32)."""
    sizes, hop = config['sizes'], config['framehop_prop']
    w = roofline_ast.windows(n_samples, sizes, hop)
    products = w * (linear_flops(sizes)
                    + sizes['encoder_layers'] * attention_flops(sizes))
    rate = peak['bf16' if config['reference_function'] == 'bf16' else 'f32']
    return (roofline_ast.fbank_flops(roofline_ast.frames(n_samples, sizes,
                                                         hop),
                                     sizes['input_fdim'])
            / peak['f32'] + products / rate)
