"""What the benchmark takes from the program: the system under test
(``buzzdetect_torch``) and its kernel names. Nothing else of the harness
imports the program.

The per-chunk path is the pipeline's own: ``runtime/inferer``'s dispatch
thread runs ``predict_async`` on the streamer's wire buffer inside
``_dispatch_scope`` (a CUDA stream of its own) and starts each chunk's copy
back at once (``_start_host_copy``); ``runtime/writer._materialize`` waits
for it.
"""

import os
import re

import numpy as np


# loader arguments a configuration passes only where it states them (YAMNet's
# kernel choices); the program's defaults hold where it does not
STATED = ('frontend', 'conv', 'conv_precision')


def load_model(config: dict, device: str):
    """The bundle of ``config``, built and initialized on ``device``."""
    from buzzdetect_torch.models.registry import load_model as load
    model = load(config['model'], device=device,
                 compute_dtype=config['compute_dtype'],
                 transfer_dtype=config['transfer_dtype'],
                 framehop_prop=config['framehop_prop'],
                 **{k: config[k] for k in STATED if k in config})
    model.initialize()
    return model


def dispatch_scope(model):
    from buzzdetect_torch.runtime.inferer import _dispatch_scope
    return _dispatch_scope(model)


def dispatch(model, samples: np.ndarray):
    """Start one chunk: ``(copy in flight, valid rows)``."""
    from buzzdetect_torch.runtime.inferer import _start_host_copy
    out, n_valid = model.predict_async(samples)
    return _start_host_copy(out), n_valid


def collect(copy, n_valid) -> np.ndarray:
    """Wait for a chunk's scores in host memory; a copy of its valid rows."""
    from buzzdetect_torch.runtime.writer import _materialize
    return np.array(_materialize(copy, n_valid))


def kernel_names(library: str):
    """The ``__global__`` functions of ``buzzdetect_torch/csrc/<library>.cu``,
    as the program has them now: a trace's kernel belongs to the library if
    its name is one of these."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'buzzdetect_torch', 'csrc',
                           f'{library}.cu')) as f:
        src = re.sub(r'__launch_bounds__\s*\([^)]*\)', '', f.read())
    return sorted(set(re.findall(r'__global__\s+void\s+(\w+)\s*\(', src)))


def kernel_matcher(library: str):
    """``match(trace_name)``: True for a kernel of ``library``."""
    pattern = re.compile(r'\b(' + '|'.join(kernel_names(library)) + r')\b')
    return lambda name: bool(pattern.search(name))
