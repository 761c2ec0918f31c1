"""buzzdetect_torch — the PyTorch/CUDA port of buzzdetect_tpu.

The same streaming bioacoustics pipeline (chunked analysis of long
recordings through a YAMNet log-mel + MobileNet embedder and a classifier
head, producing resumable per-frame CSV activations/detections), written in
PyTorch for one NVIDIA H100, with the conv stack in hand-written CUDA
kernels (``csrc/sepconv.cu``). Entry points run on the card
(``device='cuda'``) unless the caller asks for ``device='cpu'``.
"""

__version__ = '0.1.0'

__all__ = ['analyze', 'Analyzer']


def __getattr__(name):
    # lazy, and pinned into the namespace: importing the `analysis`
    # submodule sets a package attribute of the same name, which would
    # otherwise shadow analyze() on every later access
    if name in ('analyze', 'Analyzer'):
        from buzzdetect_torch.analysis import analyze, Analyzer
        globals()['analyze'] = analyze
        globals()['Analyzer'] = Analyzer
        return globals()[name]
    raise AttributeError(name)
