"""Distinct chunks of field audio, served over and over: ``chunks`` of the
configuration's ``chunklength`` each, from the seed, as int16 wire samples.
With ``pinned`` (and a card) each chunk lives in page-locked host memory,
as a decode stage that writes straight into pinned buffers leaves it, so
the program's own pinning copy finds nothing to do; without it, in
ordinary pageable memory, as the pipeline's streamers hand it over. A
traffic file leaves ``chunk_seconds`` out; only a CPU rehearsal sets it,
to a tiny length."""

from benchmark import synth


def _pinned(samples):
    import torch
    if not torch.cuda.is_available():
        return samples
    buf = torch.empty(len(samples), dtype=torch.int16, pin_memory=True)
    buf.numpy()[:] = samples
    return buf.numpy()


def generate(params: dict, config: dict, seed: int):
    """``{'chunks': [int16 samples, ...]}``."""
    seconds = params.get('chunk_seconds', config['chunklength'])
    chunks = synth.recordings(seed, params['chunks'], seconds, stream=1)
    if params.get('pinned'):
        chunks = [_pinned(c) for c in chunks]
    return {'chunks': chunks}
