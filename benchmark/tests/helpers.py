"""What the benchmark's tests share: a rehearsal run in this process."""

import json

import pytest


def rehearse(capsys, workload, seed=5, seconds=2.0, trace=0, root=None):
    """One ``--rehearse`` run of ``workload``; its result line as a dict."""
    from benchmark import run
    argv = ['--workload', workload, '--seed', str(seed), '--seconds',
            str(seconds), '--trace', str(trace), '--rehearse']
    kw = {} if root is None else {'root': root}
    assert run.main(argv, **kw) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('rehearsal: ')]
    assert lines, 'the rehearsal printed no result'
    return json.loads(lines[-1][len('rehearsal: '):])


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; this machine has none')
    return torch.device('cuda')
