"""What the benchmark's tests share: a rehearsal run in this process, and
the faults a broken timed path can have."""

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


def altered(out):
    """An answer altered where it is produced."""
    out = out.clone()
    out.view(-1)[out.numel() // 2] += 1.0
    return out


def half_left_out(out):
    """Half of the batch left out, the mean of the rest in its place."""
    out = out.clone()
    rows = out.reshape(-1, out.shape[-1])
    keep = max(1, len(rows) // 2)
    rows[keep:] = rows[:keep].mean(dim=0)
    return out


def break_path(monkeypatch, fault):
    """From now on every model the harness loads (``program.load_model``)
    has ``fault`` applied, in place, to the scores tensor that
    ``predict_async`` hands ``program.dispatch``, before its copy back
    starts; the tensor stays the one the program tagged with its chunk."""
    import torch
    from benchmark import program
    load = program.load_model

    def broken_load(config, device):
        model = load(config, device)
        predict = model.predict_async

        def predict_async(samples, *args, **kwargs):
            out, n_valid = predict(samples, *args, **kwargs)
            with torch.inference_mode():
                out.copy_(fault(out))
            return out, n_valid
        model.predict_async = predict_async
        return model
    monkeypatch.setattr(program, 'load_model', broken_load)
