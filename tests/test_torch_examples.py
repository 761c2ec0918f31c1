"""The port's examples (``buzzdetect_torch/examples/``), each run as
``main(['--device', 'cpu'])``: the counterparts of ``examples/*.py``, with
the checks their output implies (the JAX scripts assert only the scale-out
layouts' byte identity).

No JAX here: each example is the port's own, and the JAX scripts print
rather than return. Every example runs in under ~15 s on one CPU core's
share (model load, the conv kernels' plain versions), so none is marked
slow.
"""

import numpy as np
import torch


def test_quickstart():
    from buzzdetect_torch.examples import quickstart
    from buzzdetect_torch.ops.frontend import FrontendConfig, num_patches
    starts, scores, events = quickstart.main(['--device', 'cpu'])
    cfg = FrontendConfig().with_framehop(1.0)
    assert len(starts) == scores.shape[0] == num_patches(60 * 16000, cfg)
    assert np.isfinite(scores).all() and scores.shape[1] == 13
    assert events and all(e['ident'] == 'field' for e in events)
    print(f'{len(starts)} frames, {len(events)} event(s); max |port - '
          f'reference| = n/a (an example)')


def test_scale_out():
    """Replicas and two hosts byte-identical to one device, the mesh
    byte-identical to one device on the XLA conv path and within one unit
    of the CSVs' 2-digit rounding of the default run (asserted inside);
    on the one CPU the script says it repeats it."""
    from buzzdetect_torch.examples import scale_out
    worst = scale_out.main(['--device', 'cpu'])
    assert worst <= 0.0101
    print(f'max |mesh - one device| = {worst} after 2-digit rounding')


def test_train_detector():
    """Head-only training on the synthesized corpus, then detections at a
    requested precision on two unseen recordings: the buzz fires on more
    frames than the noise."""
    from buzzdetect_torch.examples import train_detector
    fired = train_detector.main(['--device', 'cpu'])
    (buzz, n_buzz), (noise, n_noise) = fired['has_buzz'], fired['no_buzz']
    assert n_buzz == n_noise == 5
    assert buzz > noise
    print(f'has_buzz {buzz}/{n_buzz}, no_buzz {noise}/{n_noise}; max |port '
          f'- reference| = n/a (an example)')


def test_field_monitoring():
    """Watch mode over a simulated recorder with live alerts: every file
    analyzed, the alert command fired, and the archive re-called into
    events, label tracks and clips, one each per buzzy file at least."""
    from buzzdetect_torch.examples import field_monitoring
    alerts, events, labels, clips = field_monitoring.main(['--device',
                                                           'cpu'])
    assert alerts and all(a.startswith('ALERT ins_buzz') for a in alerts)
    idents = {e['ident'] for e in events}
    assert {'hive_0001', 'hive_0003'} <= idents
    assert len(labels) == len(idents) and len(clips) == len(events)
    print(f'{len(alerts)} alerts, {len(events)} events; max |port - '
          f'reference| = n/a (an example)')


def test_examples_refuse_cuda_without_a_card():
    """Each example runs on the card by default: without one it raises
    before any work, as every entry point does."""
    import pytest
    from buzzdetect_torch.examples import (field_monitoring, quickstart,
                                           scale_out, train_detector)
    assert not torch.cuda.is_available()
    for example in (quickstart, scale_out, train_detector,
                    field_monitoring):
        with pytest.raises(RuntimeError, match='CUDA'):
            example.main([])
    print('max |port - reference| = n/a (refusals)')
