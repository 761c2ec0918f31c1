"""Seeded field audio: what a hive or meadow recorder hears.

Each recording is Gaussian field noise at about -42 dBFS with a one-tap
low-pass tilt, plus intermittent buzzes (a 150-300 Hz fundamental and three
harmonics under a Hann envelope, 0.5-3 s each, about 15% of the time) and
broadband events (rain drops, wind gusts, handling: decaying noise bursts,
about six a minute). It is made with vectorised numpy from a
``numpy.random.Generator`` and returned as 16 kHz mono int16.
"""

import numpy as np

RATE = 16000


def field_audio(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """``seconds`` of field audio as int16 samples."""
    n = int(round(seconds * RATE))
    x = rng.standard_normal(n, dtype=np.float32) * np.float32(10 ** (-42 / 20))
    x[1:] += np.float32(0.6) * x[:-1]
    n_buzz = int(0.15 * seconds / 1.75) + 1
    for _ in range(n_buzz):
        length = int(rng.uniform(0.5, 3.0) * RATE)
        at = int(rng.integers(0, max(1, n - length)))
        length = min(length, n - at)
        t = np.arange(length, dtype=np.float32) / np.float32(RATE)
        f0 = rng.uniform(150.0, 300.0)
        phase = rng.uniform(0, 2 * np.pi, 4)
        tone = sum(a * np.sin(np.float32(2 * np.pi * f0 * (h + 1)) * t
                              + np.float32(phase[h]))
                   for h, a in enumerate((1.0, 0.5, 0.3, 0.2)))
        amp = np.float32(10 ** (rng.uniform(-30, -15) / 20))
        x[at:at + length] += amp * np.hanning(length).astype(np.float32) * tone
    n_events = int(seconds / 10) + 1
    for _ in range(n_events):
        length = int(rng.uniform(0.05, 0.4) * RATE)
        at = int(rng.integers(0, max(1, n - length)))
        length = min(length, n - at)
        decay = np.exp(-np.arange(length, dtype=np.float32)
                       * np.float32(8.0 / length))
        amp = np.float32(10 ** (rng.uniform(-25, -10) / 20))
        x[at:at + length] += amp * decay * rng.standard_normal(
            length, dtype=np.float32)
    return (np.clip(x, -1.0, 1.0) * 32767.0).round().astype(np.int16)


def recordings(seed: int, count: int, seconds: float, stream: int = 0):
    """``count`` distinct recordings of ``seconds`` each, from ``seed``
    (``stream`` keeps different uses of one seed apart)."""
    children = np.random.SeedSequence([int(seed), int(stream)]).spawn(count)
    return [field_audio(np.random.default_rng(c), seconds) for c in children]
