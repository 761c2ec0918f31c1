"""AudioDriver contract (parity: reference `src/stream/driver.py:3-23`).

A driver exposes a SoundFile-alike interface over one audio file:
``read(n, dtype)``, ``seek(sample)``, ``tell()``, ``close()`` and attributes
``samplerate`` (of returned samples), ``channels``, ``frames`` (estimated
length in samples at ``samplerate``; may overestimate for truncated files).

Unlike the reference, drivers here may decode directly at the model rate
(``target_rate``), collapsing the decode -> downmix -> resample host chain
into the native stage.
"""


class AudioDriver:
    samplerate: int = None
    channels: int = None
    frames: int = None

    def read(self, n, dtype=None):
        raise NotImplementedError

    def seek(self, sample):
        raise NotImplementedError

    def tell(self):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError
