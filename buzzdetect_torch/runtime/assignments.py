"""Work-item dataclasses passed between pipeline stages.

Parity: reference `src/pipeline/assignments.py:13-51` (AssignFile derives the
ident and partial/complete result paths; AssignChunk carries samples in and
results out; AssignLog carries a log record). Results here may be a
device->host copy still in flight (runtime/inferer.HostCopy) — the writer
materializes it, which is what lets device compute overlap the next chunk's
host work.
"""

import os
from dataclasses import dataclass, field

from buzzdetect_torch import config as cfg
from buzzdetect_torch.loglevels import loglevels
from buzzdetect_torch.utils import build_ident


@dataclass
class AssignFile:
    path_audio: str
    dir_audio: str
    dir_results: str
    track: object = None
    duration_audio: float = None
    chunklist: list = None
    has_results: bool = False    # resume: the partial on disk attests data
    queued_data: bool = False    # a non-empty chunk was queued this run

    def __post_init__(self):
        self.ident = build_ident(self.path_audio, self.dir_audio)
        base = os.path.join(self.dir_results, self.ident)
        self.path_results_base = base
        self.path_results_partial = base + cfg.SUFFIX_RESULT_PARTIAL
        self.path_results_complete = base + cfg.SUFFIX_RESULT_COMPLETE
        self.extension_audio = os.path.splitext(self.path_audio)[1]
        self.shortpath_audio = self.ident + self.extension_audio
        self.shortpath_results_complete = self.ident + cfg.SUFFIX_RESULT_COMPLETE


@dataclass
class AssignChunk:
    file: AssignFile
    chunk: tuple = None            # (start_s, end_s)
    last_chunk: bool = False
    samples: object = None         # np.ndarray float32 @ model rate
    results: object = None         # HostCopy, tensor or np.ndarray (n_frames, n_classes)
    n_valid: int = None            # valid result rows (rest is shape padding)
    delivered: bool = False        # True once handed to the writer (put_write)
    input_rate: int = None         # samples' native rate when they ship
                                   # unresampled for on-device resampling


@dataclass
class AssignLog:
    message: str
    level_str: str
    terminate: bool = False
    level_int: int = field(init=False)

    def __post_init__(self):
        self.level_int = loglevels[self.level_str]
