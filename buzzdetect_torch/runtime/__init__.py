from buzzdetect_torch.runtime.coordination import Coordinator, ExitSignal, EXIT  # noqa: F401
from buzzdetect_torch.runtime.assignments import (  # noqa: F401
    AssignFile, AssignChunk, AssignLog)
