from buzzdetect_torch.ops.frontend import (  # noqa: F401
    FrontendConfig, log_mel_spectrogram, log_mel_patches, pad_waveform,
    padded_length, num_stft_frames, num_patches)
from buzzdetect_torch.ops.resample import resample  # noqa: F401
