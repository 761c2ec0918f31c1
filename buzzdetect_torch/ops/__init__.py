from buzzdetect_torch.ops.frontend import (  # noqa: F401
    FrontendConfig, log_mel_spectrogram, log_mel_patches, padded_length,
    num_stft_frames, num_patches)
