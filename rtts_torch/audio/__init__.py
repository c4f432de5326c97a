"""The audio frontend of the port: STFT and log-mel (``stft``), ISTFT and
Griffin-Lim (``griffin``), wav IO (``wav``) and resampling (``resample``);
counterparts of ``rtts/audio/``."""

from rtts_torch.audio.stft import (
    mel_filterbank,
    stft_magnitude,
    log_mel_spectrogram,
    make_mel_fn,
)
from rtts_torch.audio.wav import read_wav, write_wav
from rtts_torch.audio.resample import resample_poly

__all__ = [
    "mel_filterbank",
    "stft_magnitude",
    "log_mel_spectrogram",
    "make_mel_fn",
    "read_wav",
    "write_wav",
    "resample_poly",
]
