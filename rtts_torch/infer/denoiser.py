"""Vocoder bias-removal denoiser: port of ``rtts/infer/denoiser.py``.

Flow vocoders emit a characteristic bias noise (their output on zero
conditioning).  The denoiser estimates that bias spectrum once, by running
the vocoder on a silent mel with sigma 0, and subtracts a scaled copy of it
from the magnitude of generated audio, keeping the phase, then resynthesizes
by overlap-add.  Everything runs on the vocoder's device (``torch.fft``).
"""

from __future__ import annotations

import numpy as np
import torch

from rtts_torch.audio.griffin import istft
from rtts_torch.audio.stft import _frame, _hann
from rtts_torch.config import SqueezeWaveConfig
from rtts_torch.models import squeezewave as SW

# log(1e-5): the log floor the audio frontend gives silence
SILENT_LOG_MEL = -11.5127


def _complex_stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    win = torch.as_tensor(_hann(n_fft), device=x.device)
    frames = _frame(x, n_fft, hop, center=True)
    return torch.fft.rfft(frames * win, n=n_fft, dim=-1)


def estimate_bias_spectrum(vocoder: SW.SqueezeWave, cfg: SqueezeWaveConfig,
                           n_frames: int = 88, n_fft: int = 1024,
                           hop: int = 256) -> torch.Tensor:
    """(n_fft//2+1,) mean magnitude of the vocoder's silent-mel output."""
    device = next(vocoder.parameters()).device
    mel = torch.full((1, n_frames, cfg.n_mels), SILENT_LOG_MEL, device=device)
    bias_audio = SW.infer(vocoder, cfg, mel, sigma=0.0)[0]
    return _complex_stft(bias_audio, n_fft, hop).abs().mean(dim=0)


def denoise(audio: torch.Tensor, bias_spectrum: torch.Tensor,
            strength: float = 0.05, n_fft: int = 1024,
            hop: int = 256) -> torch.Tensor:
    """Spectral-subtract the bias profile from (T,) audio."""
    spec = _complex_stft(audio, n_fft, hop)
    mag = spec.abs()
    phase = spec / torch.clamp(mag, min=1e-8)
    mag = torch.clamp(mag - strength * bias_spectrum[None, :], min=0.0)
    return istft(mag * phase, n_fft, hop)[:audio.shape[0]]


class Denoiser:
    """The bias spectrum of one vocoder, estimated once, and ``denoise``
    on the vocoder's device."""

    def __init__(self, vocoder: SW.SqueezeWave, cfg: SqueezeWaveConfig,
                 strength: float = 0.05):
        self.cfg = cfg
        self.strength = strength
        self.bias = estimate_bias_spectrum(vocoder, cfg)

    @torch.no_grad()
    def __call__(self, audio) -> np.ndarray:
        audio = torch.as_tensor(np.asarray(audio, np.float32),
                                device=self.bias.device)
        return denoise(audio, self.bias, self.strength).cpu().numpy()
