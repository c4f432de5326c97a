"""STFT -> mel-spectrogram front-end: port of ``rtts/audio/stft.py``.

The slaney mel scale and filterbank and the periodic Hann window are numpy
copies of the reference's.  The transforms run in torch on the input's
device: frames gathered from a static index grid (reflect padding when
centered), then either the matmul DFT (frames @ windowed cos and -sin
bases, two ``torch.matmul``s, the reference's default) or
``torch.fft.rfft``.  The log-mel is the magnitude @ filterbank^T, floored
and logged.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from rtts_torch.config import AudioConfig


def hz_to_mel(f):
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) slaney-normalized triangular filterbank."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # slaney normalization: each filter integrates to ~ constant energy
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann(win_length: int) -> np.ndarray:
    # periodic hann, matching torch.hann_window / librosa default for STFT
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _frame(x: torch.Tensor, n_fft: int, hop: int, center: bool) -> torch.Tensor:
    """(..., T) -> (..., frames, n_fft) by one gather of a static index
    grid; ``center`` reflect-pads n_fft // 2 on each side first (numpy's
    reflect rule, folded into the grid)."""
    src = np.arange(x.shape[-1])
    if center:
        src = np.pad(src, (n_fft // 2, n_fft // 2), mode="reflect")
    num_frames = 1 + (len(src) - n_fft) // hop
    idx = src[np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]]
    return x[..., torch.as_tensor(idx, device=x.device)]


def _dft_bases(n_fft: int, win: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases: (n_fft, n_bins) cos and -sin matrices."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(ang) * win[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * win[:, None]).astype(np.float32)
    return cos_b, sin_b


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    center: bool = True,
    method: str = "matmul",
) -> torch.Tensor:
    """|STFT| of (..., T) -> (..., frames, n_fft//2+1), on x's device.

    method="matmul": frames @ the windowed DFT bases (two matmuls).
    method="fft":    torch.fft.rfft (cross-check).
    """
    win = _hann(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    frames = _frame(x, n_fft, hop_length, center)
    if method == "fft":
        spec = torch.fft.rfft(frames * torch.as_tensor(win, device=x.device),
                              n=n_fft, dim=-1)
        return spec.abs()
    cos_b, sin_b = (torch.as_tensor(b, device=x.device)
                    for b in _dft_bases(n_fft, win))
    re = frames @ cos_b
    im = frames @ sin_b
    return torch.sqrt(re * re + im * im + 1e-12)


def log_mel_spectrogram(
    x: torch.Tensor,
    cfg: AudioConfig,
    mel_basis: Optional[torch.Tensor] = None,
    method: str = "matmul",
) -> torch.Tensor:
    """(..., T) waveform -> (..., frames, n_mels) log-mel on x's device."""
    if mel_basis is None:
        mel_basis = torch.as_tensor(mel_filterbank(
            cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax))
    mag = stft_magnitude(x, cfg.n_fft, cfg.hop_length, cfg.win_length,
                         cfg.center, method)
    mel = mag @ mel_basis.to(x.device).T
    return torch.log(torch.clamp(mel, min=cfg.log_floor))


def make_mel_fn(cfg: AudioConfig, method: str = "matmul"
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A waveform -> log-mel function with the filterbank made once."""
    basis = torch.as_tensor(
        mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                       cfg.fmax))

    def mel_fn(x: torch.Tensor) -> torch.Tensor:
        return log_mel_spectrogram(x, cfg, mel_basis=basis, method=method)

    return mel_fn
