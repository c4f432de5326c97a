"""ISTFT + Griffin-Lim phase recovery: port of ``rtts/audio/griffin.py``.

The mel -> waveform path without a vocoder (``Synthesizer.mel_to_audio``'s
fallback, the TTS eval's audio artifact).  Mel inversion uses the clamped
pseudo-inverse of the mel filterbank.  Everything runs on the input's
device: ``torch.fft`` for the transforms, ``index_add_`` for the
overlap-add.  The initial phase is drawn from a ``torch.Generator`` seeded
``seed`` on that device, so it is not the reference's (``jax.random``
cannot be reproduced); given the same angle the iterations are the
reference's (``_griffin_lim_from_angle``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtts_torch.audio.stft import _hann, mel_filterbank
from rtts_torch.config import AudioConfig


def _frame_index(num_frames: int, n_fft: int, hop: int,
                 device) -> torch.Tensor:
    """(num_frames, n_fft) sample index of each frame's taps."""
    idx = np.arange(num_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return torch.as_tensor(idx, device=device)


def _istft_centered(spec_complex: torch.Tensor, n_fft: int,
                    hop: int) -> torch.Tensor:
    """Inverse STFT (hann synthesis), keeping the center padding.
    spec: (frames, bins) complex -> (n_fft + hop*(frames-1),) signal."""
    dev = spec_complex.device
    win = torch.as_tensor(_hann(n_fft), device=dev)
    frames = torch.fft.irfft(spec_complex, n=n_fft, dim=-1) * win
    num_frames = frames.shape[0]
    out_len = n_fft + hop * (num_frames - 1)
    idx = _frame_index(num_frames, n_fft, hop, dev).reshape(-1)
    sig = torch.zeros(out_len, device=dev).index_add_(0, idx,
                                                      frames.reshape(-1))
    norm = torch.zeros(out_len, device=dev).index_add_(
        0, idx, (win * win).repeat(num_frames))
    return sig / torch.clamp(norm, min=1e-8)


def istft(spec_complex: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Inverse STFT -> exactly hop * num_frames samples (center convention)."""
    num_frames = spec_complex.shape[0]
    sig = _istft_centered(spec_complex, n_fft, hop)
    sig = torch.cat([sig, sig.new_zeros(hop)])
    return sig[n_fft // 2:n_fft // 2 + hop * num_frames]


def _griffin_lim_from_angle(magnitude: torch.Tensor, angle: torch.Tensor,
                            n_fft: int, hop: int, n_iter: int) -> torch.Tensor:
    """Griffin-Lim from a given initial phase ``angle`` (frames, bins)."""
    spec = torch.polar(magnitude, angle.to(magnitude.dtype))
    win = torch.as_tensor(_hann(n_fft), device=magnitude.device)
    idx = _frame_index(magnitude.shape[0], n_fft, hop, magnitude.device)
    for _ in range(n_iter):
        x = _istft_centered(spec, n_fft, hop)  # stay in centered domain
        new_spec = torch.fft.rfft(x[idx] * win, n=n_fft, dim=-1)
        phase = new_spec / torch.clamp(new_spec.abs(), min=1e-8)
        spec = magnitude * phase
    return istft(spec, n_fft, hop)


def griffin_lim(
    magnitude: torch.Tensor,
    n_fft: int,
    hop: int,
    n_iter: int = 32,
    seed: int = 0,
) -> torch.Tensor:
    """Phase recovery from |STFT| (frames, bins) -> waveform (hop*frames,),
    on magnitude's device; the initial phase is uniform in [-pi, pi) from a
    generator seeded ``seed`` there."""
    gen = torch.Generator(device=magnitude.device).manual_seed(seed)
    u = torch.rand(magnitude.shape, generator=gen, device=magnitude.device)
    return _griffin_lim_from_angle(magnitude, (2.0 * u - 1.0) * math.pi,
                                   n_fft, hop, n_iter)


def mel_to_audio(log_mel: torch.Tensor, cfg: AudioConfig,
                 n_iter: int = 32) -> torch.Tensor:
    """(T, n_mels) log-mel -> waveform via pinv(mel basis) + Griffin-Lim."""
    basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                           cfg.fmax)
    inv = torch.as_tensor(np.linalg.pinv(basis).T, device=log_mel.device)
    mag = torch.clamp(torch.exp(log_mel.float()) @ inv, min=0.0)
    return griffin_lim(mag, cfg.n_fft, cfg.hop_length, n_iter)
