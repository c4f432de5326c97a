"""Eval-time quality scalars: port of ``rtts/train/quality.py``.

- ``mel_cepstral_distortion``: MCD (dB) between predicted and target
  log-mels on DCT-II cepstra c1..cK (c0, the energy, excluded); torch, in
  the eval step.
- ``stop_length_mae``: mean |predicted length - true length| in frames from
  the teacher-forced stop head, with serving's stop rule; torch.
- ``multi_resolution_stft_distance``: spectral convergence + log-magnitude
  L1 between a rendered or vocoded waveform and the ground truth, over
  three STFT resolutions; a host-side numpy copy of the reference's.
- ``attention_diagonality``: band mass and focus of one head-averaged
  cross-attention map; a host-side numpy copy.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def _dct_basis(n_mels: int, n_coeffs: int, device=None) -> torch.Tensor:
    """Orthonormal DCT-II basis (n_mels, n_coeffs + 1)."""
    n = torch.arange(n_mels, dtype=torch.float32, device=device)
    k = torch.arange(n_coeffs + 1, dtype=torch.float32, device=device)
    basis = torch.cos(math.pi * (n[:, None] + 0.5) * k[None, :] / n_mels)
    scale = torch.full_like(k, math.sqrt(2.0 / n_mels))
    scale[0] = math.sqrt(1.0 / n_mels)
    return basis * scale[None, :]


def mel_cepstral_distortion(pred: torch.Tensor, target: torch.Tensor,
                            mask: torch.Tensor,
                            n_coeffs: int = 13) -> torch.Tensor:
    """MCD (dB) over valid frames.  pred/target (B, T, n_mels) natural-log
    mels; mask (B, T).  MCD_t = (10/ln10) sqrt(2 sum_k (c_pred,k -
    c_tgt,k)^2), averaged over valid frames."""
    basis = _dct_basis(pred.shape[-1], n_coeffs, pred.device)
    diff = (pred.float() - target.float()) @ basis          # (B, T, K+1)
    sq = (diff[..., 1:] ** 2).sum(-1)                       # drop c0
    per_frame = torch.sqrt(torch.clamp(2.0 * sq, min=1e-12))
    m = mask.float()
    return (10.0 / math.log(10.0)) * (per_frame * m).sum() / torch.clamp(
        m.sum(), min=1.0)


def stop_length_mae(stop_logits: torch.Tensor, mel_mask: torch.Tensor,
                    threshold: float = 0.5) -> torch.Tensor:
    """Mean |pred_len - true_len| (frames): pred_len is the first frame whose
    stop probability crosses ``threshold`` (+1), or T when none does."""
    t = stop_logits.shape[1]
    fired = torch.sigmoid(stop_logits.float()) > threshold
    idx = torch.arange(t, device=stop_logits.device)[None, :]
    first = torch.where(fired, idx, torch.full_like(idx, t)).min(1).values
    pred_len = torch.clamp(first + 1, max=t)
    true_len = mel_mask.to(torch.int64).sum(1)
    return (pred_len - true_len).abs().float().mean()


# (n_fft, hop, win): the standard MR-STFT triple — fine / coarse / mid
# time-frequency trade-offs so neither transient smearing nor tonal error
# can hide from all three.
_MRSTFT_RESOLUTIONS = ((512, 128, 240), (1024, 256, 600), (2048, 512, 1200))


def _stft_mag(x: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """|STFT| of a 1-D signal: hann-windowed frames, no centering.
    Returns (n_frames, n_fft//2 + 1); empty when the signal is shorter
    than one window."""
    x = np.asarray(x, np.float64)
    if len(x) < win:
        return np.zeros((0, n_fft // 2 + 1))
    n_frames = 1 + (len(x) - win) // hop
    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    window = np.hanning(win)
    return np.abs(np.fft.rfft(x[idx] * window, n=n_fft, axis=-1))


def multi_resolution_stft_distance(
        pred_wav: np.ndarray, true_wav: np.ndarray,
        resolutions=_MRSTFT_RESOLUTIONS) -> dict:
    """Waveform-domain distance between predicted and ground-truth audio.

    Both inputs are 1-D float waveforms (any common scale); they are
    trimmed to the shorter length.  Returns::

        {"spectral_convergence": mean_r ||S_t - S_p||_F / ||S_t||_F,
         "log_stft_l1":          mean_r mean |log S_t - log S_p|,
         "mr_stft":              sum of the two}

    all averaged over ``resolutions`` (skipping any the signals are too
    short for).  0 for identical signals; insensitive to constant phase
    shifts of the reconstruction (magnitude-only), which is what makes it
    usable with Griffin-Lim renders as well as vocoded audio.
    """
    n = min(len(pred_wav), len(true_wav))
    p = np.asarray(pred_wav[:n], np.float64)
    t = np.asarray(true_wav[:n], np.float64)
    scs, mags = [], []
    for n_fft, hop, win in resolutions:
        sp = _stft_mag(p, n_fft, hop, win)
        st = _stft_mag(t, n_fft, hop, win)
        if st.shape[0] == 0:
            continue
        denom = np.sqrt(np.sum(st ** 2))
        scs.append(float(np.sqrt(np.sum((st - sp) ** 2))
                         / max(denom, 1e-9)))
        eps = 1e-7
        mags.append(float(np.mean(np.abs(np.log(st + eps)
                                         - np.log(sp + eps)))))
    if not scs:
        return {"spectral_convergence": float("nan"),
                "log_stft_l1": float("nan"), "mr_stft": float("nan")}
    sc, mag = float(np.mean(scs)), float(np.mean(mags))
    return {"spectral_convergence": sc, "log_stft_l1": mag,
            "mr_stft": sc + mag}


def attention_diagonality(align: np.ndarray, n_frames: int, n_tokens: int,
                          band_frac: float = 0.12
                          ) -> Tuple[float, float]:
    """(diagonality, focus) of one head-averaged cross-attention map.

    align: (T_rows, L_cols) row-normalized probs (rows may be mel GROUPS
    under a reduction factor — only the first ``n_frames`` rows /
    ``n_tokens`` cols are scored).  diagonality = mean row mass inside a
    band of half-width ``band_frac * n_tokens`` around the ideal monotone
    line l*(t) = t * (L-1)/(T-1); focus = mean max row prob (how peaky
    the alignment is).  Both in [0, 1]; a trained, aligned model pushes
    both up, an untrained one sits near L_band/L and 1/L."""
    a = np.asarray(align, np.float64)[:n_frames, :n_tokens]
    t_n, l_n = a.shape
    if t_n == 0 or l_n == 0:
        return 0.0, 0.0
    # rows were normalized over the PADDED token axis; renormalize over
    # the valid slice so padding attention doesn't deflate the score
    row_sum = a.sum(axis=1, keepdims=True)
    a = a / np.maximum(row_sum, 1e-9)
    ideal = (np.arange(t_n) * (l_n - 1) / max(t_n - 1, 1))[:, None]
    radius = max(1.0, band_frac * l_n)
    band = np.abs(np.arange(l_n)[None, :] - ideal) <= radius
    diagonality = float((a * band).sum(axis=1).mean())
    focus = float(a.max(axis=1).mean())
    return diagonality, focus
