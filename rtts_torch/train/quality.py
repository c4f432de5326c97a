"""Eval-time quality scalars: port of the two that ``rtts/train/quality.py``
computes inside the eval step.

- ``mel_cepstral_distortion``: MCD (dB) between predicted and target
  log-mels on DCT-II cepstra c1..cK (c0, the energy, excluded).
- ``stop_length_mae``: mean |predicted length - true length| in frames from
  the teacher-forced stop head, with serving's stop rule.
"""

from __future__ import annotations

import math

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
