"""SqueezeWave flow negative log-likelihood: port of
``rtts/train/vocoder_loss.py``.

    L = sum(z^2) / (2 sigma^2) - sum(log s) - sum(log|det W|)

normalized by the number of audio samples (z elements), the WaveGlow
convention.  Each log-det term is a per-flow scalar already scaled by the
squeezed length and is multiplied by the batch here, as the reference
does: every batch row sees the same W.

On a data-parallel shard ``count`` (a sum over the data group) makes the
sample count, and ``z_rms``, the global batch's: the shards' losses, and
``log_s_mean`` and ``log_det_mean``, then sum to the one-device values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def squeezewave_loss(z: torch.Tensor, log_s_list: List[torch.Tensor],
                     log_det_w_list: List[torch.Tensor], sigma: float = 1.0,
                     count=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, {loss_vocoder, z_rms, log_s_mean, log_det_mean}), all f32
    0-dim tensors on z's device."""
    z = z.float()
    n = z.numel()
    if count is not None:
        n = count(torch.tensor(float(n), device=z.device))
    z_term = (z * z).sum() / (2.0 * sigma * sigma)
    log_s_term = sum(ls.float().sum() for ls in log_s_list)
    log_det_term = sum(log_det_w_list) * z.shape[0]
    loss = (z_term - log_s_term - log_det_term) / n
    return loss, {
        "loss_vocoder": loss,
        "z_rms": (torch.sqrt((z * z).mean()) if count is None
                  else torch.sqrt(count((z * z).sum()) / n)),
        "log_s_mean": log_s_term / n,
        "log_det_mean": log_det_term / n,
    }
