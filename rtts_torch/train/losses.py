"""TTS composite loss: port of ``rtts/train/losses.py``.

Masked MSE on mel before and after the postnet plus BCE on the stop token
with positive-class weighting, the guided-attention penalty on the decoder
cross-attention, and the stop target.  All in float32.

Each loss is a sum over valid elements divided by their count.  On a
data-parallel shard ``count`` (``collectives.psum`` over the data group)
makes the count the global batch's, so the shards' losses sum to the
one-device loss and their gradients sum to its gradient; a batch
replicated over the group counts each row once per rank, and the sum
comes out the same.  Under tensor parallelism the guided-attention
numerator sums over the model group's heads (``reduce_from_model``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from rtts_torch.parallel.collectives import reduce_from_model


def _local(x: torch.Tensor) -> torch.Tensor:
    return x


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor, count=_local) -> torch.Tensor:
    """Mean squared error over valid frames only. pred/target (B,T,C), mask (B,T)."""
    m = mask[..., None].float()
    se = (pred.float() - target.float()) ** 2 * m
    return se.sum() / torch.clamp(count(m.sum()) * pred.shape[-1], min=1.0)


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor, count=_local) -> torch.Tensor:
    m = mask[..., None].float()
    ae = (pred.float() - target.float()).abs() * m
    return ae.sum() / torch.clamp(count(m.sum()) * pred.shape[-1], min=1.0)


def stop_bce(stop_logits: torch.Tensor, stop_target: torch.Tensor,
             mask: torch.Tensor, pos_weight: float,
             count=_local) -> torch.Tensor:
    """Weighted binary cross-entropy on stop logits. All (B, T)."""
    z = stop_logits.float()
    y = stop_target.float()
    per = -(pos_weight * y * F.logsigmoid(z) + (1.0 - y) * F.logsigmoid(-z))
    m = mask.float()
    return (per * m).sum() / torch.clamp(count(m.sum()), min=1.0)


def tts_loss(mel_pre: torch.Tensor, mel_post: torch.Tensor,
             stop_logits: torch.Tensor, mel_target: torch.Tensor,
             stop_target: torch.Tensor, mel_mask: torch.Tensor,
             stop_pos_weight: float = 8.0, count=_local
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``count`` maps a local count to the global batch's (module
    docstring)."""
    l_pre = masked_mse(mel_pre, mel_target, mel_mask, count)
    l_post = masked_mse(mel_post, mel_target, mel_mask, count)
    l_stop = stop_bce(stop_logits, stop_target, mel_mask, stop_pos_weight,
                      count)
    total = l_pre + l_post + l_stop
    return total, {
        "loss": total,
        "loss_mel_pre": l_pre,
        "loss_mel_post": l_post,
        "loss_stop": l_stop,
        "mel_l1": masked_l1(mel_post, mel_target, mel_mask, count),
    }


def guided_attention_loss(probs_list, token_mask: torch.Tensor,
                          mel_mask: torch.Tensor, reduction_factor: int = 1,
                          sigma: float = 0.2, count=_local,
                          heads=None) -> torch.Tensor:
    """Soft-diagonal guided-attention penalty (Tachibana et al. 2017).

    ``probs_list``: per-cross-layer probabilities, each (B, H, T_groups_padded,
    L_tokens) f32.  Weight w[t, n] = 1 - exp(-(n/N - t/T)^2 / (2 sigma^2))
    with N/T the true token/group counts; the loss is the mean per-row
    penalty over valid rows, heads and layers.  ``count`` as in
    ``tts_loss``; ``heads`` = (total heads, model group) when the H heads
    are a tensor-parallel shard's."""
    n_tok = token_mask.float().sum(1)                                 # (B,)
    n_frames = mel_mask.to(torch.int32).sum(1)
    r = max(1, reduction_factor)
    n_groups = torch.div(n_frames + r - 1, r, rounding_mode="floor").float()
    total = torch.zeros((), device=token_mask.device)
    for probs in probs_list:
        _, _, tg, lk = probs.shape
        t = torch.arange(tg, dtype=torch.float32,
                         device=probs.device)[None, :, None]          # (1,T,1)
        n = torch.arange(lk, dtype=torch.float32,
                         device=probs.device)[None, None, :]          # (1,1,L)
        tt = (t + 0.5) / torch.clamp(n_groups, min=1.0)[:, None, None]
        nn_ = (n + 0.5) / torch.clamp(n_tok, min=1.0)[:, None, None]
        w = 1.0 - torch.exp(-(nn_ - tt) ** 2 / (2.0 * sigma * sigma))
        valid_t = t < n_groups[:, None, None]                         # (B,T,1)
        valid_n = n < n_tok[:, None, None]                            # (B,1,L)
        w = torch.where(valid_t & valid_n, w, torch.zeros_like(w))    # (B,T,L)
        row_pen = (probs.float() * w[:, None]).sum(-1).sum()
        n_heads = probs.shape[1]
        if heads is not None:
            n_heads = heads[0]
            row_pen = reduce_from_model(row_pen, heads[1])
        rows = torch.clamp(count(valid_t[..., 0].float().sum()),
                           min=1.0) * n_heads
        total = total + row_pen / rows
    return total / float(max(1, len(probs_list)))


def make_stop_target(mel_mask: torch.Tensor) -> torch.Tensor:
    """Stop target = 1 at the last valid frame of each utterance."""
    lengths = mel_mask.to(torch.int64).sum(1)
    t = torch.arange(mel_mask.shape[1], device=mel_mask.device)[None, :]
    return (t == (lengths - 1)[:, None]).float()
