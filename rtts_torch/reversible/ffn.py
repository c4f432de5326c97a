"""Pre-LN feed-forward sublayer, optionally chunked over the sequence.

Port of ``rtts/reversible/ffn.py``: LN -> dense(d -> d_ff) -> activation ->
dense(d_ff -> d).  ``chunked_ffn`` applies it to ``chunk_size`` slices of
the sequence, each under ``torch.utils.checkpoint`` (the reference's
``lax.map`` over ``jax.checkpoint``), so a training pass keeps no
(B, L, d_ff) hidden: each chunk's is recomputed in the backward.  The
fused kernel of the same sublayer (K6) is ``rtts_torch/ops/chunked_ffn.py``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rtts_torch.nn.layers import Dense, LayerNorm, activation


class FFN(nn.Module):
    """Params {ln, w_in, w_out} (``ffn_init``)."""

    def __init__(self, d_model: int, d_ff: int, *, generator=None, device=None):
        super().__init__()
        self.ln = LayerNorm(d_model, device=device)
        self.w_in = Dense(d_model, d_ff, generator=generator, device=device)
        self.w_out = Dense(d_ff, d_model, generator=generator, device=device)


def _ffn_body(p: FFN, x: torch.Tensor, act_name: str,
              compute_dtype=None) -> torch.Tensor:
    h = p.ln(x)
    h = activation(act_name)(p.w_in(h, compute_dtype))
    return p.w_out(h, compute_dtype)


def chunked_ffn(p: FFN, x: torch.Tensor, chunk_size: int = 0,
                act: str = "gelu", compute_dtype=None) -> torch.Tensor:
    """x: (B, L, D) -> (B, L, D).  Pre-LN FFN, chunked over L when
    ``chunk_size`` > 0 and L is longer than one chunk."""
    if chunk_size <= 0 or x.shape[-2] <= chunk_size:
        return _ffn_body(p, x, act, compute_dtype)
    l = x.shape[-2]
    if l % chunk_size != 0:
        raise ValueError(f"seq len {l} not a multiple of ffn chunk {chunk_size}")
    chunks = x.split(chunk_size, dim=-2)
    if torch.is_grad_enabled():
        outs = [checkpoint(_ffn_body, p, c, act, compute_dtype,
                           use_reentrant=False) for c in chunks]
    else:
        outs = [_ffn_body(p, c, act, compute_dtype) for c in chunks]
    return torch.cat(outs, dim=-2)
