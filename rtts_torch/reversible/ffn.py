"""Pre-LN feed-forward sublayer.

Port of ``rtts/reversible/ffn.py``: LN -> dense(d -> d_ff) -> activation ->
dense(d_ff -> d), unchunked, for serving and for training with plain
residuals (autograd keeps the hidden activations).  Sequence chunking only
trades speed for training memory; the chunked remat and its fused kernel
(K6) come with the reversible training path, and until then
``rtts_torch.models.stack`` refuses a train step that resolves to either.
"""

from __future__ import annotations

import torch
from torch import nn

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
