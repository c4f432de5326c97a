"""Full softmax attention: shared-QK self-attention and cross-attention.

Port of ``rtts/attention/full.py``.  The flash path is K1/K3
(``flash_attend``, differentiable); the naive path writes the probabilities
out, as the reference's does, and shares K1's statement of the masks
(``masked_scores``):

- ``full_attention`` (on projected heads) and ``cross_attention``
  (separate Q/K/V projections): 1/sqrt(d) scaling.
- ``shared_qk_self_attention``: one shared QK projection; keys are the
  length-normalized queries scaled by 1/sqrt(d), computed OUTSIDE the kernel,
  which then runs with sm_scale = 1; a token never attends itself (-1e5)
  unless it has no other target (pad and causal masks are -1e9).

Attention-probs dropout: the flash path draws its keep mask in the kernel
from ``dropout_seed`` (uint32); the naive path draws it from ``generator``.
A missing seed or generator means no dropout, as a missing key does in the
reference.  ``probs_sink`` (a list) records the f32 pre-dropout
probabilities and forces the naive path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rtts_torch.nn.layers import Dense, dropout
from rtts_torch.ops.flash_attention import flash_attend, masked_scores


class Attention(nn.Module):
    """Projection weights of one attention block (``attention_init``)."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 shared_qk: bool, *, generator=None, device=None):
        super().__init__()
        d_inner = num_heads * head_dim
        kw = dict(use_bias=False, generator=generator, device=device)
        if shared_qk:
            self.w_qk = Dense(d_model, d_inner, **kw)
        else:
            self.w_q = Dense(d_model, d_inner, **kw)
            self.w_k = Dense(d_model, d_inner, **kw)
        self.w_v = Dense(d_model, d_inner, **kw)
        self.w_o = Dense(d_inner, d_model, **kw)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _len_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Divide the head dim by its root mean square (not its L2 norm)."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps)


def _attend(q, k, v, kv_mask, *, causal, self_mask, sm_scale, impl,
            dropout_rate, dropout_seed, generator, probs_sink):
    """One masked softmax attention on (B, H, L, d) heads, by ``impl``."""
    if probs_sink is not None:
        impl = "naive"
    if impl == "flash":
        rate = dropout_rate if dropout_seed is not None else 0.0
        return flash_attend(q, k, v, kv_mask, causal=causal,
                            self_mask=self_mask, sm_scale=sm_scale,
                            dropout_rate=rate, dropout_seed=dropout_seed)
    if impl != "naive":
        raise ValueError(
            f"attention impl must be 'flash' or 'naive', got {impl!r}")
    s = masked_scores(q, k, kv_mask, causal=causal, self_mask=self_mask,
                      sm_scale=sm_scale)
    probs = torch.softmax(s, dim=-1)
    if probs_sink is not None:
        probs_sink.append(probs)
    if generator is not None:
        probs = dropout(probs, dropout_rate, generator)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None,
                   causal: bool = False, scale: Optional[float] = None,
                   dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   impl: str = "naive",
                   probs_sink: Optional[list] = None) -> torch.Tensor:
    """Masked softmax attention on (B, H, L, d) tensors, scaled by
    ``scale`` (default d^-0.5); softmax in float32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _attend(q, k, v, kv_mask, causal=causal, self_mask=False,
                   sm_scale=scale, impl=impl, dropout_rate=dropout_rate,
                   dropout_seed=dropout_seed, generator=generator,
                   probs_sink=probs_sink)


def cross_attention(p: Attention, x: torch.Tensor, memory: torch.Tensor,
                    memory_mask: Optional[torch.Tensor] = None,
                    num_heads: int = 8, compute_dtype=None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    impl: str = "naive",
                    probs_sink: Optional[list] = None) -> torch.Tensor:
    """Decoder -> encoder attention: x (B, Lq, D), memory (B, Lk, D).
    ``probs_sink`` collects the (B, H, Lq, Lk) f32 pre-dropout probs."""
    q = _split_heads(p.w_q(x, compute_dtype), num_heads)
    k = _split_heads(p.w_k(memory, compute_dtype), num_heads)
    v = _split_heads(p.w_v(memory, compute_dtype), num_heads)
    out = full_attention(q, k, v, kv_mask=memory_mask,
                         dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                         generator=generator, impl=impl,
                         probs_sink=probs_sink)
    return p.w_o(_merge_heads(out), compute_dtype)


def shared_qk_self_attention(p: Attention, x: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             causal: bool = False, num_heads: int = 8,
                             compute_dtype=None, dropout_rate: float = 0.0,
                             dropout_seed: Optional[int] = None,
                             generator: Optional[torch.Generator] = None,
                             impl: str = "naive") -> torch.Tensor:
    """Reformer full-softmax self-attention.  x: (B, L, D); mask: (B, L)
    bool validity."""
    qk = _split_heads(p.w_qk(x, compute_dtype), num_heads)
    v = _split_heads(p.w_v(x, compute_dtype), num_heads)
    k = _len_norm(qk) * (qk.shape[-1] ** -0.5)
    out = _attend(qk, k, v, mask, causal=causal, self_mask=True,
                  sm_scale=1.0, impl=impl, dropout_rate=dropout_rate,
                  dropout_seed=dropout_seed, generator=generator,
                  probs_sink=None)
    return p.w_o(_merge_heads(out), compute_dtype)
