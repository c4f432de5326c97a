"""Local (sliding-chunk) self-attention.

Port of ``rtts/attention/local.py``: chunked attention over the natural
sequence order, with no hashing and no sort.  Chunk i attends chunks
[i - num_chunks_before, ..., i, ..., i + num_chunks_after] with one joint
softmax; the neighbour index wraps over the chunk axis, and the masks are
the LSH attend's (invalid key and causal -1e9, self -1e5, by position).  It
is the LSH pipeline with the identity permutation and a single round.

The chunk attend is the one ``lsh_attention_core`` takes: K4/K5
(``lsh_attend_chunks_kernel``) per ``cfg.use_pallas`` on the card, their
plain versions on the CPU, or the plain attend when ``use_pallas`` is
false.  With attention dropout on it is always the plain attend (the
kernels have no dropout), as in the reference, which runs its jnp attend
here.  A chunk length that K4 does not take raises on the card.
Sequences no longer than one chunk fall back to full shared-QK attention
(K1 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from rtts_torch.attention.full import (Attention, _len_norm, _merge_heads,
                                       _split_heads, shared_qk_self_attention)
from rtts_torch.attention.lsh import _pick_attend_fn, plain_attend
from rtts_torch.config import AttentionConfig
from rtts_torch.ops.flash_attention import resolve_flash_impl


def local_attention_core(qk: torch.Tensor, v: torch.Tensor,
                         cfg: AttentionConfig, mask: Optional[torch.Tensor],
                         causal: bool, attend_fn=None,
                         dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Projected heads (B, H, L, d) -> out (B, H, L, d).  ``dropout_seed``
    (with cfg.attention_dropout > 0) turns on the attention-probs dropout
    and forces the plain attend."""
    b, h, l, d = qk.shape
    c = cfg.chunk_length
    if l % c != 0:
        raise ValueError(f"seq len {l} not a multiple of chunk {c}")
    nc = l // c
    if dropout_seed is not None and cfg.attention_dropout > 0.0:
        def attend_fn(*args):
            return plain_attend(*args, dropout_rate=cfg.attention_dropout,
                                dropout_seed=dropout_seed,
                                chunks_per_round=nc)
    elif attend_fn is None:
        attend_fn = _pick_attend_fn(cfg)
    pos = torch.arange(l, dtype=torch.int32, device=qk.device).expand(b, h, l)
    if mask is not None:
        valid = mask.bool()[:, None, :].expand(b, h, l)
    else:
        valid = torch.ones((b, h, l), dtype=torch.bool, device=qk.device)
    q_c = qk.reshape(b, h, nc, c, d)
    k_c = (_len_norm(qk) * (d ** -0.5)).reshape(b, h, nc, c, d)
    v_c = v.reshape(b, h, nc, c, d)
    out, _ = attend_fn(q_c, k_c, v_c, pos.reshape(b, h, nc, c),
                       valid.reshape(b, h, nc, c), causal,
                       cfg.num_chunks_before, cfg.num_chunks_after,
                       cfg.mask_value, cfg.self_mask_value)
    return out.reshape(b, h, l, d)


def local_self_attention(p: Attention, x: torch.Tensor,
                         mask: Optional[torch.Tensor], causal: bool,
                         cfg: AttentionConfig, compute_dtype=None,
                         dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Shared-QK sliding-chunk self-attention sublayer: (B, L, D) -> (B, L,
    D).  ``dropout_seed`` turns on the attention-probs dropout."""
    if x.shape[1] <= cfg.chunk_length:
        return shared_qk_self_attention(
            p, x, mask=mask, causal=causal, num_heads=cfg.num_heads,
            compute_dtype=compute_dtype, dropout_rate=cfg.attention_dropout,
            dropout_seed=dropout_seed, impl=resolve_flash_impl(cfg.flash))
    qk = _split_heads(p.w_qk(x, compute_dtype), cfg.num_heads)
    v = _split_heads(p.w_v(x, compute_dtype), cfg.num_heads)
    out = local_attention_core(qk, v, cfg, mask, causal,
                               dropout_seed=dropout_seed)
    return p.w_o(_merge_heads(out), compute_dtype)
