"""LSH-bucketed self-attention: hash -> sort -> chunked attend -> unsort ->
multi-round combine.

Port of ``rtts/attention/lsh.py``, with its semantics:

- shared QK: one projection gives queries and keys; keys are the
  length-normalised queries scaled by d^-0.5.
- multi-round hashing with random rotations (H, d, n_hashes, nb/2):
  bucket = argmax([xR; -xR]) of the detached vectors, factorised
  (mixed-radix) for a list of bucket factors; padding goes to the overflow
  bucket nb, so key validity falls out of the sort.
- the sort key bucket * L + position is unique, so any sort gives the
  stable order: K7's path entry (``rtts_torch/ops/bitonic_sort.py``) on
  the card, ``torch.sort`` + ``argsort`` on the CPU; the gathers into and
  out of sorted order have an inverse-gather backward (never a
  scatter-add, which is atomic and nondeterministic on the card).
  ``sort_gather: onehot`` permutes with one-hot matmuls instead, the
  combine weights folded into the unsort matmul, as the reference does;
  its backward is autograd of the matmuls.
- the chunk attend is K4/K5 (``rtts_torch/ops/lsh_attention.py``) on the
  card, or ``plain_attend`` (K4's plain forward with the reference's
  exp(s - lse) probabilities, and the attention-probs dropout) when
  ``use_pallas`` is false or dropout is on.
- rounds are combined with weights exp(lse - logsumexp(lse)), the
  reference's formula.
- sequences no longer than one chunk fall back to full shared-QK attention
  (K1 on the card).

Random rotations come from ``draw_rotations`` and a ``torch.Generator``:
the stack's training generator, else one device generator seeded 0 that
the stack's layers consume in turn, or, with ``cfg.hash_seed`` set, a fresh
generator with that seed for every layer.  JAX's Threefry draws cannot be
reproduced, so the parity tests inject JAX's rotations through
``draw_rotations``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from rtts_torch.attention.full import (Attention, _len_norm, _merge_heads,
                                       _split_heads, shared_qk_self_attention)
from rtts_torch.config import AttentionConfig
from rtts_torch.ops import bitonic_sort as BS
from rtts_torch.ops.flash_attention import resolve_flash_impl
from rtts_torch.ops.lsh_attention import (  # noqa: F401 (re-exported)
    dropout_lane, lsh_attend_chunks_kernel, lsh_attend_chunks_reference,
    positional_dropout)


class LshCache(NamedTuple):
    buckets: torch.Tensor  # (B, H, n_hashes, L) int64


def auto_num_buckets(seq_len: int, chunk_length: int) -> int:
    """2 * L / chunk rounded up to a power of two (reference auto rule)."""
    raw = max(2, 2 * seq_len // max(chunk_length, 1))
    return 1 << (raw - 1).bit_length()


def total_buckets(num_buckets) -> int:
    """Total bucket count for an int or factorized (list) spec."""
    if isinstance(num_buckets, int):
        return num_buckets
    out = 1
    for f in num_buckets:
        out *= f
    return out


def draw_rotations(h: int, d: int, n_hashes: int, half: int,
                   generator: Optional[torch.Generator], device
                   ) -> torch.Tensor:
    """(h, d, n_hashes, half) f32 standard normal rotations."""
    return torch.randn((h, d, n_hashes, half), generator=generator,
                       device=device, dtype=torch.float32)


def hash_vectors(vecs: torch.Tensor, num_buckets, n_hashes: int,
                 generator: Optional[torch.Generator],
                 mask: Optional[torch.Tensor],
                 rotations: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random-rotation LSH of (B, H, L, d) vectors (detached) -> buckets
    (B, H, n_hashes, L) in [0, nb], nb the overflow bucket of padding.

    ``num_buckets`` a list of even factors: one rotation block of factor/2
    per factor, per-factor argmax buckets combined mixed-radix (b = b0 +
    f0 b1 + f0 f1 b2 ...).  ``rotations`` overrides the draw."""
    b, h, l, d = vecs.shape
    factors = ([num_buckets] if isinstance(num_buckets, int)
               else list(num_buckets))
    for f in factors:
        if f % 2 != 0:
            raise ValueError(f"bucket factors must be even, got {f}")
    rot_size = sum(factors)
    if rotations is None:
        rotations = draw_rotations(h, d, n_hashes, rot_size // 2, generator,
                                   vecs.device)
    x = vecs.detach().float()
    rotated = torch.einsum("bhld,hdnr->bhnlr", x, rotations.to(x.device))
    buckets, cur_sum, cur_product = None, 0, 1
    for f in factors:
        rf = rotated[..., cur_sum:cur_sum + f // 2]
        cur_sum += f // 2
        piece = torch.argmax(torch.cat([rf, -rf], dim=-1), dim=-1)
        buckets = piece if buckets is None else buckets + cur_product * piece
        cur_product *= f
    if mask is not None:
        buckets = torch.where(mask.bool()[:, None, None, :], buckets,
                              total_buckets(num_buckets))
    return buckets


def _sort_by_bucket(buckets: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """buckets (B, H, nh, L) -> (sorted_pos, undo_idx, sorted_buckets).

    Per round, sort by the unique key bucket * L + position (the stable
    sort: ties by original position).  sorted_pos[..., s] is the original
    position of sorted slot s; undo_idx is the inverse permutation.  K7's
    path entry on the card (one launch), its plain version on the CPU."""
    return BS.sort_by_bucket(buckets)


class _PermRowsTake(torch.autograd.Function):
    """out[b, r*L + s] = x[b, idx[b, r, s]] for x (BH, L, W) and per-round
    permutations idx (BH, nh, L); the backward is the inverse gather
    dx[b, j] = sum_r g[b, r, inv[b, r, j]] (every row gets exactly nh
    cotangent rows)."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        bh, nh, l = idx.shape
        ctx.save_for_backward(inv)
        flat = idx.reshape(bh, nh * l, 1).expand(bh, nh * l, x.shape[-1])
        return torch.gather(x, 1, flat)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        bh, nh, l = inv.shape
        w = g.shape[-1]
        gr = g.reshape(bh, nh, l, w)
        dx = torch.gather(gr, 2, inv[..., None].expand(bh, nh, l, w)).sum(1)
        return dx, None, None


class _PermRoundTake(torch.autograd.Function):
    """Within-round row permutation of (B, H, nh, L, W):
    out[..., r, s, :] = x[..., r, idx[..., r, s], :], with the inverse
    gather as backward."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return torch.gather(x, 3, idx[..., None].expand(x.shape))

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return torch.gather(g, 3, inv[..., None].expand(g.shape)), None, None


def _perm_rows_take(x, idx, inv):
    return _PermRowsTake.apply(x, idx, inv)


def _perm_round_take(x, idx, inv):
    return _PermRoundTake.apply(x, idx, inv)


# the reference's jnp attend: K4's plain version with exp(s - lse)
plain_attend = functools.partial(lsh_attend_chunks_reference,
                                 probs_from_lse=True)


def _sort_gather_mode(cfg: AttentionConfig, bh: int, nh: int, l: int,
                      dtype) -> str:
    """Resolve cfg.sort_gather, with the reference's arguments: "take"
    gathers rows by index, "onehot" permutes with one-hot matmuls (the
    reference's choice on the v5e while the (bh, nh L, L) one-hot operand
    stays under 4 GiB).  "auto" is "take" here: the choice is speed-only,
    and the v5e's size gate is not carried over until the H100's numbers
    decide it (``PERF.md``)."""
    del bh, nh, l, dtype
    mode = cfg.sort_gather
    if mode == "auto":
        return "take"
    if mode not in ("onehot", "take"):
        raise ValueError(f"unknown sort_gather {mode!r}")
    return mode


def _pick_attend_fn(cfg: AttentionConfig):
    """The chunk attend per the use_pallas knob: true and "auto" take K4/K5
    (on the card; their plain versions on the CPU) at every length: the
    TPU's 8192-position gate is not carried over.  false takes the plain
    attend."""
    use = cfg.use_pallas
    if isinstance(use, str):
        if use != "auto":
            raise ValueError(
                f"use_pallas must be true, false or 'auto', got {use!r}")
        use = True
    return lsh_attend_chunks_kernel if use else plain_attend


def lsh_attention_core(qk: torch.Tensor, v: torch.Tensor,
                       cfg: AttentionConfig, mask: Optional[torch.Tensor],
                       causal: bool, generator: Optional[torch.Generator],
                       buckets: Optional[torch.Tensor] = None,
                       attend_fn=None, dropout_seed: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSH pipeline on projected heads (B, H, L, d) -> (out (B, H, L,
    d), buckets).  ``dropout_seed`` (with cfg.attention_dropout > 0) turns
    on attention-probs dropout, which the kernels do not have: it forces
    the plain attend, as in the reference."""
    b, h, l, d = qk.shape
    c = cfg.chunk_length
    nh = cfg.num_hashes
    if dropout_seed is not None and cfg.attention_dropout > 0.0:
        def attend_fn(*args):
            return plain_attend(*args, dropout_rate=cfg.attention_dropout,
                                dropout_seed=dropout_seed,
                                chunks_per_round=l // c)
    elif attend_fn is None:
        attend_fn = _pick_attend_fn(cfg)
    if l % c != 0:
        raise ValueError(
            f"seq len {l} not a multiple of chunk {c} (autopad upstream)")
    nb = cfg.num_buckets or auto_num_buckets(l, c)
    if (total_buckets(nb) + 1) * l > 2**31 - 1:
        # the reference's int32 sort key bucket * L + pos would wrap
        raise ValueError(
            f"int32 sort-key overflow: (total_buckets+1) * seq_len = "
            f"{(total_buckets(nb) + 1) * l} > 2^31-1 — reduce num_buckets "
            f"({nb}) or the sequence length ({l})")
    mode = _sort_gather_mode(cfg, b * h, nh, l, qk.dtype)

    if buckets is None:
        buckets = hash_vectors(qk, nb, nh, generator, mask)      # (B,H,nh,L)
    sorted_pos, undo_idx, sorted_buckets = _sort_by_bucket(buckets)

    # q/k and v ride one packed operand through one gather: (B,H,nh,L,2d);
    # "onehot" realises it as a matmul with the one-hot matrix of the
    # sorted positions (exact: one matched element per row)
    bh = b * h
    packed = torch.cat([qk, v], dim=-1).reshape(bh, l, 2 * d)
    if mode == "onehot":
        idx = sorted_pos.reshape(bh, nh * l)
        oh = (idx[..., None] == torch.arange(l, device=idx.device)).to(
            packed.dtype)
        g = torch.einsum("bsl,blw->bsw", oh, packed)
    else:
        g = _perm_rows_take(packed, sorted_pos.reshape(bh, nh, l),
                            undo_idx.reshape(bh, nh, l))
    g = g.reshape(b, h, nh, l, 2 * d)
    qk_s, v_s = g[..., :d], g[..., d:]
    if mask is not None:
        valid_s = sorted_buckets < total_buckets(nb)
    else:
        valid_s = torch.ones((b, h, nh, l), dtype=torch.bool,
                             device=qk.device)

    # chunk the concatenated-rounds axis; L % c == 0 keeps rounds aligned
    nc = nh * l // c
    q_c = qk_s.reshape(b, h, nc, c, d)
    k_c = (_len_norm(qk_s) * (d ** -0.5)).reshape(b, h, nc, c, d)
    v_c = v_s.reshape(b, h, nc, c, d)
    pos_c = sorted_pos.reshape(b, h, nc, c)
    val_c = valid_s.reshape(b, h, nc, c)
    out_c, lse_c = attend_fn(q_c, k_c, v_c, pos_c, val_c, causal,
                             cfg.num_chunks_before, cfg.num_chunks_after,
                             cfg.mask_value, cfg.self_mask_value)

    # unsort per round, then combine the rounds with the reference's
    # weights exp(lse - logsumexp(lse)) (not a softmax: at rows where only
    # the -1e5 self score survives, f32 rounding at |lse| ~ 1e5 makes the
    # weights sum to slightly less than 1, and the reference keeps that)
    out_flat = out_c.reshape(b, h, nh, l, d)
    lse_flat = lse_c.reshape(b, h, nh, l)
    if mode == "onehot":
        # the combine folded into the unsort matmul: each sorted slot
        # weighted by its round's combine weight (re-sorted), then one
        # transposed one-hot matmul sums a position's nh slots
        weighted = out_flat
        if nh > 1:
            lse_r = _perm_round_take(lse_flat[..., None], undo_idx,
                                     sorted_pos)[..., 0]
            w = torch.exp(lse_r - torch.logsumexp(lse_r, dim=2, keepdim=True))
            w_s = _perm_round_take(w[..., None], sorted_pos, undo_idx)[..., 0]
            weighted = out_flat * w_s.to(out_flat.dtype)[..., None]
        out = torch.einsum("bsl,bsd->bld", oh, weighted.reshape(bh, nh * l, d))
        return out.reshape(b, h, l, d), buckets
    if nh == 1:
        return _perm_round_take(out_flat, undo_idx, sorted_pos)[:, :, 0], \
            buckets
    fused = torch.cat([out_flat.float(), lse_flat[..., None]], dim=-1)
    got = _perm_round_take(fused, undo_idx, sorted_pos)
    out_r, lse_r = got[..., :d], got[..., d]
    w = torch.exp(lse_r - torch.logsumexp(lse_r, dim=2, keepdim=True))
    # the rounded products summed round by round, as the onehot mode's
    # unsort matmul sums them on the card (a GEMM over the rounds would
    # fuse each product into the sum, one rounding fewer): the two modes
    # give the same f32 bits
    terms = w[..., None] * out_r
    out = terms[:, :, 0]
    for r in range(1, nh):
        out = out + terms[:, :, r]
    return out, buckets


def lsh_self_attention(p: Attention, x: torch.Tensor,
                       mask: Optional[torch.Tensor], causal: bool,
                       cfg: AttentionConfig,
                       generator: Optional[torch.Generator],
                       compute_dtype=None, dropout_seed: Optional[int] = None,
                       cache: Optional[LshCache] = None
                       ) -> Tuple[torch.Tensor, LshCache]:
    """Reformer LSH self-attention sublayer: x (B, L, D) -> (out, cache).

    ``generator`` draws the rotations (``cfg.hash_seed`` replaces it by a
    fresh generator with that seed); ``dropout_seed`` turns on the
    attention-probs dropout.  ``cache``, the cache of an earlier call on
    the same input (the reversible backward's recompute), supplies the
    buckets: nothing is hashed and no rotation is drawn."""
    l = x.shape[1]
    if l <= cfg.chunk_length:
        # the reference's fallback: full softmax attention for short inputs
        out = shared_qk_self_attention(
            p, x, mask=mask, causal=causal, num_heads=cfg.num_heads,
            compute_dtype=compute_dtype, dropout_rate=cfg.attention_dropout,
            dropout_seed=dropout_seed, impl=resolve_flash_impl(cfg.flash))
        return out, LshCache(buckets=torch.zeros((0,), dtype=torch.int64,
                                                 device=x.device))
    buckets = None if cache is None else cache.buckets
    if buckets is None and cfg.hash_seed is not None:
        generator = torch.Generator(device=x.device).manual_seed(cfg.hash_seed)
    qk = _split_heads(p.w_qk(x, compute_dtype), cfg.num_heads)
    v = _split_heads(p.w_v(x, compute_dtype), cfg.num_heads)
    out, buckets = lsh_attention_core(qk, v, cfg, mask, causal, generator,
                                      buckets=buckets,
                                      dropout_seed=dropout_seed)
    out = p.w_o(_merge_heads(out), compute_dtype)
    return out, LshCache(buckets=buckets)
