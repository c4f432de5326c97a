"""Autoregressive mel decoding with incremental caches.

Port of ``rtts/infer/decode.py``.  The loop is a host loop over the decoder
groups (``t`` a Python int) that checks once every ``unroll`` steps whether
every row has fired its stop token; every cache is written in place.  The
step walks the two-stream residual stack (h1 += f(h2); h2 += g(h1); output
= mean) with float32 streams and compute-dtype sublayers in
``_stack_substep``, which the serving engine's ring step
(``rtts_torch.infer.serving``) shares; ``_Decoder`` is also the streaming
synthesizer's decoder.  Cross-attention K/V are projected once from the
raw encoder memory.

Self-attention caches, per ``mode``:

- ``kv_full``: keys (length-normalized) and values of every position in
  (B, T, H, d) buffers; a step attends its prefix.
- ``kv_local``: for the decoder's ``local`` layers, a ring of W = min(chunk
  (1 + before), groups) slots; position p lives in slot p mod W, and the
  step attends the window [(t//chunk - before) chunk, t] that training's
  local attention gives it.  The other layers keep the full cache.
- ``kv_lsh``: the full cache plus each key's buckets (B, H, n_hashes, T);
  per round the step attends the prefix keys in its own bucket, and the
  rounds are combined by exp(lse - logsumexp(lse)).
- ``kv_lsh_chunk``: per (head, round, bucket) a ring of the positions of
  the last C keys hashed there (C = chunk (1 + before + after)); the step
  gathers its bucket's ring before inserting itself, attends those keys
  plus itself (at -1e5), and evicts the oldest entry on overflow.  It
  equals ``kv_lsh`` while no bucket overflows.

The LSH modes hash each new key with per-layer rotations drawn once per
decode (``_decode_rotations``); they and the prenet's always-on dropout
are drawn through ``rtts_torch/infer/draws.py``, which an exported
artifact's runner shares.  The caches are stored in
``cfg.kv_cache_dtype``; when that differs from the compute dtype the keys
are stored length-normalized but unscaled and 1/sqrt(d) goes to the query
(the reference's layout for e4m3, which it also takes for a bf16 cache
under f32 compute), and e4m3 is clipped to +-448 before the cast.  In
eager PyTorch the read of a narrower cache materialises a compute-dtype
copy of it every step.

The step is one function of the step index ``t`` (a Python int, or the
symbolic int of an exported step, ``rtts_torch/infer/export.py``): no
shape depends on it.  It writes position t with ``select``/``narrow``
and reads every full cache whole, with the positions after t masked to
-1e9 (the reference's mask; they contribute exactly zero probability) and
t itself to -1e5.  The staged buffers (``staged``) change no value: they
change only how much memory the early steps hold and read.

On a tensor-parallel shard (``rtts_torch/parallel/serving.py``) every
cache holds the rank's heads, the LSH modes keep their heads' rotations
of the draw for all heads, and the row-sharded projections sum over the
model group.  On a data-parallel shard (inside ``batch_shard``) the prenet
dropout draws the whole batch's mask and keeps the rank's rows, and the
loop stops when every row of the whole batch has stopped
(``collectives.batch_all``), as one device would.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from rtts_torch.attention import lsh as TL
from rtts_torch.attention.full import (_len_norm, head_span, local_heads,
                                       shared_keys)
from rtts_torch.config import ReformerTTSConfig, resolve_attention_kind
from rtts_torch.infer import draws
from rtts_torch.models.reformer_tts import _dtype, decode_train, postnet_apply
from rtts_torch.models.stack import _layer_kinds
from rtts_torch.nn.layers import scalar
from rtts_torch.nn.posenc import pos_table
from rtts_torch.ops.flash_attention import MASK_VALUE, SELF_MASK_VALUE
from rtts_torch.parallel.collectives import (batch_all, current_batch_shard,
                                             reduce_from_model)
from rtts_torch.reversible.ffn import _ffn_body

MODES = ("kv_full", "kv_lsh", "kv_lsh_chunk", "kv_local")
# the largest finite e4m3fn magnitude; past it the cast gives NaN
E4M3_MAX = 448.0


@torch.no_grad()
def _precast_weights(model: torch.nn.Module, cdt) -> torch.nn.Module:
    """Cast every float32 parameter or buffer of rank >= 2 (matmul and conv
    weights, the embedding and positional tables) to the compute dtype,
    once and in place, before serving.  The per-use casts of ``Dense``,
    ``conv1d`` and the tables then do nothing, so no result changes.
    LayerNorm parameters, biases and ``alpha`` stay float32."""
    if cdt == torch.float32:
        return model
    for t in list(model.parameters()) + list(model.buffers()):
        if t.ndim >= 2 and t.dtype == torch.float32:
            t.data = t.data.to(cdt)
    return model


class DecodeResult(NamedTuple):
    """Uniform return of every greedy decode."""

    mel_post: torch.Tensor      # (B, T_max, n_mels) float32, length-masked
    lengths: torch.Tensor       # (B,) int32 — first-stop frame counts
    stop_logits: torch.Tensor   # (B, T_max) float32


def _kv_dtype(cfg: ReformerTTSConfig, cdt) -> torch.dtype:
    """Storage dtype of the decode caches and the cross-attention K/V:
    "compute" (or unset) is the compute dtype, "float8_e4m3fn" e4m3, else
    one of float32, bfloat16 and float16; anything else (float8_e5m2
    included, as in the reference) raises KeyError."""
    name = cfg.kv_cache_dtype
    if name in ("compute", None, ""):
        return cdt
    if name == "float8_e4m3fn":
        return torch.float8_e4m3fn
    try:
        return _dtype(name)
    except KeyError:
        raise KeyError(f"kv_cache_dtype {name!r} is not one of compute, "
                       "float32, bfloat16, float16, float8_e4m3fn") from None


def _to_kv(x: torch.Tensor, kdt) -> torch.Tensor:
    """Cast to the cache dtype; e4m3 saturates at +-448 instead of turning
    an outlier into NaN."""
    if kdt == torch.float8_e4m3fn and x.dtype != kdt:
        x = x.clamp(-E4M3_MAX, E4M3_MAX)
    return x.to(kdt)


def _zeros(shape, dtype, device) -> torch.Tensor:
    """Zeros of any cache dtype (e4m3 through its byte view: 0 is +0.0)."""
    if dtype == torch.float8_e4m3fn:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def _take_rows(cache: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """cache (B, T, H, d) at positions index (B, N, H) -> (B, N, H, d);
    e4m3 is gathered as bytes (gather has no e4m3 kernel)."""
    idx = index[..., None].expand(*index.shape, cache.shape[-1])
    if cache.dtype == torch.float8_e4m3fn:
        return torch.gather(cache.view(torch.uint8), 1, idx).view(cache.dtype)
    return torch.gather(cache, 1, idx)


def _write_row(cache: torch.Tensor, t, x: torch.Tensor) -> None:
    """cache[:, t] = x (in the cache's dtype already)."""
    cache.select(1, t).copy_(x)


def _prefix_masks(positions: torch.Tensor, t):
    """(keep, fill) of step t over a whole cache's ``positions`` (T,):
    keep the positions before t; fill t itself with SELF_MASK_VALUE (no
    self-attend) and the positions after it, not written yet, with
    MASK_VALUE.  A step makes them once for all its layers."""
    fill = torch.where(positions == t, SELF_MASK_VALUE, MASK_VALUE)
    return positions < t, fill


def _prefix_scores(scores: torch.Tensor, t, prefix=None) -> torch.Tensor:
    """Scores (..., T) over a whole cache, masked by ``prefix`` (made here
    when not given)."""
    if prefix is None:
        prefix = _prefix_masks(torch.arange(scores.shape[-1],
                                            device=scores.device), t)
    return torch.where(prefix[0], scores, prefix[1])


def _proj_heads(dense, x, num_heads, cdt):
    """(B, D) -> (B, H, d)"""
    y = dense(x, cdt)
    return y.reshape(y.shape[0], num_heads, -1)


def _project(p, h_t, num_heads, cdt, kdt):
    """-> (qk_t, v_t, k_t, q_s) of one frame, (B, H, d) each.  A cache in
    another dtype than the compute one stores the length-normalized key
    unscaled, and the query takes 1/sqrt(d); else the key is pre-scaled."""
    qk_t = _proj_heads(p.w_qk, h_t, local_heads(p), cdt)
    v_t = _proj_heads(p.w_v, h_t, local_heads(p), cdt)
    if kdt != qk_t.dtype:
        scale = scalar(qk_t.shape[-1] ** -0.5, qk_t.dtype)
        return qk_t, v_t, _len_norm(qk_t), qk_t * scale
    return qk_t, v_t, shared_keys(qk_t), qk_t


def _self_attn_step(p, h_t, k_cache, v_cache, t, num_heads, cdt,
                    prefix=None):
    """One-frame shared-QK causal self-attention over the cached prefix;
    writes position t of the caches.  h_t: (B, D) LN'd frame; ``prefix``
    the step's ``_prefix_masks``."""
    _, v_t, k_t, q_s = _project(p, h_t, num_heads, cdt, k_cache.dtype)
    _write_row(k_cache, t, _to_kv(k_t, k_cache.dtype))
    _write_row(v_cache, t, _to_kv(v_t, v_cache.dtype))
    scores = torch.einsum("bhd,bthd->bht", q_s, k_cache.to(cdt)).float()
    probs = torch.softmax(_prefix_scores(scores, t, prefix), dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs.to(cdt), v_cache.to(cdt))
    return p.w_o(out.reshape(out.shape[0], -1), cdt)


def _self_attn_step_local(p, h_t, k_cache, v_cache, t, num_heads, cdt,
                          outside):
    """One-frame local self-attention over a ring of W slots (B, W, H, d):
    position t goes to slot t mod W.  ``outside`` (W,) bool marks the slots
    whose position lies before the window (``_local_outside``)."""
    _, v_t, k_t, q_s = _project(p, h_t, num_heads, cdt, k_cache.dtype)
    slot = t % k_cache.shape[1]
    _write_row(k_cache, slot, _to_kv(k_t, k_cache.dtype))
    _write_row(v_cache, slot, _to_kv(v_t, v_cache.dtype))
    scores = torch.einsum("bhd,bwhd->bhw", q_s, k_cache.to(cdt)).float()
    scores = scores.masked_fill(outside, MASK_VALUE)
    scores.select(-1, slot).fill_(SELF_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhw,bwhd->bhd", probs.to(cdt), v_cache.to(cdt))
    return p.w_o(out.reshape(out.shape[0], -1), cdt)


def _local_outside(slots: torch.Tensor, t: int, chunk: int,
                   before: int) -> torch.Tensor:
    """(W,) slot indices -> True where the slot's position, t - ((t - s)
    mod W) (floor mod: never-written slots resolve to negative positions),
    lies before the window start max(0, (t//chunk - before) chunk)."""
    w_cap = slots.shape[0]
    pos = t - torch.remainder(t - slots, w_cap)
    return pos < torch.sym_max(0, (t // chunk - before) * chunk)


def _hash_token(qk_t: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Buckets (B, H, nh) of one frame's shared-QK vectors (B, H, d) under
    rotations (H, d, nh, nb/2): argmax of [xR, -xR], first index on ties."""
    rotated = torch.einsum("bhd,hdnr->bhnr", qk_t.float(), rotations)
    return torch.argmax(torch.cat([rotated, -rotated], dim=-1), dim=-1)


def _combine_rounds(lse, out_r):
    """Rounds (B, H, nh, d) weighted by exp(lse - logsumexp(lse))."""
    w = torch.exp(lse - torch.logsumexp(lse, dim=-1, keepdim=True))
    return torch.einsum("bhn,bhnd->bhd", w.to(out_r.dtype), out_r)


def _self_attn_step_lsh(p, h_t, k_cache, v_cache, b_cache, rotations, t,
                        num_heads, cdt, prefix=None):
    """LSH self-attention over the cached prefix with a per-round
    bucket-equality mask; b_cache (B, H, nh, T) holds each key's buckets
    (-1 before it is written).  The query's own entry always matches its
    bucket, so no round is ever fully masked."""
    qk_t, v_t, k_t, q_s = _project(p, h_t, num_heads, cdt, k_cache.dtype)
    bucket_t = _hash_token(qk_t, rotations)
    _write_row(k_cache, t, _to_kv(k_t, k_cache.dtype))
    _write_row(v_cache, t, _to_kv(v_t, v_cache.dtype))
    b_cache.select(-1, t).copy_(bucket_t)
    scores = torch.einsum("bhd,bthd->bht", q_s, k_cache.to(cdt)).float()
    scores = _prefix_scores(scores, t, prefix)
    # positions after t hold bucket -1, which no query's bucket equals
    same = b_cache == bucket_t[..., None]                     # (B,H,nh,T)
    scores_r = torch.where(same, scores[:, :, None, :], MASK_VALUE)
    lse = torch.logsumexp(scores_r, dim=-1)                   # (B,H,nh)
    probs = torch.exp(scores_r - lse[..., None])
    out_r = torch.einsum("bhnt,bthd->bhnd", probs.to(cdt), v_cache.to(cdt))
    out = _combine_rounds(lse, out_r)
    return p.w_o(out.reshape(out.shape[0], -1), cdt)


def _self_attn_step_lsh_chunk(p, h_t, k_cache, v_cache, ring, rotations, t,
                              num_heads, cdt):
    """LSH self-attention over the query's bucket ring per round.  ring =
    (idx (B, H, nh, NB, C) int32 positions, -1 empty; cnt (B, H, nh, NB)
    int32 insert counters).  The bucket row is gathered before self is
    inserted; self joins as an extra column at -1e5, its value through the
    cache dtype's round trip (as kv_lsh reads it back)."""
    qk_t, v_t, k_t, q_s = _project(p, h_t, num_heads, cdt, k_cache.dtype)
    bucket_t = _hash_token(qk_t, rotations)                   # (B,H,nh)
    _write_row(k_cache, t, _to_kv(k_t, k_cache.dtype))
    _write_row(v_cache, t, _to_kv(v_t, v_cache.dtype))
    idx, cnt = ring
    b, h, nh, nb, cap = idx.shape
    d = qk_t.shape[-1]
    row = torch.gather(idx, 3, bucket_t[..., None, None].expand(
        b, h, nh, 1, cap))[:, :, :, 0]                        # (B,H,nh,C)
    valid = row >= 0
    flat = row.clamp(min=0).long().reshape(b, h, nh * cap).transpose(1, 2)
    k_g = _take_rows(k_cache, flat).to(cdt)                   # (B,nhC,H,d)
    v_g = _take_rows(v_cache, flat).to(cdt)
    k_g = k_g.transpose(1, 2).reshape(b, h, nh, cap, d)
    v_g = v_g.transpose(1, 2).reshape(b, h, nh, cap, d)
    scores = torch.einsum("bhd,bhncd->bhnc", q_s, k_g).float()
    scores = scores.masked_fill(~valid, MASK_VALUE)
    scores = torch.cat([scores, scores.new_full((b, h, nh, 1),
                                                SELF_MASK_VALUE)], dim=-1)
    v_self = _to_kv(v_t, v_cache.dtype).to(cdt)
    vals = torch.cat([v_g, v_self[:, :, None, None, :].expand(
        b, h, nh, 1, d)], dim=3)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    out_r = torch.einsum("bhnc,bhncd->bhnd", probs.to(vals.dtype), vals)
    out = _combine_rounds(lse, out_r)
    # insert self at slot cnt mod C of its bucket (the oldest on overflow)
    bucket = bucket_t[..., None]
    slot = bucket * cap + torch.gather(cnt, 3, bucket) % cap
    idx.view(b, h, nh, nb * cap).scatter_(3, slot, torch.full_like(
        slot, t, dtype=idx.dtype))
    cnt.scatter_add_(3, bucket, torch.ones_like(bucket, dtype=cnt.dtype))
    return p.w_o(out.reshape(out.shape[0], -1), cdt)


def _cross_attn_step(p, h_t, mem_k, mem_v, memory_mask, num_heads, cdt,
                     window=None, align_pos=None):
    """One-frame cross-attention.  mem_k/mem_v: (B, L, H, d) precomputed.
    ``window=(w_back, w_fwd)`` keeps the tokens within [align_pos - w_back,
    align_pos + w_fwd] of the (B,) tracker ``align_pos`` -> (out, the
    head-averaged attention peak (B,), or None without a window)."""
    q = _proj_heads(p.w_q, h_t, local_heads(p), cdt)
    scores = torch.einsum("bhd,blhd->bhl", q, mem_k.to(cdt)).float() * (
        q.shape[-1] ** -0.5)
    if memory_mask is not None:
        scores = scores.masked_fill(~memory_mask[:, None, :], MASK_VALUE)
    if window is not None:
        w_back, w_fwd = window
        l_idx = torch.arange(scores.shape[-1], device=scores.device)[None, :]
        in_win = ((l_idx >= align_pos[:, None] - w_back)
                  & (l_idx <= align_pos[:, None] + w_fwd))
        scores = scores.masked_fill(~in_win[:, None, :], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhl,blhd->bhd", probs.to(cdt), mem_v.to(cdt))
    out = p.w_o(out.reshape(out.shape[0], -1), cdt)
    if window is None:
        return out, None
    # the mean over every head of the block: a tensor-parallel shard sums
    # its heads' over the model group, so every rank tracks one peak
    heads = probs.sum(dim=1)
    if p.w_o.tp is not None:
        heads = reduce_from_model(heads, p.w_o.tp[1])
    return out, torch.argmax(heads / p.num_heads, dim=-1)


def _stack_substep(model, cfg: ReformerTTSConfig, x_t, cdt, self_attn,
                   cross) -> torch.Tensor:
    """One frame (B, D) through the decoder's two-stream residual stack ->
    the final LN's output.  The caches are the callbacks' business:
    ``self_attn(i, attn, hh)`` and ``cross(i, attn, hh)`` get the layer's
    index among its kind, its attention module and the LN'd stream, and
    return the sublayer's output.  The streams ride float32, as the stack
    does in training."""
    h1 = h2 = x_t.float()
    for li, lp in enumerate(model.decoder.layers):
        hh = lp.f.ln(h2)
        fn = cross if li % 2 else self_attn
        h1 = h1 + fn(li // 2, lp.f.attn, hh)
        h2 = h2 + _ffn_body(lp.g, h1, cfg.decoder.ffn_activation, cdt)
    return model.decoder.final_ln((h1 + h2) * 0.5)


def _init_mem_kv(model, cfg: ReformerTTSConfig, memory, cdt, kdt):
    """Cross-attention K/V per decoder cross layer in the cache dtype,
    projected from the RAW encoder memory (the cross layer's LN normalizes
    the decoder stream, the query side, not the memory)."""
    b, l, _ = memory.shape
    mem_k, mem_v = [], []
    layers = model.decoder.layers
    for i in range(1, len(layers), 2):       # [self, cross] * num_layers
        a = layers[i].f.attn
        h = local_heads(a)
        mem_k.append(_to_kv(a.w_k(memory, cdt).reshape(b, l, h, -1), kdt))
        mem_v.append(_to_kv(a.w_v(memory, cdt).reshape(b, l, h, -1), kdt))
    return mem_k, mem_v


def _auto_mode(cfg: ReformerTTSConfig, max_frames: int) -> str:
    """The reference's serving-cache rule: kv_local for decoders with local
    layers, kv_lsh_chunk for pure-LSH decoders whose prefix is more than
    10x the n_hashes x ring working set (the reference's measured
    crossover; it changes outputs, so it is kept), else kv_full."""
    a = cfg.decoder.attention
    n_groups = max_frames // cfg.reduction_factor
    kinds = set(resolve_attention_kind(a, n_groups) if k == "auto" else k
                for k in _layer_kinds(cfg.decoder))
    if "local" in kinds:
        return "kv_local"
    if kinds != {"lsh"}:
        return "kv_full"
    ring_cap = min(
        a.chunk_length * (1 + a.num_chunks_before + a.num_chunks_after),
        n_groups)
    return ("kv_lsh_chunk" if n_groups > 10 * a.num_hashes * ring_cap
            else "kv_full")


def _local_spec(cfg: ReformerTTSConfig, n_groups: int):
    """Per-self-layer ring specs of kv_local: ``(chunk, before, W)`` for the
    layers whose resolved kind is 'local', None for the others (which keep
    the full-prefix cache)."""
    a = cfg.decoder.attention
    kinds = [resolve_attention_kind(a, n_groups) if k == "auto" else k
             for k in _layer_kinds(cfg.decoder)]
    w_cap = min(a.chunk_length * (1 + a.num_chunks_before), n_groups)
    return tuple((a.chunk_length, a.num_chunks_before, w_cap)
                 if k == "local" else None for k in kinds)


def _stage_sizes(n_groups: int, stage_min: int) -> Tuple[int, ...]:
    """Geometric (x2) buffer schedule ending at n_groups."""
    sizes = [n_groups]
    s = n_groups
    while s % 2 == 0 and s // 2 >= stage_min:
        s //= 2
        sizes.append(s)
    return tuple(reversed(sizes))


def _auto_staged(n_groups: int) -> bool:
    """staged="auto": on from 256 groups (the reference's rule; whether the
    card wants it is measured by ``chip_smoke.py``)."""
    return n_groups >= 256


def _decode_rotations(cfg: ReformerTTSConfig,
                      generator: Optional[torch.Generator], max_frames: int,
                      device) -> Tuple[List[torch.Tensor], int]:
    """Per-self-layer hash rotations (H, d, nh, nb/2) -> (rotations, nb).
    The buckets come from the group count (the decoder's rate), a
    factorized spec giving its total; with ``hash_seed`` set the rotations
    depend on it alone."""
    a = cfg.decoder.attention
    n_groups = max_frames // cfg.reduction_factor
    nb = TL.total_buckets(a.num_buckets
                          or TL.auto_num_buckets(n_groups, a.chunk_length))
    seed = a.hash_seed if a.hash_seed is not None else draws.rotation_seed(
        0 if generator is None else generator.initial_seed())
    return draws.decode_rotations(seed, cfg.decoder.num_layers, a.num_heads,
                                  a.head_dim, a.num_hashes, nb, device), nb


class _Decoder:
    """The decode loop's state and its step: the reference's
    ``_init_state``, ``_make_step_fn`` and ``_grow_state``.  The caches are
    allocated for ``first_groups`` groups (the first stage) and grown by
    ``grow``; mel and stop logits for all ``n_groups`` from the start."""

    def __init__(self, model, cfg: ReformerTTSConfig, memory, memory_mask,
                 n_groups: int, first_groups: int, mode: str,
                 generator: Optional[torch.Generator], stop_threshold: float,
                 rotations=None, n_buckets: int = 0, local_spec=None,
                 window=None, teacher_mel=None):
        self.model, self.cfg = model, cfg
        self.cdt = cdt = _dtype(cfg.compute_dtype)
        kdt = _kv_dtype(cfg, cdt)
        dev = memory.device
        a = cfg.decoder.attention
        heads = local_heads(model.decoder.layers[0].f.attn)
        b = memory.shape[0]
        r, n_mels = cfg.reduction_factor, cfg.n_mels
        self.memory_mask = memory_mask.bool()
        self.mem_k, self.mem_v = _init_mem_kv(model, cfg, memory.to(cdt), cdt,
                                              kdt)
        self.generator, self.stop_threshold = generator, stop_threshold
        self.rotations, self.window, self.teacher = rotations, window, \
            teacher_mel
        self.local_spec = local_spec or (None,) * cfg.decoder.num_layers
        self.slots = {s[2]: torch.arange(s[2], device=dev)
                      for s in self.local_spec if s is not None}
        self._positions = {}      # full caches' position indices by length
        self.k_caches, self.v_caches, self.b_caches = [], [], []
        for spec in self.local_spec:
            s = (b, first_groups if spec is None else spec[2], heads,
                 a.head_dim)
            self.k_caches.append(_zeros(s, kdt, dev))
            self.v_caches.append(_zeros(s, kdt, dev))
            rings = (b, heads, a.num_hashes)
            if mode == "kv_lsh":
                self.b_caches.append(torch.full(rings + (first_groups,), -1,
                                                dtype=torch.int32, device=dev))
            elif mode == "kv_lsh_chunk":
                cap = min(a.chunk_length * (1 + a.num_chunks_before
                                            + a.num_chunks_after), n_groups)
                self.b_caches.append((
                    torch.full(rings + (n_buckets, cap), -1,
                               dtype=torch.int32, device=dev),
                    torch.zeros(rings + (n_buckets,), dtype=torch.int32,
                                device=dev)))
            else:
                self.b_caches.append(None)
        self.mode = mode
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.lengths = torch.full((b,), n_groups * r, dtype=torch.int32,
                                  device=dev)
        self.prev = (torch.zeros(b, n_mels * r, device=dev)
                     if teacher_mel is None
                     else teacher_mel[:, :r].reshape(b, r * n_mels).float())
        self.mel = torch.zeros(b, n_groups * r, n_mels, device=dev)
        self.stop_logits = torch.zeros(b, n_groups * r, device=dev)
        self.align_pos = (torch.zeros(b, dtype=torch.int64, device=dev)
                          if window is not None else None)

    def grow(self, n_groups: int) -> None:
        """Pad the full-prefix caches' time axes to ``n_groups`` (zeros; -1
        for kv_lsh's buckets).  The rings are position-indexed and carry
        over: resizing kv_local's W would scramble its slots."""
        for i, spec in enumerate(self.local_spec):
            if spec is not None:
                continue
            for caches in (self.k_caches, self.v_caches):
                c = caches[i]
                n = n_groups - c.shape[1]
                if n > 0:
                    pad = _zeros((c.shape[0], n) + c.shape[2:], c.dtype,
                                 c.device)
                    if c.dtype == torch.float8_e4m3fn:
                        caches[i] = torch.cat([c.view(torch.uint8),
                                               pad.view(torch.uint8)],
                                              1).view(c.dtype)
                    else:
                        caches[i] = torch.cat([c, pad], 1)
            bc = self.b_caches[i]
            if isinstance(bc, torch.Tensor) and n_groups > bc.shape[3]:
                self.b_caches[i] = torch.cat([bc, bc.new_full(
                    bc.shape[:3] + (n_groups - bc.shape[3],), -1)], 3)

    def _prefix(self, t, length: int):
        """The step's ``_prefix_masks`` over a full cache of ``length``
        positions, made at its first layer."""
        if length not in self._masks:
            if length not in self._positions:
                self._positions[length] = torch.arange(
                    length, device=self.done.device)
            self._masks[length] = _prefix_masks(self._positions[length], t)
        return self._masks[length]

    def _self_attn(self, i, p, hh, t):
        num_heads = self.cfg.decoder.attention.num_heads
        k, v, bc = self.k_caches[i], self.v_caches[i], self.b_caches[i]
        spec = self.local_spec[i]
        if spec is not None:
            outside = _local_outside(self.slots[spec[2]], t, spec[0], spec[1])
            return _self_attn_step_local(p, hh, k, v, t, num_heads, self.cdt,
                                         outside)
        if self.mode == "kv_lsh_chunk":
            return _self_attn_step_lsh_chunk(p, hh, k, v, bc,
                                             self.rotations[i], t, num_heads,
                                             self.cdt)
        prefix = self._prefix(t, k.shape[1])
        if self.mode == "kv_lsh":
            return _self_attn_step_lsh(p, hh, k, v, bc, self.rotations[i], t,
                                       num_heads, self.cdt, prefix)
        return _self_attn_step(p, hh, k, v, t, num_heads, self.cdt, prefix)

    def _layers(self, x_t, t):
        """One frame (B, D) through the decoder stack -> (y, the last cross
        layer's attention peak or None)."""
        peak = [None]

        def cross(i, p, hh):
            out, peak[0] = _cross_attn_step(
                p, hh, self.mem_k[i], self.mem_v[i], self.memory_mask,
                self.cfg.decoder.attention.num_heads, self.cdt, self.window,
                self.align_pos)
            return out

        y = _stack_substep(self.model, self.cfg, x_t, self.cdt,
                           lambda i, p, hh: self._self_attn(i, p, hh, t),
                           cross)
        return y, peak[0]

    def prenet_uniforms(self) -> List[torch.Tensor]:
        """This step's prenet dropout uniforms from the decode's generator
        (``draws.prenet_uniforms``): the whole batch's under a batch shard,
        this rank's rows kept."""
        pre = self.model.dec_prenet
        b = self.prev.shape[0]
        b_off, b_total = current_batch_shard(b)
        u = draws.prenet_uniforms(
            self.generator, b_total, (pre.fc1.w.shape[1], pre.fc2.w.shape[1]),
            self.cfg.dec_prenet_dropout, self.prev.device)
        return [x[b_off:b_off + b] for x in u]

    def step(self, t: int, live: Optional[torch.Tensor] = None,
             uniforms: Optional[List[torch.Tensor]] = None) -> None:
        """Decode group t.  ``live`` (a 0-dim bool, or None for True) gates
        the observable writes: a step that runs after every row stopped,
        inside a block of ``unroll`` steps, leaves mel, stop logits, lengths
        and the tracker as an earlier exit would.  ``uniforms`` (an exported
        step's input) replaces this step's draw of ``prenet_uniforms``."""
        model, cfg, cdt = self.model, self.cfg, self.cdt
        r, n_mels = cfg.reduction_factor, cfg.n_mels
        self._masks = {}
        if uniforms is None:
            uniforms = self.prenet_uniforms()
        h = model.dec_prenet(self.prev.to(cdt), cfg.dec_prenet_dropout, None,
                             compute_dtype=cdt, uniforms=uniforms)
        table, alpha = pos_table(model.dec_pos)
        h = h + alpha.to(h.dtype) * table.select(0, t).to(h.dtype)
        y, peak = self._layers(h, t)
        group = model.mel_head(y, cdt).float()
        stop_logit = model.stop_head(y, cdt)[..., 0].float()
        b = group.shape[0]
        frames = group.reshape(b, r, n_mels)
        stops = stop_logit[:, None].expand(b, r)
        mel_rows = self.mel.narrow(1, t * r, r)
        stop_rows = self.stop_logits.narrow(1, t * r, r)
        if live is not None:
            frames = torch.where(live, frames, mel_rows)
            stops = torch.where(live, stops, stop_rows)
        mel_rows.copy_(frames)
        stop_rows.copy_(stops)
        if self.window is not None:
            # the monotonic tracker never retreats; frozen once a row stops
            frozen = self.done if live is None else self.done | ~live
            self.align_pos = torch.where(
                frozen, self.align_pos, torch.maximum(self.align_pos, peak))
        self.lengths = torch.where(self.done, self.lengths, (t + 1) * r)
        self.done = self.done | (torch.sigmoid(stop_logit)
                                 > self.stop_threshold)
        if self.teacher is None:
            self.prev = group
        elif (t + 2) * r <= self.teacher.shape[1]:
            self.prev = self.teacher[:, (t + 1) * r:(t + 2) * r].reshape(
                b, r * n_mels).float()

    def finish(self) -> DecodeResult:
        """Postnet over the whole buffer, then the frames past each row's
        length zeroed."""
        return DecodeResult(finish_mel(self.model, self.cfg, self.mel,
                                       self.lengths),
                            self.lengths, self.stop_logits)

    # -- the state as flat tensors (an exported step's inputs) ---------------

    def carried(self) -> List[torch.Tensor]:
        """The tensors a step replaces: prev, done, lengths (and the
        tracker with a window)."""
        out = [self.prev, self.done, self.lengths]
        return out + ([self.align_pos] if self.window is not None else [])

    def flat_state(self) -> List[torch.Tensor]:
        """``carried()``, then the tensors a step writes in place: mel,
        stop logits and every layer's caches (keys, values, then kv_lsh's
        buckets or kv_lsh_chunk's ring and counters)."""
        caches = []
        for k, v, bc in zip(self.k_caches, self.v_caches, self.b_caches):
            caches += [k, v] + ([] if bc is None else
                                [bc] if isinstance(bc, torch.Tensor)
                                else list(bc))
        return self.carried() + [self.mel, self.stop_logits] + caches

    @classmethod
    def restore(cls, model, cfg: ReformerTTSConfig, mode: str,
                stop_threshold: float, memory_mask, mem_k, mem_v, flat,
                rotations=None, local_spec=None, window=None) -> "_Decoder":
        """A decoder over given tensors, none allocated: ``memory_mask``,
        the cross-attention K/V (``_init_mem_kv``) and the ``flat_state()``
        of a decoder of the same config and mode (an exported step's
        inputs, ``rtts_torch/infer/export.py``)."""
        dec = cls.__new__(cls)
        dec.model, dec.cfg, dec.mode = model, cfg, mode
        dec.cdt = _dtype(cfg.compute_dtype)
        dec.memory_mask, dec.mem_k, dec.mem_v = (memory_mask, list(mem_k),
                                                 list(mem_v))
        dec.generator, dec.stop_threshold = None, stop_threshold
        dec.rotations, dec.window, dec.teacher = rotations, window, None
        dec.local_spec = local_spec or (None,) * cfg.decoder.num_layers
        dec.slots = {s[2]: torch.arange(s[2], device=memory_mask.device)
                     for s in dec.local_spec if s is not None}
        dec._positions = {}
        flat = list(flat)
        n = 3 + (window is not None)
        dec.prev, dec.done, dec.lengths = flat[:3]
        dec.align_pos = flat[3] if window is not None else None
        dec.mel, dec.stop_logits = flat[n:n + 2]
        rest = flat[n + 2:]
        width = {"kv_lsh": 1, "kv_lsh_chunk": 2}.get(mode, 0)
        dec.k_caches, dec.v_caches, dec.b_caches = [], [], []
        for _ in range(cfg.decoder.num_layers):
            dec.k_caches.append(rest[0])
            dec.v_caches.append(rest[1])
            dec.b_caches.append(None if width == 0 else rest[2] if width == 1
                                else tuple(rest[2:4]))
            rest = rest[2 + width:]
        return dec


def finish_mel(model, cfg: ReformerTTSConfig, mel: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """mel (B, T, n_mels) f32 -> mel + postnet residual, the frames past
    each row's length zeroed (``_Decoder.finish``)."""
    cdt = _dtype(cfg.compute_dtype)
    residual = postnet_apply(model.postnet, mel.to(cdt), cdt).float()
    frame_mask = (torch.arange(mel.shape[1], device=mel.device)[None, :]
                  < lengths[:, None])
    return (mel + residual) * frame_mask[..., None]


class DecodePlan(NamedTuple):
    """What ``decode_greedy`` resolves before its loop."""

    mode: str                   # "auto" resolved
    n_groups: int
    sizes: Tuple[int, ...]      # the caches' stages (one: unstaged)
    unroll: int                 # snapped to a divisor of sizes[0]
    local_spec: Optional[tuple]  # kv_local's rings (``_local_spec``)
    window: Optional[Tuple[int, int]]


def decode_plan(cfg: ReformerTTSConfig, max_frames: int, mode: str = "auto",
                unroll: int = 1, staged="auto", stage_min: int = 128,
                attn_window=None) -> DecodePlan:
    """Check ``decode_greedy``'s options against the config and resolve
    them (the exported decode shares it)."""
    if mode == "auto":
        mode = _auto_mode(cfg, max_frames)
    r = cfg.reduction_factor
    if max_frames % r != 0:
        raise ValueError(f"max_frames {max_frames} not a multiple of "
                         f"reduction_factor {r}")
    if mode not in MODES:
        raise ValueError(f"unknown decode mode {mode!r} (want kv_full, "
                         "kv_lsh, kv_lsh_chunk, kv_local or auto)")
    n_groups = max_frames // r
    if n_groups > cfg.max_pos:
        raise ValueError(f"max_frames {max_frames} needs {n_groups} decoder "
                         f"positions; the table has {cfg.max_pos}")
    local_spec = None
    if mode == "kv_local":
        local_spec = _local_spec(cfg, n_groups)
        if all(s is None for s in local_spec):
            raise ValueError(
                "kv_local needs at least one decoder self-attention layer "
                "with resolved kind 'local' (attention.kind or attn_layers)"
                " — this decoder has none; use mode='auto'")
    if attn_window is not None:
        w_back, w_fwd = attn_window
        if w_back < 0 or w_fwd < 1:
            raise ValueError(
                f"attn_window must satisfy w_back >= 0 and w_fwd >= 1 "
                f"(the tracker must be able to advance), got {attn_window}")
        if unroll > 1:
            raise ValueError("attn_window is incompatible with unroll > 1 "
                             "(block decoding does not thread the "
                             "alignment tracker)")
        attn_window = (int(w_back), int(w_fwd))
    if staged == "auto":
        staged = _auto_staged(n_groups)
    sizes = _stage_sizes(n_groups, stage_min) if staged else (n_groups,)
    unroll = max(1, min(int(unroll), sizes[0]))
    while sizes[0] % unroll:       # the largest divisor <= requested
        unroll -= 1
    return DecodePlan(mode, n_groups, sizes, unroll, local_spec, attn_window)


@torch.no_grad()
def decode_greedy(model, cfg: ReformerTTSConfig, memory: torch.Tensor,
                  memory_mask: torch.Tensor, max_frames: int,
                  generator: Optional[torch.Generator] = None,
                  stop_threshold: Optional[float] = None,
                  mode: str = "kv_full", unroll: int = 1, staged="auto",
                  stage_min: int = 128,
                  attn_window: Optional[Tuple[int, int]] = None
                  ) -> DecodeResult:
    """Greedy AR decode -> DecodeResult(mel_post (B, T_max, n_mels), lengths
    (B,), stop_logits (B, T_max)).

    ``generator`` (on memory's device) draws the decoder prenet's always-on
    dropout.  ``mode``: "kv_full", "kv_local", "kv_lsh", "kv_lsh_chunk" (see
    the module docstring) or "auto" (``_auto_mode``).

    ``unroll`` k: the host checks whether every row has stopped once every
    k steps; k snaps down to the largest divisor of the first stage's group
    count.  The port runs the k steps as a plain replay in every mode, with
    the steps after the last stop writing nothing observable, so its
    outputs equal unroll=1's; the reference's kv_full block decoding
    (deferred cache writes, for XLA's buffer aliasing) differs from its
    eager step in f32 softmax reduction length only.

    ``staged`` (True, False or "auto": from 256 groups) allocates the
    full-prefix caches for ``stage_min`` x 2^k groups and doubles them as
    the decode reaches them; outputs do not change (module docstring).

    ``attn_window=(w_back, w_fwd)`` (tokens): each step the cross-attention
    keeps the tokens within [peak - w_back, peak + w_fwd] of a per-row
    tracker that follows the last cross layer's head-averaged attention
    peak and never retreats (monotonic windowing against looping and
    skipping).  It cannot be combined with unroll > 1, as in the
    reference."""
    if stop_threshold is None:
        stop_threshold = cfg.stop_threshold
    plan = decode_plan(cfg, max_frames, mode, unroll, staged, stage_min,
                       attn_window)
    mode, n_groups, sizes, unroll, local_spec, attn_window = plan
    rotations, nb = None, 0
    if mode in ("kv_lsh", "kv_lsh_chunk"):
        rotations, nb = _decode_rotations(cfg, generator, max_frames,
                                          memory.device)
        off, _ = head_span(model.decoder.layers[0].f.attn)
        n = local_heads(model.decoder.layers[0].f.attn)
        rotations = [r[off:off + n] for r in rotations]
    dec = _Decoder(model, cfg, memory, memory_mask, n_groups, sizes[0], mode,
                   generator, stop_threshold, rotations, nb, local_spec,
                   attn_window)
    t = 0
    for size in sizes:
        dec.grow(size)
        while t < size:
            live = None
            for _ in range(unroll):
                dec.step(t, live)
                t += 1
                if unroll > 1:
                    live = ~batch_all(dec.done)
            if bool(batch_all(dec.done)):
                return dec.finish()
    return dec.finish()


@torch.no_grad()
def decode_greedy_recompute(model, cfg: ReformerTTSConfig,
                            memory: torch.Tensor, memory_mask: torch.Tensor,
                            max_frames: int,
                            stop_threshold: Optional[float] = None
                            ) -> DecodeResult:
    """The reference-faithful loop: every step re-runs the whole decoder
    (``decode_train``, deterministic) on the padded prefix, so any
    self-attention kind runs its exact training pattern (LSH's rotations
    are the deterministic stack's, from a generator seeded 0).  O(T^2) in
    decoder passes; same ``DecodeResult`` as ``decode_greedy``."""
    if stop_threshold is None:
        stop_threshold = cfg.stop_threshold
    r = cfg.reduction_factor
    if max_frames % r:
        raise ValueError(f"max_frames {max_frames} not a multiple of "
                         f"reduction_factor {r}")
    dev = memory.device
    b = memory.shape[0]
    mel = torch.zeros(b, max_frames, cfg.n_mels, device=dev)
    stop_buf = torch.zeros(b, max_frames, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    lengths = torch.full((b,), max_frames, dtype=torch.int32, device=dev)
    frames = torch.arange(max_frames, device=dev)[None, :]
    for g in range(max_frames // r):
        # one group per step: decode_train consumes group-shifted input
        mel_in = torch.cat([torch.zeros_like(mel[:, :r]), mel[:, :-r]], 1)
        mel_mask = (frames < (g + 1) * r).expand(b, max_frames)
        pre, _, stop_logits = decode_train(model, cfg, mel_in, mel_mask,
                                           memory, memory_mask)
        rows = slice(g * r, (g + 1) * r)
        mel[:, rows] = pre[:, rows]
        stop_buf[:, rows] = stop_logits[:, rows]
        lengths = torch.where(done, lengths, (g + 1) * r)
        done = done | (torch.sigmoid(stop_logits[:, (g + 1) * r - 1])
                       > stop_threshold)
        if bool(done.all()):
            break
    cdt = _dtype(cfg.compute_dtype)
    residual = postnet_apply(model.postnet, mel.to(cdt), cdt).float()
    frame_mask = frames < lengths[:, None]
    return DecodeResult((mel + residual) * frame_mask[..., None], lengths,
                        stop_buf)


@torch.no_grad()
def decode_teacher_check(model, cfg: ReformerTTSConfig, memory: torch.Tensor,
                         memory_mask: torch.Tensor,
                         teacher_input: torch.Tensor, mode: str = "kv_full"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The incremental path fed with teacher frames (B, T, n_mels), the
    input ``decode_train`` sees -> (mel_pre (B, T, n_mels), stop_logits
    (B, T)), for parity against ``decode_train``.  ``mode`` "kv_full" or
    "kv_local" (the windowed ring: exact against a local decoder).  The
    prenet dropout is drawn from a generator seeded 0."""
    if mode not in ("kv_full", "kv_local"):
        raise ValueError(f"decode_teacher_check runs kv_full or kv_local, "
                         f"not {mode!r}")
    r = cfg.reduction_factor
    t_total = teacher_input.shape[1]
    if t_total % r:
        raise ValueError(f"teacher length {t_total} not a multiple of "
                         f"reduction_factor {r}")
    n_groups = t_total // r
    local_spec = (_local_spec(cfg, n_groups) if mode == "kv_local"
                  else None)
    gen = torch.Generator(device=memory.device).manual_seed(0)
    dec = _Decoder(model, cfg, memory, memory_mask, n_groups, n_groups, mode,
                   gen, 10.0, local_spec=local_spec,
                   teacher_mel=teacher_input)
    for t in range(n_groups):
        dec.step(t)
    return dec.mel, dec.stop_logits
