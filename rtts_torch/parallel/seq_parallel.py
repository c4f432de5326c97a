"""Sequence-parallel self-attention over a mesh axis: port of
``rtts/parallel/seq_parallel.py``.

The reference shard_maps a stack's self-attention over a mesh axis; here
each rank of the axis holds the stack's stream whole (every rank of the
model axis computes the same residuals, layer norms and FFNs) and its
attention sublayers work on the rank's L/n rows:

- ``seq_enter`` takes the rank's rows of the normalised input, with the
  projection weights; backward it gathers the rows' cotangents (the stream
  stays replicated) and sums the weights' (each rank computed the part of
  its rows), in one all-reduce;
- keys and values go round the group by ``gather_seq`` (backward: summed,
  then sliced), or by the ring;
- the output projection's rows are gathered whole by ``gather_rows``
  (backward: sliced).

Both stack kinds:

- ``full_self_attention_seq_parallel``: the rank's queries against the
  gathered length-normalised keys and values through K1 (forward) and K3
  (backward) at ``q_offset = rank * L / n``, so the causal and self masks
  and the attention dropout (the kernels' counter hash, keyed on the global
  row) are the one-device sublayer's.  The naive path draws the same hash.
- ``lsh_attention_seq_parallel``: each rank hashes its positions; the
  buckets are gathered (no gradient) and every rank sorts the whole
  sequence through K7's path entry (``_sort_by_bucket``), attends its
  ``nc / n`` sorted chunks and their neighbours with ``_attend_window``
  (plain PyTorch, as the reference's is plain ``jnp``), returns each
  round's (out, lse) to sequence order and combines the rounds with
  exp(lse - logsumexp).  Exchanges: ``allgather`` (the operands and the
  results gathered whole) and ``ring`` (``_ring_gather``: the shards ride
  n - 1 hops and each rank keeps the rows it needs).  Under gloo a hop is
  an all-reduce (``collectives``), so the ring keeps its result and loses
  its memory bound there.
- ``lsh_self_attention_seq_parallel``: the sublayer, drawing the rotations
  exactly as the one-device ``hash_vectors`` does (the stack's generator,
  or a fresh one for ``hash_seed``), so every rank hashes alike and the
  output is the one-device sublayer's; its cache holds the rotations, so
  the reversible backward's recompute draws nothing.

Over an axis the batch rides (``data``, ``dcn``: ``mesh.mesh_axis``'s
``batch``), a rank holds its own rows of a split batch, where the
reference's shard_map (``in_specs`` leaving the batch unsharded) has XLA
gather them.  The sublayers do the same (``_whole_batch``): the
normalised input's rows (and the mask's) are gathered over the data group
(``gather_rows``), the split path above runs on the whole batch at
``q_offset = rank * L / n``, and the rank keeps its rows of the output
(``seq_enter``, whose backward gathers the rows' cotangents, so the split
path's backward sees the replicated cotangent it expects).  The
projections' gradients, summed over the axis by the split path, are
scaled by 1 / the data group's size (``scale_grad``): the trainer sums
every gradient over the data group again.  A batch that is whole on
every rank (``current_batch_shard``) takes the split path as it is.

Every rank must make the same calls in the same order: all collectives are
issued by every rank of the group, forward and backward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rtts_torch.attention import lsh
from rtts_torch.attention.full import (Attention, _merge_heads,
                                       _split_heads, shared_keys)
from rtts_torch.attention.lsh import (_perm_rows_take, _sort_by_bucket,
                                      auto_num_buckets, hash_vectors,
                                      lane_span, total_buckets)
from rtts_torch.config import AttentionConfig
from rtts_torch.ops.flash_attention import (_drop_rscale, flash_attend,
                                            masked_scores, resolve_flash_impl)
from rtts_torch.ops.lsh_attention import dropout_lane, positional_dropout
from rtts_torch.parallel.collectives import (current_batch_shard,
                                             gather_dim, gather_rows,
                                             gather_seq, hop, scale_grad,
                                             seq_enter)
from rtts_torch.parallel.mesh import batch_axis, mesh_axis

_WHAT = "seq-parallel attention"


class SeqLshCache(NamedTuple):
    rotations: torch.Tensor   # (H, d, n_hashes, rot/2) f32


def _mm(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    return x @ w


def _check_len(l: int, n: int, axis: str) -> None:
    if l % n:
        raise ValueError(f"sequence length {l} must divide over {n} "
                         f"devices on axis {axis!r}")


def _check_chunks(cfg: AttentionConfig, l: int, n: int) -> None:
    if (cfg.num_hashes * l) % (cfg.chunk_length * n) != 0:
        raise ValueError(
            f"nh*L ({cfg.num_hashes * l}) must divide into chunks of "
            f"{cfg.chunk_length} across {n} devices")


def _ring_gather(x_l: torch.Tensor, pos: torch.Tensor, ax,
                 shard: int) -> torch.Tensor:
    """Rows of a sequence-sharded array at global indices.

    x_l: (B, H, shard, w), this rank's shard of (B, H, n * shard, w); pos:
    (B, H, P) global row indices.  The shards ride n - 1 hops; each rank
    copies out the rows whose index falls in the shard it holds.  ->
    (B, H, P, w)."""
    n = ax.size
    acc = torch.zeros(pos.shape + (x_l.shape[-1],), dtype=x_l.dtype,
                      device=x_l.device)
    buf = x_l
    for i in range(n):
        src = (ax.index - i) % n     # whose shard buf holds after i hops
        local = pos - src * shard
        ok = (local >= 0) & (local < shard)
        idx = local.clamp(0, shard - 1)[..., None].expand(
            pos.shape + (x_l.shape[-1],))
        got = torch.gather(buf, 2, idx)
        acc = torch.where(ok[..., None], got, acc)
        if i < n - 1:
            buf = hop(buf, ax)
    return acc


def _whole_batch(mesh, ax, x: torch.Tensor, mask: Optional[torch.Tensor],
                 weights):
    """-> (x, mask, weights, the data group's Axis or None).  On an axis
    the batch rides, with the batch split over the data group: the group's
    rows of x and mask gathered (x's gradient: this rank's rows), and the
    weights with their gradients scaled by 1 / the group's size.
    Otherwise the arguments as they are, and None."""
    rows = x.shape[0]
    _, total = current_batch_shard(rows)
    if not ax.batch or total == rows:
        return x, mask, weights, None
    bax = batch_axis(mesh)
    if rows * bax.size != total:
        raise ValueError(f"a batch of {total} rows in shards of {rows} "
                         f"does not split over the {bax.size} data ranks")
    if mask is not None:
        mask = gather_dim(mask, 0, bax.group, bax.index, bax.size)
    return (gather_rows(x, 0, bax), mask,
            tuple(scale_grad(w, 1.0 / bax.size) for w in weights), bax)


def _own_rows(y: torch.Tensor, bax) -> torch.Tensor:
    """This rank's batch rows of the whole batch's ``y`` (backward: the
    ranks' cotangents gathered); ``y`` when ``bax`` is None."""
    return y if bax is None else seq_enter(y, (), 0, bax)[0]


def lsh_attention_seq_parallel(
        qk_l: torch.Tensor, v_l: torch.Tensor, cfg: AttentionConfig,
        mask: Optional[torch.Tensor], causal: bool, rotations: torch.Tensor,
        mesh=None, axis: str = "model", exchange: str = "allgather",
        dropout_rate: float = 0.0, dropout_seed: Optional[int] = None
) -> torch.Tensor:
    """Sequence-parallel LSH attention on this rank's shard.

    qk_l, v_l: (B, H, L/n, d), the rank's rows of (B, H, L, d); ``mask``
    (B, L) bool, whole; ``rotations`` (H, d, nh, rot/2), the same on every
    rank.  -> (B, H, L/n, d), the rank's rows of the one-device
    ``lsh_attention_core`` output.  ``dropout_seed`` (with a rate > 0)
    applies the position-keyed attention-probs dropout, the one-device
    mask."""
    if exchange not in ("allgather", "ring"):
        raise ValueError(f"unknown exchange {exchange!r}")
    ax = mesh_axis(mesh, axis, _WHAT)
    n = ax.size
    b, h, shard, d = qk_l.shape
    l = shard * n
    c, nh = cfg.chunk_length, cfg.num_hashes
    nb = cfg.num_buckets or auto_num_buckets(l, c)
    _check_chunks(cfg, l, n)
    drop = dropout_seed is not None and dropout_rate > 0.0
    off = ax.index * shard
    mask_l = None if mask is None else mask[:, off:off + shard]

    # hash the rank's positions; every rank sorts the gathered buckets
    buckets_l = hash_vectors(qk_l, nb, nh, None, mask_l, rotations=rotations)
    buckets = gather_dim(buckets_l, 3, ax.group, ax.index, n)
    sorted_pos, undo_idx, sorted_buckets = _sort_by_bucket(buckets)

    nc = nh * l // c
    ncl = nc // n
    lo = ax.index * ncl
    before, after = cfg.num_chunks_before, cfg.num_chunks_after
    pos_c = sorted_pos.reshape(b, h, nc, c)
    win = (lo + torch.arange(-before, ncl + after, device=qk_l.device)) % nc
    pos_k = pos_c[:, :, win]                          # (B, H, ncl+b+a, c)
    pos_q = pos_c[:, :, lo:lo + ncl]

    packed = torch.cat([qk_l, v_l], dim=-1)           # (B, H, L/n, 2d)
    if exchange == "allgather":
        whole = gather_seq(packed, 2, ax).reshape(b * h, l, 2 * d)
        g = _perm_rows_take(whole, sorted_pos.reshape(b * h, nh, l),
                            undo_idx.reshape(b * h, nh, l))
        g = g.reshape(b, h, nc, c, 2 * d)
        q_my = g[:, :, lo:lo + ncl, :, :d]
        kv = g[:, :, win]
    else:
        wk = pos_k.shape[2]
        kv = _ring_gather(packed, pos_k.reshape(b, h, wk * c), ax,
                          shard).reshape(b, h, wk, c, 2 * d)
        q_my = kv[:, :, before:before + ncl, :, :d]
    k_my = shared_keys(kv[..., :d])
    v_my = kv[..., d:]

    if mask is not None:
        # padding hashed into the overflow bucket: validity is the sort's
        val_c = (sorted_buckets < total_buckets(nb)).reshape(b, h, nc, c)
        val_k = val_c[:, :, win]
    else:
        val_k = torch.ones(pos_k.shape, dtype=torch.bool,
                           device=qk_l.device)

    out_c, lse_c = _attend_window(
        q_my, k_my, v_my, pos_q, pos_k, val_k, causal, before, after,
        cfg.mask_value, cfg.self_mask_value,
        dropout_rate=dropout_rate if drop else 0.0,
        dropout_seed=dropout_seed if drop else None, chunk_lo=lo,
        chunks_per_round=l // c)

    # back to sequence order: the rank's positions need, per round, the
    # sorted-slot results at undo_idx; the flat slot axis is round-major
    undo_my = undo_idx[..., off:off + shard]          # (B, H, nh, L/n)
    res = torch.cat([out_c.float(), lse_c[..., None]], dim=-1).reshape(
        b, h, ncl * c, d + 1)
    if exchange == "allgather":
        res_all = gather_seq(res, 2, ax).reshape(b, h, nh, l, d + 1)
        got = torch.gather(res_all, 3, undo_my[..., None].expand(
            b, h, nh, shard, d + 1))
    else:
        offs = (torch.arange(nh, device=undo_my.device) * l)[None, None, :,
                                                              None]
        flat_u = (undo_my + offs).reshape(b, h, nh * shard)
        got = _ring_gather(res, flat_u, ax, ncl * c).reshape(
            b, h, nh, shard, d + 1)
    out_r, lse_r = got[..., :d], got[..., d]
    if nh == 1:
        return out_r[:, :, 0].to(out_c.dtype)
    # the combine in f32, as the one-device core's
    w = torch.exp(lse_r - torch.logsumexp(lse_r, dim=2, keepdim=True))
    return torch.einsum("bhnl,bhnld->bhld", w, out_r).to(out_c.dtype)


def full_self_attention_seq_parallel(
        p: Attention, x: torch.Tensor, mask: Optional[torch.Tensor],
        causal: bool, cfg: AttentionConfig, compute_dtype=None, mesh=None,
        axis: str = "model", dropout_rate: float = 0.0,
        dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Sequence-parallel shared-QK full attention, the drop-in for
    ``shared_qk_self_attention``: x (B, L, D) whole on every rank of the
    group -> (B, L, D) whole.  The rank's L/n queries attend the gathered
    keys at ``q_offset = rank * L / n`` (K1 forward, K3 backward on the
    card); ``dropout_seed`` turns on the attention dropout, keyed on the
    global row.  Over an axis the batch rides, x holds this rank's batch
    rows, and so does the output (``_whole_batch``)."""
    ax = mesh_axis(mesh, axis, _WHAT)
    n = ax.size
    _check_len(x.shape[1], n, axis)
    x, mask, weights, bax = _whole_batch(
        mesh, ax, x, mask, (p.w_qk.w, p.w_v.w, p.w_o.w))
    b, l, _ = x.shape
    shard = l // n
    q_off = ax.index * shard
    heads = p.num_heads
    x_l, w_qk, w_v, w_o = seq_enter(x, weights, 1, ax)
    qk = _split_heads(_mm(x_l, w_qk, compute_dtype), heads)
    v = _split_heads(_mm(x_l, w_v, compute_dtype), heads)
    d = qk.shape[-1]
    # per-row ops commute with the shard: normalise locally, gather once
    kv = gather_seq(torch.cat([shared_keys(qk), v], dim=-1),
                    2, ax)
    k_g, v_g = kv[..., :d], kv[..., d:]
    rate = dropout_rate if dropout_seed is not None else 0.0
    b_off, _ = current_batch_shard(b)
    if resolve_flash_impl(cfg.flash) == "flash":
        out = flash_attend(qk, k_g, v_g, mask, causal=causal, self_mask=True,
                           sm_scale=1.0, q_offset=q_off, dropout_rate=rate,
                           dropout_seed=dropout_seed, b_offset=b_off,
                           h_offset=0, h_total=heads)
    else:
        s = masked_scores(qk, k_g, mask, causal=causal, self_mask=True,
                          sm_scale=1.0, q_offset=q_off)
        probs = torch.softmax(s, dim=-1)
        rs = _drop_rscale(dropout_seed, b, heads, shard, l, rate, q_off,
                          x.device, b_off, 0, heads)
        if rs is not None:
            probs = probs * rs
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v_g.dtype), v_g)
    return _own_rows(gather_rows(_mm(_merge_heads(out), w_o, compute_dtype),
                                 1, ax), bax)


def lsh_self_attention_seq_parallel(
        p: Attention, x: torch.Tensor, mask: Optional[torch.Tensor],
        causal: bool, cfg: AttentionConfig,
        generator: Optional[torch.Generator], compute_dtype=None, mesh=None,
        axis: str = "model", exchange: str = "allgather",
        dropout_seed: Optional[int] = None,
        cache: Optional[SeqLshCache] = None):
    """Sequence-parallel drop-in for ``lsh_self_attention``: x (B, L, D)
    whole -> (out (B, L, D) whole, ``SeqLshCache``).  The rotations are the
    one-device sublayer's draw (``generator``, or a fresh generator seeded
    ``cfg.hash_seed``), or the cache's.  Over an axis the batch rides, x
    holds this rank's batch rows, and so does the output
    (``_whole_batch``)."""
    ax = mesh_axis(mesh, axis, _WHAT)
    l = x.shape[1]
    _check_len(l, ax.size, axis)
    if exchange not in ("allgather", "ring"):
        raise ValueError(f"unknown exchange {exchange!r}")
    _check_chunks(cfg, l, ax.size)
    if cache is not None:
        rotations = cache.rotations
    else:
        if cfg.hash_seed is not None:
            generator = torch.Generator(device=x.device).manual_seed(
                cfg.hash_seed)
        nb = cfg.num_buckets or auto_num_buckets(l, cfg.chunk_length)
        factors = [nb] if isinstance(nb, int) else list(nb)
        rotations = lsh.draw_rotations(cfg.num_heads, cfg.head_dim,
                                   cfg.num_hashes, sum(factors) // 2,
                                   generator, x.device)
    heads = p.num_heads
    x, mask, weights, bax = _whole_batch(
        mesh, ax, x, mask, (p.w_qk.w, p.w_v.w, p.w_o.w))
    x_l, w_qk, w_v, w_o = seq_enter(x, weights, 1, ax)
    qk = _split_heads(_mm(x_l, w_qk, compute_dtype), heads)
    v = _split_heads(_mm(x_l, w_v, compute_dtype), heads)
    out = lsh_attention_seq_parallel(
        qk, v, cfg, mask, causal, rotations, mesh, axis=axis,
        exchange=exchange, dropout_rate=cfg.attention_dropout,
        dropout_seed=dropout_seed)
    out = gather_rows(_mm(_merge_heads(out), w_o, compute_dtype), 1, ax)
    return _own_rows(out, bax), SeqLshCache(rotations=rotations)


def _attend_window(q_my, k_pad, v_pad, pos_q, pos_k_pad, val_pad, causal,
                   before, after, mask_value, self_mask_value,
                   dropout_rate=0.0, dropout_seed=None, chunk_lo=0,
                   chunks_per_round=None):
    """Attend my chunks against their neighbour windows (plain PyTorch).

    q_my: (B, H, ncl, c, d); k_pad etc.: (B, H, ncl + before + after, c,
    d): chunk i of q_my attends chunks [i, i + before + after] of the
    padded arrays ([i - before, ..., i + after] in global chunk
    coordinates).  ``dropout_seed`` applies the position-keyed dropout,
    its lanes keyed on the global chunk ``chunk_lo + i``.  Scores,
    probabilities and P.V in f32, as the one-device plain attend
    (``lsh_attend_chunks_reference``) computes them.  -> (out (B, H, ncl,
    c, d) in q's dtype, lse (B, H, ncl, c) f32)."""
    b, h, ncl, c, d = q_my.shape
    w = before + after + 1
    ks = torch.cat([k_pad[:, :, i:i + ncl] for i in range(w)], dim=-2)
    vs = torch.cat([v_pad[:, :, i:i + ncl] for i in range(w)], dim=-2)
    pk = torch.cat([pos_k_pad[:, :, i:i + ncl] for i in range(w)], dim=-1)
    vl = torch.cat([val_pad[:, :, i:i + ncl] for i in range(w)], dim=-1)

    scores = torch.einsum("bhnqd,bhnkd->bhnqk", q_my.float(), ks.float())
    scores = torch.where(vl[..., None, :], scores,
                         torch.full_like(scores, mask_value))
    if causal:
        scores = torch.where(pos_q[..., :, None] >= pk[..., None, :], scores,
                             torch.full_like(scores, mask_value))
    scores = torch.where(pos_q[..., :, None] == pk[..., None, :],
                         torch.full_like(scores, self_mask_value), scores)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    if dropout_seed is not None and dropout_rate > 0.0:
        lane = dropout_lane(b, h, chunk_lo + torch.arange(
            ncl, device=q_my.device), chunks_per_round, lane_span(b, h))
        probs = positional_dropout(probs, pos_q, pk, lane, dropout_seed,
                                   dropout_rate)
    out = torch.einsum("bhnqk,bhnkd->bhnqd", probs, vs.float())
    return out.to(q_my.dtype), lse
