"""LSH chunk-attend: kernels K4 (forward) and K5 (backward) and their plain
versions.

Port of ``rtts/ops/lsh_attention.py``.  After hashing and the bucket sort
(``rtts_torch/attention/lsh.py``), the sorted rows are cut into chunks of
``c``; each chunk of queries attends its own chunk and the ``before`` /
``after`` neighbour chunks with one joint softmax.  The neighbour index
wraps over the whole chunk axis, which runs over the concatenated hash
rounds, so chunk 0 of round r looks back into the last chunk of round r - 1;
a position may then appear twice in one window, and nothing removes the
duplicate (the reference does not either).  Masks replace f32 scores, by
ORIGINAL position, in this order:

- invalid key (padding, from the overflow bucket):  score := mask_value
- causal, q_pos < k_pos:                            score := mask_value
- self, q_pos == k_pos (even on an invalid key):    score := self_mask_value

``lsh_attend_chunks_kernel`` is differentiable and returns (out, lse).  On
CUDA tensors its forward launches ``rtts_torch/csrc/lsh_attend_fwd.cu`` (K4;
bf16 on tensor cores) and its backward ``rtts_torch/csrc/lsh_attend_bwd.cu``
(K5: a dQ kernel per query chunk, then a dK/dV kernel per key chunk; bf16
on tensor cores), or they raise; on CPU tensors the same
``torch.autograd.Function`` runs ``lsh_attend_chunks_reference`` and
``lsh_attend_bwd_reference``.  The backward takes both cotangents: the
multi-round combine differentiates through lse, so dS = P (dP - rowsum(dP
P)) + P dlse, zero on the self entries (their score is a constant), while
dV keeps every entry.

The kernels normalise by the joint softmax's own sum, as the TPU kernels
do, so a row whose only surviving entries are self entries at -1e5 gets
exact probabilities; the JAX package's jnp attend computes exp(s - lse)
there, and so does the plain attend when asked (``probs_from_lse``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rtts_torch.ops import _build
from rtts_torch.ops.flash_attention import (MASK_VALUE, SELF_MASK_VALUE,
                                            _aligned, keep_bits)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_CHUNKS = (16, 32, 64)


def look_adjacent(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """(..., nc, c, ...) -> the chunk neighbours concatenated on the c axis:
    chunk i sees chunks [i - before, ..., i, ..., i + after], wrapping over
    the whole chunk axis (``rtts/attention/lsh.py::_look_adjacent``)."""
    if before == 0 and after == 0:
        return x
    return torch.cat([torch.roll(x, shifts=-off, dims=-3)
                      for off in range(-before, after + 1)], dim=-2)


def window_scores(q, k, pos, valid, causal, before, after,
                  mask_value=MASK_VALUE, self_mask_value=SELF_MASK_VALUE):
    """-> ((B, H, nc, c, W) f32 masked scores, (B, H, nc, c, W) self mask,
    key positions (B, H, nc, W)) of every chunk against its window of W =
    (before + 1 + after) c keys."""
    k_adj = look_adjacent(k, before, after)
    k_pos = look_adjacent(pos[..., None], before, after)[..., 0]
    k_val = look_adjacent(valid[..., None], before, after)[..., 0]
    s = torch.einsum("bhnqd,bhnkd->bhnqk", q.float(), k_adj.float())
    s = s.masked_fill(~k_val.bool()[..., None, :], mask_value)
    q_pos = pos[..., :, None]
    if causal:
        s = s.masked_fill(q_pos < k_pos[..., None, :], mask_value)
    self_m = q_pos == k_pos[..., None, :]
    return s.masked_fill(self_m, self_mask_value), self_m, k_pos


# -- plain versions ------------------------------------------------------------


def positional_dropout(probs: torch.Tensor, q_pos: torch.Tensor,
                       k_pos: torch.Tensor, lane: torch.Tensor, seed: int,
                       rate: float) -> torch.Tensor:
    """Attention-probs dropout keyed by ORIGINAL positions: keep(i, j) is
    the flash kernels' hash of (seed, lane, q_pos i, k_pos j), so the mask
    does not depend on the bucket permutation.  Inverted scaling."""
    keep = keep_bits(seed, lane, q_pos[..., :, None], k_pos[..., None, :],
                     rate)
    return probs * (keep.to(probs.dtype) / (1.0 - rate))


def dropout_lane(b: int, h: int, chunk_idx: torch.Tensor,
                 chunks_per_round: int, span=None) -> torch.Tensor:
    """(B, H, nc, 1, 1) lane ids for ``positional_dropout`` over a chunked
    attend: lane = round * (B*H) + b*H + h.  ``span`` = (b_offset,
    b_total, h_offset, h_total) places a rank's rows and heads in the
    global batch, whose lanes they take."""
    b_off, b_tot, h_off, h_tot = span or (0, b, 0, h)
    rounds = chunk_idx.long() // chunks_per_round
    bh = ((torch.arange(b, device=chunk_idx.device)[:, None] + b_off) * h_tot
          + torch.arange(h, device=chunk_idx.device)[None, :] + h_off)
    lane = rounds[None, None, :] * (b_tot * h_tot) + bh[:, :, None]
    return lane[..., None, None]


def lsh_attend_chunks_reference(q, k, v, pos, valid, causal, before, after,
                                mask_value=MASK_VALUE,
                                self_mask_value=SELF_MASK_VALUE,
                                probs_from_lse: bool = False,
                                dropout_rate: float = 0.0,
                                dropout_seed: Optional[int] = None,
                                chunks_per_round: Optional[int] = None,
                                lane_span=None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4, and the plain attend.  q, k, v: (B, H,
    nc, c, d) sorted chunks (k already length-normalised and scaled); pos:
    (B, H, nc, c) original positions; valid: (B, H, nc, c) key validity.
    Scores and probabilities in f32; P is rounded to v's dtype before P.V
    (a no-op in f32), as the path JAX takes on the CPU does: its jnp attend
    casts the normalised probabilities (``rtts/attention/lsh.py``), where
    the TPU kernel and K4 round exp(s - m) before the divide; P.V sums in
    f32 -> (out (B, H, nc, c, d) in q's dtype, lse (B, H, nc, c) f32 of
    the undropped scores).

    The probabilities divide by the joint sum, as K4 and the TPU kernel do;
    ``probs_from_lse`` takes exp(s - lse) instead, as the JAX package's jnp
    attend does (``use_pallas: false`` and attention dropout run it).  The
    two differ only in f32 rounding at |lse| ~ 1e5: rows left with nothing
    but a self entry seen twice.  Given a ``dropout_seed`` (which K4 does
    not take), the probabilities get positional dropout keyed per (round,
    q_pos, k_pos), with ``chunks_per_round`` = L / c (``lane_span``:
    ``dropout_lane``'s)."""
    s, _, k_pos = window_scores(q, k, pos, valid, causal, before, after,
                                mask_value, self_mask_value)
    lse = torch.logsumexp(s, dim=-1)
    p = (torch.exp(s - lse[..., None]) if probs_from_lse
         else torch.softmax(s, dim=-1))
    if dropout_seed is not None and dropout_rate > 0.0:
        b, h, nc = q.shape[:3]
        lane = dropout_lane(b, h, torch.arange(nc, device=q.device),
                            chunks_per_round or nc, lane_span)
        p = positional_dropout(p, pos, k_pos, lane, dropout_seed,
                               dropout_rate)
    v_adj = look_adjacent(v, before, after).float()
    out = torch.einsum("bhnqk,bhnkd->bhnqd", p.to(v.dtype).float(), v_adj)
    return out.to(q.dtype), lse


def unwindow(x_adj: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Adjoint of ``look_adjacent`` on (B, H, nc, W, d): split the window
    into its offsets, roll each back by +off and sum."""
    if before == 0 and after == 0:
        return x_adj
    c = x_adj.shape[3] // (before + 1 + after)
    parts = x_adj.split(c, dim=3)
    return sum(torch.roll(part, shifts=off, dims=2)
               for part, off in zip(parts, range(-before, after + 1)))


def lsh_attend_bwd_reference(q, k, v, pos, valid, dout, dlse, causal, before,
                             after, mask_value=MASK_VALUE,
                             self_mask_value=SELF_MASK_VALUE):
    """Plain PyTorch version of K5, the formula of the TPU kernel
    ``_attend_bwd_kernel`` written out in f32: the joint softmax is
    recomputed, dS = P (dP - rowsum(dP P)) + P dlse with dP = dO V^T, zero
    on the self entries; dQ = dS K, and dK, dV per window offset, rolled
    back and summed -> (dq, dk, dv) in the dtypes of (q, k, v).

    In bf16 too P, dS and the window sums stay in f32, as K5 keeps them
    (P and dS as hi + lo bf16 operands).  JAX's bf16 backward rounds P for
    dV, dS, and each window offset's dK and dV to bf16: done here, that
    puts the gradients 3-5% of their largest from f32, past the 1e-2 K5 is
    held to against this version (PERF.md, PR 19, bounds the difference
    from JAX)."""
    s, self_m, _ = window_scores(q, k, pos, valid, causal, before, after,
                                 mask_value, self_mask_value)
    p = torch.softmax(s, dim=-1)
    k_adj = look_adjacent(k, before, after).float()
    v_adj = look_adjacent(v, before, after).float()
    qf, dof = q.float(), dout.float()
    dp = torch.einsum("bhnqd,bhnkd->bhnqk", dof, v_adj)
    row = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - row) + p * dlse.float()[..., None]
    ds = ds.masked_fill(self_m, 0.0)
    dq = torch.einsum("bhnqk,bhnkd->bhnqd", ds, k_adj)
    dk = unwindow(torch.einsum("bhnqk,bhnqd->bhnkd", ds, qf), before, after)
    dv = unwindow(torch.einsum("bhnqk,bhnqd->bhnkd", p, dof), before, after)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers -----------------------------------------------------------


def _check(name, q, k, v, pos, valid, before, after):
    """Raise on what the kernels do not take -> q, k, v contiguous from
    16-byte boundaries, int32 positions and uint8 validity, all (N = B*H,
    nc, c[, d])."""
    b, h, nc, c, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in float32/bfloat16")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if c not in _CHUNKS:
        raise ValueError(f"{name}: chunk length {c} not in {_CHUNKS}")
    if before < 0 or after < 0:
        raise ValueError(f"{name}: before/after must be >= 0, got "
                         f"{before}/{after}")
    for tname, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tname} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, want {tuple(q.shape)} {q.dtype} "
                             f"on {q.device}")
    for tname, t in (("pos", pos), ("valid", valid)):
        if t.shape != q.shape[:4] or t.device != q.device:
            raise ValueError(f"{name}: {tname} is {tuple(t.shape)} on "
                             f"{t.device}, want {tuple(q.shape[:4])}")
    n = b * h
    return ([_aligned(t.reshape(n, nc, c, d)) for t in (q, k, v)],
            pos.reshape(n, nc, c).to(torch.int32).contiguous(),
            valid.reshape(n, nc, c).to(torch.uint8).contiguous())


def _scalars(q, causal, before, after, mask_value, self_mask_value):
    b, h, nc, c, d = q.shape
    return (_DTYPES[q.dtype], b * h, nc, c, d, int(bool(causal)), int(before),
            int(after), float(mask_value), float(self_mask_value),
            torch.cuda.current_stream(q.device).cuda_stream)


def fwd_route(dtype: torch.dtype, c: int, dh: int) -> int:
    """Which K4 kernel a (dtype, chunk length, head dim) takes on the card,
    as the C entry point's ``mma`` argument: 1, the tensor-core kernel
    (bf16: mma.sync products, P rounded to bf16 once), or 0, the FMA kernel
    (f32, for the f32 tolerance).  The plain version is never a fallback:
    what neither takes raises."""
    if c not in _CHUNKS:
        raise ValueError(f"lsh_attend_fwd: chunk length {c} not in {_CHUNKS}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"lsh_attend_fwd: head dim {dh} not in {_HEAD_DIMS}")
    if dtype not in _DTYPES:
        raise TypeError(f"lsh_attend_fwd: dtype {dtype} not in "
                        "float32/bfloat16")
    return int(dtype == torch.bfloat16)


def lsh_attend_fwd(q, k, v, pos, valid, causal, before, after,
                   mask_value=MASK_VALUE, self_mask_value=SELF_MASK_VALUE):
    """Launch K4 on the route of ``fwd_route`` -> (out like q, lse (B, H,
    nc, c) f32); counts in ``lsh_attend_fwd.launches``."""
    (qc, kc, vc), pos32, val8 = _check("lsh_attend_fwd", q, k, v, pos, valid,
                                      before, after)
    out = torch.empty_like(qc)
    lse = torch.empty(pos32.shape, device=q.device, dtype=torch.float32)
    err = _build.library().rtts_lsh_attend_fwd(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos32.data_ptr(),
        val8.data_ptr(), out.data_ptr(), lse.data_ptr(),
        fwd_route(q.dtype, q.shape[3], q.shape[4]),
        *_scalars(q, causal, before, after, mask_value, self_mask_value))
    _build.check(err, "rtts_lsh_attend_fwd")
    lsh_attend_fwd.launches += 1
    return out.reshape(q.shape), lse.reshape(q.shape[:4])


def bwd_route(dtype: torch.dtype, c: int) -> int:
    """Which K5 kernels a (dtype, chunk length) takes on the card, as the
    C entry point's ``mma`` argument: 1, the tensor-core kernels (bf16, c
    16, 32 or 64: mma.sync products), or 0, the FMA kernels (f32, for the
    f32 tolerance).  The plain version is never a fallback: what neither
    takes raises."""
    if c not in _CHUNKS:
        raise ValueError(f"lsh_attend_bwd: chunk length {c} not in {_CHUNKS}")
    return int(dtype == torch.bfloat16)


def lsh_attend_bwd(q, k, v, pos, valid, dout, dlse, causal, before, after,
                   mask_value=MASK_VALUE, self_mask_value=SELF_MASK_VALUE):
    """Launch K5 -> (dq, dk, dv) like (q, k, v); counts in
    ``lsh_attend_bwd.launches``.  Two kernels, on the route of
    ``bwd_route``: one per query chunk writes dQ and each row's f32
    softmax max, sum and D - dlse (the ``stats`` scratch, 12 bytes a row);
    one per key chunk reads them and writes dK and dV.  Each gradient entry
    has one writer and no atomics, so two runs on the same inputs are
    bit-equal."""
    (qc, kc, vc), pos32, val8 = _check("lsh_attend_bwd", q, k, v, pos, valid,
                                      before, after)
    doc = _aligned(dout.to(q.dtype).reshape(qc.shape))
    dlsec = dlse.to(torch.float32).reshape(pos32.shape).contiguous()
    dq, dk, dv = (torch.empty_like(qc) for _ in range(3))
    stats = torch.empty((3,) + pos32.shape, device=q.device,
                        dtype=torch.float32)
    err = _build.library().rtts_lsh_attend_bwd(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos32.data_ptr(),
        val8.data_ptr(), doc.data_ptr(), dlsec.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        bwd_route(q.dtype, q.shape[3]),
        *_scalars(q, causal, before, after, mask_value, self_mask_value))
    _build.check(err, "rtts_lsh_attend_bwd")
    lsh_attend_bwd.launches += 1
    return dq.reshape(q.shape), dk.reshape(q.shape), dv.reshape(q.shape)


lsh_attend_fwd.launches = 0
lsh_attend_bwd.launches = 0


class _LshAttend(torch.autograd.Function):
    """K4 forward and K5 backward (the JAX ``_attend_with_vjp``).  Saves
    only the inputs: the backward recomputes the joint softmax."""

    @staticmethod
    def forward(ctx, q, k, v, pos, valid, causal, before, after, mask_value,
                self_mask_value):
        opts = (causal, before, after, mask_value, self_mask_value)
        if q.device.type == "cpu":
            out, lse = lsh_attend_chunks_reference(q, k, v, pos, valid, *opts)
        else:
            out, lse = lsh_attend_fwd(q, k, v, pos, valid, *opts)
        ctx.save_for_backward(q, k, v, pos, valid)
        ctx.opts = opts
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, pos, valid = ctx.saved_tensors
        fn = (lsh_attend_bwd_reference if q.device.type == "cpu"
              else lsh_attend_bwd)
        dq, dk, dv = fn(q, k, v, pos, valid, dout, dlse, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None, None


def lsh_attend_chunks_kernel(q_c, k_c, v_c, pos_c, val_c, causal, before,
                             after, mask_value=MASK_VALUE,
                             self_mask_value=SELF_MASK_VALUE
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk attend through K4/K5 (the port of
    ``lsh_attend_chunks_pallas``), differentiable in q, k and v: (out (B,
    H, nc, c, d), lse (B, H, nc, c) f32).  Any chunk count: there is no
    fallback to the plain attend on the card.  When no gradient can be
    asked for, the forward is the operator ``rtts::lsh_attend_fwd``
    (``rtts_torch/ops/registry.py``)."""
    args = (q_c, k_c, v_c, pos_c, val_c, bool(causal), int(before),
            int(after), float(mask_value), float(self_mask_value))
    if torch.is_grad_enabled() and (q_c.requires_grad or k_c.requires_grad
                                    or v_c.requires_grad):
        return _LshAttend.apply(*args)
    return torch.ops.rtts.lsh_attend_fwd(*args)


from rtts_torch.ops import registry  # noqa: E402,F401  (defines rtts::*)
