"""Flash (online-softmax) attention: kernels K1 and K3 and their plain versions.

Port of ``rtts/ops/flash_attention.py``.  ``flash_attend`` is differentiable:
its forward launches the CUDA kernel ``rtts_torch/csrc/flash_fwd.cu`` (K1)
and its backward the two kernels of ``rtts_torch/csrc/flash_bwd.cu`` (K3,
FA2: dK/dV, then dQ), bf16 on tensor cores, for tensors on the card; for
tensors on the CPU the same ``torch.autograd.Function`` runs
``flash_attend_reference`` and ``flash_attend_bwd_reference``.  All of
them compute the same masked softmax attention, with the reference's
replace-style masks applied to f32 scores before the softmax:

- pad keys (``kv_mask`` False):     score := MASK_VALUE      (-1e9)
- causal, q_offset + row < col:     score := MASK_VALUE      (-1e9)
- self_mask, q_offset + row == col: score := SELF_MASK_VALUE (-1e5)

so a query whose keys are all masked still attends itself.  Attention-probs
dropout is the JAX kernel's counter hash, bit for bit
(``dropout_keep_mask``): the keep bit of (batch*head, global row, global
col) is a function of a uint32 seed, so the forward and the backward
regenerate the same mask and none is stored.  Dropout scales P.V only; the
saved lse is that of the undropped softmax.  A rank that holds batch rows
``b_offset``.. and heads ``h_offset``.. of ``h_total`` (data and tensor
parallelism, ``rtts_torch/parallel/``) hashes the global (b, h), so its
mask is that slice of the one-device mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from rtts_torch.ops import _build

# the kernels' constants kMaskValue and kSelfMaskValue hold the same values
MASK_VALUE = -1e9
SELF_MASK_VALUE = -1e5

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_DROP_BITS = 24
_M32 = 0xFFFFFFFF


def resolve_flash_impl(knob) -> str:
    """Resolve the AttentionConfig.flash knob to 'flash' | 'naive'.

    true / "auto" -> flash (the kernel on the card, its plain version on
                     the CPU); "auto" takes the kernel at every length until
                     a crossover is measured on the H100 (the TPU's
                     1024-position threshold does not carry over)
    false         -> naive (the plain version everywhere)
    """
    if knob in (False, None):
        return "naive"
    if knob is True or knob == "auto":
        return "flash"
    raise ValueError(f"flash knob must be true, false or 'auto', got {knob!r}")


# -- attention-probs dropout ---------------------------------------------------
# The JAX kernel's keep mask: lowbias32 of
# row*0x85EBCA6B + col*0xC2B2AE35 + bh*0x27D4EB2F + seed (mod 2^32), top 24
# bits against round(keep_prob * 2^24).  torch has no uint32 multiply that
# wraps, so the plain version runs in int64 and splits every product into
# 16-bit halves (no intermediate reaches 2^63), masking to 32 bits.


def _drop_threshold(rate: float) -> int:
    """24-bit keep threshold for a dropout rate (0 => no dropout)."""
    if rate <= 0.0:
        return 0
    if rate >= 1.0:
        raise ValueError(f"dropout_rate must be < 1, got {rate}")
    return int(round((1.0 - rate) * (1 << _DROP_BITS)))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche finalizer on int64 holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_bits(seed: int, bh: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor, rate: float) -> torch.Tensor:
    """f32 keep indicators in {0, 1} of broadcastable non-negative int
    grids (the JAX ``_keep_tile``): the hash of (rows, cols, bh, seed)."""
    thr = _drop_threshold(rate)
    rows, cols, bh = (t.to(torch.int64) & _M32 for t in (rows, cols, bh))
    u = (_mul32(rows, 0x85EBCA6B) + _mul32(cols, 0xC2B2AE35)
         + _mul32(bh, 0x27D4EB2F) + (int(seed) & _M32)) & _M32
    return ((_mix32(u) >> (32 - _DROP_BITS)) < thr).float()


def dropout_keep_mask(seed: int, n_bh: int, l_q: int, l_k: int, rate: float,
                      q_offset: int = 0, device=None,
                      heads: Optional[int] = None, b_offset: int = 0,
                      h_offset: int = 0,
                      h_total: Optional[int] = None) -> torch.Tensor:
    """Dense (n_bh, l_q, l_k) f32 keep mask in {0, 1}: the exact mask the
    kernels regenerate tile by tile, equal bit for bit to JAX
    ``dropout_keep_mask`` for the same uint32 seed.  With ``heads`` (the
    local heads a row of n_bh holds), row b * heads + h hashes the global
    index (b_offset + b) * h_total + h_offset + h."""
    kw = dict(dtype=torch.int64, device=device)
    bh = torch.arange(n_bh, **kw)
    if heads is not None:
        bh = global_bh(bh, heads, b_offset, h_offset, h_total)
    return keep_bits(seed, bh[:, None, None],
                     (torch.arange(l_q, **kw) + q_offset)[None, :, None],
                     torch.arange(l_k, **kw)[None, None, :], rate)


def global_bh(bh, heads: int, b_offset: int = 0, h_offset: int = 0,
              h_total: Optional[int] = None):
    """The hashed index of local row bh = b * heads + h: (b_offset + b) *
    h_total + h_offset + h (the kernels' ``drop_bh``)."""
    h_total = heads if h_total is None else h_total
    return (bh // heads + b_offset) * h_total + bh % heads + h_offset


def _drop_rscale(seed, b, h, l_q, l_k, rate, q_offset, device, b_offset=0,
                 h_offset=0, h_total=None):
    """keep / keep_prob as (B, H, Lq, Lk) f32, or None without dropout."""
    if not _drop_threshold(rate):
        return None
    keep = dropout_keep_mask(seed, b * h, l_q, l_k, rate, q_offset, device,
                             h, b_offset, h_offset, h_total)
    return keep.reshape(b, h, l_q, l_k) * (1.0 / (1.0 - rate))


# -- plain versions ------------------------------------------------------------


def masked_scores(q, k, kv_mask=None, *, causal=False, self_mask=False,
                  sm_scale=1.0, q_offset=0) -> torch.Tensor:
    """(B, H, Lq, Lk) f32 scores q.k * sm_scale with the replace-style masks
    (pad, then causal, then self), positions compared as q_offset + row."""
    l_q, l_k = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], MASK_VALUE)
    rows = torch.arange(l_q, device=q.device)[:, None] + q_offset
    cols = torch.arange(l_k, device=q.device)[None, :]
    if causal:
        s = s.masked_fill(rows < cols, MASK_VALUE)
    if self_mask:
        s = s.masked_fill(rows == cols, SELF_MASK_VALUE)
    return s


def flash_attend_reference(q, k, v, kv_mask=None, *, causal=False,
                           self_mask=False, sm_scale=1.0, q_offset=0,
                           dropout_rate=0.0, dropout_seed=None,
                           return_lse=False, b_offset=0, h_offset=0,
                           h_total=None):
    """Plain PyTorch version of K1: explicit (B, H, Lq, Lk) f32 scores, then
    softmax and the keep mask in f32; P is rounded to v's dtype before P.V
    (a no-op in f32), as JAX's attention casts its probabilities
    (``rtts/attention/full.py``) and the kernels round P, and P.V sums in
    f32; the output is cast to q's dtype, lse is (B*H, Lq) f32 of the
    undropped softmax."""
    b, h, l_q, _ = q.shape
    s = masked_scores(q, k, kv_mask, causal=causal, self_mask=self_mask,
                      sm_scale=sm_scale, q_offset=q_offset)
    # softmax subtracts the row max: exp(s - lse) would lose the fully
    # masked rows, whose lse = -1e9 + log(Lk) rounds back to -1e9 in f32
    p = torch.softmax(s, dim=-1)
    rscale = _drop_rscale(dropout_seed, b, h, l_q, k.shape[2], dropout_rate,
                          q_offset, q.device, b_offset, h_offset, h_total)
    if rscale is not None:
        p = p * rscale
    p = p.to(v.dtype).float()
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(b * h, l_q)
    return out


def flash_attend_bwd_reference(q, k, v, out, dout, lse, kv_mask=None, *,
                               causal=False, self_mask=False, sm_scale=1.0,
                               q_offset=0, dropout_rate=0.0,
                               dropout_seed=None, b_offset=0, h_offset=0,
                               h_total=None):
    """Plain PyTorch version of K3: the kernels' equations written out
    densely in f32 -> (dq, dk, dv) in the dtypes of (q, k, v).

    P is recomputed as exp(s - lse) from the saved lse, as the kernels do
    (not autograd of the plain forward): the two agree on every row that
    has an unmasked key or the self position.

    In bf16 too P, D = rowsum(O o dO) and dS stay in f32, as the kernels
    keep them (K3 feeds P and dS to its bf16 products as hi + lo halves).
    JAX's bf16 backward rounds P for dV, takes D = rowsum(P o dP) and
    rounds dS to bf16 before dQ and dK: done here, that puts the gradients
    3-4% of their largest from f32, past the 1e-2 K3 is held to against
    this version (PERF.md, PR 19, bounds the difference from JAX)."""
    b, h, l_q, _ = q.shape
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    s = masked_scores(q, k, kv_mask, causal=causal, self_mask=self_mask,
                      sm_scale=sm_scale, q_offset=q_offset)
    p = torch.exp(s - lse.reshape(b, h, l_q, 1))
    rscale = _drop_rscale(dropout_seed, b, h, l_q, k.shape[2], dropout_rate,
                          q_offset, q.device, b_offset, h_offset, h_total)
    pr = p if rscale is None else p * rscale
    dv = torch.einsum("bhqk,bhqd->bhkd", pr, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    if rscale is not None:
        dp = dp * rscale
    di = (of * dof).sum(-1, keepdim=True)
    ds = p * (dp - di)
    if self_mask:
        rows = torch.arange(l_q, device=q.device)[:, None] + q_offset
        ds = ds.masked_fill(rows == torch.arange(k.shape[2], device=q.device),
                            0.0)
    ds = ds * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers -----------------------------------------------------------


def _check_inputs(name, q, k, v, kv_mask):
    """Raise on what the kernels do not take; returns the contiguous
    tensors and the mask as bytes."""
    b, h, l_q, dh = q.shape
    l_k = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in float32/bfloat16")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dh} not in {_HEAD_DIMS}")
    for tname, t in (("k", k), ("v", v)):
        if t.shape != (b, h, l_k, dh) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tname} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {(b, h, l_k, dh)} {q.dtype} on "
                             f"{q.device}")
    if kv_mask is not None:
        if kv_mask.shape != (b, l_k) or kv_mask.device != q.device:
            raise ValueError(f"{name}: kv_mask is {tuple(kv_mask.shape)} on "
                             f"{kv_mask.device}, want {(b, l_k)} on {q.device}")
        kv_mask = kv_mask.to(torch.bool).contiguous()
    return _aligned(q), _aligned(k), _aligned(v), kv_mask


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous from a 16-byte boundary (the bf16 kernels load 16
    bytes at a time): a copy for the rare view that starts elsewhere."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scalars(q, k, causal, self_mask, sm_scale, q_offset, rate, seed,
             b_offset=0, h_offset=0, h_total=None):
    """The C entry points' trailing arguments, dtype through stream."""
    b, h, l_q, dh = q.shape
    thr = _drop_threshold(rate)
    return (_DTYPES[q.dtype], b * h, h, l_q, k.shape[2], dh, float(sm_scale),
            int(bool(causal)), int(bool(self_mask)), int(q_offset),
            int(seed) & _M32 if thr else 0, thr,
            1.0 / (1.0 - rate) if thr else 1.0, int(b_offset), int(h_offset),
            h if h_total is None else int(h_total),
            _build.stream(q.get_device()))


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd(q, k, v, kv_mask, causal, self_mask, sm_scale, q_offset,
              dropout_rate, dropout_seed, b_offset=0, h_offset=0,
              h_total=None):
    """Launch K1 -> (out, lse (B*H, Lq) f32); counts in ``flash_attend.launches``."""
    q, k, v, kv_mask = _check_inputs("flash_attend", q, k, v, kv_mask)
    b, h, l_q, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, l_q), device=q.device, dtype=torch.float32)
    err = _build.function("rtts_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
        out.data_ptr(), lse.data_ptr(),
        *_scalars(q, k, causal, self_mask, sm_scale, q_offset, dropout_rate,
                  dropout_seed, b_offset, h_offset, h_total))
    _build.check(err, "rtts_flash_fwd")
    flash_attend.launches += 1
    return out, lse


# the bf16 dK/dV kernel's tiles (MmaTiles in flash_bwd.cu): 64 keys a
# block, 64 (dh 64) or 32 (dh 128) queries a streamed step
_KEY_TILE = 64


def dkv_query_splits(bh: int, l_q: int, l_k: int, dh: int, sms: int) -> int:
    """Blocks the bf16 dK/dV kernel splits each key tile's query range
    into: enough to give ``sms`` SMs about six blocks each, while a split
    keeps at least 8 query tiles and none is empty."""
    br = 64 if dh == 64 else 32
    n_qt = -(-l_q // br)
    blocks = -(-l_k // _KEY_TILE) * bh
    n = max(1, min(-(-6 * sms // max(blocks, 1)), n_qt // 8))
    per = -(-n_qt // n) if n_qt else 1
    return max(1, -(-n_qt // per))


_SM_COUNT = {}


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = _SM_COUNT[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def flash_bwd_dkv(q, k, v, out, dout, lse, kv_mask, causal, self_mask,
                  sm_scale, q_offset, dropout_rate, dropout_seed, b_offset=0,
                  h_offset=0, h_total=None):
    """Launch K3's dK/dV kernel -> (dk, dv); counts in
    ``flash_bwd_dkv.launches``.  In bf16 each key tile's query range is
    split over ``dkv_query_splits`` blocks whose f32 partials are summed in
    a fixed order; f32 runs one block per key tile."""
    q, k, v, kv_mask = _check_inputs("flash_bwd_dkv", q, k, v, kv_mask)
    out, dout = _aligned(out), _aligned(dout.to(q.dtype))
    b, h, l_q, dh = q.shape
    l_k = k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    di = part = None
    n_split = 1
    if q.dtype == torch.bfloat16:
        f32 = dict(dtype=torch.float32, device=q.device)
        di = torch.empty(b * h * l_q, **f32)
        n_split = dkv_query_splits(b * h, l_q, l_k, dh, _sm_count(q.device))
        if n_split > 1:
            part = torch.empty(2 * n_split * b * h * l_k * dh, **f32)
    err = _build.function("rtts_flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.contiguous().data_ptr(), _ptr(kv_mask),
        dk.data_ptr(), dv.data_ptr(), _ptr(di), _ptr(part), n_split,
        *_scalars(q, k, causal, self_mask, sm_scale, q_offset, dropout_rate,
                  dropout_seed, b_offset, h_offset, h_total))
    _build.check(err, "rtts_flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, out, dout, lse, kv_mask, causal, self_mask,
                 sm_scale, q_offset, dropout_rate, dropout_seed, b_offset=0,
                 h_offset=0, h_total=None):
    """Launch K3's dQ kernel -> dq; counts in ``flash_bwd_dq.launches``."""
    q, k, v, kv_mask = _check_inputs("flash_bwd_dq", q, k, v, kv_mask)
    out, dout = _aligned(out), _aligned(dout.to(q.dtype))
    dq = torch.empty_like(q)
    err = _build.function("rtts_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.contiguous().data_ptr(), _ptr(kv_mask),
        dq.data_ptr(),
        *_scalars(q, k, causal, self_mask, sm_scale, q_offset, dropout_rate,
                  dropout_seed, b_offset, h_offset, h_total))
    _build.check(err, "rtts_flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward and K3 backward (the JAX ``_flash`` custom_vjp).  The
    backward recomputes the probabilities from (q, k, lse) and the seed."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, self_mask, sm_scale, q_offset,
                rate, seed, b_offset, h_offset, h_total):
        opts = (causal, self_mask, sm_scale, q_offset, rate, seed, b_offset,
                h_offset, h_total)
        if q.device.type == "cpu":
            out, lse = flash_attend_reference(
                q, k, v, kv_mask, causal=causal, self_mask=self_mask,
                sm_scale=sm_scale, q_offset=q_offset, dropout_rate=rate,
                dropout_seed=seed, return_lse=True, b_offset=b_offset,
                h_offset=h_offset, h_total=h_total)
        else:
            out, lse = flash_fwd(q, k, v, kv_mask, *opts)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.opts = opts
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        (causal, self_mask, sm_scale, q_offset, rate, seed, b_offset,
         h_offset, h_total) = ctx.opts
        if q.device.type == "cpu":
            dq, dk, dv = flash_attend_bwd_reference(
                q, k, v, out, dout, lse, kv_mask, causal=causal,
                self_mask=self_mask, sm_scale=sm_scale, q_offset=q_offset,
                dropout_rate=rate, dropout_seed=seed, b_offset=b_offset,
                h_offset=h_offset, h_total=h_total)
        else:
            args = (q, k, v, out, dout, lse, kv_mask, *ctx.opts)
            dk, dv = flash_bwd_dkv(*args)
            dq = flash_bwd_dq(*args)
        return (dq, dk, dv) + (None,) * 10


def flash_attend(
    q: torch.Tensor,                        # (B, H, Lq, dh)
    k: torch.Tensor,                        # (B, H, Lk, dh)
    v: torch.Tensor,                        # (B, H, Lk, dh)
    kv_mask: Optional[torch.Tensor] = None,  # (B, Lk) bool key validity
    *,
    causal: bool = False,
    self_mask: bool = False,
    sm_scale: float = 1.0,
    q_offset: int = 0,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    return_lse: bool = False,
    b_offset: int = 0,
    h_offset: int = 0,
    h_total: Optional[int] = None,
):
    """Masked softmax attention without an L x L tensor in device memory,
    differentiable in q, k and v.

    On CUDA tensors the forward launches K1 (counted in
    ``flash_attend.launches``) and the backward K3 (``flash_bwd_dkv`` and
    ``flash_bwd_dq``), or they raise; on CPU tensors both run the plain
    versions.  When no gradient can be asked for (grad mode off, or no
    input requiring one) the forward is the operator ``rtts::flash_fwd``
    (``rtts_torch/ops/registry.py``), which ``torch.export`` records.  ``dropout_rate`` > 0 needs a ``dropout_seed`` (uint32).
    ``return_lse`` also returns the per-row logsumexp as (B*H, Lq) f32.
    ``b_offset``, ``h_offset`` and ``h_total`` place a rank's batch rows
    and heads in the global batch for the dropout hash (None: H).
    """
    thr = _drop_threshold(dropout_rate)
    if thr and dropout_seed is None:
        raise ValueError("flash_attend: dropout_rate > 0 needs dropout_seed")
    seed = int(dropout_seed) & _M32 if thr else 0
    args = (q, k, v, kv_mask, bool(causal), bool(self_mask), float(sm_scale),
            int(q_offset), float(dropout_rate), seed, int(b_offset),
            int(h_offset), None if h_total is None else int(h_total))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(*args)
    else:   # serving: the registered operator (``registry``)
        out, lse = torch.ops.rtts.flash_fwd(*args)
    return (out, lse) if return_lse else out


flash_attend.launches = 0

from rtts_torch.ops import registry  # noqa: E402,F401  (defines rtts::*)
