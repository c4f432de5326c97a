"""The bf16 tensor-core K1, K4 and K5, and K5's split into two kernels, on
the CPU.

The kernels cannot run here, so their arithmetic is emulated in plain
torch, step for step where a rounding happens:

- K1 (``rtts_torch/csrc/flash_fwd.cu``): S from bf16 tiles with f32 sums,
  an online softmax over 64-key tiles, and P o R rounded to bf16 once as
  the A operand of P.V (as the TPU kernel rounds it), or as hi + lo;
- K4 (``rtts_torch/csrc/lsh_attend_fwd.cu``): S from bf16 chunks with f32
  sums, the joint softmax online over the window's offsets, and P rounded
  to bf16 once for O = P V (as the TPU kernel rounds it);
- K5 (``rtts_torch/csrc/lsh_attend_bwd.cu``): P (for O = P V and dV) and
  dS (for dQ and dK) as hi + lo bf16 operands, or rounded once;
- K5's structure: a pass per query chunk that writes dQ and each row's
  max, sum and D - dlse, then a pass per key chunk that walks the window
  offsets and writes dK and dV, with no per-offset slab.

The first three hold the card tests' bf16 tolerance against the f32 plain
versions at the shapes of ``chip_smoke.py`` phases 3, 7 and 11 that stay
small on the CPU; the fourth holds the f32 plain backward to 1e-5.  The
route functions of K4, K5 and K6 (which kernel a dtype and shape take on
the card) are held here too.
"""

import pytest
import torch

from rtts_torch.ops.chunked_ffn import ffn_route
from rtts_torch.ops.flash_attention import (_drop_rscale,
                                            flash_attend_reference,
                                            masked_scores)
from rtts_torch.ops.lsh_attention import (bwd_route, fwd_route, look_adjacent,
                                          lsh_attend_bwd_reference,
                                          lsh_attend_chunks_reference,
                                          unwindow, window_scores)
from tests.test_torch_cuda import (ENCODER_LENS, TOL, _err, lsh_case,
                                   train_case)
from tests.test_torch_flash_bf16 import SMALL_CASES, _bf16, _hi_lo
from torch_twin import one_thread  # noqa: F401  (autouse)


BF16_TOL = TOL[torch.bfloat16]
DROP_SEED = 0x9E3779B9
KEY_TILE = 64   # K1's streamed key tile (kMmaBK)


# -- K1 ------------------------------------------------------------------------

def flash_fwd_tc(q, k, v, kv_mask, p_operand, *, causal=False, self_mask=False,
                 sm_scale=1.0, q_offset=0, dropout_rate=0.0,
                 dropout_seed=None):
    """K1's bf16 arithmetic: per 64-key tile the masked f32 scores, the
    running max m and sum l (of the undropped P), O scaled by
    exp(m_old - m_new) and then O += ``p_operand``(P o R) V in f32; out =
    O / l rounded to bf16, lse = m + log(l)."""
    b, h, l_q, _ = q.shape
    l_k = k.shape[2]
    s = masked_scores(q, k, kv_mask, causal=causal, self_mask=self_mask,
                      sm_scale=sm_scale, q_offset=q_offset)
    rscale = _drop_rscale(dropout_seed, b, h, l_q, l_k, dropout_rate,
                          q_offset, q.device)
    vf = v.float()
    m = torch.full((b, h, l_q, 1), -1e30)
    l = torch.zeros(b, h, l_q, 1)
    o = torch.zeros(b, h, l_q, v.shape[-1])
    for k0 in range(0, l_k, KEY_TILE):
        st = s[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pr = p if rscale is None else p * rscale[..., k0:k0 + KEY_TILE]
        o = o * alpha + p_operand(pr) @ vf[:, :, k0:k0 + KEY_TILE]
        m = m_new
    out = (o / torch.where(l == 0, 1.0, l)).bfloat16()
    return out, (m + torch.log(torch.where(l == 0, 1.0, l))).reshape(b * h, l_q)


# chip_smoke.py phase 3: (b, h, lq, lk, kv lengths, causal, self_mask,
# sm_scale, q_offset), dh 64, q, k, v drawn independently
SERVING_CASES = {
    "encoder": (8, 8, 256, 256, ENCODER_LENS, False, True, 1.0, 0),
    "causal": (2, 8, 256, 256, None, True, True, 1.0, 0),
    "cross": (8, 8, 512, 256, ENCODER_LENS, False, False, 0.125, 0),
    "ragged": (2, 8, 200, 200, (200, 150), False, True, 1.0, 0),
    "q_offset": (2, 8, 100, 256, (256, 180), True, True, 1.0, 128),
}


def _serving_case(name):
    b, h, lq, lk, lens, causal, self_mask, scale, q_offset = \
        SERVING_CASES[name]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, h, n, 64, generator=g).bfloat16()
               for n in (lq, lk, lk))
    mask = None
    if lens is not None:
        mask = torch.arange(lk)[None, :] < torch.tensor(lens)[:, None]
    return (q, k, v, mask), dict(causal=causal, self_mask=self_mask,
                                 sm_scale=scale, q_offset=q_offset)


def _k1_errors(args, opts, p_operand, rate=0.0):
    """(out error, lse error) of the emulation against the f32 plain K1."""
    q, k, v, mask = args
    drop = dict(dropout_rate=rate, dropout_seed=DROP_SEED)
    out, lse = flash_fwd_tc(q, k, v, mask, p_operand, **opts, **drop)
    want, want_lse = flash_attend_reference(q.float(), k.float(), v.float(),
                                            mask, return_lse=True, **opts,
                                            **drop)
    return _err(out, want), _err(lse, want_lse)


K1_CASES = ([("serving", name, 0.0) for name in SERVING_CASES]
            + [("train", name, rate) for name in SMALL_CASES
               for rate in (0.0, 0.1)])


@pytest.mark.parametrize("kind,name,rate", K1_CASES)
def test_k1_p_rounded_once_stays_within_the_bf16_tolerance(kind, name, rate):
    """The rounding K1 ships: P o R to bf16 once, as on the TPU.  P >= 0,
    so P.V has no sums that cancel: at most 6.7e-3 here (hi + lo: 3.9e-3,
    the output's own bf16 rounding), and lse is the f32 one."""
    if kind == "serving":
        args, opts = _serving_case(name)
    else:
        (q, k, v, _, mask), opts = train_case(name, torch.bfloat16, "cpu")
        args = (q, k, v, mask)
    err, lse_err = _k1_errors(args, opts, _bf16, rate)
    hi_lo_err, _ = _k1_errors(args, opts, _hi_lo, rate)
    assert err < BF16_TOL and hi_lo_err < BF16_TOL, (err, hi_lo_err)
    assert lse_err < 1e-5, lse_err


# -- K4 ------------------------------------------------------------------------

def lsh_fwd_tc(q, k, v, pos, valid, causal, before, after, p_operand):
    """K4's bf16 arithmetic: S in f32 from the bf16 chunks, per window
    offset the masked scores, the joint max m and sum l of the unrounded
    exp(S - m) online, O scaled by exp(m_old - m_new) and then O +=
    ``p_operand``(exp(S - m)) V in f32; out = O / l rounded to bf16, lse =
    m + log(l)."""
    s, _, _ = window_scores(q, k, pos, valid, causal, before, after)
    c = q.shape[3]
    v_adj = look_adjacent(v, before, after).float()
    m = torch.full(s.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for off in range(before + 1 + after):
        so = s[..., off * c:(off + 1) * c]
        m_new = torch.maximum(m, so.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(so - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + p_operand(e) @ v_adj[..., off * c:(off + 1) * c, :]
        m = m_new
    return (o / l).bfloat16(), (m + torch.log(l))[..., 0]


def _k4_case(name):
    """bf16 chunk-attend inputs of a phase-11 case or a split case (nc 1
    and 2, a window on both sides)."""
    if name in SPLIT_CASES:
        (q, k, v, pos, valid, _, _), opts = _split_case(name)
        q, k, v = (t.bfloat16() for t in (q, k, v))
    else:
        (q, k, v, _), pos, valid, _, opts = lsh_case(name, torch.bfloat16,
                                                     "cpu")
    return (q, k, v, pos, valid), opts


# the phase-11 shapes small enough for the CPU, and windows that wrap onto
# their own chunk (nc 1 and 2; SPLIT_CASES below)
K4_CASES = ("test_c16_causal", "test_c32_dh128_window3",
            "nc_not_multiple_of_8", "encoder_L1024", "window3_c64_causal",
            "serving_fast_encoder_L256", "nc 1, before 1",
            "nc 2, before 1 after 1 (a chunk seen twice)")


@pytest.mark.parametrize("name", K4_CASES)
def test_k4_p_rounded_once_stays_within_the_bf16_tolerance(name):
    """The rounding K4 ships: P to bf16 once, as on the TPU.  P >= 0, so
    P V has no sums that cancel; lse is the f32 one."""
    args, opts = _k4_case(name)
    out, lse = lsh_fwd_tc(*args, *opts, _bf16)
    q, k, v, pos, valid = args
    want, want_lse = lsh_attend_chunks_reference(q.float(), k.float(),
                                                 v.float(), pos, valid, *opts)
    assert _err(out, want) < BF16_TOL, _err(out, want)
    assert _err(lse, want_lse) < 1e-5, _err(lse, want_lse)


# -- K5 ------------------------------------------------------------------------

def lsh_bwd_tc(q, k, v, pos, valid, dout, dlse, causal, before, after,
               p_operand, ds_operand):
    """K5's bf16 arithmetic.  The dQ kernel: S in f32, the joint max and
    sum online over the window's offsets, O += ``p_operand``(exp(S - m))
    V, D = rowsum(dO o O) / l; dP = dO V^T in f32, dS = P (dP - (D -
    dlse)), 0 on the self entries, dQ = ``ds_operand``(dS) K.  The dK/dV
    kernel: dV = ``p_operand``(P)^T dO and dK = ``ds_operand``(dS)^T Q per
    offset, summed in f32.  Every gradient rounded to bf16 once."""
    s, self_m, _ = window_scores(q, k, pos, valid, causal, before, after)
    c = q.shape[3]
    v_adj = look_adjacent(v, before, after).float()
    m = torch.full(s.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for off in range(before + 1 + after):
        so = s[..., off * c:(off + 1) * c]
        m_new = torch.maximum(m, so.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(so - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + p_operand(e) @ v_adj[..., off * c:(off + 1) * c, :]
        m = m_new
    dof = dout.float()
    dd = (dof * o).sum(-1, keepdim=True) / l - dlse.float()[..., None]
    p = torch.exp(s - m) / l
    dp = dof @ v_adj.transpose(-1, -2)
    ds = (p * (dp - dd)).masked_fill(self_m, 0.0)
    dq = ds_operand(ds) @ look_adjacent(k, before, after).float()
    dk = unwindow(ds_operand(ds).transpose(-1, -2) @ q.float(), before, after)
    dv = unwindow(p_operand(p).transpose(-1, -2) @ dof, before, after)
    return tuple(t.bfloat16() for t in (dq, dk, dv))


# the phase-11 shapes (tests/test_torch_cuda.py::LSH_CASES) small enough for
# the CPU, the window with an after chunk among them
K5_CASES = ("test_c16_causal", "test_c32_dh128_window3",
            "nc_not_multiple_of_8", "encoder_L1024", "window3_c64_causal",
            "serving_fast_encoder_L256")


def _k5_errors(name, p_operand, ds_operand):
    (q, k, v, dout), pos, valid, dlse, opts = lsh_case(name, torch.bfloat16,
                                                       "cpu")
    got = lsh_bwd_tc(q, k, v, pos, valid, dout, dlse, *opts, p_operand,
                     ds_operand)
    wants = lsh_attend_bwd_reference(q.float(), k.float(), v.float(), pos,
                                     valid, dout.float(), dlse, *opts)
    assert all(bool(t.abs().max() > 0) for t in got)
    return {what: _err(g, w) for g, w, what in zip(got, wants, "qkv")}


@pytest.mark.parametrize("name", K5_CASES)
def test_k5_hi_lo_operands_stay_within_the_bf16_tolerance(name):
    errs = _k5_errors(name, _hi_lo, _hi_lo)
    assert all(e < BF16_TOL for e in errs.values()), errs


def test_k5_one_bf16_rounding_of_ds_would_not():
    """The design hi + lo replaces: dS rounded once to bf16 puts dK, a sum
    over every query of every window that cancels, past the tolerance at
    the longform encoder's shape (2.1e-2 there; 2.1e-2 to 4.6e-2 at every
    K5_CASES shape, where hi + lo stays at or under 3.9e-3)."""
    errs = _k5_errors("encoder_L1024", _hi_lo, _bf16)
    assert errs["k"] > BF16_TOL, errs


# -- K5's split: stats and dQ per query chunk, then dK/dV per key chunk --------

def lsh_bwd_split(q, k, v, pos, valid, dout, dlse, causal, before, after):
    """K5's two kernels in f32.  (a) per query chunk: the joint max m and
    sum l over the window, D - dlse with D = rowsum(dP o P), and dQ.
    (b) per key chunk j: for each window offset o, in order, the query
    chunk (j - o + before) mod nc, its S^T and dP^T with keys as rows, P =
    exp(s - m) / l from (a)'s stats, dS, and dK, dV summed over the
    offsets.  -> (dq, dk, dv, stats)."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s, self_m, _ = window_scores(q, k, pos, valid, causal, before, after)
    m = s.amax(-1, keepdim=True)
    l = torch.exp(s - m).sum(-1, keepdim=True)
    p = torch.exp(s - m) / l
    dp = dof @ look_adjacent(v, before, after).float().transpose(-1, -2)
    dd = (dp * p).sum(-1, keepdim=True) - dlse.float()[..., None]
    ds = (p * (dp - dd)).masked_fill(self_m, 0.0)
    dq = ds @ look_adjacent(k, before, after).float()

    nc = q.shape[2]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for off in range(before + 1 + after):
        src = (torch.arange(nc) - off + before) % nc   # the query chunk of j
        qo, doo = qf[:, :, src], dof[:, :, src]
        qpos, kpos = pos[:, :, src], pos
        st = kf @ qo.transpose(-1, -2)                 # (.., key, query)
        st = st.masked_fill(~valid.bool()[..., :, None], -1e9)
        if causal:
            st = st.masked_fill(qpos[..., None, :] < kpos[..., :, None], -1e9)
        self_t = qpos[..., None, :] == kpos[..., :, None]
        st = st.masked_fill(self_t, -1e5)
        mt, lt, ddt = (x[:, :, src].transpose(-1, -2) for x in (m, l, dd))
        pt = torch.exp(st - mt) / lt
        dpt = vf @ doo.transpose(-1, -2)
        dst = (pt * (dpt - ddt)).masked_fill(self_t, 0.0)
        dv = dv + pt @ doo
        dk = dk + dst @ qo
    return dq, dk, dv, (m, l, dd)


SPLIT_CASES = {
    # name: (b, h, n_hashes, L, c, dh, causal, before, after, valid length)
    "nc 9 (not a multiple of 8), after 1": (1, 2, 3, 96, 32, 64, True, 1, 1,
                                           80),
    "nc 2, before 1 after 1 (a chunk seen twice)": (2, 1, 1, 32, 16, 16,
                                                   False, 1, 1, 30),
    "nc 1, before 1": (1, 2, 1, 16, 16, 16, True, 1, 0, 12),
    "before 2, after 1": (2, 2, 2, 64, 16, 32, True, 2, 1, 50),
    "before 0": (2, 2, 2, 64, 16, 32, False, 0, 0, 64),
}


def _split_case(name, seed=0):
    b, h, nh, l, c, dh, causal, before, after, n_valid = SPLIT_CASES[name]
    g = torch.Generator().manual_seed(seed)
    nc = nh * l // c
    q, v, dout = (torch.randn(b, h, nc, c, dh, generator=g) for _ in range(3))
    k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) * dh ** -0.5
    pos = torch.stack([torch.randperm(l, generator=g)
                       for _ in range(b * h * nh)]).reshape(b, h, nc, c)
    dlse = torch.randn(b, h, nc, c, generator=g)
    return (q, k, v, pos, pos < n_valid, dout, dlse), (causal, before, after)


@pytest.mark.parametrize("name", sorted(SPLIT_CASES) + ["test_c16_causal",
                                                        "window3_c64_causal"])
def test_k5_split_matches_the_plain_backward(name):
    """No slab: every dK/dV row is summed in one place, over the offsets in
    order, from the query chunks' stats; f32 within 1e-5 of the plain
    backward, which tests/test_torch_lsh.py holds to the JAX kernel."""
    if name in SPLIT_CASES:
        args, opts = _split_case(name)
    else:
        (q, k, v, dout), pos, valid, dlse, opts = lsh_case(name, torch.float32,
                                                           "cpu")
        args = (q, k, v, pos, valid, dout, dlse)
    got = lsh_bwd_split(*args, *opts)[:3]
    wants = lsh_attend_bwd_reference(*args, *opts)
    for g, w, what in zip(got, wants, "qkv"):
        assert bool(w.abs().max() > 0)
        assert _err(g, w) < 1e-5, (what, _err(g, w))


def test_k5_split_stats_are_the_softmax_of_each_row():
    """(a)'s stats: m is the row max, m + log(l) the plain attend's lse."""
    from rtts_torch.ops.lsh_attention import lsh_attend_chunks_reference
    args, opts = _split_case("nc 9 (not a multiple of 8), after 1")
    m, l, _ = lsh_bwd_split(*args, *opts)[3]
    _, lse = lsh_attend_chunks_reference(*args[:5], *opts)
    assert _err((m + torch.log(l))[..., 0], lse) < 1e-6


TENSOR_CORES, FMA = 1, 0   # the C entry point's ``mma`` argument


@pytest.mark.parametrize("dtype,c,route", [
    (torch.bfloat16, 16, TENSOR_CORES), (torch.bfloat16, 32, TENSOR_CORES),
    (torch.bfloat16, 64, TENSOR_CORES), (torch.float32, 16, FMA),
    (torch.float32, 32, FMA), (torch.float32, 64, FMA)])
def test_k5_route_of_each_dtype_and_chunk_length(dtype, c, route):
    assert bwd_route(dtype, c) == route


def test_k5_route_refuses_other_chunk_lengths():
    with pytest.raises(ValueError, match="chunk length"):
        bwd_route(torch.bfloat16, 24)


@pytest.mark.parametrize("dtype,c,dh,route", [
    (torch.bfloat16, 16, 64, TENSOR_CORES), (torch.bfloat16, 32, 64,
                                             TENSOR_CORES),
    (torch.bfloat16, 64, 64, TENSOR_CORES), (torch.bfloat16, 64, 128,
                                             TENSOR_CORES),
    (torch.float32, 16, 64, FMA), (torch.float32, 64, 128, FMA)])
def test_k4_route_of_each_dtype_chunk_length_and_head_dim(dtype, c, dh,
                                                          route):
    assert fwd_route(dtype, c, dh) == route


@pytest.mark.parametrize("dtype,c,dh,error,match", [
    (torch.bfloat16, 24, 64, ValueError, "chunk length"),
    (torch.bfloat16, 64, 32, ValueError, "head dim"),
    (torch.float16, 64, 64, TypeError, "dtype")])
def test_k4_route_refuses_what_no_kernel_takes(dtype, c, dh, error, match):
    with pytest.raises(error, match=match):
        fwd_route(dtype, c, dh)


H100_SMS = 132


@pytest.mark.parametrize("n,d,rows", [
    (8 * 1024, 512, 64),    # the decoder FFN: 128 blocks
    (8 * 1000 + 13, 512, 64),
    (8 * 256, 512, 16),     # the encoder FFN: 32 blocks at 64 rows, 128 at 16
    (1037, 96, 16),         # 65 blocks at 16 rows
    (3000, 1024, 32),       # too wide for 64 rows
    (64, 1024, 16)])
def test_k6_route_takes_tensor_cores_and_fills_the_card(n, d, rows):
    """bf16 multiplies: the largest row tile the width allows, halved while
    the halved tile's grid still fits on the SMs in one wave."""
    assert ffn_route(torch.bfloat16, n, d, H100_SMS) == rows
    assert ffn_route(torch.float32, n, d, H100_SMS) == FMA


@pytest.mark.parametrize("mxu,d,error,match", [
    (torch.bfloat16, 1040, ValueError, "width"),
    (torch.float32, 0, ValueError, "width"),
    (torch.float16, 512, TypeError, "mxu_dtype")])
def test_k6_route_refuses_what_no_kernel_takes(mxu, d, error, match):
    with pytest.raises(error, match=match):
        ffn_route(mxu, 8, d, H100_SMS)
