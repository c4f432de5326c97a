"""The bf16 tensor-core K3 (flash-attention backward), on the CPU.

The kernel computes S and dP from bf16 tiles with f32 sums, as the plain
backward does in f32, and feeds two intermediates to the next products as
bf16 operands: P o R (for dV = (P o R)^T dO) and dS * sm_scale (for
dK = dS^T Q and dQ = dS K).  Each is split into hi = bf16(x) and
lo = bf16(x - hi), multiplied into the same f32 sum.  An emulation of the
plain backward with that split has to stay within the card tests' bf16
tolerance of the f32 plain backward, so that tolerance holds the new
kernel; one bf16 rounding in their place would not.  And the query-split
rule of the dK/dV kernel.
"""

import pytest
import torch

from rtts_torch.ops.flash_attention import (_drop_rscale, dkv_query_splits,
                                            flash_attend_bwd_reference,
                                            flash_attend_reference,
                                            masked_scores)
from tests.test_torch_cuda import TOL, TRAIN_CASES, _err, train_case
from torch_twin import one_thread  # noqa: F401  (autouse)


# the TRAIN_CASES shapes that stay small on the CPU
SMALL_CASES = ("encoder", "cross", "q_offset", "dh128_ragged")
DROP_SEED = 0x9E3779B9


def _bf16(t):
    return t.bfloat16().float()


def _hi_lo(t):
    """t as the kernel multiplies it: bf16(t) + bf16(t - bf16(t))."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def bwd_bf16_operands(q, k, v, out, dout, lse, kv_mask, p_operand,
                      ds_operand, *, causal=False, self_mask=False,
                      sm_scale=1.0, q_offset=0, dropout_rate=0.0,
                      dropout_seed=None):
    """``flash_attend_bwd_reference`` with P o R passed through
    ``p_operand`` and dS * sm_scale through ``ds_operand`` before the
    products that read them, and the gradients rounded to bf16: the
    arithmetic of the tensor-core kernels when both are ``_hi_lo``."""
    b, h, l_q, _ = q.shape
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    s = masked_scores(q, k, kv_mask, causal=causal, self_mask=self_mask,
                      sm_scale=sm_scale, q_offset=q_offset)
    p = torch.exp(s - lse.reshape(b, h, l_q, 1))
    rscale = _drop_rscale(dropout_seed, b, h, l_q, k.shape[2], dropout_rate,
                          q_offset, q.device)
    pr = p if rscale is None else p * rscale
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    if rscale is not None:
        dp = dp * rscale
    ds = p * (dp - (of * dof).sum(-1, keepdim=True))
    if self_mask:
        rows = torch.arange(l_q)[:, None] + q_offset
        ds = ds.masked_fill(rows == torch.arange(k.shape[2]), 0.0)
    pr, ds = p_operand(pr), ds_operand(ds * sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", pr, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return tuple(t.bfloat16() for t in (dq, dk, dv))


def _errors(name, rate, p_operand, ds_operand):
    """{gradient: error} of the emulation against the f32 plain backward,
    on K1's bf16 output and f32 lse."""
    (q, k, v, dout, mask), opts = train_case(name, torch.bfloat16, "cpu")
    drop = dict(dropout_rate=rate, dropout_seed=DROP_SEED)
    f = [t.float() for t in (q, k, v)]
    out, lse = flash_attend_reference(*f, mask, return_lse=True, **opts,
                                      **drop)
    out = out.bfloat16()
    got = bwd_bf16_operands(q, k, v, out, dout, lse, mask, p_operand,
                            ds_operand, **opts, **drop)
    wants = flash_attend_bwd_reference(*f, out.float(), dout.float(), lse,
                                       mask, **opts, **drop)
    assert all(bool(t.abs().max() > 0) for t in got)
    return {what: _err(g, w) for g, w, what in zip(got, wants,
                                                   ("dq", "dk", "dv"))}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", SMALL_CASES)
def test_bf16_hi_lo_operands_stay_within_the_bf16_tolerance(name, rate):
    errs = _errors(name, rate, _hi_lo, _hi_lo)
    assert all(e < TOL[torch.bfloat16] for e in errs.values()), errs


@pytest.mark.parametrize("rounded,rate,grad", [("ds", 0.0, "dq"),
                                               ("p", 0.1, "dv")])
def test_one_bf16_rounding_of_an_operand_would_not(rounded, rate, grad):
    """The design the split replaces: dS rounded once to bf16 puts dQ,
    a sum that cancels, off by about 4e-2; P o R rounded once puts dV off
    by more than 1e-2 where dropout scales P (the q_offset case)."""
    ops = (_bf16, _hi_lo) if rounded == "p" else (_hi_lo, _bf16)
    errs = _errors("q_offset", rate, *ops)
    assert errs[grad] > TOL[torch.bfloat16], errs


@pytest.mark.parametrize("name,sms,want", [
    ("cross_longform", 132, 4),     # 16 key tiles x 16 heads: 256 blocks
    ("cross", 132, 2),              # 4 x 64 blocks, 16 query tiles
    ("decoder", 132, 1),            # 16 x 64 = 1024 blocks fill the card
    ("encoder", 132, 1),            # 4 query tiles: too few to split
    ("q_offset", 132, 1),
    ("dh128_ragged", 132, 1),
    ("cross_longform", 16, 1),      # a small card: 256 blocks are enough
])
def test_dkv_query_splits(name, sms, want):
    b, h, lq, lk, dh = TRAIN_CASES[name][:5]
    assert dkv_query_splits(b * h, lq, lk, dh, sms) == want


@pytest.mark.parametrize("bh,lq,lk,dh,sms", [
    (16, 8192, 1024, 64, 132), (16, 8192, 1024, 128, 132),
    (4, 1000, 64, 64, 132), (1, 64 * 9, 64, 64, 132), (2, 0, 64, 64, 132)])
def test_dkv_query_splits_leave_no_split_empty(bh, lq, lk, dh, sms):
    br = 64 if dh == 64 else 32
    n_qt = -(-lq // br)
    n = dkv_query_splits(bh, lq, lk, dh, sms)
    per = -(-n_qt // n) if n_qt else 0
    assert n >= 1 and (n_qt == 0 or (n - 1) * per < n_qt)
    assert n == 1 or per >= 8
