"""Flash (online-softmax) attention: kernel K1 and its plain version.

Port of ``rtts/ops/flash_attention.py``.  ``flash_attend`` launches the CUDA
kernel ``rtts_torch/csrc/flash_fwd.cu`` for tensors on the card and runs
``flash_attend_reference`` for tensors on the CPU.  Both compute the same
masked softmax attention, with the reference's replace-style masks applied to
f32 scores before the softmax:

- pad keys (``kv_mask`` False):     score := MASK_VALUE      (-1e9)
- causal, q_offset + row < col:     score := MASK_VALUE      (-1e9)
- self_mask, q_offset + row == col: score := SELF_MASK_VALUE (-1e5)

so a query whose keys are all masked still attends itself.  Forward only:
the backward (K3) and in-kernel attention dropout come with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from rtts_torch.ops import _build

# the kernel's constants kMaskValue and kSelfMaskValue hold the same values
MASK_VALUE = -1e9
SELF_MASK_VALUE = -1e5

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


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


def flash_attend_reference(q, k, v, kv_mask=None, *, causal=False,
                           self_mask=False, sm_scale=1.0, q_offset=0,
                           return_lse=False):
    """Plain PyTorch version of K1: explicit (B, H, Lq, Lk) f32 scores, then
    softmax and P.V in f32; the output is cast to q's dtype."""
    b, h, l_q, dh = q.shape
    l_k = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], MASK_VALUE)
    rows = torch.arange(l_q, device=q.device)[:, None] + q_offset
    cols = torch.arange(l_k, device=q.device)[None, :]
    if causal:
        s = s.masked_fill(rows < cols, MASK_VALUE)
    if self_mask:
        s = s.masked_fill(rows == cols, SELF_MASK_VALUE)
    # softmax subtracts the row max: exp(s - lse) would lose the fully
    # masked rows, whose lse = -1e9 + log(Lk) rounds back to -1e9 in f32
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                       v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(b * h, l_q)
    return out


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
    return_lse: bool = False,
):
    """Masked softmax attention without an L x L tensor in device memory.

    On a CUDA tensor this launches K1 (and counts the launch in
    ``flash_attend.launches``) or raises; on a CPU tensor it runs
    ``flash_attend_reference``.  ``return_lse`` also returns the per-row
    logsumexp as (B*H, Lq) f32, the statistic the backward will need.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attend: attention dropout arrives with the backward kernel")
    if q.device.type == "cpu":
        return flash_attend_reference(
            q, k, v, kv_mask, causal=causal, self_mask=self_mask,
            sm_scale=sm_scale, q_offset=q_offset, return_lse=return_lse)
    b, h, l_q, dh = q.shape
    l_k = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attend: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attend: dtype {q.dtype} not in float32/bfloat16")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash_attend: head dim {dh} not in {_HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != (b, h, l_k, dh) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attend: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, want "
                             f"{(b, h, l_k, dh)} {q.dtype} on {q.device}")
    q3, k3, v3 = (t.contiguous() for t in (q, k, v))
    if kv_mask is not None:
        if kv_mask.shape != (b, l_k) or kv_mask.device != q.device:
            raise ValueError(f"flash_attend: kv_mask is {tuple(kv_mask.shape)} "
                             f"on {kv_mask.device}, want {(b, l_k)} on "
                             f"{q.device}")
        kv_mask = kv_mask.to(torch.bool).contiguous()
    out = torch.empty_like(q3)
    lse = (torch.empty((b * h, l_q), device=q.device, dtype=torch.float32)
           if return_lse else None)
    lib = _build.library()
    err = lib.rtts_flash_fwd(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None,
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        _DTYPES[q.dtype], b * h, h, l_q, l_k, dh, float(sm_scale),
        int(bool(causal)), int(bool(self_mask)), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "rtts_flash_fwd")
    flash_attend.launches += 1
    return (out, lse) if return_lse else out


flash_attend.launches = 0
