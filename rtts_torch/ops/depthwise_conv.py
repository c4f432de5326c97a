"""Depthwise 1-D convolution: kernel K2 and its plain version.

Port of ``rtts/ops/depthwise_conv.py``, the SqueezeWave WN depth stage.
``depthwise_conv1d`` launches the CUDA kernel
``rtts_torch/csrc/depthwise_conv.cu`` for tensors on the card and runs
``depthwise_conv1d_reference`` for tensors on the CPU.  Both take x (B, L, C),
w (K, 1, C) in the grouped conv layout and b (C,); SAME zero padding reaches
(K-1)//2 left and K//2 right; accumulation is f32 and the output has x's
dtype.  Forward only (the vocoder's training brings the backward).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rtts_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def depthwise_conv1d_reference(x: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: grouped ``F.conv1d`` in f32, cast to x's dtype."""
    k, c = w.shape[0], x.shape[-1]
    xt = F.pad(x.float().transpose(1, 2), ((k - 1) // 2, k // 2))
    y = F.conv1d(xt, w.float().reshape(k, c).t().unsqueeze(1), groups=c)
    return (y.transpose(1, 2) + b.float()).to(x.dtype)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """x (B, L, C), w (K, 1, C), b (C,) -> (B, L, C), SAME padding, stride 1.

    On a CUDA tensor this launches K2 (and counts the launch in
    ``depthwise_conv1d.launches``) or raises; on a CPU tensor it runs
    ``depthwise_conv1d_reference``."""
    if x.device.type == "cpu":
        return depthwise_conv1d_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"depthwise_conv1d: dtype {x.dtype} not in "
                        "float32/bfloat16")
    bsz, l, c = x.shape
    k = w.shape[0]
    if w.shape != (k, 1, c) or b.shape != (c,):
        raise ValueError(f"depthwise_conv1d: w {tuple(w.shape)} / b "
                         f"{tuple(b.shape)} do not match C={c} (want "
                         f"(K, 1, {c}) and ({c},))")
    for name, t in (("w", w), ("b", b)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"depthwise_conv1d: {name} is {t.dtype} on "
                             f"{t.device}, want {x.dtype} on {x.device}")
    x, w, b = x.contiguous(), w.reshape(k, c).contiguous(), b.contiguous()
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    if c % vec or any(t.data_ptr() % 16 for t in (x, w, b, out)):
        vec = 1
    err = _build.library().rtts_depthwise_conv1d(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        _DTYPES[x.dtype], bsz, l, c, k, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rtts_depthwise_conv1d")
    depthwise_conv1d.launches += 1
    return out


depthwise_conv1d.launches = 0
