"""Depthwise 1-D convolution: kernel K2 and its plain version.

Port of ``rtts/ops/depthwise_conv.py``, the SqueezeWave WN depth stage.
``depthwise_conv1d`` is differentiable: its forward launches the CUDA kernel
``rtts_torch/csrc/depthwise_conv.cu`` for tensors on the card and runs
``depthwise_conv1d_reference`` for tensors on the CPU; its backward is
autograd of the plain grouped conv in f32, each gradient cast to its input's
dtype (the reference's ``_dw_bwd``: ``jax.vjp`` of the XLA conv).  All take
x (B, L, C), w (K, 1, C) in the grouped conv layout and b (C,); SAME zero
padding reaches (K-1)//2 left and K//2 right; w and b are rounded to x's
dtype, the sum is f32 and the output has x's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from rtts_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (x, w, b dtypes) -> (x code, w/b code) of the combinations K2 takes
_CODES = {(x, w, w): (xc, wc) for x, xc in _DTYPES.items()
          for w, wc in _DTYPES.items()}
MAX_TAPS = 8          # kMaxTaps of the kernel
_SMEM_BYTES = 40960   # kSmemBytes: the staged rows of one block


def _conv_f32(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The plain function in f32: w and b rounded to x's dtype, grouped
    ``F.conv1d`` with SAME padding -> (B, L, C) f32."""
    k, c = w.shape[0], x.shape[-1]
    wf, bf = w.to(x.dtype).float(), b.to(x.dtype).float()
    xt = F.pad(x.float().transpose(1, 2), ((k - 1) // 2, k // 2))
    y = F.conv1d(xt, wf.reshape(k, c).t().unsqueeze(1), groups=c)
    return y.transpose(1, 2) + bf


def depthwise_conv1d_reference(x: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: grouped ``F.conv1d`` in f32, cast to x's dtype."""
    return _conv_f32(x, w, b).to(x.dtype)


@functools.lru_cache(maxsize=32)
def _plan(dtypes, x_shape, w_shape, b_shape):
    """Check a combination of (x, w, b) dtypes and shapes against what K2
    takes and return its launch description: a C int array (x dtype, w/b
    dtype, batch, len, channels, taps, vector width) and its address.
    Cached: the vocoder repeats a few combinations per utterance length."""
    codes = _CODES.get(dtypes)
    if codes is None:
        raise TypeError("depthwise_conv1d: x {}, w {}, b {}: want x "
                        "float32/bfloat16 and w, b of one of those "
                        "dtypes".format(*dtypes))
    bsz, l, c = x_shape
    k = w_shape[0]
    if w_shape != (k, 1, c) or b_shape != (c,):
        raise ValueError(f"depthwise_conv1d: w {tuple(w_shape)} / b "
                         f"{tuple(b_shape)} do not match C={c} (want "
                         f"(K, 1, {c}) and ({c},))")
    es = dtypes[0].itemsize
    if not 1 <= k <= MAX_TAPS or k * c * es > _SMEM_BYTES:
        raise ValueError(f"depthwise_conv1d: {k} taps over {c} channels: the "
                         f"kernel takes 1..{MAX_TAPS} taps and rows up to "
                         f"{_SMEM_BYTES // k} bytes")
    if max(bsz, l) >= 2**31 or bsz * l * c >= 2**62:
        raise ValueError(f"depthwise_conv1d: x {tuple(x_shape)} is too large")
    vec = 16 // es
    dims = (ctypes.c_int * 7)(*codes, bsz, l, c, k, 1 if c % vec else vec)
    return dims, ctypes.addressof(dims)


def depthwise_conv1d_kernel(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Launch K2 on CUDA tensors (counted in ``depthwise_conv1d.launches``)
    or raise on what it does not take.  w and b share one dtype, x's or
    float32.  The vocoder makes 96 of these calls per utterance, so the
    shape checks run once per combination of dtypes and shapes, and the
    per-call work is the device check, the output's allocation and one
    ctypes call with six pointers."""
    if not x.is_cuda:
        raise ValueError(f"depthwise_conv1d: unsupported device {x.device}")
    plan = _plan((x.dtype, w.dtype, b.dtype), x.shape, w.shape, b.shape)
    card = x.get_device()
    if w.get_device() != card or b.get_device() != card:
        raise ValueError(f"depthwise_conv1d: w on {w.device}, b on "
                         f"{b.device}, x on {x.device}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty_like(x)
    err = _build.function("rtts_depthwise_conv1d")(
        plan[1], x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        _build.stream(card))
    if err:
        _build.check(err, "rtts_depthwise_conv1d")
    depthwise_conv1d.launches += 1
    return out


def _forward(x, w, b):
    """K2 on a CUDA tensor (or raise on another device), its plain version
    on a CPU tensor."""
    if x.is_cuda or x.device.type != "cpu":
        return depthwise_conv1d_kernel(x, w, b)
    return depthwise_conv1d_reference(x, w, b)


class _DepthwiseConv(torch.autograd.Function):
    """K2 (or its plain version on the CPU) forward; the plain f32 conv's
    autograd backward (the reference's custom_vjp)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _forward(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        # the gradient of the rounded w and b passes to w and b unchanged,
        # as through the casts the kernel makes in registers
        with torch.enable_grad():
            xf, wf, bf = (t.detach().to(x.dtype).float().requires_grad_()
                          for t in (x, w, b))
            grads = torch.autograd.grad(_conv_f32(xf, wf, bf), (xf, wf, bf),
                                        dy.float())
        return tuple(g.to(t.dtype) for g, t in zip(grads, (x, w, b)))


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """x (B, L, C), w (K, 1, C), b (C,) -> (B, L, C), SAME padding, stride 1,
    differentiable in x, w and b.

    On a CUDA tensor the forward launches K2 (and counts the launch in
    ``depthwise_conv1d.launches``) or raises; on a CPU tensor it runs
    ``depthwise_conv1d_reference``.  w and b may be float32 with a bfloat16
    x: they are rounded to x's dtype inside.  When no gradient can be asked
    for (grad mode off, as in serving, or no input requiring one) the
    forward runs without the ``autograd.Function``, whose bookkeeping
    would record nothing and costs more host time than the launch."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _DepthwiseConv.apply(x, w, b)
    return _forward(x, w, b)


depthwise_conv1d.launches = 0
