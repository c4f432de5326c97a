"""Fused LayerNorm + feed-forward: kernel K6 and its plain version.

Port of ``rtts/ops/chunked_ffn.py``.  Per row of x (B·L, d): LayerNorm
(eps 1e-5) in f32, then ``act(h W_in + b_in) W_out + b_out`` with both
products multiplied in ``mxu_dtype`` (bf16 or f32) and summed in f32, the
bias and the activation in f32, the output in x's dtype.

``ffn_fused`` launches ``rtts_torch/csrc/ffn_fused.cu`` on CUDA tensors (or
raises): bf16 multiplies on tensor cores, after one cast of the weights to
bf16 into scratch per call, f32 multiplies on FMAs (``ffn_route``);
``ffn_fused_reference`` is the same arithmetic in plain PyTorch.
``chunked_ffn_fused`` is the differentiable sublayer (the reference's
``chunked_ffn_pallas``): on the card its forward is the kernel, on the CPU
the plain version; its backward is what the reference's is, autograd of
the FFN body in f32 with no compute dtype (``_ffn_bwd``), cast to x's
dtype.  There is no backward kernel, as the JAX package has none.

The TPU's VMEM guard and its row-tiling fallback to the jnp path are not
carried over: the kernel tiles rows itself and takes any row count, any
d_ff and widths up to 1024.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rtts_torch.nn.layers import activation
from rtts_torch.ops import _build
from rtts_torch.reversible.ffn import _ffn_body

EPS = 1e-5
MAX_WIDTH = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the activations of rtts_torch.nn.layers, as the kernel numbers them
_ACT_CODES = {"relu": 0, "gelu": 1, "tanh": 2, "silu": 3}
# the tensor-core kernel's row tiles, and the padded widths each takes
# (its output accumulators: a warp holds at most 16 n-tiles of 8 columns
# of its rows, over 8 warps); the kernel refuses a launch past them
_ROW_TILES = {64: 512, 32: 1024, 16: 1024}
# d and d_ff of the bf16 weight scratch round up to this, a whole number of
# the kernel's W_in slabs (64 rows) and d_ff tiles (128 columns); the
# wrapper passes the padded shape to the kernel with the scratch
_PAD = 128
_SM_COUNTS = {}


def _pad(x: int) -> int:
    return -(-x // _PAD) * _PAD


def ffn_route(mxu_dtype, n: int, d: int, sms: int) -> int:
    """Which K6 kernel an (n, d) input takes on a card of ``sms`` SMs, as
    the C entry point's route argument: 0, the FMA kernel (f32 multiplies,
    for the f32 tolerance), or the rows a block of the tensor-core kernel
    (bf16 multiplies): the largest tile the width allows, halved while the
    halved tile's grid still fits on the SMs in one wave (a block takes an
    SM), so a short input is cut finer rather than left on a few SMs.
    Raises on what neither takes."""
    if mxu_dtype not in _DTYPES:
        raise TypeError(f"ffn_fused: mxu_dtype {mxu_dtype} not in "
                        "float32/bfloat16")
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"ffn_fused: width {d} not in [1, {MAX_WIDTH}]")
    if mxu_dtype == torch.float32:
        return 0
    rows = max(r for r, width in _ROW_TILES.items() if _pad(d) <= width)
    while rows > min(_ROW_TILES) and -(-n // (rows // 2)) <= sms:
        rows //= 2
    return rows


def _sm_count(device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNTS[index]


def ffn_fused_reference(x2d, ln_scale, ln_bias, w_in, b_in, w_out, b_out,
                        act: str, mxu_dtype) -> torch.Tensor:
    """Plain version of K6, rounding where ``_ffn_kernel`` does: the
    normalised rows, the weights and the activations are cast to
    ``mxu_dtype``; products, biases and the activation are f32."""
    x = x2d.float()
    h = F.layer_norm(x, (x.shape[-1],), ln_scale.float(), ln_bias.float(), EPS)
    h = h.to(mxu_dtype).float()
    mid = h @ w_in.to(mxu_dtype).float() + b_in.float()
    mid = activation(act)(mid).to(mxu_dtype).float()
    out = mid @ w_out.to(mxu_dtype).float() + b_out.float()
    return out.to(x2d.dtype)


def ffn_fused(x2d, ln_scale, ln_bias, w_in, b_in, w_out, b_out, act: str,
              mxu_dtype) -> torch.Tensor:
    """Launch K6 on x2d (n, d) -> (n, d) in x2d's dtype; counts in
    ``ffn_fused.launches``."""
    if x2d.device.type != "cuda":
        raise ValueError(f"ffn_fused: unsupported device {x2d.device}")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"ffn_fused: dtype {x2d.dtype} not in float32/bfloat16")
    if act not in _ACT_CODES:
        raise ValueError(f"ffn_fused: unknown activation {act!r}; options: "
                         f"{sorted(_ACT_CODES)}")
    n, d = x2d.shape
    f = w_in.shape[1]
    route = ffn_route(mxu_dtype, n, d, _sm_count(x2d.device))
    want = {"ln_scale": (d,), "ln_bias": (d,), "w_in": (d, f), "b_in": (f,),
            "w_out": (f, d), "b_out": (d,)}
    params = dict(zip(want, (ln_scale, ln_bias, w_in, b_in, w_out, b_out)))
    for name, t in params.items():
        if tuple(t.shape) != want[name] or t.device != x2d.device:
            raise ValueError(f"ffn_fused: {name} is {tuple(t.shape)} on "
                             f"{t.device}, want {want[name]} on {x2d.device}")
    x2d = x2d.contiguous()
    params = [t.float().contiguous() for t in params.values()]
    out = torch.empty_like(x2d)
    # the bf16 W_in (dp, fp) and W_out (fp, dp), padded, cast by the launch
    dp, fp = (_pad(d), _pad(f)) if route else (0, 0)
    scratch = (torch.empty(2 * dp * fp, device=x2d.device,
                           dtype=torch.bfloat16) if route else None)
    err = _build.library().rtts_ffn_fused(
        x2d.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        _DTYPES[x2d.dtype], n, d, f, dp, fp, _ACT_CODES[act], route, EPS,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(err, "rtts_ffn_fused")
    ffn_fused.launches += 1
    return out


ffn_fused.launches = 0


def _params(p):
    return (p.ln.scale, p.ln.bias, p.w_in.w, p.w_in.b, p.w_out.w, p.w_out.b)


class _FusedFFN(torch.autograd.Function):
    """K6 forward (its plain version on the CPU), backward by autograd of
    the FFN body with no compute dtype on the saved input (the JAX
    ``_ffn_with_vjp``).  The parameters are inputs, so autograd routes
    their gradients; the backward takes them from the module ``p``."""

    @staticmethod
    def forward(ctx, p, act, mxu_dtype, x, *params):
        fn = ffn_fused_reference if x.device.type == "cpu" else ffn_fused
        out = fn(x.reshape(-1, x.shape[-1]), *params, act, mxu_dtype)
        ctx.save_for_backward(x)
        ctx.p, ctx.act = p, act
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        x = ctx.saved_tensors[0].detach().requires_grad_()
        inputs = (x, *_params(ctx.p))
        need = [t for t, n in zip(inputs, ctx.needs_input_grad[3:]) if n]
        with torch.enable_grad():
            # the f32 stream: the body's dtype is x's, as the reference pins
            out = _ffn_body(ctx.p, x.float(), ctx.act).to(x.dtype)
        got = iter(torch.autograd.grad(out, need, dout.to(out.dtype)))
        return (None, None, None,
                *(next(got) if n else None for n in ctx.needs_input_grad[3:]))


def chunked_ffn_fused(p, x: torch.Tensor, act: str, mxu_dtype) -> torch.Tensor:
    """The FFN sublayer ``p`` (an ``FFN``: {ln, w_in, w_out}) through K6:
    x (B, L, d) -> (B, L, d) in x's dtype, differentiable in x and the
    parameters."""
    return _FusedFFN.apply(p, act, mxu_dtype, x, *_params(p))
