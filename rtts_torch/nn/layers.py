"""Core layers as nn.Modules whose parameter names are the JAX leaf names.

Port of ``rtts/nn/layers.py``.  Leaf layouts are the JAX package's (dense
``w`` is (d_in, d_out)), so a parameter tree converts by renaming alone
(``rtts_torch/convert.py``).  Initial values are drawn on the CPU from an
explicit ``torch.Generator`` and then moved to ``device``, so one seed gives
the same weights on every device.

Dtype policy: parameters live in ``param_dtype`` (float32 unless the
config says otherwise: ``init`` casts them); ``compute_dtype`` casts the
weights and the input at each use, as the reference does (serving casts
them once: ``rtts_torch/infer/decode.py::_precast_weights``).

Tensor parallelism (``rtts_torch/parallel/sharding.py::shard_params``) marks
a sharded ``Dense`` with ``tp``: a column-sharded one passes its input
through ``copy_to_model`` (its gradient sums over the model group), a
row-sharded one sums its product over the model group and adds its bias
once, after the sum.  ``dropout`` inside ``collectives.batch_shard`` draws
the global batch's mask and keeps this rank's rows, so a data-parallel step
draws what one device does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rtts_torch.parallel.collectives import (copy_to_model,
                                             current_batch_shard,
                                             reduce_from_model)


def normal(shape, generator: Optional[torch.Generator], device=None,
           scale: float = 1.0) -> torch.Tensor:
    """N(0, scale^2) draws made on the CPU from ``generator``."""
    return (torch.randn(shape, generator=generator) * scale).to(device)


# -- dense --------------------------------------------------------------------


class Dense(nn.Module):
    """y = x @ w (+ b); LeCun-normal fan-in init.  ``tp`` (None, or
    ("col" | "row", model group)) marks a tensor-parallel shard."""

    tp = None

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True, *,
                 generator=None, device=None):
        super().__init__()
        self.w = nn.Parameter(normal((d_in, d_out), generator, device,
                                     1.0 / math.sqrt(d_in)))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device))
                  if use_bias else None)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        w = self.w
        kind, group = self.tp or (None, None)
        if kind == "col":
            x = copy_to_model(x, group)
        if compute_dtype is not None:
            w, x = w.to(compute_dtype), x.to(compute_dtype)
        y = x @ w
        if kind == "row":
            y = reduce_from_model(y, group)
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


# -- layer norm ---------------------------------------------------------------


class LayerNorm(nn.Module):
    """Normalizes in float32 whatever the input dtype (eps 1e-5), then casts
    back to the input's dtype."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                         self.bias.float(), eps)
        return y.to(x.dtype)


# -- embedding ----------------------------------------------------------------


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, generator=None, device=None):
        super().__init__()
        self.table = nn.Parameter(normal((vocab, d), generator, device,
                                         d ** -0.5))

    def forward(self, ids: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        table = self.table
        if compute_dtype is not None:
            table = table.to(compute_dtype)
        return F.embedding(ids, table)


# -- dropout ------------------------------------------------------------------


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            heads: Optional[tuple] = None) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (which must live on x's
    device); identity when rate == 0.  A batch shard (``batch_shard``)
    draws the whole batch's uniforms and keeps its rows; ``heads`` =
    (offset, total) does the same for dim 1, a rank's heads of x (B, H,
    ...).  So the generator advances as on one device, and the mask is
    that device's slice."""
    if rate == 0.0:
        return x
    b_off, b_total = current_batch_shard(x.shape[0])
    shape = (b_total,) + tuple(x.shape[1:])
    if heads is not None:
        shape = shape[:1] + (heads[1],) + shape[2:]
    u = torch.rand(shape, generator=generator, device=x.device)
    u = u[b_off:b_off + x.shape[0]]
    if heads is not None:
        u = u[:, heads[0]:heads[0] + x.shape[1]]
    return apply_dropout(x, rate, u)


def apply_dropout(x: torch.Tensor, rate: float,
                  u: torch.Tensor) -> torch.Tensor:
    """Inverted dropout of x with given uniforms ``u`` (x's shape): kept
    where u < 1 - rate, scaled by 1 / (1 - rate)."""
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


# -- activations --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX casts a weak-typed Python
    constant to the dtype of the array it meets.  torch computes
    ``bf16_tensor * 0.1767767`` with the constant in f32; JAX with
    bf16(0.1767767) = 0.17675781.  Multiplying by the rounded value gives
    JAX's bits, and creates no tensor on the card."""
    return torch.tensor(value, dtype=torch.float64).to(dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation).  On the CPU it is JAX's
    formula op by op in x's dtype, sqrt(2/pi) and 0.044715 cast to it, so
    a bf16 x rounds after every op as XLA does (bit-equal to JAX).  On the
    card it is ``F.gelu(approximate="tanh")``: one launch, f32 inside and
    one rounding; in bf16 it differs from the CPU form by at most one bf16
    ulp of max(|output|, 1) (PERF.md, PR 19)."""
    if x.device.type != "cpu":
        return F.gelu(x, approximate="tanh")
    c = scalar(math.sqrt(2.0 / math.pi), x.dtype)
    k = scalar(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``.  XLA expands it to 1 / (1 + exp(-x)), each op
    rounded to x's dtype; on the CPU the port writes that out (bit-equal
    in bf16), on the card it is ``torch.sigmoid``'s one launch, which
    rounds once (PERF.md, PR 19)."""
    if x.device.type != "cpu":
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
    "gelu": gelu,
    "tanh": torch.tanh,
    "silu": F.silu,
}


def activation(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; options: "
                         f"{sorted(ACTIVATIONS)}") from None


# -- decoder prenet MLP (bottleneck with always-on dropout) --------------------


class PrenetMLP(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, d_out: int, *,
                 generator=None, device=None):
        super().__init__()
        self.fc1 = Dense(d_in, d_hidden, generator=generator, device=device)
        self.fc2 = Dense(d_hidden, d_out, generator=generator, device=device)

    def forward(self, x: torch.Tensor, rate: float,
                generator: Optional[torch.Generator],
                compute_dtype=None,
                uniforms: Optional[list] = None) -> torch.Tensor:
        """Transformer-TTS decoder prenet: a 2-layer ReLU MLP whose dropout
        stays on at inference (the AR stability trick of the lineage).
        ``uniforms`` (one tensor per layer, or [] at rate 0) replaces the
        draws from ``generator``: the decode step takes them as an input
        (``rtts_torch/infer/draws.py``)."""
        def drop(h, i):
            if uniforms is None:
                return dropout(h, rate, generator)
            return apply_dropout(h, rate, uniforms[i]) if rate else h

        h = drop(F.relu(self.fc1(x, compute_dtype)), 0)
        return drop(F.relu(self.fc2(h, compute_dtype)), 1)

