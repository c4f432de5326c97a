"""Core layers as nn.Modules whose parameter names are the JAX leaf names.

Port of ``rtts/nn/layers.py``.  Leaf layouts are the JAX package's (dense
``w`` is (d_in, d_out)), so a parameter tree converts by renaming alone
(``rtts_torch/convert.py``).  Initial values are drawn on the CPU from an
explicit ``torch.Generator`` and then moved to ``device``, so one seed gives
the same weights on every device.

Dtype policy: parameters live in float32; ``compute_dtype`` casts the
weights and the input at each use, as the reference does (serving casts
them once: ``rtts_torch/infer/decode.py::_precast_weights``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def normal(shape, generator: Optional[torch.Generator], device=None,
           scale: float = 1.0) -> torch.Tensor:
    """N(0, scale^2) draws made on the CPU from ``generator``."""
    return (torch.randn(shape, generator=generator) * scale).to(device)


# -- dense --------------------------------------------------------------------


class Dense(nn.Module):
    """y = x @ w (+ b); LeCun-normal fan-in init."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True, *,
                 generator=None, device=None):
        super().__init__()
        self.w = nn.Parameter(normal((d_in, d_out), generator, device,
                                     1.0 / math.sqrt(d_in)))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device))
                  if use_bias else None)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        w = self.w
        if compute_dtype is not None:
            w, x = w.to(compute_dtype), x.to(compute_dtype)
        y = x @ w
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
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (which must live on x's
    device); identity when rate == 0."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


# -- activations --------------------------------------------------------------

ACTIVATIONS = {
    "relu": F.relu,
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
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
                compute_dtype=None) -> torch.Tensor:
        """Transformer-TTS decoder prenet: a 2-layer ReLU MLP whose dropout
        stays on at inference (the AR stability trick of the lineage)."""
        h = dropout(F.relu(self.fc1(x, compute_dtype)), rate, generator)
        return dropout(F.relu(self.fc2(h, compute_dtype)), rate, generator)

