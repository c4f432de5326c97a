"""Scaled sinusoidal positional encoding.

Port of ``rtts/nn/posenc.py`` (the axial variant is not ported yet).  The
numpy table is copied here because the JAX module imports jax.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) interleaved sin/cos table."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    dim = np.arange(0, d_model, 2, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, dim / d_model)
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle[:, : d_model // 2])
    return table


class ScaledPosEnc(nn.Module):
    """x + alpha * PE: a learnable scalar ``alpha`` and the sinusoid
    ``table``.  The table is a parameter as in the JAX pytree, where it is a
    leaf of the params that the optimizer updates too; train steps match
    the reference only if it is one here."""

    def __init__(self, max_len: int, d_model: int, *, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones((), device=device))
        self.table = nn.Parameter(
            torch.from_numpy(sinusoidal_table(max_len, d_model)).to(device))

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """x: (..., L, d) -> x + alpha * PE[offset:offset+L]."""
        pe = self.table[offset:offset + x.shape[-2]]
        return x + self.alpha.to(x.dtype) * pe.to(x.dtype)
