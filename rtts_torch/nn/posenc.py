"""Positional encodings: scaled sinusoidal and axial.

Port of ``rtts/nn/posenc.py``.  The numpy table is copied here because the
JAX module imports jax.  ``pos_table`` gives either one as the (rows, d)
table and scale that the decode loops slice a row of each step.
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


class AxialPosEnc(nn.Module):
    """x + the axial embedding: ``ax1`` (d1, 1, f1) and ``ax2`` (1, d2, f2),
    N(0, 0.02^2), broadcast to (d1, d2, f1 + f2), flattened row-major to
    (d1 * d2, f1 + f2) and truncated to the sequence (f1 + f2 = d)."""

    def __init__(self, shape, dims, *, generator=None, device=None):
        super().__init__()
        (d1, d2), (f1, f2) = shape, dims
        self.ax1 = nn.Parameter((torch.randn((d1, 1, f1), generator=generator)
                                 * 0.02).to(device))
        self.ax2 = nn.Parameter((torch.randn((1, d2, f2), generator=generator)
                                 * 0.02).to(device))

    def embedding(self) -> torch.Tensor:
        """The whole (d1 * d2, f1 + f2) table."""
        d1, _, f1 = self.ax1.shape
        _, d2, f2 = self.ax2.shape
        return torch.cat([self.ax1.expand(d1, d2, f1),
                          self.ax2.expand(d1, d2, f2)],
                         dim=-1).reshape(d1 * d2, f1 + f2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, d) with L <= d1 * d2 -> x + embedding[:L]."""
        length = x.shape[-2]
        capacity = self.ax1.shape[0] * self.ax2.shape[1]
        if length > capacity:
            raise ValueError(
                f"sequence {length} exceeds axial capacity {capacity}")
        return x + self.embedding()[:length].to(x.dtype)


def pos_table(pe: nn.Module):
    """(table (rows, d), scale) of a positional encoding, for decode loops
    that add one row a step: the sinusoid's table and ``alpha``, or the
    axial embedding and 1 (the reference's ``_pos_table``)."""
    if isinstance(pe, AxialPosEnc):
        table = pe.embedding()
        return table, torch.ones((), dtype=table.dtype, device=table.device)
    return pe.table, pe.alpha
