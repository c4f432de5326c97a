"""1-D convolutions on (batch, time, channels), SAME padding, with groups.

Port of ``rtts/nn/conv.py``.  The weight keeps the JAX layout
(K, C_in/groups, C_out); it is rearranged to PyTorch's (C_out, C_in/groups, K)
at the call.  SAME padding follows XLA: for an even kernel the extra tap
reaches right, (K-1)//2 to the left and K//2 to the right.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rtts_torch.nn.layers import normal


def conv1d(x: torch.Tensor, w: torch.Tensor, b=None, groups: int = 1,
           compute_dtype=None) -> torch.Tensor:
    """x (B, T, C_in), w (K, C_in/groups, C_out), b (C_out,) -> (B, T, C_out)."""
    if compute_dtype is not None:
        w, x = w.to(compute_dtype), x.to(compute_dtype)
    k = w.shape[0]
    if k == 1 and groups == 1:
        y = x @ w[0]   # a pointwise conv is a matmul; no layout change needed
    else:
        xt = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
        y = F.conv1d(xt, w.permute(2, 1, 0), groups=groups).transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class Conv1d(nn.Module):
    """Conv params {w, b} with fan-in normal init (``conv1d_init``)."""

    def __init__(self, d_in: int, d_out: int, kernel: int, groups: int = 1,
                 use_bias: bool = True, *, generator=None, device=None):
        super().__init__()
        fan_in = (d_in // groups) * kernel
        self.groups = groups
        self.w = nn.Parameter(normal((kernel, d_in // groups, d_out), generator,
                                     device, 1.0 / math.sqrt(fan_in)))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device))
                  if use_bias else None)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        return conv1d(x, self.w, self.b, self.groups, compute_dtype)
