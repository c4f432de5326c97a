"""Row gather out[i] = x[idx[i]]: kernel K8 and its plain version.

Port of ``scripts/probe_vmem_sort.py::vmem_row_gather``, the per-row
dynamic-index gather that a fused sorted attend would need.  x is (rows, d)
in float32 or bfloat16, idx int32 with 0 <= idx < rows; the TPU kernel
takes idx of length rows, the port any length m, giving (m, d).

On a CUDA tensor the wrapper launches ``rtts_torch/csrc/row_gather.cu`` (a
group of lanes per row, 16-byte vectors where the row allows) or raises; on
a CPU tensor it runs ``row_gather_reference``, ``x[idx.long()]``.
"""

from __future__ import annotations

import torch

from rtts_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


def row_gather_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K8."""
    return x[idx.long()]


def _vector_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy vector that divides a row and every pointer (2, a
    bf16 value, divides every row and pointer of either dtype)."""
    for vb in (16, 8, 4):
        if row_bytes % vb == 0 and all(t.data_ptr() % vb == 0
                                       for t in tensors):
            return vb
    return 2


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (rows, d), idx (m,) int32 -> (m, d) with out[i] = x[idx[i]].

    On a CUDA tensor this launches K8 (counted in ``row_gather.launches``)
    or raises; an index out of range stops the kernel, which the next
    synchronize reports.  On a CPU tensor it runs ``row_gather_reference``.
    """
    if x.device.type == "cpu":
        return row_gather_reference(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"row_gather: dtype {x.dtype} not in float32/bfloat16")
    if x.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"row_gather: want x (rows, d) and idx (m,) int32, "
                         f"got {tuple(x.shape)} and {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if idx.device != x.device:
        raise ValueError(f"row_gather: idx on {idx.device}, x on {x.device}")
    rows, d = x.shape
    m = idx.shape[0]
    if max(rows, m) >= 2**31:
        raise ValueError(f"row_gather: {rows} rows / {m} indices exceed int32")
    x, idx = x.contiguous(), idx.contiguous()
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    row_bytes = d * x.element_size()
    err = _build.library().rtts_row_gather(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), m, rows, row_bytes,
        _vector_bytes(row_bytes, x, out),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rtts_row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
