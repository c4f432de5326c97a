"""Column-wise bitonic sort of int32 keys: kernel K7 and its plain version.

Port of ``scripts/probe_vmem_sort.py::bitonic_sort_cols``, the sort half of
the in-fast-memory fused sort probe.  ``bitonic_sort_cols(x)`` sorts each
column of an (n, C) int32 tensor ascending (signed), n a power of two.  With
packed keys ``bucket * L + pos`` a value sort is the stable bucket sort, and
``key % L`` is the permutation.

On a CUDA tensor the wrapper launches ``rtts_torch/csrc/bitonic_sort.cu``
(one block per tile of adjacent columns, the whole column in shared memory,
n up to ``MAX_ROWS``) or raises; on a CPU tensor it runs
``bitonic_sort_cols_reference``, the same compare-exchange network in
PyTorch, with ``torch.roll`` reaching the partner i ^ j as the TPU kernel
does with ``pltpu.roll``.
"""

from __future__ import annotations

import functools

import torch

from rtts_torch.ops import _build

# rows one block holds: (n + 1) int32 words of a column in 227 KB of
# shared memory
MAX_ROWS = 32768
_SMEM_BYTES = 232448


def _check_rows(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"bitonic_sort_cols: {n} rows is not a power of two "
                         "(bitonic needs a power-of-two length)")


def bitonic_sort_cols_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: the TPU kernel's passes over the whole block."""
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"bitonic_sort_cols: want (n, C) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n = x.shape[0]
    _check_rows(n)
    iota = torch.arange(n, device=x.device)[:, None]
    for s in range(1, n.bit_length()):
        k = 1 << s
        up = (iota & k) == 0
        for t in range(s - 1, -1, -1):
            j = 1 << t
            lower = (iota & j) == 0
            # roll by -j: the value of row i + j lands at i; by j: of i - j
            partner = torch.where(lower, torch.roll(x, -j, 0),
                                  torch.roll(x, j, 0))
            x = torch.where(up == lower, torch.minimum(x, partner),
                            torch.maximum(x, partner))
    return x


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def columns_per_block(n: int, cols: int, sms: int) -> int:
    """Adjacent columns one block sorts: the widest of 8, 4, 2 that divides
    ``cols``, fits shared memory and still gives each of ``sms`` SMs a
    block; else 1."""
    for tc in (8, 4, 2):
        if (cols % tc == 0 and (n + 1) * tc * 4 <= _SMEM_BYTES
                and cols // tc >= sms):
            return tc
    return 1


def bitonic_sort_cols(x: torch.Tensor) -> torch.Tensor:
    """Sort each column of x (n, C) int32 ascending.

    On a CUDA tensor this launches K7 (counted in
    ``bitonic_sort_cols.launches``) or raises, also for n > ``MAX_ROWS``;
    on a CPU tensor it runs ``bitonic_sort_cols_reference``."""
    if x.device.type == "cpu":
        return bitonic_sort_cols_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"bitonic_sort_cols: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"bitonic_sort_cols: want (n, C) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, cols = x.shape
    _check_rows(n)
    if n > MAX_ROWS:
        raise ValueError(f"bitonic_sort_cols: {n} rows do not fit one block's "
                         f"shared memory (at most {MAX_ROWS})")
    x = x.contiguous()
    out = torch.empty_like(x)
    tc = columns_per_block(n, cols, _sm_count(x.device.index or 0))
    err = _build.library().rtts_bitonic_sort_cols(
        x.data_ptr(), out.data_ptr(), n, cols, tc,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "rtts_bitonic_sort_cols")
    bitonic_sort_cols.launches += 1
    return out


bitonic_sort_cols.launches = 0
