"""Bitonic sort of int32 keys: kernel K7, its two entries and their plain
versions.

Port of ``scripts/probe_vmem_sort.py::bitonic_sort_cols``, the sort half of
the in-fast-memory fused sort probe, which sorts the packed LSH keys
``bucket * L + pos``: a value sort of them is the stable bucket sort, and
``key % L`` the permutation.  ``rtts_torch/csrc/bitonic_sort.cu`` has one
sort body (keys in registers, shuffles across lanes, shared memory only
for the widest passes) behind two entries:

- ``sort_by_bucket(buckets)``: the LSH path's whole bucket sort
  (``rtts_torch/attention/lsh.py::_sort_by_bucket``), buckets (..., L) ->
  (sorted_pos, undo_idx, sorted_buckets), int64, in one launch, any L up to
  ``MAX_ROWS``; its plain version is ``torch.sort`` + ``torch.argsort``
  (``sort_by_bucket_reference``);
- ``bitonic_sort_cols(x)``: the TPU kernel's contract, each column of an
  (n, C) int32 tensor sorted ascending (signed), n a power of two; its
  plain version is ``bitonic_sort_cols_reference``, the same
  compare-exchange network in PyTorch, with ``torch.roll`` reaching the
  partner i ^ j as the TPU kernel does with ``pltpu.roll``.

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from rtts_torch.ops import _build

# keys of one sort row: a CTA's part of them in 227 KB of shared memory
# for the widest passes, at most 1024 threads of 32 keys
MAX_ROWS = 32768
_SMEM_BYTES = 232448
# keys a thread holds: 8, or keys / 1024 past 8192 keys a CTA
_MIN_KEYS_A_THREAD = 8
# threads a block where the rows are short enough to share one
_BLOCK_THREADS = 256
# the shortest padded row a 2-CTA cluster sorts faster than one CTA: on 64
# rows, one CTA a row wins at 1024 and 2048 keys, the cluster from 4096 on
# (chip_smoke.py phase 20, the route sweep)
_CLUSTER_MIN_KEYS = 4096


def _check_rows(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"bitonic_sort_cols: {n} rows is not a power of two "
                         "(bitonic needs a power-of-two length)")


def _threads_a_row(keys: int) -> int:
    """Threads that hold ``keys`` keys (a power of two, at least 8)."""
    return keys // max(_MIN_KEYS_A_THREAD, keys // 1024)


# -- the column entry: the TPU kernel's contract ------------------------------


def bitonic_sort_cols_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K7's column entry: the TPU kernel's passes over the
    whole block."""
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
    """Columns one block sorts: the widest of 8, 4, 2 that divides
    ``cols``, keeps the block within 1024 threads and shared memory and
    still gives each of ``sms`` SMs a block, else 1; at least as many as
    make the block's threads whole warps (short columns)."""
    threads = _threads_a_row(max(n, _MIN_KEYS_A_THREAD))
    least = max(1, 32 // threads)
    for tc in (8, 4, 2):
        if (cols % tc == 0 and tc * threads <= 1024
                and tc * max(n, _MIN_KEYS_A_THREAD) * 4 <= _SMEM_BYTES
                and cols // tc >= sms):
            return max(tc, least)
    return least


def bitonic_sort_cols(x: torch.Tensor) -> torch.Tensor:
    """Sort each column of x (n, C) int32 ascending.

    On a CUDA tensor this launches K7's column entry (counted in
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
    tc = columns_per_block(n, cols, _sm_count(x.get_device()))
    err = _build.function("rtts_bitonic_sort_cols")(
        x.data_ptr(), out.data_ptr(), n, cols, tc,
        _build.stream(x.get_device()))
    _build.check(err, "rtts_bitonic_sort_cols")
    bitonic_sort_cols.launches += 1
    return out


bitonic_sort_cols.launches = 0


# -- the path entry: the LSH bucket sort --------------------------------------


def sort_by_bucket_reference(buckets: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version of K7's path entry: per row, sort by the unique key
    bucket * L + position (the stable sort: ties by original position);
    sorted_pos[..., s] is the original position of sorted slot s, undo_idx
    the inverse permutation, sorted_buckets slot s's bucket."""
    l = buckets.shape[-1]
    pos = torch.arange(l, device=buckets.device)
    sorted_keys, sorted_pos = torch.sort(buckets * l + pos, dim=-1)
    undo_idx = torch.argsort(sorted_pos, dim=-1)
    return sorted_pos, undo_idx, sorted_keys // l


def sort_route(rows: int, l: int, sms: int) -> Optional[Tuple[int, int]]:
    """How ``sort_by_bucket`` takes ``rows`` rows of ``l`` buckets on a card
    of ``sms`` SMs: None, the plain version (l > ``MAX_ROWS``, or nothing
    to sort), else the kernel's (CTAs a row, rows a block).  A row spans a
    2-CTA cluster where one CTA a row would leave SMs idle and the padded
    row is long enough for the halved sort to pay for the cluster's
    barriers; a block takes the most rows, up to 256 threads, that still
    give every SM a block, and at least whole warps."""
    if rows == 0 or l == 0 or l > MAX_ROWS:
        return None
    p = max(1 << (l - 1).bit_length(), _MIN_KEYS_A_THREAD)
    cluster = 2 if rows < sms and p >= _CLUSTER_MIN_KEYS else 1
    threads = _threads_a_row(p // cluster)
    block = max(1, 32 // threads)
    while (2 * block * threads <= _BLOCK_THREADS
           and -(-rows // (2 * block)) >= sms):
        block *= 2
    return cluster, block


def sort_by_bucket(buckets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """buckets (..., L) int64 (as ``hash_vectors`` gives them), each row's
    (bucket + 1) * L below 2^31 -> (sorted_pos, undo_idx, sorted_buckets),
    (..., L) int64, as ``sort_by_bucket_reference``.

    On a CUDA tensor this launches K7's path entry once (counted in
    ``sort_by_bucket.launches``) on the route of ``sort_route``, or raises;
    on a CPU tensor it runs ``sort_by_bucket_reference``."""
    if buckets.dim() == 0 or buckets.dtype != torch.int64:
        raise ValueError(f"sort_by_bucket: want (..., L) int64, got "
                         f"{tuple(buckets.shape)} {buckets.dtype}")
    if buckets.device.type == "cpu":
        return sort_by_bucket_reference(buckets)
    if buckets.device.type != "cuda":
        raise ValueError(f"sort_by_bucket: unsupported device "
                         f"{buckets.device}")
    l = buckets.shape[-1]
    rows = buckets.numel() // l if l else 0
    index = buckets.get_device()
    route = sort_route(rows, l, _sm_count(index))
    if route is None:
        return sort_by_bucket_reference(buckets)
    b = buckets.contiguous()
    # the three outputs in one allocation, addressed by offset
    out = torch.empty((3, *b.shape), dtype=torch.int64, device=b.device)
    ptr, step = out.data_ptr(), b.numel() * 8
    err = _build.function("rtts_sort_by_bucket")(
        b.data_ptr(), ptr, ptr + step, ptr + 2 * step, rows, l, *route,
        _build.stream(index))
    _build.check(err, "rtts_sort_by_bucket")
    sort_by_bucket.launches += 1
    return out.unbind(0)


sort_by_bucket.launches = 0
