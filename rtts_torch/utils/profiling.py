"""Tracing and profiling of the port; counterpart of
``rtts/utils/profiling.py``.

- ``trace(log_dir)``: ``torch.profiler`` over the block (CPU, and CUDA
  where there is a card), exported as a Chrome trace into ``log_dir``.
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``).
- ``timed(fn, *args)``: the best wall time of a few calls, each ended by
  ``torch.cuda.synchronize`` when CUDA is in use.
- ``enable_nan_debugging(enable)``: autograd's anomaly mode, the
  counterpart of ``jax_debug_nans``; ``check_finite`` is the trainers'
  check of the loss and every gradient under ``experiment.debug_nans``.

The JAX package's persistent compilation cache has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import Callable, Iterator, Sequence, Tuple

import torch


def enable_nan_debugging(enable: bool = True):
    """Turn autograd's anomaly mode on (or off): a backward function that
    returns NaN raises, with the forward's stack trace.  Called, it holds
    for the process; as a context manager, for the block."""
    return torch.autograd.set_detect_anomaly(enable)


def check_finite(named: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """Raise FloatingPointError naming the first tensor of ``named`` that
    holds a NaN or an infinity; one host synchronization in all."""
    flags = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    bad = torch.nonzero(~flags)
    if len(bad):
        raise FloatingPointError(
            f"debug_nans: {named[int(bad[0])][0]} is not finite")


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; its Chrome trace goes to
    ``log_dir/trace_<pid>_<ns>.json`` (the path is the yielded profile's
    ``trace_file``)."""
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_file = str(out / f"trace_{os.getpid()}_{time.time_ns()}.json")
    with prof:
        yield prof
        _sync()
    prof.export_chrome_trace(prof.trace_file)


def annotate(name: str):
    """Named trace range: ``with annotate('lsh_sort'): ...``."""
    return torch.profiler.record_function(name)


def timed(fn: Callable, *args, repeats: int = 3, warmup: int = 1):
    """Run ``fn(*args)`` ``warmup`` times, then ``repeats`` timed times,
    synchronizing the card after each; -> (best seconds, last result)."""
    result = None
    for _ in range(warmup):
        result = fn(*args)
        _sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best, result
