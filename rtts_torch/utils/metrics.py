"""Metric logging of the port: a copy of ``rtts/utils/metrics.py``'s
``MetricLogger`` with its JSONL and stderr sinks.

The JAX package's logger also writes TensorBoard through flax (which
imports JAX) and forwards to a hosted tracker; neither is part of the copy,
and ``make_logger`` refuses both.  The JSONL lines are the JAX logger's
(``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
from typing import Any, Dict, Optional

__all__ = ["MetricLogger", "make_logger"]


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._jsonl = None
        if jsonl_path:
            p = pathlib.Path(jsonl_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(p, "a")

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                rec[key] = v
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self.echo:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in rec.items() if k not in ("time",))
            print(parts, file=sys.stderr)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()


def make_logger(jsonl_path: str, tensorboard_dir: Optional[str] = None,
                tracker: Optional[str] = None) -> MetricLogger:
    """A JSONL + stderr logger; raises on a TensorBoard directory or a
    tracker, which are not ported."""
    if tensorboard_dir:
        raise NotImplementedError(
            "rtts_torch: logging.tensorboard_dir is not ported (the JAX "
            "package writes TensorBoard through flax, which imports JAX); "
            "unset it, metrics still go to logging.jsonl_path")
    if tracker:
        raise NotImplementedError(
            "rtts_torch: logging.tracker is not ported yet; unset it")
    return MetricLogger(jsonl_path)
