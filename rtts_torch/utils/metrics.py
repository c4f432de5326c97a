"""Metric logging of the port: a copy of ``rtts/utils/metrics.py``'s
``MetricLogger``.

Sinks: stderr and JSONL always (the JSONL lines are the JAX logger's,
``tests/test_torch_copies.py``); TensorBoard event files when
``tensorboard_dir`` is set, through ``torch.utils.tensorboard`` at the JAX
logger's tags and steps (where the ``tensorboard`` package is missing the
sink stays off, with a warning that names it); and an optional hosted
tracker (``rtts_torch.utils.tracking.make_tracker``), whose failures never
stop training.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
import warnings
from typing import Any, Dict, Optional

__all__ = ["MetricLogger"]


def _summary_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        warnings.warn(f"logging.tensorboard_dir is set but the tensorboard "
                      f"package is not installed ({e}); TensorBoard logging "
                      "is off, metrics still go to the JSONL file")
        return None
    return SummaryWriter(log_dir)


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 echo: bool = True,
                 tracker=None):
        self.echo = echo
        # optional hosted sink; local sinks never depend on it and its
        # failures must never kill training
        self._tracker = tracker
        self._jsonl = None
        if jsonl_path:
            p = pathlib.Path(jsonl_path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(p, "a")
        self._tb = _summary_writer(tensorboard_dir) if tensorboard_dir else None

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
        if self._tb:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)
        if self._tracker is not None:
            try:
                self._tracker.log(
                    step, {k: v for k, v in rec.items()
                           if k not in ("step", "time")})
            except Exception as e:  # hosted sink down != training down
                print(f"tracker log failed: {e}", file=sys.stderr)
        if self.echo:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in rec.items() if k not in ("time",))
            print(parts, file=sys.stderr)

    def log_artifact(self, path, name: Optional[str] = None) -> None:
        """Forward an eval artifact (PNG/wav) to the hosted tracker, if any.

        Local artifact files are already on disk when this is called — the
        hosted copy is additive, so failures only print.
        """
        if self._tracker is not None:
            try:
                self._tracker.log_artifact(str(path), name=name)
            except Exception as e:
                print(f"tracker artifact upload failed: {e}", file=sys.stderr)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
        if self._tracker is not None:
            try:
                self._tracker.finish()
            except Exception as e:
                print(f"tracker finish failed: {e}", file=sys.stderr)
