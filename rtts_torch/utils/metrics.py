"""Metric logging of the port: ``rtts.utils.metrics.MetricLogger``, shared.

The logger writes JSONL and echoes to stderr in plain Python.  Its
TensorBoard sink imports flax (and so JAX), and a hosted tracker comes from
``rtts.utils.tracking``; ``make_logger`` refuses both rather than import
them.  This module is the one place where the port reaches the shared
logger.
"""

from typing import Optional

from rtts.utils.metrics import MetricLogger

__all__ = ["MetricLogger", "make_logger"]


def make_logger(jsonl_path: str, tensorboard_dir: Optional[str] = None,
                tracker: Optional[str] = None) -> MetricLogger:
    """A JSONL + stderr logger; raises on a TensorBoard directory or a
    tracker, which are not ported."""
    if tensorboard_dir:
        raise NotImplementedError(
            "rtts_torch: logging.tensorboard_dir is not ported (the shared "
            "logger writes TensorBoard through flax, which imports JAX); "
            "unset it, metrics still go to logging.jsonl_path")
    if tracker:
        raise NotImplementedError(
            "rtts_torch: logging.tracker is not ported yet; unset it")
    return MetricLogger(jsonl_path)
