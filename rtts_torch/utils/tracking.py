"""Hosted experiment-tracker adapters: a copy of ``rtts/utils/tracking.py``.

The port's metric sinks are local (JSONL, TensorBoard); a tracker is an
optional extra sink.  ``make_tracker`` resolves ``logging.tracker``: None
or "" (off, the default), a known name (``neptune``, ``wandb``; each SDK
imported when its adapter is made), or ``"module.path:factory"``.  A named
adapter whose SDK is missing, or whose run fails to start (no network, no
credentials), warns and gives no tracker: training never depends on a
hosted service.  An unknown bare name raises ValueError.

Adapter contract (duck-typed): ``log(step, metrics)`` with prefixed scalar
names (``train/loss``), ``log_artifact(path, name=None)`` for eval
artifacts and ``finish()``; ``rtts_torch.utils.metrics.MetricLogger``
calls all three.
"""

from __future__ import annotations

import importlib
import warnings
from typing import Any, Dict, Optional


class NeptuneTracker:
    """neptune.ai adapter (the reference's tracker)."""

    def __init__(self, run_name: str, config: Optional[Dict[str, Any]] = None,
                 **kwargs):
        import neptune  # lazy: optional dependency

        self._run = neptune.init_run(name=run_name, **kwargs)
        if config:
            self._run["config"] = _flatten(config)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._run[k].append(float(v), step=step)

    def log_artifact(self, path: str, name: Optional[str] = None) -> None:
        import pathlib

        self._run[f"artifacts/{name or pathlib.Path(path).name}"].upload(path)

    def finish(self) -> None:
        self._run.stop()


class WandbTracker:
    """Weights & Biases adapter."""

    def __init__(self, run_name: str, config: Optional[Dict[str, Any]] = None,
                 **kwargs):
        import wandb  # lazy: optional dependency

        self._wandb = wandb
        self._run = wandb.init(name=run_name, config=config or {}, **kwargs)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        if scalars:
            self._run.log(scalars, step=step)

    def log_artifact(self, path: str, name: Optional[str] = None) -> None:
        self._wandb.save(path)

    def finish(self) -> None:
        self._run.finish()


_KNOWN = {"neptune": NeptuneTracker, "wandb": WandbTracker}


def make_tracker(spec: Optional[str], run_name: str,
                 config: Optional[Dict[str, Any]] = None) -> Optional[Any]:
    """Resolve ``LoggingConfig.tracker`` to a live tracker, or None.

    ``spec`` is None/"" (tracking off, the default), a known name
    (``"neptune"``, ``"wandb"``), or ``"module.path:factory"`` — the
    factory is called as ``factory(run_name=..., config=...)`` and its
    return value is used verbatim (duck-typed; see module docstring).

    Failures (missing SDK, no network, bad credentials) WARN and return
    None so offline training is never blocked by the hosted sink.
    An unknown bare name raises ValueError — that is a config typo, not
    an environment condition.
    """
    if not spec:
        return None
    if ":" in spec:
        mod_name, _, attr = spec.partition(":")
        factory = getattr(importlib.import_module(mod_name), attr)
    elif spec in _KNOWN:
        factory = _KNOWN[spec]
    else:
        raise ValueError(
            f"unknown tracker {spec!r}: expected one of {sorted(_KNOWN)} "
            "or a 'module.path:factory' dotted path")
    try:
        return factory(run_name=run_name, config=config)
    except Exception as e:  # SDK absent / offline / bad credentials
        warnings.warn(f"tracker {spec!r} unavailable ({type(e).__name__}: "
                      f"{e}); continuing with local sinks only")
        return None


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Dotted-key flatten for hosted config fields (nested dicts upload
    poorly in both SDKs)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{key}."))
        else:
            out[key] = v
    return out
