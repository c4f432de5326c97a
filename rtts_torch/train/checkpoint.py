"""Checkpoint and resume: port of ``rtts/train/checkpoint.py``, same format.

Each save writes ``step_<N>/`` atomically (a temporary directory, then a
rename) with ``leaves.npz``, one ``np.savez`` of path-keyed arrays, and
``meta.json`` (step, metric, ``format_version`` 2, leaf count).  Retention
keeps the latest step plus the best ``keep - 1`` by metric.

Keys: ``params/<path>`` with the JAX pytree's paths (``encoder/layers/0/
f/attn/w_qk/w``), so the JAX ``restore_checkpoint`` reads the port's params
and ``rtts_torch.convert.load_leaves_npz`` reads the JAX package's.  The
optimizer state has the port's own keys (``rtts_torch/train/optim.py``):
``opt_state/count`` (int64 scalar) and, for adam/adamw,
``opt_state/mu/<path>`` and ``opt_state/nu/<path>``; with gradient
accumulation also ``opt_state/mini_step`` and ``opt_state/acc/<path>``.
The JAX package's optax state is not read and the port's is not readable
by it.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rtts_torch.convert import load_flat


# the optimizer state's counters and its per-parameter tensor lists
_COUNTERS = ("count", "mini_step")
_PER_PARAM = ("mu", "nu", "acc")


def param_names(model: nn.Module) -> List[str]:
    """The JAX pytree paths of the model's parameters, in parameter order."""
    return [name.replace(".", "/") for name, _ in model.named_parameters()]


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 (which numpy lacks) as float32, exactly: a
    restore casts it back to the parameter's dtype."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().to("cpu", copy=True).numpy()


def snapshot(model: nn.Module, opt_state: Optional[Dict]) -> Dict[str, np.ndarray]:
    """The path-keyed host copy of params (and optimizer state) that a save
    writes; copies, so later in-place updates cannot reach it."""
    flat = {f"params/{k.replace('.', '/')}": _host(t)
            for k, t in model.state_dict().items()}
    if opt_state is not None:
        for key in _COUNTERS:
            if key in opt_state:
                flat[f"opt_state/{key}"] = np.asarray(opt_state[key], np.int64)
        for key in _PER_PARAM:
            for name, t in zip(param_names(model), opt_state.get(key, ())):
                flat[f"opt_state/{key}/{name}"] = _host(t)
    return flat


def save_checkpoint(directory, model: nn.Module, opt_state: Optional[Dict],
                    step: int, metric: Optional[float] = None,
                    keep: int = 3) -> str:
    return write_checkpoint(directory, snapshot(model, opt_state), step,
                            metric, keep)


def write_checkpoint(directory, flat: Dict[str, np.ndarray], step: int,
                     metric: Optional[float] = None, keep: int = 3) -> str:
    base = pathlib.Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f".tmp_step_{step}"
    final = base / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "leaves.npz", **flat)
    meta = {"step": step, "metric": metric, "format_version": 2,
            "n_leaves": len(flat)}
    with open(tmp / "meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _retain(base, keep)
    return str(final)


def _list_steps(base: pathlib.Path
                ) -> List[Tuple[int, Optional[float], pathlib.Path]]:
    out = []
    for p in base.glob("step_*"):
        try:
            with open(p / "meta.json") as f:
                meta = json.load(f)
            out.append((int(meta["step"]), meta.get("metric"), p))
        except (OSError, ValueError, KeyError):
            continue
    return sorted(out)


def _retain(base: pathlib.Path, keep: int) -> None:
    steps = _list_steps(base)
    if len(steps) <= keep:
        return
    latest = steps[-1][2]
    with_metric = [s for s in steps if s[1] is not None]
    best = sorted(with_metric, key=lambda s: s[1])[: max(0, keep - 1)]
    keep_paths = {latest} | {p for _, _, p in best}
    for _, _, p in steps:
        if p not in keep_paths and len(keep_paths) < len(steps):
            shutil.rmtree(p, ignore_errors=True)


class AsyncCheckpointer:
    """Overlaps the npz write with training: ``save`` snapshots params and
    optimizer state to host memory first (the train step updates them in
    place), then a worker thread writes, renames and prunes.  Saves run in
    order; a worker's error re-raises on the next ``save`` or ``wait``."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, directory, model: nn.Module, opt_state: Optional[Dict],
             step: int, metric: Optional[float] = None, keep: int = 3) -> None:
        self.save_flat(directory, snapshot(model, opt_state), step, metric,
                       keep)

    def save_flat(self, directory, flat: Dict[str, np.ndarray], step: int,
                  metric: Optional[float] = None, keep: int = 3) -> None:
        """Write an already snapshotted tree (``snapshot``, or a sharded
        run's gathered one) on the worker."""
        self.wait()

        def _write() -> None:
            try:
                write_checkpoint(directory, flat, step, metric=metric,
                                 keep=keep)
            except BaseException as e:  # surface on next save()/wait()
                self._err = e

        self._thread = threading.Thread(target=_write, daemon=True,
                                        name=f"ckpt-save-{step}")
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save lands; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def latest_checkpoint(directory) -> Optional[str]:
    base = pathlib.Path(directory)
    if not base.exists():
        return None
    steps = _list_steps(base)
    return str(steps[-1][2]) if steps else None


@torch.no_grad()
def restore_checkpoint(path, model: nn.Module,
                       opt_state: Optional[Dict] = None) -> int:
    """Fill ``model`` (and ``opt_state``, in place) from a checkpoint;
    returns its step.  Every leaf they need must be present and of the
    same shape; other leaves are ignored."""
    p = pathlib.Path(path)
    with open(p / "meta.json") as f:
        meta = json.load(f)
    with np.load(p / "leaves.npz") as z:
        stored = {k: z[k] for k in z.files}
    load_flat(model, {k[len("params/"):].replace("/", "."): v
                      for k, v in stored.items() if k.startswith("params/")})
    if opt_state is not None:
        counters = [k for k in _COUNTERS if k in opt_state]
        missing = [f"opt_state/{k}" for k in counters
                   if f"opt_state/{k}" not in stored]
        for key in _PER_PARAM:
            for name, t in zip(param_names(model), opt_state.get(key, ())):
                leaf = f"opt_state/{key}/{name}"
                if leaf not in stored:
                    missing.append(leaf)
                    continue
                if tuple(stored[leaf].shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint leaf {leaf!r} has shape "
                                     f"{stored[leaf].shape}, expected "
                                     f"{tuple(t.shape)}")
                t.copy_(torch.from_numpy(stored[leaf]))
        if missing:
            raise ValueError(f"checkpoint at {p} has no port optimizer state, "
                             f"e.g. {missing[:3]}")
        for key in counters:
            opt_state[key] = int(stored[f"opt_state/{key}"])
    return int(meta["step"])
