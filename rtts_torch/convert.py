"""The parameter bridge: JAX parameter trees and checkpoints -> modules.

The port's modules name their parameters after the JAX pytree paths and keep
the JAX leaf layouts, so a tree fills a module by renaming alone:
``encoder/layers/0/f/attn/w_qk/w`` is ``encoder.layers.0.f.attn.w_qk.w``.
No transposes.  Keys must match exactly in both directions, and shapes too;
values are cast to each parameter's dtype.  Nothing here imports JAX: a live
pytree is handed over as nested dicts/lists of numpy arrays, and a checkpoint
``step_N/leaves.npz`` (``rtts/train/checkpoint.py``: one ``np.savez`` of
path-keyed leaves) is read with numpy.

A vocoder tree may be weight-norm folded or not; fold the module first
(``squeezewave.fold_weightnorm``) to load a folded tree.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


@torch.no_grad()
def load_flat(module: nn.Module, leaves: Mapping[str, np.ndarray]) -> nn.Module:
    """Fill ``module`` from dot-separated leaf paths; returns the module."""
    state = module.state_dict(keep_vars=True)
    missing = sorted(set(state) - set(leaves))
    unexpected = sorted(set(leaves) - set(state))
    if missing or unexpected:
        raise KeyError(f"parameter tree does not match "
                       f"{type(module).__name__}: missing {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}, unexpected "
                       f"{unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")
    for name, t in state.items():
        arr = np.asarray(leaves[name])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: tree leaf has shape {arr.shape}, module "
                             f"has {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr)))
    return module


def from_numpy_tree(module: nn.Module, tree: Any) -> nn.Module:
    """Fill ``module`` from nested dicts/lists of numpy arrays (e.g. a JAX
    pytree mapped through ``np.asarray``); returns the module."""
    return load_flat(module, _flatten(tree))


def load_leaves_npz(module: nn.Module, step_dir: Union[str, pathlib.Path],
                    prefix: str = "params") -> nn.Module:
    """Fill ``module`` from a checkpoint's ``leaves.npz``, taking the leaves
    under ``prefix`` (training checkpoints keep the model under "params";
    "" takes every leaf); returns the module."""
    head = prefix.rstrip("/") + "/" if prefix else ""
    with np.load(pathlib.Path(step_dir) / "leaves.npz") as z:
        leaves = {k[len(head):].replace("/", "."): z[k]
                  for k in z.files if k.startswith(head)}
    return load_flat(module, leaves)
