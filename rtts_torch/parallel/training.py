"""A train step over a mesh: what the JAX trainers get from their shardings.

``rtts/train/train_tts.py`` and ``train_vocoder.py`` put the params,
optimizer state and batch on a mesh and jit one SPMD step; XLA adds the
collectives.  ``MeshTraining`` holds the port's explicit counterparts for
one rank, around the one-device step:

- the batch: this data rank's rows (``shard_batch``), inside
  ``batch_shard`` so that dropout and the kernels' hashes see global rows;
- the loss: global-batch counts (``count``), so the ranks' losses and
  gradients sum to the one-device ones; the gradients and the additive
  metrics then sum over the data group, one collective each;
- the gradient norm (the metric and the clip): each leaf's squares summed
  over the ranks that hold different parts of it, once over those that
  hold copies;
- tensor parallelism: ``shard_params`` (``sharding.py``), but for the
  stacks that split their sequence or layers over the model group
  (``whole``), which hold their parameters whole and sum their gradients
  over that group themselves; the step runs inside ``with mesh:`` so that
  those stacks find it;
- ZeRO-1: each data rank updates the ``zero_dims`` slice of every leaf
  with its own moments, then broadcasts it;
- checkpoints: the whole tree, under the one-device leaf names, gathered
  on every rank and written by rank 0 (``snapshot``); a run restores into
  the whole model before it shards, so any mesh reads any checkpoint.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rtts_torch.parallel.collectives import all_reduce_flat, psum
from rtts_torch.parallel.mesh import Mesh
from rtts_torch.parallel.sharding import (_slice, broadcast_zero_slices,
                                          gather_param, shard_batch,
                                          shard_params, zero_dims,
                                          zero_slices)
from rtts_torch.train.checkpoint import _host

_PER_PARAM = ("mu", "nu", "acc")


class MeshTraining:
    """One rank's share of a training run over ``mesh``.  Construction
    shards ``model`` in place (tensor parallelism when the mesh has a model
    group and ``tensor_parallel``; the stacks under the prefixes ``whole``
    stay whole: ``sharding.whole_stacks``)."""

    def __init__(self, model: nn.Module, mesh: Mesh, zero: bool = False,
                 tensor_parallel: bool = True, whole: Sequence[str] = ()):
        self.mesh = mesh
        self.plan = shard_params(model, mesh, tensor_parallel, whole)
        names = [name for name, _ in model.named_parameters()]
        self.tp = [self.plan[n] for n in names]
        self.zero = zero and mesh.data_size > 1
        self.zdims = zero_dims(model, mesh, self.zero)

    # -- data --------------------------------------------------------------

    def shard(self, batch: Dict):
        """-> (this rank's rows, (offset, total)) of a batch."""
        local, off, total = shard_batch(batch, self.mesh)
        return local, (off, total)

    def count(self, t: torch.Tensor) -> torch.Tensor:
        """A local count made the global batch's."""
        return psum(t, self.mesh.data_group)

    # -- gradients and metrics ----------------------------------------------

    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum the ranks' gradients over the data group, in place."""
        all_reduce_flat(grads, self.mesh.data_group)

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor],
                       global_keys=()) -> Dict[str, torch.Tensor]:
        """Sum the additive metrics over the data group (one collective);
        ``global_keys`` are the global batch's already."""
        keys = [k for k in metrics if k not in global_keys]
        if not keys or self.mesh.data_group is None:
            return metrics
        stacked = torch.stack([metrics[k].detach().float() for k in keys])
        stacked = psum(stacked, self.mesh.data_group)
        out = dict(metrics)
        out.update({k: stacked[i] for i, k in enumerate(keys)})
        return out

    def norm(self, grads: List[torch.Tensor],
             sliced: bool = False) -> torch.Tensor:
        """The global norm of the whole gradient from this rank's leaves
        (their ZeRO slices when ``sliced``): a TP shard's squares sum over
        the model group, a ZeRO slice's over the data group."""
        dev = grads[0].device if grads else None
        parts = {k: torch.zeros((), device=dev) for k in
                 ("plain", "tp", "zero", "both")}
        for g, tp, z in zip(grads, self.tp, self.zdims):
            key = {(False, False): "plain", (True, False): "tp",
                   (False, True): "zero", (True, True): "both"}[
                (tp is not None, sliced and z is not None)]
            parts[key] = parts[key] + (g.float() ** 2).sum()
        m = self.mesh
        model = psum(parts["tp"] + psum(parts["both"], m.data_group),
                     m.model_group)
        return torch.sqrt(parts["plain"] + model
                          + psum(parts["zero"], m.data_group))

    # -- the optimizer --------------------------------------------------------

    def init_state(self, optimizer, model: nn.Module) -> Dict:
        """The optimizer state this rank keeps (its ZeRO slices)."""
        return optimizer.init(zero_slices(list(model.parameters()),
                                          self.zdims, self.mesh))

    @torch.no_grad()
    def shard_state(self, state: Dict) -> Dict:
        """A whole optimizer state (a restored checkpoint's) cut to this
        rank's TP shards and ZeRO slices."""
        m = self.mesh
        out = dict(state)
        for key in _PER_PARAM:
            if key in state:
                out[key] = [
                    _slice(_slice(t, tp, m.model_index, m.model_size),
                           z, m.data_index, m.data_size).clone()
                    for t, tp, z in zip(state[key], self.tp, self.zdims)]
        return out

    def update(self, optimizer, params: List[torch.Tensor],
               grads: List[torch.Tensor], state: Dict) -> None:
        """The optimizer step on this rank's leaves (ZeRO: its slices, then
        every slice broadcast from its owner)."""
        if not self.zero:
            optimizer.step(params, grads, state, norm_fn=self.norm)
            return
        optimizer.step(zero_slices(params, self.zdims, self.mesh),
                       zero_slices(grads, self.zdims, self.mesh), state,
                       norm_fn=lambda g: self.norm(g, sliced=True))
        broadcast_zero_slices(params, self.zdims, self.mesh)

    # -- checkpoints ----------------------------------------------------------

    @torch.no_grad()
    def snapshot(self, model: nn.Module,
                 state: Optional[Dict]) -> Dict[str, np.ndarray]:
        """The whole tree's host copy, under the one-device leaf names
        (``rtts_torch/train/checkpoint.py::snapshot``); every rank must
        call it."""
        names = [n for n, _ in model.named_parameters()]
        params = dict(model.named_parameters())
        flat = {}
        for key, t in model.state_dict().items():
            tp = self.plan.get(key) if key in params else None
            flat[f"params/{key.replace('.', '/')}"] = _host(
                gather_param(t, tp, None, self.mesh))
        if state is None:
            return flat
        for key in ("count", "mini_step"):
            if key in state:
                flat[f"opt_state/{key}"] = np.asarray(state[key], np.int64)
        zdims = self.zdims if self.zero else [None] * len(names)
        for key in _PER_PARAM:
            for name, t, tp, z in zip(names, state.get(key, ()), self.tp,
                                      zdims):
                flat[f"opt_state/{key}/{name.replace('.', '/')}"] = _host(
                    gather_param(t, tp, z, self.mesh))
        return flat
