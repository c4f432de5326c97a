"""Sharded serving: port of ``rtts/parallel/serving.py``.

The decode step runs the training step's projections, so the training
rules shard serving unchanged: ``shard_for_serving`` keeps this rank's
columns of q/k/v and the FFN in-projection and rows of the output
projections (``sharding.shard_params``), and the decode then holds the
rank's heads in every KV cache and sums the row-sharded products over the
model group, one all-reduce each.  The request batch splits over the data
group: ``shard_request_batch`` takes this rank's rows (the batch padded to
a multiple of ``data_parallel_size`` upstream, as ``Synthesizer`` does by
repeating the last request) and ``gather_request_batch`` puts the rows of
every data rank back together.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
from torch import nn

from rtts_torch.parallel.collectives import gather_dim
from rtts_torch.parallel.mesh import Mesh
from rtts_torch.parallel.sharding import shard_params


def shard_for_serving(model: nn.Module, mesh: Mesh,
                      tensor_parallel: bool = True,
                      whole: Sequence[str] = ()) -> nn.Module:
    """Shard ``model`` in place with the TP rules (everything else, and
    the stacks under ``whole``, stays whole on every rank); returns it."""
    shard_params(model, mesh, tensor_parallel, whole)
    return model


def replicate_for_serving(model: nn.Module, mesh: Mesh) -> nn.Module:
    """The vocoder: every rank holds the whole of it (its depthwise convs
    have no wide axis worth sharding; it scales by the data-parallel
    batch).  Each rank already holds it whole, so nothing moves."""
    return model


def data_parallel_size(mesh: Mesh) -> int:
    """Number of ways the request batch is split (data x dcn)."""
    return mesh.data_size


def shard_request_batch(tree: Tuple[torch.Tensor, ...],
                        mesh: Mesh) -> Tuple[Tuple[torch.Tensor, ...], int,
                                             int]:
    """This data rank's rows of batched request tensors -> (rows, offset,
    total).  The leading dim of each must divide by
    ``data_parallel_size``: pad the request list upstream."""
    dp = data_parallel_size(mesh)
    total = int(tree[0].shape[0])
    for x in tree:
        if x.shape[0] % dp:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by data-parallel size "
                f"{dp}; pad the request batch first")
    n = total // dp
    off = mesh.data_index * n
    return tuple(x[off:off + n] for x in tree), off, total


def gather_request_batch(x: Any, mesh: Mesh) -> torch.Tensor:
    """The rows of every data rank, in order (each rank's ``x`` the same
    shape)."""
    return gather_dim(x, 0, mesh.data_group, mesh.data_index,
                      mesh.data_size)
