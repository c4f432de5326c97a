"""Sharding rules and what they do to a module: port of
``rtts/parallel/sharding.py``.

The JAX package maps each parameter path to a PartitionSpec and lets XLA
place the data.  Here the same rules pick, for each parameter, the dim its
rank keeps a slice of (``shard_params``), and the collectives are the
port's own: the batch splits over the data group (``shard_batch``), the
gradients sum over it, the sharded projections reduce over the model group
(``rtts_torch/nn/layers.py::Dense``), and with ZeRO-1 each data rank owns
the Adam moments of one slice of each parameter (``_zero_extend``'s dim),
updates that slice alone and broadcasts it to the others.

``param_sharding_rules`` and ``_zero_extend`` are copies of the
reference's, returning a tuple of dims (an axis name or None each) or None
where the reference returns a PartitionSpec; ``tests/test_torch_copies.py``
holds them equal.  The port's parameter names are the JAX pytree paths, so
the rules shard the same leaves on the same dims: attention q/k/v columns
and output rows, the FFN out-projection rows.  The FFN in-projection's
path (``…/g/w_in``) holds none of the rule's FFN words, so the reference
leaves it whole and XLA partitions its product from the out-projection's
sharding; the port shards its columns and its bias explicitly
(``tp_dim``), the Megatron pairing that gives each rank d_ff / mp of the
hidden.  The arithmetic is the same either way.

A stack with ``seq_parallel_axis`` or ``pipeline_axis`` set
(``whole_stacks``) keeps its parameters whole on every rank of the model
group: the JAX trainer shards them by the rule above and XLA reshards them
for the stack's shard_map; here the stack computes its rows or its stage's
layers from whole parameters and sums their gradients over the model group
itself (``seq_parallel.py``, ``pipeline.py``).  The rest of the model keeps
the tensor-parallel rule.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from rtts_torch.parallel.collectives import broadcast_, gather_dim
from rtts_torch.parallel.mesh import DATA_AXIS, DCN_AXIS, MODEL_AXIS, Mesh

Spec = Optional[Tuple[Optional[str], ...]]

# the FFN in-projection of a stack pair (``…/g/w_in/{w,b}``): column-sharded
# with its bias, to pair with the row-sharded out-projection
_FFN_IN = re.compile(r"(^|/)g/w_in/(w|b)$")


def param_sharding_rules(path_str: str, ndim: int,
                         tensor_parallel: bool) -> Spec:
    """Map a parameter (by pytree path string + rank) to a PartitionSpec.

    Without tensor parallelism everything is replicated.  With it, the FFN
    and attention projection matrices shard their wide axis over ``model``:
      - ffn in-projection  (d_model, d_ff): shard axis 1
      - ffn out-projection (d_ff, d_model): shard axis 0
      - qkv projections    (d_model, n_heads*head_dim): shard axis 1
      - attention output   (n_heads*head_dim, d_model): shard axis 0
    """
    if not tensor_parallel or ndim < 2:
        return None
    p = path_str.lower()
    if ("ffn" in p or "feed_forward" in p) and ("w_in" in p or "wi" in p):
        return (None, MODEL_AXIS)
    if ("ffn" in p or "feed_forward" in p) and ("w_out" in p or "wo" in p):
        return (MODEL_AXIS, None)
    if any(k in p for k in ("w_qk", "w_q", "w_k", "w_v", "qkv")):
        return (None, MODEL_AXIS)
    if "w_o" in p or "out_proj" in p:
        return (MODEL_AXIS, None)
    return None


def _zero_extend(spec: Spec, shape, dp: int) -> Spec:
    """Add the data axis to the first unsharded dim divisible by ``dp``."""
    dims = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    for i, (d, s) in enumerate(zip(dims, shape)):
        if d is None and s >= dp and s % dp == 0:
            dims[i] = DATA_AXIS
            break
    return tuple(dims)


def _spec_dim(spec: Spec, axis: str) -> Optional[int]:
    return None if spec is None or axis not in spec else spec.index(axis)


def tp_dim(name: str, ndim: int, tensor_parallel: bool) -> Optional[int]:
    """The dim a parameter (by its port name, ``a.b.c`` or ``a/b/c``)
    splits over the model group, or None: the reference's rule, and the FFN
    in-projection's columns and bias (module docstring)."""
    path = name.replace(".", "/")
    if tensor_parallel and _FFN_IN.search(path):
        return ndim - 1
    return _spec_dim(param_sharding_rules(path, ndim, tensor_parallel),
                     MODEL_AXIS)


def whole_stacks(model_cfg) -> Tuple[str, ...]:
    """The parameter-name prefixes of the stacks that split their sequence
    or their layers over the model group (kept whole by ``shard_params``)."""
    return tuple(f"{name}." for name in ("encoder", "decoder")
                 if getattr(model_cfg, name).seq_parallel_axis
                 or getattr(model_cfg, name).pipeline_axis)


def splits_over_batch(model_cfg) -> bool:
    """Whether a stack splits its sequence over an axis the batch rides
    (``data``, ``dcn``): each of its forwards then needs every data rank,
    an evaluation's included."""
    return any(getattr(model_cfg, name).seq_parallel_axis
               in (DATA_AXIS, DCN_AXIS) for name in ("encoder", "decoder"))


def _slice(t: torch.Tensor, dim: Optional[int], index: int,
           size: int) -> torch.Tensor:
    if dim is None or size == 1:
        return t
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{size} ways")
    return t.narrow(dim, index * (n // size), n // size)


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh, tensor_parallel: bool = True,
                 whole: Sequence[str] = ()) -> Dict[str, Optional[int]]:
    """Keep this rank's slice of every model-sharded parameter, in place,
    and wire the projections to the model group: column-sharded ``Dense``
    layers take ``copy_to_model`` on their input, row-sharded ones
    ``reduce_from_model`` on their output (their bias added once, after
    it), and each attention block learns its heads' offset.  Parameters
    under a prefix of ``whole`` stay whole.  Returns the plan {parameter
    name: sharded dim or None}, also kept as ``model.tp_plan``.  A model
    sharded already is left as it is."""
    from rtts_torch.attention.full import Attention
    from rtts_torch.nn.layers import Dense

    if getattr(model, "tp_plan", None) is not None:
        return model.tp_plan
    tp = tensor_parallel and mesh.model_size > 1
    plan = {name: (None if name.startswith(tuple(whole))
                   else tp_dim(name, p.ndim, tp))
            for name, p in model.named_parameters()}
    if tp:
        for name, p in model.named_parameters():
            dim = plan[name]
            if dim is not None:
                p.data = _slice(p.data, dim, mesh.model_index,
                                mesh.model_size).clone()
        for mname, m in model.named_modules():
            if isinstance(m, Dense) and plan.get(f"{mname}.w") is not None:
                m.tp = ("col" if plan[f"{mname}.w"] == 1 else "row",
                        mesh.model_group)
            elif isinstance(m, Attention) and not f"{mname}.".startswith(
                    tuple(whole)):
                if m.num_heads % mesh.model_size:
                    raise ValueError(
                        f"{m.num_heads} heads do not split over "
                        f"{mesh.model_size} model ranks")
                m.head_offset = (mesh.model_index * m.num_heads
                                 // mesh.model_size)
    model.tp_plan = plan
    return plan


def zero_dims(model: nn.Module, mesh: Mesh, zero: bool) -> List[Optional[int]]:
    """Per parameter (in order), the dim of its local shape whose slices the
    data ranks own the moments of under ZeRO-1 (``_zero_extend`` after the
    TP rule), or None: replicated moments, every rank updates the whole."""
    plan = getattr(model, "tp_plan", None) or {}
    dp = mesh.data_size
    out = []
    for name, p in model.named_parameters():
        if not zero or dp == 1 or p.ndim == 0:
            out.append(None)
            continue
        spec = [None] * p.ndim
        if plan.get(name) is not None:
            spec[plan[name]] = MODEL_AXIS
        out.append(_spec_dim(_zero_extend(tuple(spec), p.shape, dp),
                             DATA_AXIS))
    return out


def zero_slices(tensors, dims, mesh: Mesh) -> List[torch.Tensor]:
    """The views of ``tensors`` this data rank owns under ``dims``."""
    return [_slice(t, d, mesh.data_index, mesh.data_size)
            for t, d in zip(tensors, dims)]


@torch.no_grad()
def broadcast_zero_slices(params, dims, mesh: Mesh) -> None:
    """After a ZeRO-1 update: each data rank's slice goes to the others."""
    for p, d in zip(params, dims):
        if d is None:
            continue
        for i, src in enumerate(mesh.data_ranks):
            broadcast_(_slice(p.data, d, i, mesh.data_size), src,
                       mesh.data_group)


@torch.no_grad()
def gather_param(t: torch.Tensor, tp: Optional[int], zero: Optional[int],
                 mesh: Mesh) -> torch.Tensor:
    """A whole (unsharded) copy of a local leaf: its ZeRO slices gathered
    over the data group, then its TP shards over the model group."""
    if zero is not None:
        t = gather_dim(t, zero, mesh.data_group, mesh.data_index,
                       mesh.data_size)
    if tp is not None:
        t = gather_dim(t, tp, mesh.model_group, mesh.model_index,
                       mesh.model_size)
    return t


def shard_batch(batch: Dict, mesh: Mesh) -> Tuple[Dict, int, int]:
    """This data rank's rows of a batch (arrays or tensors), and (offset,
    total): ``_shard_batch``'s split over the data group, or the whole
    batch on every rank when it does not divide."""
    first = next(iter(batch.values()))
    total = int(first.shape[0])
    dp = mesh.data_size
    if dp == 1 or total % dp:
        return batch, 0, total
    n = total // dp
    off = mesh.data_index * n
    return {k: v[off:off + n] for k, v in batch.items()}, off, total

