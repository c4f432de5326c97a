"""The collectives of data and tensor parallelism, written out.

Port of what XLA inserts from the JAX package's shardings
(``rtts/parallel/``): here every collective is a call a reader can see.

- ``copy_to_model`` / ``reduce_from_model``: the Megatron pair that makes
  tensor parallelism train.  The first is the identity forward and an
  all-reduce of the gradient over the model group backward (the input of a
  column-sharded projection); the second all-reduces forward (the output
  of a row-sharded projection) and is the identity backward.
- ``psum``: a sum over a group outside autograd (loss denominators, metric
  and gradient reductions).
- ``gather_dim``: a group's shards concatenated along one dim, written as
  an all-reduce of zero-padded copies, because gloo reduces and broadcasts
  CUDA tensors but gathers none.
- ``batch_shard``: where this rank's batch rows sit in the global batch, so
  that dropout draws the one-device mask and keeps its rows
  (``rtts_torch.nn.layers.dropout``) and the flash kernels hash the global
  row.

The collectives of sequence and pipeline parallelism, which autograd
passes through (``rtts_torch/parallel/seq_parallel.py``, ``pipeline.py``);
each takes an ``Axis`` (``mesh.mesh_axis``):

- ``seq_enter``: a rank's rows of a replicated tensor, with the weights its
  rows go through; backward, the rows' cotangents gathered over the group
  and the weights' summed (each rank computed a part of them), in one
  all-reduce.
- ``gather_seq``: the shards concatenated; backward, the cotangent summed
  over the group, then this rank's rows (keys and values gathered for
  rank-local queries get a different cotangent on each rank).
- ``gather_rows``: the shards concatenated; backward, this rank's rows of
  the cotangent alone (every rank goes on to compute the same thing from
  the whole tensor, so the cotangents are equal).
- ``hop``: the reference's neighbour ``ppermute``: each rank receives the
  tensor of the rank ``shift`` before it; backward, the reverse hop.
- ``scale_grad``: the identity forward; backward, the cotangent times a
  constant (a weight whose gradient a split sublayer sums over a group
  that the data group's gradient sum covers again).

Backends: a gather is an all-reduce of zero-padded copies on either
backend.  A hop under nccl is ``dist.batch_isend_irecv``, one send and one
receive.  gloo sends no CUDA tensor, so under gloo a hop is an all-reduce
of a (size, ...) buffer in which each rank fills its own slot: every rank
then holds every rank's tensor, so the ring's memory bound (one
neighbour's shard in flight) is lost, while the result stays the same.

Every function is the identity, or the plain value, for a group of None
(one rank).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_BATCH_SHARD: Tuple[int, Optional[int]] = (0, None)
_BATCH_GROUP = None


@contextlib.contextmanager
def batch_shard(offset: int, total: int, group=None):
    """Within the block, a batch tensor of fewer than ``total`` rows holds
    rows ``offset``.. of a global batch of ``total``, split over the data
    group ``group``."""
    global _BATCH_SHARD, _BATCH_GROUP
    prev = _BATCH_SHARD, _BATCH_GROUP
    _BATCH_SHARD, _BATCH_GROUP = (int(offset), int(total)), group
    try:
        yield
    finally:
        _BATCH_SHARD, _BATCH_GROUP = prev


def batch_shard_state() -> Optional[Tuple[int, int, object]]:
    """The ambient ``batch_shard`` as (offset, total, group), or None: a
    reversible backward's recompute re-enters it, since it may run after
    the caller left the block."""
    off, total = _BATCH_SHARD
    return None if total is None else (off, total, _BATCH_GROUP)


def current_batch_shard(rows: int) -> Tuple[int, int]:
    """(offset, total) of a batch of ``rows`` rows: (0, rows) outside
    ``batch_shard`` or when the batch is whole (replicated)."""
    off, total = _BATCH_SHARD
    if total is None or rows == total:
        return 0, rows
    return off, total


def batch_all(flags: torch.Tensor) -> torch.Tensor:
    """0-dim bool: every flag of the whole batch is set (the data group's
    flags too, inside ``batch_shard``)."""
    out = flags.all()
    if _BATCH_GROUP is None:
        return out
    return _reduce(out.to(torch.int32), _BATCH_GROUP,
                   dist.ReduceOp.MIN).bool()


def _reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``t`` in place (f32 for floats narrower than f32, so a
    gloo group takes bf16 too); returns it."""
    if group is None:
        return t
    if t.is_floating_point() and t.dtype != torch.float32 \
            and t.dtype != torch.float64:
        wide = t.float()
        dist.all_reduce(wide, op=op, group=group)
        t.copy_(wide)
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


@torch.no_grad()
def psum(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group``, outside autograd."""
    return _reduce(t.detach().clone(), group, op)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    if group is None or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` all-reduced over ``group``; the gradient passes unchanged."""
    if group is None:
        return x
    if not torch.is_grad_enabled():
        return _reduce(x.contiguous().clone(), group)
    return _ReduceFromModel.apply(x, group)


@torch.no_grad()
def all_reduce_flat(tensors, group) -> None:
    """Sum a list of tensors over ``group`` in place, as one f32 buffer
    (one collective, whatever the count)."""
    tensors = [t for t in tensors]
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


@torch.no_grad()
def gather_dim(t: torch.Tensor, dim: int, group, index: int,
               size: int) -> torch.Tensor:
    """The ``size`` equal shards of ``group`` (this rank's is ``t``, at
    ``index``) concatenated along ``dim``: each rank writes its shard into
    zeros of the whole and the group sums them, exactly."""
    if group is None or size == 1:
        return t.detach().clone()
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * size
    dtype = t.dtype if t.dtype in (torch.float32, torch.float64,
                                   torch.int32, torch.int64) \
        else torch.float32
    full = torch.zeros(shape, dtype=dtype, device=t.device)
    full.narrow(dim, index * n, n).copy_(t)
    dist.all_reduce(full, group=group)
    return full.to(t.dtype)


@torch.no_grad()
def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s copy, in place."""
    if group is None:
        return t
    narrow = t.is_floating_point() and t.dtype not in (torch.float32,
                                                       torch.float64)
    buf = t.float() if narrow else t.contiguous()
    dist.broadcast(buf, src=src, group=group)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(buf)
    return t


# -- sequence and pipeline parallelism -----------------------------------------


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a dtype every backend reduces (f32 for narrow floats)."""
    if t.dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
        return t.contiguous()
    return t.float() if t.is_floating_point() else t.long()


def _rows(t: torch.Tensor, dim: int, ax) -> torch.Tensor:
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n).contiguous()


class _SeqEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, *weights):
        ctx.dim, ctx.ax = dim, ax
        ctx.wmeta = [(w.shape, w.dtype) for w in weights]
        return (_rows(x, dim, ax),) + tuple(w.view_as(w) for w in weights)

    @staticmethod
    def backward(ctx, g, *gw):
        ax, dim = ctx.ax, ctx.dim
        n = g.shape[dim]
        shape = list(g.shape)
        shape[dim] = n * ax.size
        full = torch.zeros(shape, dtype=torch.float32, device=g.device)
        full.narrow(dim, ax.index * n, n).copy_(g)
        gw = [torch.zeros(shape, dtype=dt, device=g.device) if t is None
              else t for t, (shape, dt) in zip(gw, ctx.wmeta)]
        flat = torch.cat([full.reshape(-1)] + [t.reshape(-1).float()
                                               for t in gw])
        dist.all_reduce(flat, group=ax.group)
        dx = flat[:full.numel()].view(shape).to(g.dtype)
        out, i = [], full.numel()
        for t in gw:
            out.append(flat[i:i + t.numel()].view_as(t).to(t.dtype))
            i += t.numel()
        return (dx, None, None) + tuple(out)


def seq_enter(x: torch.Tensor, weights, dim: int, ax):
    """-> (this rank's rows of ``x`` along ``dim``, *weights): the rows'
    gradient is gathered over the group and the weights' summed, in one
    all-reduce."""
    if ax.group is None:
        return (x,) + tuple(weights)
    return _SeqEnter.apply(x, dim, ax, *weights)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, summed):
        ctx.dim, ctx.ax, ctx.summed = dim, ax, summed
        return gather_dim(x, dim, ax.group, ax.index, ax.size)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _reduce(g.contiguous().clone(), ctx.ax.group)
        return _rows(g, ctx.dim, ctx.ax), None, None, None


def gather_seq(x: torch.Tensor, dim: int, ax) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``; backward,
    the cotangent summed over the group, then this rank's rows."""
    if ax.group is None:
        return x
    return _GatherSeq.apply(x, dim, ax, True)


def gather_rows(x: torch.Tensor, dim: int, ax) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``; backward,
    this rank's rows of the (replicated) cotangent."""
    if ax.group is None:
        return x
    return _GatherSeq.apply(x, dim, ax, False)


def _hop(t: torch.Tensor, ax, shift: int) -> torch.Tensor:
    """The ``t`` of rank (index - shift) mod size, outside autograd."""
    size = ax.size
    src, dst = (ax.index - shift) % size, (ax.index + shift) % size
    if ax.backend == "nccl":
        out = torch.empty_like(t)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t.contiguous(), ax.ranks[dst], ax.group),
            dist.P2POp(dist.irecv, out, ax.ranks[src], ax.group)])
        for r in reqs:
            r.wait()
        return out
    wide = _wide(t)
    buf = torch.zeros((size,) + tuple(t.shape), dtype=wide.dtype,
                      device=t.device)
    buf[ax.index].copy_(wide)
    dist.all_reduce(buf, group=ax.group)
    return buf[src].to(t.dtype)


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, shift):
        ctx.ax, ctx.shift = ax, shift
        return _hop(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, ctx.ax, -ctx.shift), None, None


def hop(x: torch.Tensor, ax, shift: int = 1) -> torch.Tensor:
    """Each rank receives the ``x`` of the rank ``shift`` before it on the
    ring (``ppermute`` with perm [(j, j + shift)]); backward, the reverse
    hop.  Outside autograd (no_grad, or ``x`` needing no gradient) it is
    the plain hop."""
    if ax.group is None or ax.size == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _hop(x, ax, shift)
    return _Hop.apply(x, ax, shift)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x``; its gradient times ``scale``."""
    if scale == 1.0 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ScaleGrad.apply(x, scale)
