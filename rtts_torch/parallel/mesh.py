"""Process groups and multi-process init: port of ``rtts/parallel/mesh.py``.

The JAX package builds one SPMD mesh over its devices, (data, model) or
(dcn, data, model), and XLA places the collectives.  Here each rank is a
process with one device (``cuda:(local_rank % device_count)``, or the
CPU), and the mesh is that rank's view of the same layout: the data group
(every rank with its model coordinate; ``dcn`` folds into it, outermost,
as the reference's batch axes do), the model group (every rank with its
data coordinate; innermost, so consecutive ranks share a model group), the
sizes and this rank's coordinates.

Backend rule, printed at init and never caught: ``nccl`` when every rank
of a host has a card of its own, ``gloo`` otherwise (ranks that share one
card included) and on the CPU.  gloo's CUDA collectives are all-reduce and
broadcast, so under gloo the port uses only those two
(``rtts_torch/parallel/collectives.py``).

The ambient mesh: the reference's sequence-parallel and pipelined stacks
read the mesh the caller entered (``with mesh:``, ``current_mesh``).  A
port ``Mesh`` is a context manager too: ``with mesh:`` makes it the one
``current_mesh()`` returns, which ``MeshTraining``'s step, the trainers and
``Synthesizer(mesh=...)`` enter; ``mesh_axis`` returns any of its axes
(its group, this rank's index, the size, the ranks, and whether the batch
rides it) and raises the reference's ValueError when no mesh with the
axis is active.  With ``dcn`` > 1 the inner ``data`` axis and the ``dcn``
axis each get groups of their own; ``data_group`` spans both.
``shutdown_distributed`` destroys the process group
``initialize_distributed`` started.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from rtts_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"

_initialized = False


def should_initialize(cfg: Optional[MeshConfig] = None,
                      env: Optional[dict] = None) -> bool:
    """Decide whether the process group must be started (the reference's
    rule, copied).

    The signal is explicit: a coordinator address / process count in the
    MeshConfig, or the ``RTTS_MULTIHOST=1`` env opt-in (which defers to the
    launcher's variables).  Generic cluster env vars are deliberately NOT
    sniffed: a WORLD_SIZE alone starts nothing.
    """
    env = os.environ if env is None else env
    if cfg is not None and (cfg.coordinator_address or cfg.num_processes > 1):
        return True
    return env.get("RTTS_MULTIHOST", "") not in ("", "0")


def _env_int(env, key: str, default: int) -> int:
    value = env.get(key, "")
    return int(value) if value not in ("", None) else default


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK`` as
    ``torch.distributed.run`` sets it, else the global rank)."""
    return _env_int(os.environ, "LOCAL_RANK", global_rank())


def backend_for(device, local_world: int) -> str:
    """``nccl`` when each of a host's ``local_world`` ranks has a card of
    its own, else ``gloo`` (shared cards, and the CPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device="cuda") -> torch.device:
    """The device a rank runs on: ``cuda:(local_rank % device_count)`` for
    "cuda" without an index, else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def initialize_distributed(cfg: Optional[MeshConfig] = None,
                           device="cuda") -> None:
    """Start the process group (idempotent); a no-op in one process.

    ``coordinator_address`` (host:port, or a whole ``tcp://`` or
    ``file://`` init method), ``num_processes`` and ``process_id`` give the
    rendezvous, the world size and the rank; under ``RTTS_MULTIHOST=1``
    what the config leaves unset comes from ``torch.distributed.run``'s
    variables (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    Without either nothing starts: a WORLD_SIZE alone is not read."""
    global _initialized
    if _initialized or dist.is_initialized() or not should_initialize(cfg):
        return
    env = os.environ
    cfg = cfg or MeshConfig()
    if cfg.num_processes > 1:
        world, rank = cfg.num_processes, cfg.process_id
    else:
        world, rank = _env_int(env, "WORLD_SIZE", 1), _env_int(env, "RANK", 0)
    addr = cfg.coordinator_address
    if not addr:
        init_method = "env://"
    elif "://" in addr:
        init_method = addr
    else:
        init_method = f"tcp://{addr}"
    local_world = _env_int(env, "LOCAL_WORLD_SIZE", world)
    backend = backend_for(device, local_world)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _env_int(env, "LOCAL_RANK", rank)
                           % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"rtts_torch.parallel: rank {rank} of {world}, backend {backend}, "
          f"device {dev}", flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    _initialized = True


def shutdown_distributed() -> None:
    """Destroy the process group, if one is up (no barrier: a rank that
    failed never reaches one, and its peers would wait on it)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass
class Mesh:
    """One rank's view of the (dcn, data, model) layout.

    ``data_group``/``model_group`` are process groups, None where the size
    is 1; ``data_ranks``/``model_ranks`` the global ranks of this rank's
    groups, in coordinate order."""

    dcn: int
    dp: int
    mp: int
    rank: int
    data_index: int
    model_index: int
    data_ranks: List[int]
    model_ranks: List[int]
    data_group: object = None
    model_group: object = None
    backend: str = "none"
    axis_groups: dict = dataclasses.field(default_factory=dict)

    @property
    def data_size(self) -> int:
        """Ways the batch is split (dcn x data)."""
        return self.dcn * self.dp

    @property
    def model_size(self) -> int:
        return self.mp

    @property
    def shape(self) -> dict:
        out = {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}
        if self.dcn > 1:
            out = {DCN_AXIS: self.dcn, **out}
        return out

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's ``axis``, in coordinate order
        (``dcn`` outermost, then ``data``, then ``model``)."""
        if axis == MODEL_AXIS:
            return list(self.model_ranks)
        outer, inner = divmod(self.data_index, self.dp)
        if axis == DATA_AXIS:
            rows = [outer * self.dp + j for j in range(self.dp)]
        elif axis == DCN_AXIS:
            rows = [k * self.dp + inner for k in range(self.dcn)]
        else:
            raise ValueError(f"no mesh axis {axis!r}")
        return [i * self.mp + self.model_index for i in rows]

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.pop()

    def describe(self) -> str:
        return (f"mesh {'x'.join(str(v) for v in self.shape.values())} "
                f"({', '.join(self.axis_names)}), backend {self.backend}, "
                f"rank {self.rank}: data {self.data_index}, model "
                f"{self.model_index}")


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """This rank's ``Mesh`` for ``cfg`` over the process group's ranks.

    ``data_parallel`` -1 means world / (model_parallel x dcn_parallel), at
    least 1.  A
    mesh that needs more ranks than the world has raises the reference's
    ValueError; one that leaves ranks out raises too (each rank is a
    process that must take part).  Every rank must call this, in the same
    order, since it creates the groups."""
    cfg = cfg or MeshConfig()
    n = world_size()
    mp = max(1, cfg.model_parallel)
    dcn = max(1, cfg.dcn_parallel)
    dp = (cfg.data_parallel if cfg.data_parallel > 0
          else max(1, n // (mp * dcn)))
    if dcn * dp * mp > n:
        raise ValueError(
            f"mesh {dcn}x{dp}x{mp} needs {dcn * dp * mp} devices, have {n}")
    if dcn * dp * mp != n:
        raise ValueError(
            f"mesh {dcn}x{dp}x{mp} uses {dcn * dp * mp} of {n} ranks; every "
            "rank must belong to the mesh")
    rank = global_rank()
    data_index, model_index = divmod(rank, mp)
    model_ranks = [data_index * mp + j for j in range(mp)]
    data_ranks = [i * mp + model_index for i in range(dcn * dp)]
    data_group = model_group = None
    axis_groups = {}
    backend = dist.get_backend() if dist.is_initialized() else "none"
    if dist.is_initialized() and n > 1:
        # every rank creates every group, in one order
        for j in range(mp):
            ranks = [i * mp + j for i in range(dcn * dp)]
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if j == model_index:
                data_group = g
        for i in range(dcn * dp):
            ranks = [i * mp + j for j in range(mp)]
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if i == data_index:
                model_group = g
        if dcn > 1 and dp > 1:
            # the inner data axis and the dcn axis, each a part of the
            # data group, for a stack split over one of them
            outer, inner = divmod(data_index, dp)
            for j in range(mp):
                for k in range(dcn):
                    g = dist.new_group([(k * dp + i) * mp + j
                                        for i in range(dp)])
                    if (j, k) == (model_index, outer):
                        axis_groups[DATA_AXIS] = g
                for i in range(dp):
                    g = dist.new_group([(k * dp + i) * mp + j
                                        for k in range(dcn)])
                    if (j, i) == (model_index, inner):
                        axis_groups[DCN_AXIS] = g
    return Mesh(dcn=dcn, dp=dp, mp=mp, rank=rank, data_index=data_index,
                model_index=model_index, data_ranks=data_ranks,
                model_ranks=model_ranks, data_group=data_group,
                model_group=model_group, backend=backend,
                axis_groups=axis_groups)



_ACTIVE: List[Mesh] = []


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class Axis(NamedTuple):
    """One mesh axis as a rank sees it: its process group (None for one
    rank), this rank's index, the size, the global ranks in index order,
    the backend, and whether the batch rides it (``data`` and ``dcn``:
    inside ``batch_shard`` its ranks hold different rows of a split
    batch)."""

    group: object
    index: int
    size: int
    ranks: List[int]
    backend: str
    batch: bool = False


def mesh_axis(mesh: Optional[Mesh], axis: str, what: str) -> Axis:
    """``axis`` of ``mesh`` (the ambient one when None) for ``what``; the
    reference's ValueError when no mesh with the axis is active."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis not in mesh.shape:
        raise ValueError(
            f"{what} needs a Mesh with axis {axis!r}; enter one (`with "
            "mesh:`) or pass mesh= explicitly")
    if axis == MODEL_AXIS:
        return Axis(mesh.model_group, mesh.model_index, mesh.model_size,
                    list(mesh.model_ranks), mesh.backend)
    ranks = mesh.axis_ranks(axis)
    group = (mesh.data_group if len(ranks) == mesh.data_size
             else mesh.axis_groups.get(axis))
    return Axis(group if len(ranks) > 1 else None, ranks.index(mesh.rank),
                len(ranks), ranks, mesh.backend, batch=True)


def batch_axis(mesh: Optional[Mesh]) -> Axis:
    """Every axis the batch rides as one (the data group: ``dcn`` x
    ``data``), of ``mesh`` or the ambient one."""
    mesh = mesh if mesh is not None else current_mesh()
    return Axis(mesh.data_group, mesh.data_index, mesh.data_size,
                list(mesh.data_ranks), mesh.backend, batch=True)
