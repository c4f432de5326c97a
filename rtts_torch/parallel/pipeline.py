"""Pipeline parallelism for Reformer stacks over the model group: port of
``rtts/parallel/pipeline.py``.

The reference stacks the layer parameters in shard order, shard_maps them
over the pipe axis and runs one ``lax.scan`` of ``v * M + S - 1`` ticks:
at every tick each stage applies its layers to the activation pair it
holds, then the pair hops to the next stage (one neighbour ``ppermute``);
JAX differentiates the scan, so the backward is the reverse schedule.
Here each rank of the model group holds the stack whole and computes with
its stage's ``num_layers / S`` layers (device s holds chunks s, S + s, ...
of ``u_chunk`` layers each, lap-major, as the reference stacks them), and
the schedule is written out in both directions (``_Schedule``):

- forward: the reference's ticks; a tick whose microbatch index is not a
  real one (fill and drain) computes nothing and passes its input on;
  the last stage's outputs are summed over the group (every rank returns
  the whole stack output);
- backward (an ``autograd.Function``): the ticks in reverse, the cotangent
  of each tick's activation pair hopping back one stage, each real tick
  differentiated through its own graph; then one all-reduce sums, over the
  group, the layers' gradients (each rank computed its stage's, the others
  are zeros), the input's (stage 0's) and the memory's (every stage's
  cross-attention takes part).  Every rank runs every tick and every hop
  in the same order, so no rank waits on a collective another never
  issues, which autograd's rank-local graph pruning could not promise.
- ``pipeline_remat``: a stage tick keeps its inputs only and runs again,
  with autograd, when the backward reaches it: what non-reentrant
  ``torch.utils.checkpoint`` does, written into the backward that already
  visits each tick (that function's first call imports ``torch._dynamo``:
  a rank's first pipelined base.yaml step took 24.5 s with it and 7.7 s
  without, on an NVIDIA H100 80GB HBM3 at 700 W).  The recompute replays
  the dropout masks through the stack's replayable generator states.

Draws.  The port's dropout uses generators, not keys: under dropout each
(microbatch, pair) gets a generator and a kernel seed of its own, drawn
from the step's generator once before the first tick, so microbatches draw
different masks, deterministically given that generator.  The LSH
rotations are drawn once per layer, in layer order, before the first tick,
and every microbatch hashes with its layer's: at dropout 0 the draws are
the sequential path's (which then draws nothing else from the generator).

A pipeline over an axis the batch rides (``data``, ``dcn``) raises
NotImplementedError: the reference's puts its stages and its batch on one
axis, and its output there is not the one-device output
(``tests/test_torch_parallel_seq.py::
test_pipeline_over_the_data_axis_is_refused``).

Refusals, the reference's, with its exception types and conditions:
``seq_parallel_axis`` together with ``pipeline_axis``; ``reversible:
true``; non-uniform attention kinds; ``num_layers`` not dividing over the
stages, or over ``pipeline_interleave`` x stages; microbatches not a
multiple of the stages when ``v > 1``; a global batch that does not divide
into ``dp x M``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from rtts_torch.config import ReformerStackConfig, resolve_attention_kind
from rtts_torch.parallel import collectives as C
from rtts_torch.parallel.collectives import (_reduce, all_reduce_flat,
                                             batch_shard, current_batch_shard,
                                             hop)
from rtts_torch.parallel.mesh import MODEL_AXIS, current_mesh, mesh_axis

_WHAT = "pipeline parallelism"


def check_pipeline(cfg: ReformerStackConfig, kinds: List[str], batch: int,
                   mesh=None):
    """The reference's refusals -> (axis, stages S, interleave v,
    microbatches M, layers a chunk).  ``batch`` is the global batch."""
    axis = cfg.pipeline_axis
    mesh = mesh if mesh is not None else current_mesh()
    ax = mesh_axis(mesh, axis, _WHAT)
    if ax.batch:
        raise NotImplementedError(
            f"rtts_torch: {_WHAT} over the {axis!r} axis, which the batch "
            "rides too (the reference's _batch_axes); the reference's own "
            "pipeline there does not give the one-device result, so the "
            f"port pipelines over the {MODEL_AXIS!r} axis only")
    if cfg.seq_parallel_axis:
        raise ValueError(
            "pipeline_axis and seq_parallel_axis are mutually exclusive "
            "per stack (both consume the model axis)")
    if cfg.reversible is True:
        raise ValueError(
            "pipeline stages run plain two-stream residuals (activation "
            "memory is bounded per tick by pipeline_remat, so reversible "
            "reconstruction buys nothing across stages); set "
            "reversible: auto or false on a pipelined stack")
    if len(set(kinds)) > 1:
        raise ValueError(
            "pipeline parallelism requires a uniform attention kind "
            f"(stages share one stacked parameter tree); got {kinds}")
    s = ax.size
    n_units = cfg.num_layers
    if n_units % s:
        raise ValueError(
            f"num_layers ({n_units}) must divide over {s} pipeline "
            f"stages on axis {axis!r}")
    v = max(1, cfg.pipeline_interleave)
    if n_units % (v * s):
        raise ValueError(
            f"num_layers ({n_units}) must divide over "
            f"pipeline_interleave ({v}) x {s} stages "
            f"= {v * s} layer chunks")
    n_micro = cfg.pipeline_microbatches or s
    if v > 1 and n_micro % s:
        raise ValueError(
            f"pipeline_interleave={v} injects microbatches in groups of "
            f"the stage count; pipeline_microbatches ({n_micro}) must be "
            f"a multiple of {s}")
    dp = mesh.data_size
    if batch % (dp * n_micro):
        raise ValueError(
            f"batch {batch} must divide into {n_micro} microbatches per "
            f"data-parallel rank (dp={dp})")
    return ax, s, v, n_micro, n_units // (v * s)


def _tick(t: int, rank: int, s: int, v: int):
    """-> (lap, microbatch m, inject, last chunk) of tick t on ``rank``:
    microbatch m enters chunk c at tick m' + c, m' = (m // S) v S + m % S
    (groups of S injected at consecutive ticks every v S ticks)."""
    t_rel = t - rank
    if v == 1:
        return 0, t_rel, rank == 0, True
    phi = t_rel % (v * s)
    lap = phi // s
    m = ((t_rel - phi) // (v * s)) * s + phi % s
    return lap, m, rank == 0 and lap == 0, lap == v - 1


class _Schedule:
    """One pipelined stack call on this rank: the stage ticks, forward and
    backward."""

    def __init__(self, stack, cfg, layer_fns, aux, ax, s, v, n_micro,
                 u_chunk, ppu, mask, memory_mask, b_off, b_total):
        self.stack, self.cfg, self.fns, self.aux = stack, cfg, layer_fns, aux
        self.ax, self.s, self.v, self.m = ax, s, v, n_micro
        self.u_chunk, self.ppu = u_chunk, ppu
        self.mask, self.memory_mask = mask, memory_mask
        self.b_off, self.b_total = b_off, b_total
        self.group = C._BATCH_GROUP
        self.n_ticks = v * n_micro + s - 1

    def units(self, lap: int) -> List[int]:
        """The layers this rank applies on ``lap``, in order."""
        first = (lap * self.s + self.ax.index) * self.u_chunk
        return list(range(first, first + self.u_chunk))

    def stage(self, h: torch.Tensor, memory: Optional[torch.Tensor], m: int,
              lap: int) -> torch.Tensor:
        """The stage's layers on microbatch m's pair h (2, mb, L, D)."""
        mb = h.shape[1]
        rows = slice(m * mb, (m + 1) * mb)
        mask = None if self.mask is None else self.mask[rows]
        mm = None if self.memory_mask is None else self.memory_mask[rows]
        h1, h2 = h[0], h[1]
        with batch_shard(self.b_off + m * mb, self.b_total, self.group):
            for u in self.units(lap):
                for j in range(self.ppu):
                    i = u * self.ppu + j
                    f, g = self.fns[i]
                    p = self.stack.layers[i]
                    aux = dict(self.aux[m][i], mask=mask, memory_mask=mm)
                    h1 = h1 + f(p.f, h2, memory, aux, None)[0]
                    h2 = h2 + g(p.g, h1, memory, aux)
        return torch.stack([h1, h2])

    def params(self, lap: int) -> List[torch.Tensor]:
        out = []
        for u in self.units(lap):
            for j in range(self.ppu):
                out += list(self.stack.layers[u * self.ppu + j].parameters())
        return out

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor],
                keep_graphs: bool) -> torch.Tensor:
        """-> (B, L, D) f32, the two-stream mean, whole on every rank.
        ``keep_graphs`` records each real tick's (input, memory, output)
        for ``backward``."""
        b = x.shape[0]
        mb = b // self.m
        micro = x.float().reshape((self.m, mb) + x.shape[1:])
        recv = torch.zeros((2,) + micro.shape[1:], device=x.device)
        out = torch.zeros_like(micro)
        self.graphs: Dict[int, tuple] = {}
        rank = self.ax.index
        for t in range(self.n_ticks):
            lap, m, inject, last = _tick(t, rank, self.s, self.v)
            real = 0 <= m < self.m
            inp = torch.stack([micro[m], micro[m]]) if inject and real \
                else recv
            h = inp
            if real:
                mem = (None if memory is None
                       else memory[m * mb:(m + 1) * mb])
                if keep_graphs and not self.cfg.pipeline_remat:
                    with torch.enable_grad():
                        inp_d = inp.detach().requires_grad_()
                        mem_d = (None if mem is None
                                 else mem.detach().requires_grad_())
                        h = self.stage(inp_d, mem_d, m, lap)
                    self.graphs[t] = (inp_d, mem_d, h)
                    h = h.detach()
                else:
                    h = self.stage(inp, mem, m, lap)
                    if keep_graphs:   # remat: the inputs alone
                        self.graphs[t] = (inp, mem, None)
                if last and rank == self.s - 1:
                    out[m] = (h[0] + h[1]) * 0.5
            if t < self.n_ticks - 1:
                recv = hop(h, self.ax)
        # only the last stage's buffer holds outputs: sum it over the group
        if rank != self.s - 1:
            out.zero_()
        return _reduce(out, self.ax.group).reshape(x.shape)

    def backward(self, gy: torch.Tensor, x: torch.Tensor,
                 memory: Optional[torch.Tensor], params: List[torch.Tensor]):
        """-> (dx, dmemory, dparams) summed over the group; ``gy`` is the
        cotangent of ``forward``'s output (the same on every rank)."""
        b = x.shape[0]
        mb = b // self.m
        g_out = gy.float().reshape((self.m, mb) + x.shape[1:])
        dx = torch.zeros_like(g_out)
        dmem = None if memory is None else torch.zeros_like(memory)
        index = {id(p): k for k, p in enumerate(params)}
        dparams = [torch.zeros_like(p) for p in params]
        rank = self.ax.index
        g_in = torch.zeros((2,) + g_out.shape[1:], device=gy.device)
        for t in reversed(range(self.n_ticks)):
            lap, m, inject, last = _tick(t, rank, self.s, self.v)
            g_h = (hop(g_in, self.ax, -1) if t < self.n_ticks - 1
                   else torch.zeros_like(g_in))
            g_in = torch.zeros_like(g_in)
            if not 0 <= m < self.m:
                continue
            if last and rank == self.s - 1:
                g_h = g_h + 0.5 * g_out[m]
            inp_d, mem_d, h = self.graphs.pop(t)
            if h is None:     # remat: run the tick again, with autograd
                with torch.enable_grad():
                    inp_d = inp_d.detach().requires_grad_()
                    mem_d = (None if mem_d is None
                             else mem_d.detach().requires_grad_())
                    h = self.stage(inp_d, mem_d, m, lap)
            used = self.params(lap)
            wrt = [inp_d] + ([mem_d] if mem_d is not None else []) + used
            grads = torch.autograd.grad(h, wrt, g_h, allow_unused=True)
            if inject:
                dx[m] += grads[0][0] + grads[0][1]
            else:
                g_in = grads[0]
            k = 1
            if mem_d is not None:
                dmem[m * mb:(m + 1) * mb] += grads[1]
                k = 2
            for p, g in zip(used, grads[k:]):
                if g is not None:
                    dparams[index[id(p)]] += g
        flat = [dx] + ([dmem] if dmem is not None else []) + dparams
        all_reduce_flat(flat, self.ax.group)
        return (dx.reshape(x.shape).to(x.dtype), dmem,
                [g.to(p.dtype) for g, p in zip(dparams, params)])


class _Pipelined(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, memory, *params):
        ctx.sched = sched
        ctx.save_for_backward(x, memory)
        ctx.params = params
        return sched.forward(x, memory, keep_graphs=True)

    @staticmethod
    def backward(ctx, gy):
        x, memory = ctx.saved_tensors
        dx, dmem, dparams = ctx.sched.backward(gy, x, memory,
                                               list(ctx.params))
        return (None, dx, dmem) + tuple(dparams)


def pipeline_stack_apply(stack, cfg: ReformerStackConfig, x: torch.Tensor,
                         mask: Optional[torch.Tensor],
                         memory: Optional[torch.Tensor],
                         memory_mask: Optional[torch.Tensor],
                         compute_dtype, generator: Optional[torch.Generator],
                         mesh=None) -> torch.Tensor:
    """Run ``stack.layers`` as a pipeline over ``cfg.pipeline_axis``.

    x (B, L, D) is this data rank's batch, whole on every rank of the model
    group.  Returns the two-stream mean (B, L, D) in float32 (the caller
    applies the final LN, as after ``reversible_sequence``)."""
    from rtts_torch.attention.lsh import auto_num_buckets, draw_rotations
    from rtts_torch.models.stack import _layer_kinds, make_stack_layer_fns

    kinds = _layer_kinds(cfg)
    b, l, _ = x.shape
    b_off, b_total = current_batch_shard(b)
    ax, s, v, n_micro, u_chunk = check_pipeline(cfg, kinds, b_total, mesh)
    cross = memory is not None
    ppu = 2 if cross else 1
    layer_fns = make_stack_layer_fns(cfg, cross, compute_dtype)
    n_pairs = len(layer_fns)
    a = cfg.attention
    dev = x.device

    # LSH rotations: one draw per layer, in layer order (the sequential
    # path's order), shared by the microbatches
    rotations: List[Optional[torch.Tensor]] = [None] * n_pairs
    hash_gen = generator
    resolved = [resolve_attention_kind(a, l) if k == "auto" else k
                for k in kinds]
    if "lsh" in resolved and l > a.chunk_length:
        if hash_gen is None:
            hash_gen = torch.Generator(device=dev).manual_seed(0)
        nb = a.num_buckets or auto_num_buckets(l, a.chunk_length)
        half = sum([nb] if isinstance(nb, int) else list(nb)) // 2
        for u, k in enumerate(resolved):
            if k == "lsh":
                gen = hash_gen
                if a.hash_seed is not None:
                    gen = torch.Generator(device=dev).manual_seed(a.hash_seed)
                rotations[u * ppu] = draw_rotations(
                    a.num_heads, a.head_dim, a.num_hashes, half, gen, dev)

    # dropout: a generator and a kernel seed per (microbatch, pair)
    drop = generator is not None and (cfg.dropout > 0.0
                                      or a.attention_dropout > 0.0)
    seeds = gens = None
    if drop:
        seeds = torch.randint(0, 1 << 32, (n_micro, n_pairs),
                              generator=generator, device=dev).tolist()
        gens = torch.randint(0, 1 << 62, (n_micro, n_pairs),
                             generator=generator, device=dev).tolist()
    aux = [[{"generator": (None if gens is None else
                           torch.Generator(device=dev).manual_seed(
                               gens[m][i])),
             "hash_generator": None, "rotations": rotations[i],
             "seed": (None if seeds is None or a.attention_dropout == 0.0
                      else seeds[m][i]),
             "gen_states": [None] * 3}
            for i in range(n_pairs)] for m in range(n_micro)]
    sched = _Schedule(stack, cfg, layer_fns, aux, ax, s, v, n_micro, u_chunk,
                      ppu, mask, memory_mask, b_off, b_total)
    params = [p for layer in stack.layers for p in layer.parameters()]
    needs = torch.is_grad_enabled() and (
        x.requires_grad or (cross and memory.requires_grad)
        or any(p.requires_grad for p in params))
    if not needs:
        return sched.forward(x, memory, keep_graphs=False)
    return _Pipelined.apply(sched, x, memory, *params)
