"""Reformer stacks: attention and FFN sublayers wired as (f, g) residual pairs.

Port of ``rtts/models/stack.py``: self-attention kinds ``full``, ``lsh``
and ``local`` (per layer through ``attn_layers``; ``auto`` resolves by
length).
Encoder layer = one pair (f = self-attention, g = FFN); decoder layer = two
pairs, (self-attention, FFN) then (cross-attention, FFN).  Parameter paths
repeat the JAX pytree's, e.g. ``layers.0.f.attn.w_qk.w``.  All sublayers
are pre-LN; residual streams ride in float32 while sublayers run in the
compute dtype.

Training: given a ``generator`` (on the stream's device) the stack applies
``cfg.dropout`` after every f and g and the attention dropout, with one
kernel seed per pair drawn from the generator.  The stack dropout and the
naive attention path's dropout draw from the generator itself, and each
sublayer keeps the state it drew from, so the reversible backward replays
every mask exactly and draws nothing.  Without a generator it is the
deterministic inference stack.  LSH layers
draw their random rotations from the same generator, or, without one, from
a device generator seeded 0 that the stack's layers consume in turn
(``cfg.attention.hash_seed`` fixes them per layer instead); each returns
its buckets as the cache the reversible backward replays.

Residuals per ``resolve_reversible``: reversible (``rtts_torch/reversible/
rev.py``, activation memory constant in depth) or plain; the FFN chunked
per ``resolve_ffn_chunk``, or fused into K6 when ``cfg.use_pallas_ffn`` is
set and the stream is on the card.

Over the model group of the ambient mesh (``with mesh:``), as the
reference dispatches: ``seq_parallel_axis`` sends full and LSH
self-attention longer than one chunk to ``rtts_torch/parallel/
seq_parallel.py`` (each rank attends its rows, the stream stays whole on
every rank); ``pipeline_axis`` runs the layers as a pipeline
(``rtts_torch/parallel/pipeline.py``), then the final LayerNorm, and
refuses the guided-attention capture.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import nn

from rtts_torch.attention.full import (Attention, cross_attention,
                                       shared_qk_self_attention)
from rtts_torch.attention.local import local_self_attention
from rtts_torch.attention.lsh import lsh_self_attention
from rtts_torch.config import (ReformerStackConfig, resolve_attention_kind,
                               resolve_ffn_chunk, resolve_reversible)
from rtts_torch.nn.layers import LayerNorm, dropout
from rtts_torch.ops.chunked_ffn import chunked_ffn_fused
from rtts_torch.ops.flash_attention import resolve_flash_impl
from rtts_torch.parallel.collectives import batch_shard, batch_shard_state
from rtts_torch.parallel.mesh import current_mesh
from rtts_torch.parallel.pipeline import pipeline_stack_apply
from rtts_torch.parallel.seq_parallel import (
    full_self_attention_seq_parallel, lsh_self_attention_seq_parallel)
from rtts_torch.reversible.ffn import FFN, chunked_ffn
from rtts_torch.reversible.rev import reversible_sequence


class AttnSublayer(nn.Module):
    def __init__(self, d_model: int, a, shared_qk: bool, *, generator=None,
                 device=None):
        super().__init__()
        self.ln = LayerNorm(d_model, device=device)
        self.attn = Attention(d_model, a.num_heads, a.head_dim, shared_qk,
                              generator=generator, device=device)


class Pair(nn.Module):
    """One residual pair: ``f`` (attention sublayer) and ``g`` (FFN)."""

    def __init__(self, cfg: ReformerStackConfig, shared_qk: bool, *,
                 generator=None, device=None):
        super().__init__()
        self.f = AttnSublayer(cfg.d_model, cfg.attention, shared_qk,
                              generator=generator, device=device)
        self.g = FFN(cfg.d_model, cfg.d_ff, generator=generator, device=device)


class Stack(nn.Module):
    """Parameters of one stack (the ``stack_init`` layout): per layer a
    self-attention pair, and for a decoder a cross-attention pair after it."""

    def __init__(self, cfg: ReformerStackConfig, cross_attend: bool, *,
                 generator=None, device=None):
        super().__init__()
        kinds = [True, False] if cross_attend else [True]
        self.layers = nn.ModuleList(
            Pair(cfg, shared_qk, generator=generator, device=device)
            for _ in range(cfg.num_layers) for shared_qk in kinds)
        self.final_ln = LayerNorm(cfg.d_model, device=device)


def _layer_kinds(cfg: ReformerStackConfig) -> List[str]:
    """Per-layer self-attention kinds (interleaved attn_layers support)."""
    if cfg.attn_layers is None:
        return [cfg.attention.kind] * cfg.num_layers
    if len(cfg.attn_layers) != cfg.num_layers:
        raise ValueError(
            f"attn_layers has {len(cfg.attn_layers)} entries for "
            f"{cfg.num_layers} layers")
    for k in cfg.attn_layers:
        if k not in ("full", "lsh", "local", "auto"):
            raise ValueError(f"unknown attention kind {k!r} in attn_layers")
    return list(cfg.attn_layers)


def _check_supported(cfg: ReformerStackConfig, seq_len: int,
                     capture: bool = False) -> List[str]:
    """-> the layers' kinds with ``auto`` resolved at ``seq_len``.
    ``capture`` (cross-attention probabilities wanted) raises the
    reference's ValueError under a pipeline."""
    if capture and cfg.pipeline_axis:
        raise ValueError(
            "guided attention (attn_sink) cannot capture cross-attention "
            "probabilities through the pipeline scan; disable "
            "pipeline_axis or guided_attention_weight for this stack")
    return [resolve_attention_kind(cfg.attention, seq_len) if k == "auto"
            else k for k in _layer_kinds(cfg)]


def use_ffn_kernel(x: torch.Tensor) -> bool:
    """The gate of K6 for a stack with ``use_pallas_ffn`` (the port's
    counterpart of the reference's TPU gate): the stream is on the card."""
    return x.is_cuda


def make_stack_layer_fns(cfg: ReformerStackConfig, cross_attend: bool,
                         compute_dtype) -> List[Tuple[Any, Any]]:
    """The (f, g) callables of one stack; aux per pair is dict(mask,
    memory_mask, generator, hash_generator, seed, gen_states[, mesh,
    rotations, attn_sink]).  ``generator`` None means no dropout; ``hash_generator``
    draws the LSH rotations; ``seed`` (None: no attention dropout) is the
    pair's kernel seed; ``gen_states`` ([None] * 3) receives the
    generator's state before the naive attention dropout and f's and g's
    stack dropout."""
    a = cfg.attention
    impl = resolve_flash_impl(a.flash)
    kinds = _layer_kinds(cfg)
    mxu = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32

    def replayable(aux, which, device):
        # the step's generator, its state kept at the first call; a
        # recompute (the reversible backward) draws from that state again
        gen, states = aux["generator"], aux["gen_states"]
        if gen is None:
            return None
        if states[which] is None:
            states[which] = gen.get_state()
            return gen
        replay = torch.Generator(device=device)
        replay.set_state(states[which])
        return replay

    def attn_kw(aux, device):
        gen = (replayable(aux, 0, device) if a.attention_dropout > 0.0
               else None)
        return dict(num_heads=a.num_heads, compute_dtype=compute_dtype,
                    dropout_rate=a.attention_dropout,
                    dropout_seed=aux["seed"], generator=gen, impl=impl)

    def drop(x, aux, which):
        gen = replayable(aux, 1 + which, x.device) if cfg.dropout else None
        return x if gen is None else dropout(x, cfg.dropout, gen)

    def make_f_self(kind):
        def f_self(p, x, memory, aux, cache):
            h = p.ln(x)
            k = resolve_attention_kind(a, x.shape[1]) if kind == "auto" else kind
            seq = cfg.seq_parallel_axis and x.shape[1] > a.chunk_length
            if k == "full" and seq:
                out = full_self_attention_seq_parallel(
                    p.attn, h, aux["mask"], cfg.causal, a, compute_dtype,
                    aux.get("mesh"), axis=cfg.seq_parallel_axis,
                    dropout_rate=a.attention_dropout,
                    dropout_seed=aux["seed"])
            elif k == "lsh" and seq:
                out, cache = lsh_self_attention_seq_parallel(
                    p.attn, h, aux["mask"], cfg.causal, a,
                    aux["hash_generator"], compute_dtype, aux.get("mesh"),
                    axis=cfg.seq_parallel_axis,
                    exchange=cfg.seq_parallel_exchange,
                    dropout_seed=aux["seed"], cache=cache)
            elif k == "lsh":
                out, cache = lsh_self_attention(
                    p.attn, h, aux["mask"], cfg.causal, a,
                    aux["hash_generator"], compute_dtype,
                    dropout_seed=aux["seed"], cache=cache,
                    rotations=aux.get("rotations"))
            elif k == "local":
                out = local_self_attention(p.attn, h, aux["mask"], cfg.causal,
                                           a, compute_dtype,
                                           dropout_seed=aux["seed"])
            else:
                out = shared_qk_self_attention(p.attn, h, mask=aux["mask"],
                                               causal=cfg.causal,
                                               **attn_kw(aux, x.device))
            return drop(out, aux, 0), cache

        return f_self

    def f_cross(p, x, memory, aux, cache):
        out = cross_attention(p.attn, p.ln(x), memory,
                              memory_mask=aux["memory_mask"],
                              probs_sink=aux.get("attn_sink"),
                              **attn_kw(aux, x.device))
        return drop(out, aux, 0), None

    def g_ffn(p, y, memory, aux):
        if cfg.use_pallas_ffn and use_ffn_kernel(y):
            out = chunked_ffn_fused(p, y, cfg.ffn_activation, mxu)
        else:
            chunk = resolve_ffn_chunk(
                cfg, y.shape[0], y.shape[1],
                memory.shape[1] if memory is not None else None)
            out = chunked_ffn(p, y, chunk, cfg.ffn_activation, compute_dtype)
        return drop(out, aux, 1)

    pairs: List[Tuple[Any, Any]] = []
    for kind in kinds:
        pairs.append((make_f_self(kind), g_ffn))
        if cross_attend:
            pairs.append((f_cross, g_ffn))
    return pairs


def _resolve_residuals(cfg: ReformerStackConfig, x: torch.Tensor,
                       memory: Optional[torch.Tensor],
                       attn_sink: Optional[list]) -> bool:
    """-> whether the residuals resolve reversible at x's shape; refuses
    the guided-attention capture with them."""
    rev = resolve_reversible(cfg, x.shape[0], x.shape[1],
                             memory.shape[1] if memory is not None else None)
    if attn_sink is not None and rev:
        raise ValueError(
            "guided attention (attn_sink) requires plain residuals — the "
            "captured probabilities cannot cross the reversible backward; "
            "set reversible: false on this stack (resolved reversible=True "
            f"at shape {tuple(x.shape)})")
    return rev


def _in_shard(fn: Callable, shard) -> Callable:
    """``fn`` run inside ``batch_shard(*shard)``."""
    def run(*args):
        with batch_shard(*shard):
            return fn(*args)
    return run


def stack_apply(stack: Stack, cfg: ReformerStackConfig, x: torch.Tensor,
                mask: Optional[torch.Tensor],
                memory: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None,
                compute_dtype=None,
                generator: Optional[torch.Generator] = None,
                attn_sink: Optional[list] = None) -> torch.Tensor:
    """Run the stack on x: (B, L, D) -> (B, L, D).

    ``generator`` (on x's device) turns dropout on and draws it, and the
    LSH rotations.
    ``attn_sink``: a list that collects each cross-attention layer's f32
    probabilities (B, H, L, Lm), for the guided-attention loss."""
    kinds = _check_supported(cfg, x.shape[1], attn_sink is not None)
    if cfg.pipeline_axis:
        y = pipeline_stack_apply(stack, cfg, x, mask, memory, memory_mask,
                                 compute_dtype, generator)
        return stack.final_ln(y)
    rev = _resolve_residuals(cfg, x, memory, attn_sink)
    layer_fns = make_stack_layer_fns(cfg, memory is not None, compute_dtype)
    n = len(layer_fns)
    seeds = [None] * n
    if generator is not None and cfg.attention.attention_dropout > 0.0:
        seeds = torch.randint(0, 1 << 32, (n,), generator=generator,
                              device=generator.device).tolist()
    hash_generator = generator
    if hash_generator is None and "lsh" in kinds:
        hash_generator = torch.Generator(device=x.device).manual_seed(0)
    # the ambient mesh and batch shard at the forward: the reversible
    # backward's recompute may run after the caller left them
    mesh = current_mesh()
    shard = batch_shard_state()
    if shard is not None:
        layer_fns = [tuple(_in_shard(fn, shard) for fn in pair)
                     for pair in layer_fns]
    aux_list = [{"mask": mask, "memory_mask": memory_mask,
                 "generator": generator, "hash_generator": hash_generator,
                 "seed": seed, "gen_states": [None] * 3, "mesh": mesh,
                 **({"attn_sink": attn_sink} if attn_sink is not None
                    else {})}
                for seed in seeds]
    y = reversible_sequence(layer_fns, stack.layers, x.float(), memory,
                            aux_list, reversible=rev)
    return stack.final_ln(y)
