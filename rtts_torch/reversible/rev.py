"""Reversible residual sequence with activation memory constant in depth.

Port of ``rtts/reversible/rev.py``.  Two streams run

    Y1 = X1 + f(X2)        (attention sublayer)
    Y2 = X2 + g(Y1)        (feed-forward sublayer)

and the output is (Y1 + Y2) / 2 after the last pair.  With
``reversible=True`` and gradients on, ``_Reversible`` (the reference's
``jax.custom_vjp``) runs the forward without keeping any layer's inputs or
activations: it saves the final (Y1, Y2), each f's cache (the LSH
buckets) and the memory.  Its backward reconstructs, layer by layer in
reverse,

    X2 = Y2 - g(Y1),   X1 = Y1 - f(X2)

re-running g and f under autograd for their vector-Jacobian products (f
with its cache, so LSH does not hash again), with the stream cotangents in
f32 and the memory's gradient summed over the pairs.  The subtraction uses
the output the sublayer gives in the recompute, the same function the
forward added (with K6 on, K6's output).  Dropout replays because every
draw is a function of a seed in ``aux`` (``rtts_torch/models/stack.py``).

The parameters are inputs of the Function and their gradients are its
outputs, so ``torch.autograd.grad`` over the parameters sees them; the
backward writes no ``.grad``.

f signature: f(params, x, memory, aux, cache) -> (out, cache)
g signature: g(params, y, memory, aux) -> out
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn


def _grads(out: torch.Tensor, inputs: List[Optional[torch.Tensor]],
           cot: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """Vector-Jacobian product of ``out`` for each input that is a tensor
    requiring grad (None for the others and for unused inputs)."""
    live = [t for t in inputs if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad(out, live, cot.to(out.dtype),
                                   allow_unused=True))
    return [next(got) if t is not None and t.requires_grad else None
            for t in inputs]


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if b is None:
        return a
    return b if a is None else a + b


class _Reversible(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer_fns, layers, aux_list, x1, x2, memory, *params):
        caches = []
        for (f, g), p, aux in zip(layer_fns, layers, aux_list):
            fx, cache = f(p.f, x2, memory, aux, None)
            x1 = x1 + fx
            x2 = x2 + g(p.g, x1, memory, aux)
            caches.append(cache)
        ctx.layer_fns, ctx.layers, ctx.aux_list = layer_fns, layers, aux_list
        ctx.caches = caches
        ctx.save_for_backward(x1, x2, memory)
        return x1, x2

    @staticmethod
    def backward(ctx, dy1, dy2):
        y1, y2, memory = ctx.saved_tensors
        dy1, dy2 = dy1.float(), dy2.float()
        mem = None
        if memory is not None:
            mem = memory.detach().requires_grad_(ctx.needs_input_grad[5])
        dmem = None
        grads = {}
        for i in range(len(ctx.layer_fns) - 1, -1, -1):
            (f, g), p = ctx.layer_fns[i], ctx.layers[i]
            aux, cache = ctx.aux_list[i], ctx.caches[i]

            # g: reconstruct X2 with g's own output, then its vjp
            gp = list(p.g.parameters())
            y1_ = y1.detach().requires_grad_()
            with torch.enable_grad():
                gy = g(p.g, y1_, mem, aux)
            d_y1, d_mem, *d_gp = _grads(gy, [y1_, mem, *gp], dy2)
            x2 = y2 - gy.detach()
            dy1 = dy1 + d_y1.float()
            dmem = _add(dmem, d_mem)

            # f: reconstruct X1, re-running f on its cache, then its vjp
            fp = list(p.f.parameters())
            x2_ = x2.detach().requires_grad_()
            with torch.enable_grad():
                fx, _ = f(p.f, x2_, mem, aux, cache)
            d_x2, d_mem, *d_fp = _grads(fx, [x2_, mem, *fp], dy1)
            x1 = y1 - fx.detach()
            dy2 = dy2 + d_x2.float()
            dmem = _add(dmem, d_mem)

            for t, d in zip(gp + fp, d_gp + d_fp):
                grads[t] = _add(grads.get(t), d)
            y1, y2 = x1, x2
        params = [t for p in ctx.layers for t in p.parameters()]
        return (None, None, None, dy1, dy2, dmem,
                *(grads.get(t) for t in params))


def reversible_sequence(layer_fns: Sequence[Tuple[Callable, Callable]],
                        layers: Sequence[nn.Module], x: torch.Tensor, memory,
                        aux_list, reversible: bool = True) -> torch.Tensor:
    """Run a stack of (f, g) residual pairs over x: (B, L, D); each of
    ``layers`` holds one pair's parameters as ``.f`` and ``.g``.

    The two-stream scheme (input duplicated, output the mean of the
    streams) for both residual kinds.  ``reversible`` and gradients on: the
    memory-saving ``_Reversible``; otherwise plain residuals, where autograd
    keeps the activations (the reference's ``reversible=False``, also its
    gradient-parity oracle)."""
    if reversible and torch.is_grad_enabled():
        params = [t for p in layers for t in p.parameters()]
        y1, y2 = _Reversible.apply(tuple(layer_fns), tuple(layers),
                                   tuple(aux_list), x, x, memory, *params)
        return (y1 + y2) * 0.5
    h1 = h2 = x
    for (f, g), p, aux in zip(layer_fns, layers, aux_list):
        h1 = h1 + f(p.f, h2, memory, aux, None)[0]
        h2 = h2 + g(p.g, h1, memory, aux)
    return (h1 + h2) * 0.5
