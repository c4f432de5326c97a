"""Optimizer and learning-rate schedule: port of ``rtts/train/optim.py``.

The JAX package chains optax transforms: ``clip_by_global_norm`` ->
``scale_by_adam`` (-> ``add_decayed_weights`` for adamw) ->
``scale_by_learning_rate(schedule)``.  This module computes the same update
with optax's semantics, which differ from ``torch.optim`` in three places
that decide parity:

- the schedule is called with the update count BEFORE its increment, so
  under a Noam warmup the first update has learning rate 0;
- the global-norm clip adds no epsilon to the norm
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6): g * max_norm / norm
  when norm >= max_norm, g otherwise;
- Adam adds eps outside the square root of the bias-corrected second
  moment: mu_hat / (sqrt(nu_hat) + eps).

Gradient accumulation (``accumulate_steps`` = k > 1) has
``optax.MultiSteps`` semantics: every micro-step folds its gradient into the
running mean (Welford's update, as optax), and every k-th applies the chain
above once to that mean and clears it; the steps in between leave the
parameters as they are.  Clipping, Adam and the schedule see one update per
cycle, so the schedule counts updates.

The state is a plain dict: ``count`` (updates applied, an int) and, for
adam/adamw, ``mu`` and ``nu`` (one tensor per parameter, in parameter
order, in the parameter's dtype, as optax's ``scale_by_adam`` without
``mu_dtype``: under a bf16 ``param_dtype`` the moments and the whole
update are bf16 arithmetic, the clip's norm bf16 as optax sums it:
``global_norm``); with accumulation also
``mini_step`` (micro-steps folded into the current cycle) and ``acc`` (the
running mean gradient, in the parameter's dtype).  Checkpoints store it
under the port's own keys (``rtts_torch/train/checkpoint.py``).

``step`` takes ``norm_fn``, the global norm of a gradient list, for a
data- or tensor-parallel step whose lists are a rank's shards
(``rtts_torch/train/train_tts.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from rtts_torch.config import OptimConfig


def make_schedule(cfg: OptimConfig):
    """count -> learning rate, as ``rtts/train/optim.py::make_schedule``."""
    lr, warmup = cfg.learning_rate, cfg.warmup_steps

    def linear_warmup(count):
        if warmup <= 0:   # optax.linear_schedule holds init_value then
            return 0.0
        return lr * min(max(count, 0), warmup) / warmup

    if cfg.schedule == "constant":
        return lambda count: lr
    if cfg.schedule == "noam":
        # join_schedules([linear warmup, inverse sqrt], [warmup]): the
        # second schedule sees s = count - warmup and returns
        # lr * (warmup / (s + warmup)) ** 0.5
        def noam(count):
            if count < warmup:
                return linear_warmup(count)
            return lr * (warmup / count) ** 0.5
        return noam
    if cfg.schedule == "cosine":
        decay = cfg.total_steps - warmup
        if not decay > 0:
            raise ValueError("the cosine schedule needs total_steps > "
                             f"warmup_steps, got {cfg.total_steps} <= {warmup}")

        def cosine(count):
            if count < warmup:
                return linear_warmup(count)
            c = min(float(count - warmup), float(decay))
            return lr * 0.5 * (1 + math.cos(math.pi * c / decay))
        return cosine
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def lr_at_step(cfg: OptimConfig, step: int) -> float:
    """Learning rate the gradient of train step ``step`` is applied at:
    that of the update which ends its accumulation cycle."""
    return float(make_schedule(cfg)(step // max(1, cfg.accumulate_steps)))


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares, summed per leaf in
    the leaf's dtype, then over the leaves in order (the promoted dtype).
    A leaf's sum is the one XLA's CPU reduction gives: the squares exact,
    accumulated in f32, rounded once to the leaf's dtype (bf16 leaves: one
    bf16 value each, added in bf16)."""
    total = torch.zeros((), dtype=torch.float32)
    first = True
    for t in tensors:
        s = (t.float() ** 2).sum().to(t.dtype)
        total = s if first else total + s
        first = False
    return torch.sqrt(total)


class Optimizer:
    """``make_optimizer``'s chain for a list of parameters; ``init`` makes
    the state, ``step`` applies one update in place."""

    def __init__(self, cfg: OptimConfig):
        if cfg.optimizer not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        if cfg.accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1, got "
                             f"{cfg.accumulate_steps}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def init(self, params: List[torch.Tensor]) -> Dict:
        def zeros():
            return [torch.zeros_like(p) for p in params]

        state: Dict = {"count": 0}
        if self.cfg.optimizer != "sgd":
            state["mu"], state["nu"] = zeros(), zeros()
        if self.cfg.accumulate_steps > 1:
            state["mini_step"], state["acc"] = 0, zeros()
        return state

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: Dict, norm_fn=global_norm) -> None:
        """Fold ``grads`` into the cycle's mean and, at its end (every step
        without accumulation), params <- params + update(mean); ``state``
        advances in place.  ``norm_fn`` gives the clip its global norm."""
        k = self.cfg.accumulate_steps
        if k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_((g - acc) / (n + 1))
            if n + 1 < k:
                state["mini_step"] = n + 1
                return
            grads = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
            state["mini_step"] = 0
        self._update(params, grads, state, norm_fn)

    def _update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                state: Dict, norm_fn=global_norm) -> None:
        cfg = self.cfg
        if cfg.grad_clip_norm > 0:
            norm = norm_fn(grads)
            clip = norm < cfg.grad_clip_norm
            grads = [torch.where(clip, g, g / norm * cfg.grad_clip_norm)
                     for g in grads]
        lr = self.schedule(state["count"])
        state["count"] += 1
        if cfg.optimizer == "sgd":
            updates = grads
        else:
            t = state["count"]
            c1, c2 = 1.0 - cfg.beta1 ** t, 1.0 - cfg.beta2 ** t
            updates = []
            for g, mu, nu in zip(grads, state["mu"], state["nu"]):
                mu.mul_(cfg.beta1).add_(g, alpha=1.0 - cfg.beta1)
                nu.mul_(cfg.beta2).addcmul_(g, g, value=1.0 - cfg.beta2)
                updates.append((mu / c1) / (torch.sqrt(nu / c2) + cfg.eps))
            if cfg.optimizer == "adamw":
                updates = [u + cfg.weight_decay * p
                           for u, p in zip(updates, params)]
        for p, u in zip(params, updates):
            p.add_(u, alpha=-lr)


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    return Optimizer(cfg)
