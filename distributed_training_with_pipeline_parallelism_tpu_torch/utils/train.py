"""Optimizer-coupled training step on top of the pipeline executor (the
counterparts of the JAX package's ``utils/train.py:adamw`` ``:304`` and
``make_train_step`` ``:36``).

``adamw`` is the JAX recipe, held to optax: global-norm clipping, then
AdamW whose weight decay applies to the linear matrices only (the JAX
``"w"`` leaves: not biases, norms or embeddings), at a linear-warmup cosine
learning rate that starts from 0, so the first update moves nothing (the
moments still take the first gradient). It runs as ``torch.optim.AdamW``
with two parameter groups and a ``LambdaLR`` whose step count is the
optimizer's update count, as optax's schedule count is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn as nn

from ..parallel.pipeline import make_pipeline_grad_fn
from .config import ModelConfig, ScheduleConfig


class AdamWState:
    """The optimizer state of one model: ``torch.optim.AdamW`` over its
    parameters and the learning-rate schedule."""

    def __init__(self, recipe: "AdamW", model: nn.Module):
        matrices = {id(m.weight) for m in model.modules()
                    if isinstance(m, nn.Linear)}
        params = list(model.parameters())
        groups = [
            {"params": [p for p in params if id(p) in matrices],
             "weight_decay": recipe.weight_decay},
            {"params": [p for p in params if id(p) not in matrices],
             "weight_decay": 0.0}]
        self.params = params
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8
        self.optimizer = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=recipe.learning_rate,
            betas=(0.9, 0.999), eps=1e-8)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, recipe.lr_factor)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The JAX ``adamw`` recipe; ``init(model)`` binds it to a model."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10000
    max_grad_norm: float = 1.0

    def lr_factor(self, count: int) -> float:
        """The schedule at update ``count`` over the peak learning rate:
        linear from 0 over ``warmup_steps``, then a cosine to 0 at
        ``max(total_steps, warmup_steps + 1)`` (optax's
        ``warmup_cosine_decay_schedule(init_value=0.0, ...)``)."""
        w = self.warmup_steps
        if count < w:
            return count / w
        decay = max(self.total_steps, w + 1) - w
        t = min(count - w, decay)
        return 0.5 * (1.0 + math.cos(math.pi * t / decay))

    def init(self, model: nn.Module) -> AdamWState:
        return AdamWState(self, model)

    def update(self, state: AdamWState) -> None:
        """Clip the gradients to the global norm (optax's
        ``clip_by_global_norm``: unchanged below the limit, else scaled by
        ``max_grad_norm / norm``), take one AdamW step, advance the
        schedule. No host synchronisation."""
        grads = [p.grad for p in state.params if p.grad is not None]
        if grads:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.max_grad_norm, 1.0,
                                self.max_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        state.optimizer.step()
        state.scheduler.step()


def adamw(learning_rate: float = 3e-4, weight_decay: float = 0.01,
          warmup_steps: int = 100, total_steps: int = 10000,
          max_grad_norm: float = 1.0) -> AdamW:
    """Global-norm clip + AdamW (decay on the linear matrices only) +
    linear-warmup cosine, the JAX ``adamw``'s defaults."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps,
                 max_grad_norm)


def make_train_step(cfg: ModelConfig, sched: ScheduleConfig, n_stages: int,
                    optimizer: AdamW, remat_backward=None, device="cuda"
                    ) -> Callable:
    """``step(model, opt_state, tokens, targets) -> loss``: the pipeline's
    gradients (:func:`..parallel.pipeline.make_pipeline_grad_fn`), then
    the optimizer's update of ``model`` in place. ``opt_state`` is
    ``optimizer.init(model)``. The loss stays on the device."""
    grad_fn = make_pipeline_grad_fn(cfg, sched, n_stages,
                                    remat_backward=remat_backward,
                                    device=device)

    def step(model: nn.Module, opt_state: AdamWState, tokens,
             targets) -> torch.Tensor:
        opt_state.zero_grad()
        loss = grad_fn(model, tokens, targets)
        optimizer.update(opt_state)
        return loss

    return step
