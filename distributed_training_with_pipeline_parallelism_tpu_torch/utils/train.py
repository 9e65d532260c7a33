"""Optimizer-coupled training on top of the pipeline executor (the
counterpart of the JAX package's ``utils/train.py``: ``adamw`` ``:304``,
``make_train_step`` ``:36``, ``make_eval_fn`` ``:331``, ``evaluate``
``:355``, ``fit`` ``:391`` and ``synthetic_data`` ``:983``).

``adamw`` is the JAX recipe, held to optax: global-norm clipping, then
AdamW whose weight decay applies to the linear matrices only (the JAX
``"w"`` leaves: not biases, norms or embeddings), at a linear-warmup cosine
learning rate that starts from 0, so the first update moves nothing (the
moments still take the first gradient). It runs as the fused
``torch.optim.AdamW`` (one kernel for every parameter) with two parameter
groups. The learning rate is a device tensor computed from the
optimizer's device step count before each update, as optax's schedule
reads its count, so a step can be skipped on the device: the guarded
step hands the optimizer a ``found_inf`` flag, the fused kernel then
leaves the parameters, both moments and the step count (and so the
learning rate) as they were, and the host never waits. ``MultiSteps``
(``grad_accum``) is ``optax.MultiSteps``: the running mean of k batches'
gradients, one update per k batches. ``sgd`` is ``optax.sgd``: plain
gradient descent at a constant rate, no clipping.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import math
import os
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.layers import fold_seed
from ..parallel.pipeline import (make_pipeline_grad_fn, make_pipeline_loss_fn,
                                 mesh_device)
from . import profiling
from .config import ModelConfig, ScheduleConfig
from .dynamics import (StageIndex, StatSums, as_dynamics_config,
                       nonfinite_per_stage)
from .metrics import force_completion
from .resilience import (AnomalyBudgetExceeded, AnomalyGuard,
                         CheckpointManager, PreemptionHandler, SimulatedKill,
                         StepWatchdog, config_fingerprint, init_guard_state,
                         latest_committed_step_dir)


def _param_groups(recipe: "AdamW", model: nn.Module, params, of):
    """The fused AdamW's two groups over ``params`` (``of(p)`` is the
    model parameter a tensor stands for): weight decay on the linear
    matrices only, and a MoE FFN's router and expert matrices (its
    ``decayed_names``; the JAX mask's "w", "w1", "w2")."""
    matrices = {id(m.weight) for m in model.modules()
                if isinstance(m, nn.Linear)}
    matrices |= {id(getattr(m, n)) for m in model.modules()
                 for n in getattr(m, "decayed_names", ())}
    return [g for g in (
        {"params": [t for t in params if id(of(t)) in matrices],
         "weight_decay": recipe.weight_decay},
        {"params": [t for t in params if id(of(t)) not in matrices],
         "weight_decay": 0.0}) if g["params"]]


def _fused_adamw(groups, lr):
    """The fused ``torch.optim.AdamW`` (optax.adamw's defaults: b1 0.9, b2
    0.999, eps 1e-8) with its state built now, not at the first update."""
    opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            fused=True)
    for g in groups:
        for t in g["params"]:
            opt.state[t].update(
                step=torch.zeros((), dtype=torch.float32, device=t.device),
                exp_avg=torch.zeros_like(t), exp_avg_sq=torch.zeros_like(t))
    return opt


def _global_order(model: nn.Module):
    """name -> index in the whole model's parameter order (a rank's view
    holds a subset of the whole model's parameters)."""
    from ..models.moe import MoELM
    from ..models.transformer import Transformer
    whole = (MoELM(model.cfg, model.moe, device="meta")
             if isinstance(model, MoELM)
             else Transformer(model.cfg, device="meta"))
    return {n: i for i, (n, _) in enumerate(whole.named_parameters())}


def _counted(name: str, mesh, sharded=()) -> bool:
    """Whether this rank's leaf ``name`` enters the world's clipping norm:
    a layer's leaf where its stage runs, a replicated leaf (embedding,
    final norm, head) on pipe coordinate 0 only; under a model axis a
    leaf split over it (``sharded``) on every model rank, whose squares
    sum to the whole leaf's, any other on model coordinate 0 only; on an
    expert axis an expert stack on every expert rank, any other leaf on
    expert coordinate 0 only."""
    from ..models.moe import is_expert_leaf
    return ((mesh.pipe == 0 or name.startswith("layers."))
            and (mesh.model == 0 or name in sharded)
            and (mesh.expert == 0 or is_expert_leaf(name)))


def _sharded(model: nn.Module):
    from ..parallel.tensor_parallel import sharded_names
    return sharded_names(model)


def _fsdp_sharded(model: nn.Module):
    from ..parallel.fsdp import fsdp_names
    return fsdp_names(model)


class AdamWState:
    """The optimizer state of one model: the fused ``torch.optim.AdamW``
    over its parameters, whose state is built here (step count, both
    moments) rather than at the first update, and the learning-rate
    tensor its groups share. The model may be a rank's view: the update
    under a mesh clips by the whole world's norm (:meth:`global_norm`)."""

    def __init__(self, recipe: "AdamW", model: nn.Module):
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        self.names = [n for n, _ in named]
        self._model = model
        self._where = None  # the leaves' places in the whole model's order
        self.lr = torch.zeros((), dtype=torch.float32,
                              device=self.params[0].device)
        self.optimizer = _fused_adamw(
            _param_groups(recipe, model, self.params, lambda t: t), self.lr)

    @property
    def count(self) -> torch.Tensor:
        """The number of updates taken (a device f32 tensor): the
        schedule's count."""
        return self.optimizer.state[self.params[0]]["step"]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def grads(self):
        """The gradients the update steps on (``.grad`` of the
        parameters that have one)."""
        return [p.grad for p in self.params if p.grad is not None]

    def global_norm(self, grads, mesh=None) -> torch.Tensor:
        """The norm of the whole gradient (optax's ``global_norm``): the
        norm of the per-leaf norms, in the whole model's leaf order; under
        ``mesh`` (the train step's) each leaf's norm comes from the rank
        that holds it (the replicated leaves from pipe coordinate 0),
        summed over the pipe group, so the value is the lockstep one.
        Under a model axis the leaves' squared norms sum over the pipe and
        model groups, a split leaf's from every model rank, a replicated
        one's from model coordinate 0, then the norm of their roots. Under
        FSDP a leaf sharded over the data axis sums its squares over the
        data group too (a replicated one's from data coordinate 0), and on
        an expert axis an expert stack's over the expert group. The
        gradients are the data group's mean already."""
        norms = torch._foreach_norm(grads)
        if mesh is None:
            return torch.linalg.vector_norm(torch.stack(norms))
        if self._where is None:
            order = _global_order(self._model)
            self._where = ([order[n] for n in self.names], len(order),
                           _sharded(self._model), _fsdp_sharded(self._model))
        where, n_global, sharded, fsdp = self._where
        vec = torch.zeros(n_global, dtype=torch.float32,
                          device=grads[0].device)
        have = [i for i, p in enumerate(self.params) if p.grad is not None]
        tp = mesh.n_model > 1
        ep = mesh.n_expert > 1
        sq = tp or ep or bool(fsdp)
        for i, n in zip(have, norms):
            name = self.names[i]
            if _counted(name, mesh, sharded) and (
                    not fsdp or mesh.data == 0 or name in fsdp):
                vec[where[i]] = n.float().square() if sq else n.float()
        mesh.all_reduce([vec], "pipe")
        if tp:
            mesh.all_reduce([vec], "model")
        if ep:
            mesh.all_reduce([vec], "expert")
        if fsdp:
            mesh.all_reduce([vec], "data")
        if sq:
            vec = vec.sqrt()
        return torch.linalg.vector_norm(vec)

    def finish(self) -> None:
        """After the step: nothing to gather."""

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state) -> None:
        self.optimizer.load_state_dict(state)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr  # the loaded groups carry a host copy


class ShardedAdamWState:
    """ZeRO-1 (the JAX ``init_sharded_opt_state`` / ``shard_opt_state``):
    data rank k of n holds block k of every parameter's flattened (and
    zero-padded to a multiple of n) values as its master copy, and both
    Adam moments only for that block. The update reduce-scatters the
    local gradients over the data group into the rank's blocks (their
    mean), clips by the world's norm, steps the fused AdamW on the blocks
    and all-gathers the parameters. The train step hands it gradients
    that were not averaged over the data group (the pipeline's gradient
    function called with ``reduce_data=False``)."""

    def __init__(self, recipe: "AdamW", model: nn.Module, mesh):
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        self.names = [n for n, _ in named]
        self.mesh = mesh
        n = mesh.n_data
        self._chunks = [-(-p.numel() // n) for p in self.params]
        self._offsets = [sum(self._chunks[:i])
                         for i in range(len(self.params))]
        total = sum(self._chunks)
        dev = self.params[0].device
        self._master = torch.zeros(total, dtype=self.params[0].dtype,
                                   device=dev)
        self.shards = [self._master[o:o + c]
                       for o, c in zip(self._offsets, self._chunks)]
        self._of = {id(t): p for t, p in zip(self.shards, self.params)}
        self.refresh()
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.optimizer = _fused_adamw(
            _param_groups(recipe, model, self.shards,
                          lambda t: self._of[id(t)]), self.lr)
        order = _global_order(model)
        self._where = [order[nm] for nm, _ in named]
        self._n_global = len(order)
        sharded = _sharded(model)
        # the norm sums over the whole world, whose seq ranks hold the same
        # blocks: seq coordinate 0's count
        self._counted = [_counted(nm, mesh, sharded) and mesh.seq == 0
                         for nm, _ in named]

    def refresh(self) -> None:
        """Master blocks <- the parameters' values (at init, and after the
        model was loaded from a checkpoint)."""
        n = self.mesh.n_data
        with torch.no_grad():
            for p, t, c in zip(self.params, self.shards, self._chunks):
                flat = torch.zeros(n * c, dtype=p.dtype, device=p.device)
                flat[:p.numel()] = p.detach().reshape(-1)
                k = self.mesh.data
                t.copy_(flat[k * c:(k + 1) * c])

    @property
    def count(self) -> torch.Tensor:
        return self.optimizer.state[self.shards[0]]["step"]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self):
        """Reduce-scatter the parameters' local gradients over the data
        group: each block's mean lands as the block's ``.grad``."""
        n = self.mesh.n_data
        total = sum(self._chunks)
        flat = torch.zeros((n, total), dtype=self._master.dtype,
                           device=self._master.device)
        for p, o, c in zip(self.params, self._offsets, self._chunks):
            if p.grad is not None:
                g = torch.zeros(n * c, dtype=flat.dtype, device=flat.device)
                g[:p.numel()] = p.grad.reshape(-1)
                flat[:, o:o + c] = g.view(n, c)
        flat.mul_(1.0 / n)
        out = torch.empty(total, dtype=flat.dtype, device=flat.device)
        self.mesh.reduce_scatter(out, flat.reshape(-1))
        for t, o, c in zip(self.shards, self._offsets, self._chunks):
            t.grad = out[o:o + c]
        return [t.grad for t in self.shards]

    def global_norm(self, grads, mesh=None) -> torch.Tensor:
        """The world's gradient norm from the blocks: each leaf's squared
        norm sums over its data blocks and, for a leaf split over the model
        axis, its model shards (a replicated leaf's comes from pipe, and
        model, coordinate 0 only), then the norm of the leaf norms.
        ``mesh`` must be the one the state was sharded over."""
        _check_mesh(self, mesh)
        sq = torch.zeros(self._n_global, dtype=torch.float32,
                         device=grads[0].device)
        for i, g in enumerate(grads):
            if self._counted[i]:
                sq[self._where[i]] = g.float().square().sum()
        self.mesh.all_reduce([sq], "world")
        return torch.linalg.vector_norm(sq.sqrt())

    def finish(self) -> None:
        """All-gather the updated blocks into the parameters."""
        n = self.mesh.n_data
        total = sum(self._chunks)
        out = torch.empty(n * total, dtype=self._master.dtype,
                          device=self._master.device)
        self.mesh.all_gather(out, self._master)
        out = out.view(n, total)
        with torch.no_grad():
            for p, o, c in zip(self.params, self._offsets, self._chunks):
                p.copy_(out[:, o:o + c].reshape(-1)[:p.numel()].view_as(p))
        for t in self.shards:
            t.grad = None

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state) -> None:
        self.optimizer.load_state_dict(state)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        self.refresh()


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The JAX ``adamw`` recipe; ``init(model)`` binds it to a model."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10000
    max_grad_norm: float = 1.0

    def lr_factor(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule at update ``count`` (a tensor) over the peak
        learning rate: linear from 0 over ``warmup_steps``, then a cosine
        to 0 at ``max(total_steps, warmup_steps + 1)`` (optax's
        ``warmup_cosine_decay_schedule(init_value=0.0, ...)``)."""
        w = self.warmup_steps
        decay = max(self.total_steps, w + 1) - w
        t = torch.clamp(count - w, max=decay)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / decay))
        return torch.where(count < w, count / max(w, 1), cosine)

    def init(self, model: nn.Module) -> AdamWState:
        return AdamWState(self, model)

    def update(self, state, ok: Optional[torch.Tensor] = None,
               mesh=None) -> None:
        """Clip the gradients to the global norm (optax's
        ``clip_by_global_norm``: unchanged below the limit, else scaled by
        ``max_grad_norm / norm``; under ``mesh``, the train step's, the
        whole world's norm), set the learning rate from the step count,
        take one AdamW step. ``ok`` (a device bool) false skips the update
        on the device: parameters, moments and count stay. No host
        synchronisation without a mesh (a staged world's collectives
        synchronise)."""
        grads = state.grads()
        if grads:
            norm = state.global_norm(grads, mesh)
            scale = torch.where(norm < self.max_grad_norm, 1.0,
                                self.max_grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        state.lr.copy_(self.learning_rate * self.lr_factor(state.count))
        opt = state.optimizer
        opt.grad_scale = None
        opt.found_inf = None if ok is None else (~ok).to(torch.float32)
        opt.step()
        state.finish()


def adamw(learning_rate: float = 3e-4, weight_decay: float = 0.01,
          warmup_steps: int = 100, total_steps: int = 10000,
          max_grad_norm: float = 1.0) -> AdamW:
    """Global-norm clip + AdamW (decay on the linear matrices only) +
    linear-warmup cosine, the JAX ``adamw``'s defaults."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps,
                 max_grad_norm)


class SGDState:
    """``sgd``'s state: the parameters and the number of updates taken (a
    device f32 tensor)."""

    def __init__(self, model: nn.Module):
        self.params = list(model.parameters())
        self.count = torch.zeros((), dtype=torch.float32,
                                 device=self.params[0].device)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self):
        return {"count": self.count}

    def load_state_dict(self, state) -> None:
        self.count.copy_(state["count"])


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(learning_rate)``: ``p <- p - learning_rate * g``, no
    momentum and no clipping (linear in the gradients, so two runs whose
    gradients differ by rounding stay that close)."""

    learning_rate: float

    def init(self, model: nn.Module) -> SGDState:
        return SGDState(model)

    def update(self, state: SGDState, ok: Optional[torch.Tensor] = None,
               mesh=None) -> None:
        """One step; ``ok`` (a device bool) false keeps the parameters and
        the count."""
        with torch.no_grad():
            for p in state.params:
                if p.grad is None:
                    continue
                new = p - self.learning_rate * p.grad
                p.copy_(new if ok is None else torch.where(ok, new, p))
            state.count.add_(1.0 if ok is None else ok.to(torch.float32))


def sgd(learning_rate: float) -> SGD:
    """Plain gradient descent (``optax.sgd``)."""
    return SGD(learning_rate)


class MultiStepsState:
    """``MultiSteps``'s state: the inner optimizer's, the running mean of
    this cycle's gradients and the mini-step (a device int32)."""

    def __init__(self, inner: AdamWState):
        self.inner = inner
        self.params = inner.params
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = torch.zeros((), dtype=torch.int32,
                                     device=self.params[0].device)

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "acc": self.acc,
                "mini_step": self.mini_step}

    def load_state_dict(self, state) -> None:
        self.inner.load_state_dict(state["inner"])
        with torch.no_grad():
            torch._foreach_copy_(self.acc, state["acc"])
            self.mini_step.copy_(state["mini_step"])


@dataclasses.dataclass(frozen=True)
class MultiSteps:
    """``optax.MultiSteps(optimizer, every_k_schedule=every_k)``: each call
    folds the batch's gradients into the running mean ``acc + (g - acc) /
    (n + 1)``; the k-th call updates the parameters with the mean through
    ``optimizer`` (whose schedule therefore advances once per k batches)
    and restarts the mean. A call with ``ok`` false changes nothing, the
    mini-step included (the guarded step keeps the whole incoming state)."""

    optimizer: AdamW
    every_k: int

    def init(self, model: nn.Module) -> MultiStepsState:
        return MultiStepsState(self.optimizer.init(model))

    def update(self, state: MultiStepsState,
               ok: Optional[torch.Tensor] = None, mesh=None) -> None:
        pairs = [(p.grad, a) for p, a in zip(state.params, state.acc)
                 if p.grad is not None]
        grads, acc = [g for g, _ in pairs], [a for _, a in pairs]
        n = state.mini_step
        # grads <- the mean so far, this batch included
        torch._foreach_sub_(grads, acc)
        torch._foreach_div_(grads, (n + 1).to(torch.float32))
        torch._foreach_add_(grads, acc)
        emit = n == self.every_k - 1
        keep = (~emit).to(torch.float32)
        if ok is None:
            torch._foreach_copy_(acc, grads)
            torch._foreach_mul_(acc, keep)
            state.mini_step.copy_(torch.where(emit, 0, n + 1))
            self.optimizer.update(state.inner, emit, mesh)
            return
        for a, g in zip(acc, grads):
            a.copy_(torch.where(ok, g * keep, a))
        state.mini_step.copy_(torch.where(ok, torch.where(emit, 0, n + 1), n))
        self.optimizer.update(state.inner, ok & emit, mesh)


def init_sharded_opt_state(optimizer, model: nn.Module, mesh):
    """ZeRO-1's optimizer state (the JAX ``init_sharded_opt_state``): a
    :class:`ShardedAdamWState` whose moments are born as this data rank's
    blocks (inside a :class:`MultiSteps`' state for ``grad_accum``).
    Without a data axis larger than 1 it is ``optimizer.init(model)``, as
    in JAX."""
    if mesh is None or mesh.n_data <= 1:
        return optimizer.init(model)
    if isinstance(optimizer, MultiSteps):
        return MultiStepsState(ShardedAdamWState(optimizer.optimizer, model,
                                                 mesh))
    return ShardedAdamWState(optimizer, model, mesh)


def _check_mesh(state: ShardedAdamWState, mesh) -> None:
    if mesh is not state.mesh:
        raise ValueError("this ZeRO-1 optimizer state was sharded over "
                         "another mesh than the train step's: pass the "
                         "step's mesh to init_sharded_opt_state")


def _reduce_data(opt_state, mesh) -> bool:
    """Whether the pipeline's epilogue averages the gradients over the
    data group: for every state but ZeRO-1's, whose update reduce-scatters
    them (and which must have been sharded over ``mesh``)."""
    inner = getattr(opt_state, "inner", opt_state)
    if isinstance(inner, ShardedAdamWState):
        _check_mesh(inner, mesh)
        return False
    return True


def make_train_step(cfg: ModelConfig, sched: ScheduleConfig, n_stages: int,
                    optimizer, remat_backward=None, device="cuda",
                    guard=None, fault_plan=None, mesh=None,
                    comm_overlap: str = "none",
                    tp_vocab_parallel: bool = False,
                    telemetry=None, dynamics=None, fsdp: bool = False,
                    sp_attn_impl: str = "ring", moe=None) -> Callable:
    """``step(model, opt_state, tokens, targets[, step_seed]) -> loss``:
    the pipeline's gradients (:func:`..parallel.pipeline.make_pipeline_grad_fn`),
    then the optimizer's update of ``model`` in place. ``opt_state`` is
    ``optimizer.init(model)`` (``optimizer`` an :class:`AdamW` or a
    :class:`MultiSteps`). The loss stays on the device. With
    ``cfg.dropout > 0`` the step takes the step's seed, as the gradient
    function does.

    ``guard`` (a ``resilience.AnomalyGuard``) gives the *guarded* step
    ``step(model, opt_state, tokens, targets, guard_state[, step_seed])
    -> (loss, guard_state)`` (the JAX guarded step). On the device it
    checks the loss and a per-stage non-finite count over the gradients
    (``dynamics.nonfinite_per_stage``); a bad step keeps the incoming
    parameters and optimizer state (the skip of :meth:`AdamW.update`) and
    bumps the counters (``resilience.init_guard_state``), including
    ``last_bad_stage``, the first non-finite stage (-2 when only the loss
    was non-finite). Nothing is read back: the counters are read where the
    caller reads the loss. ``fault_plan.nan_grad_steps`` (requires the
    guard) poisons the gradients and the loss with NaN at those global
    steps by a compare with the device step counter; with
    ``fault_plan.nan_grad_stage`` only that stage's layer gradients.

    With ``mesh`` (this rank's ``parallel.mesh.Mesh``) the step runs the
    rank's row over the distributed transport (``comm_overlap`` as in
    :func:`..parallel.pipeline.make_pipeline_grad_fn`) on the rank's view
    and batch slice. The pipeline's epilogue averages the gradients over
    the data group before the update, except under ZeRO-1 (``opt_state``
    from :func:`init_sharded_opt_state` over this ``mesh``), whose update
    reduce-scatters them; the clipping norm is the world's; the guard's
    verdict is the maximum over the world, so every rank skips the same
    step. With a model axis ``model`` is the rank's shard
    (``parallel.tensor_parallel.shard_model``, with
    ``tp_vocab_parallel``'s head) and ZeRO-1 splits each of its leaves
    over the data group only. ``telemetry`` (a
    ``utils.telemetry.PipelineTelemetry``) stamps the pipeline's ticks
    (:func:`..parallel.pipeline.make_pipeline_grad_fn`); the update
    after them is not stamped.

    ``dynamics`` (True or a ``dynamics.DynamicsConfig``; the JAX
    ``dynamics``) adds a dict of device tensors to the step's outputs,
    ``(loss, stats)`` or ``(loss, guard_state, stats)``:
    ``dynamics.stage_stats`` of the step's gradients (before clipping;
    under the guard after the fault plan's poison), its parameters
    before the update and the update (the parameters' move, 0 on a step
    the guard skips), plus, with ``DynamicsConfig.gns``, the pipeline's
    ``sq_mb``. Nothing is read back. The loss and the update are the
    dynamics-off step's bit for bit. A model axis and ZeRO-1 (whose
    gradients are not the data group's mean until the update) raise
    ``ValueError``.

    ``fsdp`` (pp x fsdp) and ``sp_attn_impl`` (a seq axis) are the
    pipeline's (:func:`..parallel.pipeline.make_pipeline_grad_fn`): under
    FSDP ``model`` is the rank's ``parallel.fsdp.fsdp_shard_params`` copy
    and ``opt_state`` ``optimizer.init`` of it, so AdamW steps on the
    shards and its moments are shard-shaped; the clipping norm sums the
    shards' squares over the data group.

    ``moe`` (a ``models.moe.MoEConfig``): ``model`` is a
    ``models.moe.MoELM`` and its stages run MoE blocks
    (:func:`..parallel.pipeline.make_pipeline_grad_fn`; the loss is the
    cross entropy plus the routing aux term). With an expert axis
    ``model`` holds the rank's block of the experts and so does AdamW's
    state: the expert stacks' moments are shard-shaped, and the clipping
    norm sums the stacks' squares over the expert group. AdamW decays the
    router and the expert matrices (the JAX mask's "w", "w1", "w2")."""
    dcfg = as_dynamics_config(dynamics)
    want_gns = dcfg is not None and dcfg.gns
    if dcfg is not None and mesh is not None and mesh.n_model > 1:
        raise ValueError("dynamics statistics need stages that partition "
                         "the parameters: unsupported on a 'model' mesh "
                         "axis")
    grad_fn = make_pipeline_grad_fn(cfg, sched, n_stages,
                                    remat_backward=remat_backward,
                                    device=device, mesh=mesh,
                                    comm_overlap=comm_overlap,
                                    tp_vocab_parallel=tp_vocab_parallel,
                                    telemetry=telemetry, dynamics=want_gns,
                                    sp_attn_impl=sp_attn_impl, fsdp=fsdp,
                                    moe=moe)
    S = n_stages * sched.n_virtual
    indices: dict = {}  # a StageIndex by the tensor names it covers

    def index_of(named):
        """The :class:`StageIndex` over ``named``'s names, built once."""
        key = tuple(named)
        if key not in indices:
            indices[key] = StageIndex(named, cfg.n_layers, S,
                                      next(iter(named.values())).device)
        return indices[key]

    def gradients(model, opt_state, tokens, targets, step_seed):
        """(loss, sq_mb or None); the gradients land in ``.grad``."""
        opt_state.zero_grad()
        reduce_data = _reduce_data(opt_state, mesh)
        if dcfg is not None and not reduce_data:
            raise ValueError("dynamics statistics need the data group's "
                             "mean gradient: unsupported under ZeRO-1")
        out = grad_fn(model, tokens, targets, step_seed,
                      reduce_data=reduce_data)
        return out if want_gns else (out, None)

    def stat_sums(model, nonfinite):
        """Before the update: the gradients' and parameters' sums and a
        copy of the parameters (a world's replicated leaves count on pipe
        coordinate 0), or None without dynamics."""
        if dcfg is None:
            return None
        own = [(n, p) for n, p in model.named_parameters()
               if p.grad is not None
               and (mesh is None or mesh.pipe == 0
                    or n.startswith("layers."))]
        named = {n: p.detach() for n, p in own}
        sums = StatSums(index_of(named), {n: p.grad for n, p in own}, named,
                        nonfinite, mesh)
        return sums, named, torch._foreach_mul(list(named.values()), 1.0)

    def stats_of(pre, sq_mb):
        """After the update: its move (before minus after), then the
        stats dict."""
        sums, named, before = pre
        torch._foreach_sub_(before, list(named.values()))
        sums.add_updates(dict(zip(named, before)))
        out = sums.stats()
        if sq_mb is not None:
            out["sq_mb"] = sq_mb
        return out

    nan_steps = tuple(getattr(fault_plan, "nan_grad_steps", ()) or ())
    nan_stage = getattr(fault_plan, "nan_grad_stage", None)
    if nan_steps and guard is None:
        raise ValueError(
            "fault_plan.nan_grad_steps requires an AnomalyGuard — injected "
            "NaN grads without the guard would corrupt the params forever")
    if nan_stage is not None and not 0 <= nan_stage < S:
        raise ValueError(f"fault_plan.nan_grad_stage={nan_stage} out of "
                         f"range for {S} stages")

    if guard is None:
        def step(model: nn.Module, opt_state, tokens, targets,
                 step_seed: Optional[int] = None):
            loss, sq_mb = gradients(model, opt_state, tokens, targets,
                                    step_seed)
            pre = stat_sums(model, None)
            optimizer.update(opt_state, mesh=mesh)
            if pre is None:
                return loss
            return loss, stats_of(pre, sq_mb)

        return step

    def guarded_step(model: nn.Module, opt_state, tokens, targets,
                     guard_state, step_seed: Optional[int] = None):
        loss, sq_mb = gradients(model, opt_state, tokens, targets, step_seed)
        step = guard_state["step"]
        if nan_steps:
            bad = functools.reduce(torch.logical_or,
                                   [step == k for k in nan_steps])
            poison = torch.where(bad, math.nan, 1.0)
            if nan_stage is None:
                torch._foreach_mul_([p.grad for p in model.parameters()
                                     if p.grad is not None], poison)
                loss = loss * poison
            else:
                # only the stage's layer gradients, the loss stays finite:
                # only the per-stage count catches and names it
                lps = cfg.n_layers // S
                stage = model.layers[nan_stage * lps:(nan_stage + 1) * lps]
                torch._foreach_mul_([p.grad for p in stage.parameters()
                                     if p.grad is not None], poison)
        nf = nonfinite_per_stage(cfg.n_layers, S, model, index_of(
            {n: p for n, p in model.named_parameters()
             if p.grad is not None}))
        loss_ok = torch.isfinite(loss)
        if mesh is not None:  # one verdict for the world
            flags = torch.cat([nf, (~loss_ok).to(torch.int32).reshape(1)])
            mesh.all_reduce([flags], "world", op="max")
            nf, loss_ok = flags[:S], flags[S] == 0
        stage_ok = nf == 0
        grads_ok = stage_ok.all()
        ok = loss_ok & grads_ok
        first_bad = torch.where(
            grads_ok, torch.where(loss_ok, -1, -2),
            (~stage_ok).to(torch.int32).argmax()).to(torch.int32)
        pre = stat_sums(model, nf)
        optimizer.update(opt_state, ok, mesh)
        guard_state = {
            "step": step + 1,
            "consec": torch.where(ok, 0, guard_state["consec"] + 1),
            "total": guard_state["total"] + (~ok).to(torch.int32),
            "last_anomaly_step": torch.where(
                ok, guard_state["last_anomaly_step"], step),
            "last_bad_stage": torch.where(
                ok, guard_state["last_bad_stage"], first_bad),
        }
        if pre is None:
            return loss, guard_state
        return loss, guard_state, stats_of(pre, sq_mb)

    return guarded_step


def make_eval_fn(cfg: ModelConfig, sched: ScheduleConfig, n_stages: int,
                 device="cuda", mesh=None,
                 tp_vocab_parallel: bool = False,
                 sp_attn_impl: str = "ring", fsdp: bool = False,
                 moe=None) -> Callable:
    """The eval-mode loss ``(model, tokens, targets) -> loss``: the
    forward-only pipelined loss
    (:func:`..parallel.pipeline.make_pipeline_loss_fn`, over the
    distributed transport with ``mesh``, its seq and expert axes and FSDP
    shards included) with dropout off. With ``moe`` it is the cross
    entropy only: the routing aux is a training regulariser, so a MoE
    eval loss compares across capacity and aux settings (the JAX MoE
    eval convention)."""
    eval_cfg = (dataclasses.replace(cfg, dropout=0.0)
                if cfg.dropout else cfg)
    return make_pipeline_loss_fn(eval_cfg, sched, n_stages, device=device,
                                 mesh=mesh,
                                 tp_vocab_parallel=tp_vocab_parallel,
                                 sp_attn_impl=sp_attn_impl, fsdp=fsdp,
                                 moe=moe)


def evaluate(eval_fn, model: nn.Module, data: Iterator, num_batches: int
             ) -> dict:
    """Mean eval loss and perplexity over ``num_batches`` from ``data``:
    ``{"eval_loss", "perplexity", "num_batches"}``, perplexity =
    exp(mean token CE)."""
    total = 0.0
    n = 0
    for _ in range(num_batches):
        try:
            tokens, targets = next(data)
        except StopIteration:
            break
        total += float(eval_fn(model, tokens, targets))
        n += 1
    if n == 0:
        raise ValueError("evaluate: data iterator yielded no batches")
    mean = total / n
    return {"eval_loss": mean, "perplexity": math.exp(min(mean, 700.0)),
            "num_batches": n}


def fsdp_dims_of(model: nn.Module) -> dict:
    """``{"n": n_data, "dims": {name: dim}}`` of a model's FSDP shards
    (the sharded leaves only), as a checkpoint records them."""
    from ..parallel.fsdp import fsdp_shard_of
    shard = fsdp_shard_of(model)
    return {"n": shard.n, "dims": {k: d for k, d in shard.dims.items()
                                   if d is not None}}


def _latest_step_dir(checkpoint_dir: str) -> Optional[Tuple[int, str]]:
    """The newest *committed* ``step_{n}`` under ``checkpoint_dir``
    (:func:`.resilience.latest_committed_step_dir`)."""
    return latest_committed_step_dir(checkpoint_dir)


def _ep_opt_state(opt_state, state, fn):
    """``state`` (``opt_state.state_dict()``) with each expert stack's
    per-parameter tensors (AdamW's moments, the accumulation's running
    mean) mapped by ``fn(name, tensor)``, in the parameters' order (so a
    collective in ``fn`` pairs on every rank). Under ZeRO-1 a moment is
    the rank's flat data block of its expert stack, so the expert group's
    blocks, gathered, lie end to end in expert order."""
    from ..models.moe import is_expert_leaf
    if isinstance(opt_state, MultiStepsState):
        names = opt_state.inner.names
        return {**state,
                "inner": _ep_opt_state(opt_state.inner, state["inner"], fn),
                "acc": [fn(n, a) if is_expert_leaf(n) else a
                        for n, a in zip(names, state["acc"])]}
    if not isinstance(opt_state, (AdamWState, ShardedAdamWState)):
        return state  # SGD's count only
    tensors = getattr(opt_state, "shards", opt_state.params)
    name_of = dict(zip(map(id, tensors), opt_state.names))
    order = [name_of[id(p)] for g in opt_state.optimizer.param_groups
             for p in g["params"]]
    out = dict(state, state={})
    for i in sorted(state["state"]):
        entry = dict(state["state"][i])
        if is_expert_leaf(order[i]):
            for k in ("exp_avg", "exp_avg_sq"):
                entry[k] = fn(order[i], entry[k])
        out["state"][i] = entry
    return out


def fit(cfg: ModelConfig, sched: ScheduleConfig, n_stages: int,
        model: nn.Module, data: Iterator, num_steps: int,
        optimizer: Optional[AdamW] = None, log_every: int = 10,
        verbose: bool = True, checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0, resume: bool = False,
        skip_data_on_resume: bool = True,
        metrics_path: Optional[str] = None, moe=None,
        sp_attn_impl: str = "ring", tp_vocab_parallel: bool = False,
        zero1: bool = False, fsdp: bool = False, remat_backward=None,
        dropout_seed: int = 0,
        eval_data: Optional[Callable[[], Iterator]] = None,
        eval_every: int = 0, eval_batches: int = 8,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (2, 5), grad_accum: int = 1,
        report_dir: Optional[str] = None, telemetry=None,
        keep_last: Optional[int] = None, guard=None, fault_plan=None,
        handle_preemption: bool = False,
        stall_timeout_s: Optional[float] = None, dynamics=None,
        device="cuda", mesh=None):
    """Training loop over a ``(tokens, targets)`` iterator over ``n_stages``
    (D) pipeline stages (the JAX ``fit``, in its order of events). Trains
    ``model`` in place and returns ``(model, history)``, history a list of
    ``(step, loss)`` at the log points.

    Without ``mesh`` the D stages run in lockstep in this process. With
    ``mesh`` (this rank's ``parallel.mesh.Mesh``; every rank of the world
    calls ``fit`` alike) ``model`` is the rank's view, ``data`` yields the
    rank's slice of each global batch (``utils.data.batch_sharding``),
    and the steps run over the distributed transport
    (:func:`make_train_step`); with a model axis ``model`` is the rank's
    shard (``parallel.tensor_parallel.shard_model``, its head split over
    the vocab under ``tp_vocab_parallel``, which needs the model axis).
    ``zero1`` shards the optimizer's moments
    over the data group (:func:`init_sharded_opt_state`; without a data
    axis above 1 it is plain AdamW, as in JAX). Log lines and metrics
    come from global rank 0 and count the global batch; checkpoints are
    the world's (``resilience.CheckpointManager`` with the mesh; the
    fingerprint holds the mesh's shape, so a restore needs the same
    shape); ``profile_dir`` gets one trace per rank (``rank{r}/``). A
    crash is not banked under a mesh (the other ranks are blocked in the
    step: the launcher fails the world, and the run resumes from the
    last committed checkpoint), and the preemption flag is the world's.

    - ``checkpoint_dir`` + ``checkpoint_every``: save every n steps (and at
      the end) to ``step_{n}/`` through ``resilience.CheckpointManager``
      (commit markers, ``keep_last`` retention); the model's, the
      optimizer's (whose device step count is the learning-rate schedule's
      count) and, where on, the guard's and the accumulation's state, and
      the step. Mid-run saves are async (``checkpoint.save_checkpoint``).
      ``resume=True`` restores the newest committed checkpoint and, with
      ``skip_data_on_resume``, drains the completed steps' batches from
      ``data``, so an interrupted and resumed run repeats the unbroken
      one's steps bit for bit.
    - ``metrics_path``: one JSON line per log point, ``{"step", "loss",
      "tokens_per_sec", "elapsed_s"}`` (tokens/s = batch * seq * steps
      over the wall clock since the last log point; the log point's loss
      read is the window's one sync), and one per eval, ``{"step",
      "eval_loss", "perplexity", "num_batches"}``.
    - ``eval_data`` + ``eval_every``: every n steps (and at the end) the
      forward-only pipelined loss (:func:`make_eval_fn`) over
      ``eval_batches`` batches of a fresh ``eval_data()`` iterator; eval
      restarts the timing window.
    - ``profile_dir``: a ``torch.profiler`` Chrome trace
      (``utils.profiling.trace``) of steps ``profile_steps`` = [start,
      end), counted from the first step this run executes.
    - ``grad_accum``: :class:`MultiSteps` over k batches; ``num_steps``
      counts batches.
    - ``guard`` (True or a ``resilience.AnomalyGuard``): the guarded step;
      the counters are read at log points only, and the consecutive
      budget's excess checkpoints the last good state and raises
      ``resilience.AnomalyBudgetExceeded``.
    - ``handle_preemption``: SIGTERM/SIGINT finish the step, save
      synchronously and return. ``stall_timeout_s``: a watchdog logs a
      stall. Any other crash banks the last completed step before it
      propagates. ``fault_plan`` injects the ``resilience.FaultPlan``
      faults.
    - ``report_dir``: a ``utils.telemetry.RunReport`` (global rank 0's
      under a mesh): ``events.jsonl`` streamed as the run goes (every log
      point, eval, resume, stall, guard skip, preemption and crash, with
      JAX's kinds and fields) and a final ``report.json`` that
      ``telemetry.validate_report`` accepts. Its manifest holds the
      config, schedule, mesh shape, steps, ``grad_accum`` and backend,
      the ``steps`` counter and ``final_loss`` gauge, the ``compile_s``
      timer, the telemetry section, the cost model with its measured
      attribution, the run's one-row ``calibration`` section, the memory
      model with its ``live`` watermarks, and the resilience section.
      The cost model and the calibration section carry the corrections
      ``analysis.calibration.maybe_load_default_corrections`` finds
      (``$DTPP_CALIBRATION_CORRECTIONS``, else the default artifact; an
      artifact that fails its check is skipped), as in JAX.
      ``compile_s`` is the first executed step's wall, forced to
      completion, as in JAX; in the port it holds the kernels' lazy
      build and autograd's first use, not a compile.
    - ``telemetry``: a ``utils.telemetry.PipelineTelemetry`` the steps
      stamp (:func:`make_train_step`), reset before each step, so it
      holds the newest step's timeline (JAX's ``fit`` lets the steps'
      stamps pile up, and its timeline then spans the run); embedded in
      the report when ``report_dir`` is set. Under a mesh every rank
      passes its own, and global rank 0's holds the world's stamps.

    - ``dynamics`` (True or a ``dynamics.DynamicsConfig``; the JAX
      ``dynamics``): the step's statistics (:func:`make_train_step`),
      read at the log points in the loss's one read-back; the
      gradient-noise scale from the microbatches' squared norms
      (``dynamics.GNSEstimator``); a ring of recent log points and batch
      digests (``dynamics.ForensicRecorder``; a batch that
      ``data.prefetch_to_device(..., digest=True)`` yields carries the
      digest of its host arrays, any other batch is hashed here, a card
      tensor after a read-back); on a guard skip or a z-score loss spike
      a forensic bundle next to the manifest (with ``report_dir``); under
      the guard an ``anomaly_attributed`` event naming the first
      non-finite stage; ``dynamics`` events at the log points and the
      report's ``dynamics`` section.

    - ``fsdp``: pp x fsdp (ZeRO-3 in the pipeline, the JAX ``fsdp``; needs
      a data axis). A whole view is first cut to the rank's shards
      (``parallel.fsdp.fsdp_shard_params``; the returned model is that
      copy), AdamW's moments are born shard-shaped, and each rank's
      checkpoint file holds its shards (``state_pipe{d}_data{k}...``),
      which ``utils.checkpoint.restore_world_model`` gathers into the
      whole model. ``zero1`` with ``fsdp`` raises ``ValueError``, as in
      JAX: FSDP shards the optimizer state already.
    - A seq axis (``mesh.n_seq`` above 1): ``data`` yields the rank's
      chunk of each sequence (``batch_sharding``) and ``sp_attn_impl``
      ("ring" or "ulysses") picks the attention; the seq ranks hold the
      same parameters, and only seq coordinate 0 writes checkpoints.
    - ``moe`` (a ``models.moe.MoEConfig``; ``model`` a
      ``models.moe.MoELM``): MoE stages (:func:`make_train_step`), the
      eval the cross entropy only (:func:`make_eval_fn`). On an expert
      axis ``data`` yields the rank's rows over data x expert
      (``batch_sharding``), a whole model is first cut to the rank's block
      of the experts (``parallel.expert_parallel.ep_shard_model``; the
      returned model is that copy), and a checkpoint holds the whole
      expert stacks and their moments, gathered over the expert group and
      written by expert coordinate 0 (JAX saves global arrays), so a run
      without the expert axis loads it; a resumed rank takes its block.
      MoE composes with every axis and with ``fsdp`` (the expert block
      cut first, then its FSDP shards on the MoE dims) and ``zero1`` (the
      moments over the data group only: a rank's blocks of its own
      experts' stacks, gathered over the expert group into the
      checkpoint).

    The dropout seed of step i is ``fold_seed(dropout_seed, i)``, so a
    resumed run draws the unbroken run's masks.
    """
    n_ep = 1 if mesh is None else mesh.n_expert
    if fsdp and zero1:
        raise ValueError("fsdp already shards optimizer state (ZeRO-3 "
                         "subsumes ZeRO-1) — drop --zero1")
    device = mesh_device(device, mesh, n_stages)
    rank0 = mesh is None or mesh.rank == 0
    verbose = verbose and rank0
    metrics_path = metrics_path if rank0 else None
    # the global batch's rows: the expert axis splits them too
    n_data = 1 if mesh is None else mesh.n_data * mesh.n_expert
    n_seq = 1 if mesh is None else mesh.n_seq  # a rank's chunk of each row
    if guard is True:
        guard = AnomalyGuard()
    if optimizer is None:
        # the schedule advances once per optimizer update: size its
        # horizon in updates, not batches
        optimizer = adamw(total_steps=max(1, num_steps // grad_accum))
    if grad_accum > 1:
        optimizer = MultiSteps(optimizer, grad_accum)
    dcfg = as_dynamics_config(dynamics)
    step_fn = make_train_step(cfg, sched, n_stages, optimizer,
                              remat_backward=remat_backward, device=device,
                              guard=guard, fault_plan=fault_plan, mesh=mesh,
                              tp_vocab_parallel=tp_vocab_parallel,
                              telemetry=telemetry, dynamics=dcfg, fsdp=fsdp,
                              sp_attn_impl=sp_attn_impl, moe=moe)
    if n_ep > 1 and moe is not None and model.expert == (1, 0):
        from ..parallel.expert_parallel import ep_shard_model
        model = ep_shard_model(model, mesh)
    if fsdp:
        from ..parallel.fsdp import fsdp_shard_of, fsdp_shard_params
        if fsdp_shard_of(model) is None:
            model = fsdp_shard_params(model, cfg, mesh)
    report = None
    if report_dir is not None and rank0:
        from .telemetry import RunReport
        report = RunReport(out_dir=report_dir, name="fit")
        report.set_meta(config=dataclasses.asdict(cfg),
                        schedule=dataclasses.asdict(sched),
                        mesh_shape=({"data": 1, "pipe": n_stages}
                                    if mesh is None else dict(mesh.shape)),
                        num_steps=num_steps, grad_accum=grad_accum,
                        backend=device.type)
    opt_state = (init_sharded_opt_state(optimizer, model, mesh) if zero1
                 else optimizer.init(model))
    guard_state = init_guard_state(0, device) if guard is not None else None

    def _state(i):
        state = {"model": model.state_dict(),
                 "optimizer": opt_state.state_dict(), "step": i,
                 "guard": guard_state}
        if fsdp:  # the shards' dims, for a restore into a whole model
            state["fsdp"] = fsdp_dims_of(model)
        if n_ep > 1:  # the whole expert stacks, as JAX saves them
            from ..parallel.expert_parallel import ep_gather, ep_gather_state
            state["model"] = ep_gather_state(state["model"], mesh)
            state["optimizer"] = _ep_opt_state(
                opt_state, state["optimizer"], lambda _, t: ep_gather(t, mesh))
        return state

    def _load(state):
        """This rank's part of a restored state into the model and the
        optimizer (its block of the experts on an expert axis)."""
        model_state, opt = state["model"], state["optimizer"]
        if n_ep > 1:
            from ..models.moe import expert_block
            from ..parallel.expert_parallel import ep_shard_state
            model_state = ep_shard_state(model_state, model.expert)
            opt = _ep_opt_state(opt_state, opt, lambda n, t: expert_block(
                n, t, model.expert).clone())
        model.load_state_dict(model_state)
        opt_state.load_state_dict(opt)

    mgr = None
    if checkpoint_dir:
        mgr = CheckpointManager(
            checkpoint_dir, keep_last=keep_last,
            fingerprint=config_fingerprint(
                cfg, sched, {"pipe": n_stages} if mesh is None
                else mesh.shape),
            fault_plan=fault_plan, mesh=mesh, zero1=zero1, fsdp=fsdp)
    if fault_plan is not None:
        data = fault_plan.wrap_data(data)

    start_step = 0
    guard_seen = 0  # anomalies already surfaced (host high-water mark)
    if resume and mgr is not None:
        restored = mgr.restore_latest(_state(0))
        if restored is not None:
            n, path, state = restored
            _load(state)
            if guard_state is not None:
                for k, v in state["guard"].items():
                    guard_state[k].copy_(v)
                guard_seen = int(state["guard"]["total"])
            start_step = int(state["step"]) + 1
            if skip_data_on_resume:
                for _ in range(start_step):
                    next(data)
            if verbose:
                print(f"resumed from {path} (step {n})", flush=True)
            if report is not None:
                report.event("resumed", step=n, path=path)

    def _save(i, wait=True):
        mgr.save(i, _state(i), wait=wait)

    # the dynamics' host state: the GNS estimator over the microbatches'
    # squared norms, the ring and spike detector, the stats last read
    gns_est = None
    recorder = None
    dyn_host = None
    n_skipped_attributed = 0
    if dcfg is not None:
        from .dynamics import (ForensicRecorder, GNSEstimator, batch_digest,
                               dynamics_section)
        recorder = ForensicRecorder(out_dir=report_dir if rank0 else None,
                                    ring=dcfg.ring, spike_z=dcfg.spike_z,
                                    warmup=dcfg.spike_warmup)

    def _checkpoint_pointer():
        """The last committed checkpoint's step, for a bundle."""
        if mgr is None:
            return None
        st = mgr.stats()
        return {k: st[k] for k in ("last_committed_step",) if k in st}

    eval_fn = None
    if eval_data is not None and eval_every:
        eval_fn = make_eval_fn(cfg, sched, n_stages, device=device,
                               mesh=mesh, tp_vocab_parallel=tp_vocab_parallel,
                               sp_attn_impl=sp_attn_impl, fsdp=fsdp, moe=moe)
    if profile_dir is not None and mesh is not None:
        profile_dir = os.path.join(profile_dir, f"rank{mesh.rank}")
    # under a mesh the preemption flag is the world's: one host read a
    # step, only where a preemption can come
    world_preempt = mesh is not None and (
        handle_preemption or getattr(fault_plan, "preempt_at_step", None)
        is not None)

    def _eval(i):
        m = evaluate(eval_fn, model, eval_data(), eval_batches)
        if verbose:
            print(f"step {i}: eval_loss {m['eval_loss']:.4f} "
                  f"ppl {m['perplexity']:.2f}", flush=True)
        if metrics_path:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"step": i, **m}) + "\n")
        if report is not None:
            report.event("eval", step=i, **m)
        return m

    preempt = PreemptionHandler(enabled=handle_preemption)
    watchdog = None
    if stall_timeout_s:
        def _on_stall(info):
            logging.getLogger(__name__).warning(
                "fit: no step completed in %.1fs (last completed step %s) "
                "— stalled card or dead input pipeline?",
                info["stalled_s"], info["step"])
            if report is not None:
                report.count("stalls")
                report.event("stall", **info)
        watchdog = StepWatchdog(stall_timeout_s, _on_stall)

    history = []
    window_start = time.perf_counter()
    window_tokens = 0
    profiler = contextlib.ExitStack()
    profiling_on = False
    preempted = False
    last_done = start_step - 1  # newest step whose outputs the model holds
    # profile_steps counts from the first step THIS run executes
    prof_start = start_step + profile_steps[0]
    prof_stop = start_step + max(profile_steps[1], profile_steps[0] + 1)
    data_shape = None  # (global batch, seq) of the first batch

    def _finalize_report():
        if report is None:
            return
        report.count("steps", max(last_done - start_step + 1, 0))
        if history:
            report.gauge("final_loss", history[-1][1])
        cs = None
        if data_shape is not None:
            from ..analysis.cost_model import detect_hardware
            from ..parallel.schedules import compile_schedule
            cs = compile_schedule(sched.name, n_stages, sched.n_virtual,
                                  sched.n_microbatches)
            hw = detect_hardware(device)
        if telemetry is not None:
            report.attach_telemetry(telemetry)
            # the predicted and measured step over the table the stamps
            # were taken on; an accounting error is recorded, it does not
            # take the run's report down
            if telemetry.events and cs is not None:
                try:
                    from ..analysis.calibration import (
                        calibration_section_from_cost_model,
                        maybe_load_default_corrections)
                    from ..analysis.cost_model import cost_model_section
                    if (telemetry.table is not None
                            and cs.table.shape == telemetry.table.shape):
                        corrections = maybe_load_default_corrections()
                        cm = cost_model_section(
                            cs, cfg, batch_size=data_shape[0],
                            seq_length=data_shape[1], hardware=hw,
                            remat_backward=remat_backward,
                            telemetry=telemetry, correction=corrections)
                        report.attach_cost_model(cm)
                        # the run's own predicted-against-measured point
                        cal = calibration_section_from_cost_model(
                            cm, backend=device.type,
                            name=f"train_{sched.name}",
                            correction=corrections)
                        if cal is not None:
                            report.attach_calibration(cal)
                except Exception as e:
                    report.event("cost_model_error", error=str(e))
        if cs is not None:
            # the bytes-domain twin: the analytic model (AdamW's two f32
            # moments) and the stamps' live watermarks
            try:
                from ..analysis.memory_model import memory_model_section
                report.attach_memory(memory_model_section(
                    cs, cfg, batch_size=data_shape[0],
                    seq_length=data_shape[1], hardware=hw,
                    remat_backward=remat_backward, optimizer_slots=2,
                    telemetry=telemetry))
            except Exception as e:
                report.event("memory_model_error", error=str(e))
        if dcfg is not None:
            report.attach_dynamics(dynamics_section(
                n_stages * sched.n_virtual, last_stats=dyn_host,
                gns=gns_est.value() if gns_est is not None else None,
                gns_updates=gns_est.n_updates if gns_est is not None else 0,
                n_skipped_attributed=n_skipped_attributed,
                forensic_bundles=recorder.bundles))
        res = {}
        if mgr is not None:
            res.update(mgr.stats())
        if guard is not None:
            res["anomaly_budget"] = guard.max_consecutive
            res["anomalies"] = guard_seen
        if handle_preemption or (fault_plan is not None
                                 and fault_plan.preempt_at_step is not None):
            res["preempted"] = preempted
        if watchdog is not None:
            res["stalls"] = watchdog.stalls
        if res:
            report.attach_resilience(res)
        report.write()

    try:
        with preempt:
            for i in range(start_step, num_steps):
                if fault_plan is not None and fault_plan.preempt_at_step == i:
                    preempt.trigger()  # deterministic stand-in for SIGTERM
                if profile_dir is not None:
                    if i == prof_start and not profiling_on:
                        profiler.enter_context(profiling.trace(profile_dir))
                        profiling_on = True
                    elif i == prof_stop and profiling_on:
                        profiler.close()
                        profiling_on = False
                        if verbose:
                            print(f"profile trace written to {profile_dir}",
                                  flush=True)
                batch = next(data)
                tokens, targets = batch
                if data_shape is None:
                    data_shape = (int(tokens.shape[0]) * n_data,
                                  int(tokens.shape[1]) * n_seq)
                if recorder is not None:
                    digest = getattr(batch, "digest", None)
                    recorder.note_batch(i, digest if digest is not None
                                        else batch_digest(tokens, targets))
                seed = (fold_seed(dropout_seed, i) if cfg.dropout > 0.0
                        else None)
                # the first executed step: kernel builds, first launches,
                # autograd's first use; the compile_s timer brackets it,
                # forced to completion
                first = report is not None and i == start_step
                if telemetry is not None:
                    telemetry.reset()  # the stamps hold the newest step
                with (report.timer("compile_s") if first
                      else contextlib.nullcontext()):
                    if guard_state is not None:
                        out = step_fn(model, opt_state, tokens, targets,
                                      guard_state, seed)
                        loss, guard_state = out[:2]
                    else:
                        out = step_fn(model, opt_state, tokens, targets,
                                      seed)
                        loss = out[0] if dcfg is not None else out
                    if dcfg is not None:
                        dyn_latest = out[-1]
                    if first:
                        force_completion(loss)
                last_done = i
                if watchdog is not None:
                    watchdog.beat(i)
                window_tokens += (tokens.shape[0] * tokens.shape[1] * n_data
                                  * n_seq)
                if i % log_every == 0 or i == num_steps - 1:
                    # one read-back closes the window: the loss and, from
                    # the same step, the guard counters (exact in f64)
                    read = [loss.detach().double().reshape(1)]
                    if guard_state is not None:
                        read.append(torch.stack(
                            list(guard_state.values())).double())
                    n_read = sum(int(r.numel()) for r in read)
                    if dcfg is not None:  # the same read-back
                        read += [v.detach().double().reshape(-1)
                                 for v in dyn_latest.values()]
                    values = torch.cat(read).tolist()
                    loss_f, *counters = values[:n_read]
                    if dcfg is not None:
                        dyn_host = _unflatten(dyn_latest, values[n_read:])
                    elapsed = time.perf_counter() - window_start
                    history.append((i, loss_f))
                    if verbose:
                        print(f"step {i}: loss {loss_f:.4f}", flush=True)
                    if metrics_path:
                        with open(metrics_path, "a") as f:
                            f.write(json.dumps({
                                "step": i, "loss": loss_f,
                                "tokens_per_sec": round(
                                    window_tokens / elapsed, 2),
                                "elapsed_s": round(elapsed, 4)}) + "\n")
                    if report is not None:
                        report.event("train_log", step=i, loss=loss_f,
                                     tokens_per_sec=round(
                                         window_tokens / elapsed, 2),
                                     elapsed_s=round(elapsed, 4))
                    if dcfg is not None:
                        if "sq_mb" in dyn_host:
                            if gns_est is None:
                                toks = data_shape[0] * data_shape[1]
                                small = toks / (n_data * sched.n_microbatches)
                                if small < toks:  # M * data == 1: no pair
                                    gns_est = GNSEstimator(
                                        batch_small=small, batch_big=toks,
                                        ema=dcfg.ema)
                            if gns_est is not None:
                                gns_est.update(
                                    float(dyn_host["sq_mb"].mean()),
                                    float(dyn_host["grad_norm"]) ** 2)
                        gns_val = (gns_est.value() if gns_est is not None
                                   else None)
                        if report is not None:
                            report.event(
                                "dynamics", step=i,
                                grad_norm=float(dyn_host["grad_norm"]),
                                grad_norm_per_stage=[
                                    float(x) for x in
                                    dyn_host["grad_norm_per_stage"]],
                                nonfinite_per_stage=[
                                    int(x) for x in
                                    dyn_host["nonfinite_per_stage"]],
                                gns=gns_val)
                        spike_z = recorder.observe(i, loss_f, stats=dyn_host,
                                                   gns=gns_val)
                        if spike_z is not None:
                            path = recorder.dump(
                                i, "loss_spike", loss=loss_f, z=spike_z,
                                stats={k: v for k, v in dyn_host.items()
                                       if k != "sq_mb"},
                                checkpoint=_checkpoint_pointer())
                            if verbose:
                                print(f"step {i}: loss spike (z={spike_z:.1f})"
                                      + (f" — forensics at {path}"
                                         if path else ""), flush=True)
                            if report is not None:
                                report.count("loss_spikes")
                                report.event("loss_spike", step=i,
                                             loss=loss_f,
                                             z=round(float(spike_z), 2),
                                             bundle=path)
                    if guard_state is not None:
                        gs = {k: int(v) for k, v in zip(guard_state,
                                                        counters)}
                        if gs["total"] > guard_seen:
                            delta = gs["total"] - guard_seen
                            guard_seen = gs["total"]
                            bad = gs["last_bad_stage"]
                            where = (f" in stage {bad}" if bad >= 0
                                     else " (loss only)" if bad == -2 else "")
                            if verbose:
                                print(f"step {i}: anomaly guard skipped "
                                      f"{delta} step(s) (total {gs['total']}, "
                                      f"last at step "
                                      f"{gs['last_anomaly_step']}{where})",
                                      flush=True)
                            if report is not None:
                                report.count("anomalies", delta)
                                report.event(
                                    "anomaly", step=i, total=gs["total"],
                                    consec=gs["consec"],
                                    last_anomaly_step=gs["last_anomaly_step"],
                                    last_bad_stage=bad)
                            if dcfg is not None:
                                # which stage first went non-finite, and
                                # on what statistic
                                n_skipped_attributed += delta
                                attribution = {
                                    "stage": bad,
                                    "statistic": ("nonfinite_grad" if bad >= 0
                                                  else "nonfinite_loss"),
                                    "last_anomaly_step":
                                        gs["last_anomaly_step"],
                                    "nonfinite_per_stage": [
                                        int(x) for x in
                                        dyn_host["nonfinite_per_stage"]]}
                                if report is not None:
                                    report.event("anomaly_attributed", step=i,
                                                 **attribution)
                                path = recorder.dump(
                                    i, "anomaly", loss=loss_f,
                                    stats={k: v for k, v in dyn_host.items()
                                           if k != "sq_mb"},
                                    attribution=attribution,
                                    checkpoint=_checkpoint_pointer())
                                if report is not None and path is not None:
                                    report.event("forensic_bundle", step=i,
                                                 trigger="anomaly",
                                                 bundle=path)
                        if gs["consec"] >= guard.max_consecutive:
                            # the model and optimizer hold the last GOOD
                            # state: every anomalous update was skipped
                            if report is not None:
                                report.count("anomaly_aborts")
                                report.event("anomaly_abort", step=i,
                                             consec=gs["consec"],
                                             budget=guard.max_consecutive)
                            if mgr is not None:
                                _save(i, wait=True)
                            _finalize_report()
                            raise AnomalyBudgetExceeded(
                                f"{gs['consec']} consecutive anomalous steps "
                                f"at step {i} (budget {guard.max_consecutive})"
                                + (" — last good state checkpointed"
                                   if mgr is not None else ""))
                    window_start = time.perf_counter()
                    window_tokens = 0
                if (eval_fn is not None and (i + 1) % eval_every == 0
                        and i != num_steps - 1):
                    _eval(i)
                    # eval time isn't train time: restart the whole window
                    window_start = time.perf_counter()
                    window_tokens = 0
                if (mesh.any(preempt.triggered) if world_preempt
                        else preempt.triggered):
                    # the in-flight step already finished: bank it
                    # synchronously and exit resumable
                    preempted = True
                    sig = preempt.signum
                    if verbose:
                        print(f"step {i}: preemption ({sig}) — "
                              "checkpointing and exiting resumable",
                              flush=True)
                    if report is not None:
                        report.count("preemptions")
                        report.event("preempted", step=i,
                                     signal=int(sig) if sig is not None
                                     else None)
                    if mgr is not None:
                        _save(i, wait=True)
                    break
                if (mgr is not None and checkpoint_every
                        and (i + 1) % checkpoint_every == 0
                        and i != num_steps - 1):
                    _save(i, wait=False)  # written in the background
    except (SimulatedKill, AnomalyBudgetExceeded):
        raise  # injected death / already-handled abort: no crash save
    except BaseException as e:
        # crash-safe exit: the model holds step last_done's outputs — bank
        # them committed so the run resumes instead of restarting
        if mgr is not None and mesh is None and last_done >= start_step:
            try:
                _save(last_done, wait=True)
                if verbose:
                    print(f"crash at step {last_done + 1}: banked committed "
                          f"checkpoint at step {last_done}", flush=True)
            except Exception:
                logging.getLogger(__name__).exception(
                    "fit: crash checkpoint at step %d failed", last_done)
        if report is not None:
            report.event("crash", step=last_done, error=repr(e))
            with contextlib.suppress(Exception):
                _finalize_report()
        raise
    finally:
        if watchdog is not None:
            watchdog.stop()
        profiler.close()  # the window ran past the last executed step
    if eval_fn is not None and num_steps > start_step and not preempted:
        _eval(num_steps - 1)
    if (mgr is not None and checkpoint_every and num_steps > start_step
            and not preempted):
        _save(num_steps - 1)
    if mgr is not None:
        mgr.commit_pending()
    _finalize_report()
    return model, history


def _unflatten(like, values):
    """The stats dict ``like`` (device tensors) from its flattened
    read-back ``values``: numpy arrays of the tensors' shapes (int32
    counts as integers)."""
    out, k = {}, 0
    for name, t in like.items():
        n = int(t.numel())
        a = np.asarray(values[k:k + n], dtype=np.float64).reshape(t.shape)
        out[name] = a.astype(np.int64) if not t.is_floating_point() else a
        k += n
    return out


def synthetic_data(cfg: ModelConfig, batch_size: int, seq_length: int,
                   seed: int = 0) -> Iterator:
    """Random-token batches with next-token targets (the JAX
    ``synthetic_data``; :func:`.data.synthetic_batches` with the model's
    vocab)."""
    from .data import synthetic_batches
    return synthetic_batches(cfg.vocab_size, batch_size, seq_length,
                             seed=seed)
