"""Expert parallelism: a MoE model's experts split over the expert axis of
a ``torch.distributed`` world (the counterpart of the JAX package's
``parallel/expert_parallel.py``).

The GShard recipe: the token batch and the expert stacks (the ``w1``,
``b1``, ``w2`` and ``b2`` leaves under each ``moe``, on their leading
expert dim) are split over the expert axis; the router and every
attention, norm, embedding and head leaf are replicated. Each rank routes
its own tokens, packs each expert's capacity slots and exchanges slot
blocks with the other expert ranks by an all-to-all
(``ops.collectives.expert_all_to_all``), runs its resident experts and
reverses the exchange. The exchange's backward is the inverse exchange,
so autograd needs no other code; the replicated leaves' gradients are
each rank's share and sum over the expert group, the expert stacks' are
whole on their rank.

Where JAX gives ``shard_map`` a ``PartitionSpec`` tree
(``ep_param_specs``), a rank here holds its block of the experts:
``models.moe.MoELM(..., expert=(n_ep, index))``, built by
``utils.weights.from_jax_params(..., moe=, expert=)`` or cut from a whole
model by :func:`ep_shard_model`; :func:`ep_gather_state` is the inverse,
the whole stacks from the group's blocks (what a checkpoint holds). The
expert dim is neither the model axis's (each expert's ffn dim,
``parallel.tensor_parallel``) nor, under EP, the data axis's
(``parallel.fsdp.moe_fsdp_shard_dims``), so a rank's block composes with
its Megatron and FSDP shards, and the gather works on either.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
import torch.nn as nn

from ..models.moe import (MoEConfig, MoELM, expert_block, is_expert_leaf,
                          moe_lm_loss)
from ..utils.config import ModelConfig
from .mesh import EXPERT_AXIS, Mesh

__all__ = ["is_expert_leaf", "ep_shard_model", "ep_gather",
           "ep_gather_state", "ep_shard_state", "ep_reduce_grads",
           "make_ep_loss_fn"]


def ep_shard_model(model: MoELM, mesh: Mesh) -> MoELM:
    """A copy of a whole-expert ``model`` (all E experts in each stack)
    holding this rank's block of them (``expert=(n_expert,
    mesh.expert)``); the other leaves are copied as they are. ``model``
    may be a pipe rank's view, its Megatron shard
    (``parallel.tensor_parallel.shard_model``) or its FSDP shard: the
    expert dim is split by neither, so the cuts compose in any order."""
    from .tensor_parallel import _owner
    if model.expert != (1, 0):
        raise ValueError(f"the model holds expert block {model.expert}, "
                         f"not all experts")
    expert = (mesh.n_expert, mesh.expert)
    out = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in list(out.named_parameters()):
            if is_expert_leaf(name):
                mod, leaf = _owner(out, name)
                setattr(mod, leaf, nn.Parameter(
                    expert_block(name, p.detach(), expert).clone(),
                    requires_grad=p.requires_grad))
    out.expert = expert
    return out


def ep_shard_state(state: Dict[str, torch.Tensor], expert
                   ) -> Dict[str, torch.Tensor]:
    """A whole-expert state dict cut to block ``index`` of ``n_ep`` of the
    experts (``expert`` = ``(n_ep, index)``)."""
    return {k: expert_block(k, v, expert).clone() for k, v in state.items()}


def ep_gather_state(state: Dict[str, torch.Tensor], mesh: Mesh
                    ) -> Dict[str, torch.Tensor]:
    """The whole expert stacks of a state dict whose expert leaves are this
    rank's block: each gathered over the expert group in expert order
    (every rank of the group calls it, with the same names); the other
    entries as they are."""
    return {k: ep_gather(v, mesh) if is_expert_leaf(k) else v
            for k, v in state.items()}


def ep_gather(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole expert stack of which ``block`` is this rank's block
    (leading dim), gathered over the expert group in expert order."""
    if mesh.n_expert == 1:
        return block
    whole = torch.empty((mesh.n_expert * block.shape[0],) + block.shape[1:],
                        dtype=block.dtype, device=block.device)
    mesh.all_gather(whole, block.contiguous(), EXPERT_AXIS)
    return whole


def ep_reduce_grads(model: nn.Module, mesh: Mesh) -> None:
    """Sum the gradients of ``model``'s replicated leaves (all but the
    expert stacks) over the expert group, in place: after the backward of
    :func:`make_ep_loss_fn`'s loss each rank holds its share of them."""
    grads = [p.grad for n, p in model.named_parameters()
             if p.grad is not None and not is_expert_leaf(n)]
    mesh.all_reduce(grads, EXPERT_AXIS)


def make_ep_loss_fn(cfg: ModelConfig, moe: MoEConfig, mesh: Mesh,
                    ) -> Callable[..., torch.Tensor]:
    """Expert-parallel ``(model, tokens, targets) -> loss`` on this rank
    of an expert world (the JAX ``make_ep_loss_fn``): ``model`` the rank's
    expert shard of the whole model (``from_jax_params(..., moe=,
    expert=(n_expert, mesh.expert))`` or :func:`ep_shard_model`),
    ``tokens``/``targets`` the rank's rows of the global [B, S] batch
    (``utils.data.batch_sharding``; B divides by the world). The loss is
    ``models.moe.moe_lm_loss`` with the expert axis: the mean over the
    expert group, the same on every rank. Differentiable: after its
    ``backward`` the expert stacks' gradients are whole and the other
    leaves' sum over the group (:func:`ep_reduce_grads`). The CE term
    equals the unsharded loss when no token overflows capacity; the aux
    term uses each shard's routing statistics, so the whole loss equals
    the unsharded one only with ``aux_loss_weight=0`` as well."""
    if moe.n_experts % mesh.n_expert != 0:
        raise ValueError(
            f"n_experts={moe.n_experts} must divide over "
            f"{mesh.n_expert} expert shards")
    want = (mesh.n_expert, mesh.expert)

    def loss_fn(model: MoELM, tokens, targets) -> torch.Tensor:
        if model.expert != want:
            raise ValueError(f"the model holds expert block {model.expert}, "
                             f"this rank needs {want}")
        tokens = torch.as_tensor(tokens, device=mesh.device).long()
        targets = torch.as_tensor(targets, device=mesh.device).long()
        return moe_lm_loss(cfg, moe, model, tokens, targets, ep=mesh)

    return loss_fn

