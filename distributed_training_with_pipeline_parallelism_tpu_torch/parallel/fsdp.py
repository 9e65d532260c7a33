"""FSDP (ZeRO-3): parameters sharded over a world's data axis (the
counterpart of the JAX package's ``parallel/fsdp.py`` and of the pp x
fsdp placement of its ``parallel/pipeline.py``: ``_fsdp_shard_dims``
``:80`` and ``fsdp_shard_params`` ``:1907``).

JAX states the layout as shardings and lets XLA's partitioner gather the
parameters and scatter the gradients. The port does it by hand: each data
rank's model holds only its block of every sharded leaf (a copy made by
:func:`shard_params_fsdp` or :func:`fsdp_shard_params`, which records an
:class:`FSDPShard` as ``.fsdp_shard``); the code that uses a module
gathers its leaves just in time (:func:`gathered_call`, one all-gather
over the data group for all of them), runs it on the whole tensors
(``torch.func.functional_call``), and the gather's backward
reduce-scatters their gradients into the shards' ``.grad``
(``ops.collectives.fsdp_gather``). Between steps the parameters, the
gradients and the optimizer's moments all rest at 1/n_data.

Two placements, as in JAX:

- :func:`fsdp_specs` (the JAX ``fsdp_specs``, for :func:`make_fsdp_grad_fn`
  on a data-only world): every leaf on its largest dim that divides the
  shard count, ties broken toward a later dim; scalars and indivisible
  leaves replicated.
- :func:`fsdp_shard_dims` (the JAX ``_fsdp_shard_dims``, for the
  pipeline): only the blocks' linear matrices, each on its first weight
  dim that divides ``n_data`` and, under a model axis, is not its
  Megatron dim; norms, biases, the embedding and the head replicated.
  Its MoE twin :func:`moe_fsdp_shard_dims` (the JAX
  ``_moe_fsdp_shard_dims``) adds the expert stacks ``w1`` and ``w2``, each
  on its first dim that divides ``n_data`` and is owned by neither the
  expert axis (E, under EP) nor the model axis (the ffn dim, under TP);
  the router, ``b1`` and ``b2`` stay replicated.

A JAX ``linear.w`` is ``[in, out]`` and the port's weight ``[out, in]``:
a JAX dim is mapped to the port's layout leaf by leaf, so a port shard is
the JAX shard transposed. JAX stacks the blocks' leaves on a leading
layer axis, which the port's per-block parameters do not have; where the
JAX rule picks that axis, :func:`fsdp_specs` raises.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..ops import collectives as col
from ..utils.config import ModelConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class FSDPShard:
    """Which FSDP shard a model holds: data coordinate ``index`` of ``n``,
    and ``dims``, each parameter's sharded dim (None: replicated)."""

    n: int
    index: int
    dims: Dict[str, Optional[int]]


def fsdp_shard_of(model: nn.Module) -> Optional[FSDPShard]:
    """The :class:`FSDPShard` a model holds, or None for a whole one."""
    return getattr(model, "fsdp_shard", None)


def fsdp_names(model: nn.Module):
    """The names of ``model``'s parameters sharded over the data axis."""
    shard = fsdp_shard_of(model)
    if shard is None:
        return set()
    return {n for n, d in shard.dims.items() if d is not None}


def make_fsdp_mesh(n_data: int, *, backend: str, device):
    """This rank's mesh of a data-only world of ``n_data`` ranks (the JAX
    ``make_fsdp_mesh``; every rank of a ``launch`` world calls it)."""
    from .mesh import make_mesh
    return make_mesh(1, n_data, backend=backend, device=device)


def _is_linear(name: str, shape) -> bool:
    return len(shape) == 2 and name not in ("tok", "pos")


def fsdp_specs(model: nn.Module, n_shards: int) -> Dict[str, Optional[int]]:
    """Each parameter's sharded dim under the JAX ``fsdp_specs`` rule,
    mapped to the port's layout: the rule runs on the JAX leaf's shape
    (a linear weight transposed; a block's leaf with the stacked layer
    axis in front) and its pick is the port's dim of that JAX dim."""
    n_layers = model.cfg.n_layers
    out = {}
    for name, p in model.named_parameters():
        shape = list(p.shape)
        lin = _is_linear(name, shape)
        jshape = shape[::-1] if lin else shape
        to_port = [1, 0] if lin else list(range(len(shape)))
        if name.startswith("layers."):
            jshape, to_port = [n_layers] + jshape, [None] + to_port
        out[name] = None
        order = sorted(range(len(jshape)), key=lambda i: (jshape[i], i != 0),
                       reverse=True)
        for i in order:
            if jshape[i] % n_shards == 0 and jshape[i] >= n_shards:
                if to_port[i] is None:
                    raise ValueError(
                        f"fsdp_specs: the JAX rule shards {name}'s stacked "
                        f"layer axis ({n_layers} layers over {n_shards}), "
                        f"which the port's per-block parameters do not "
                        f"have")
                out[name] = to_port[i]
                break
    return out


def fsdp_shard_dims(cfg: ModelConfig, n_data: int, T: int = 1
                    ) -> Dict[str, Optional[int]]:
    """The pipeline's per-leaf data dims (the JAX ``_fsdp_shard_dims``),
    by a block's parameter name (``attn.q.weight``, ``lin1.weight``...):
    for a linear weight the first of its JAX weight dims (in, then out;
    the port's dims 1, then 0) that divides ``n_data`` and, with ``T``
    above 1, is not its Megatron dim (``tensor_parallel.split_dim``);
    None for the rest (norms and biases: O(dim), and sharding them would
    add collectives for nothing)."""
    from ..models.transformer import Transformer
    from .tensor_parallel import split_dim
    block = Transformer(dataclasses.replace(cfg, n_layers=1), device="meta")
    out = {}
    for name, p in block.layers[0].named_parameters():
        out[name] = None
        if not _is_linear(name, p.shape):
            continue
        tp_dim = split_dim(cfg, f"layers.0.{name}") if T > 1 else None
        for dim in (1, 0):
            if dim != tp_dim and p.shape[dim] % n_data == 0:
                out[name] = dim
                break
    return out


def moe_fsdp_shard_dims(cfg: ModelConfig, moe, n_data: int, T: int = 1,
                        n_ep: int = 1) -> Dict[str, Optional[int]]:
    """The MoE blocks' per-leaf data dims (the JAX ``_moe_fsdp_shard_dims``,
    reached through its ``_resolve_fsdp_dims``), by a block's parameter
    name (``attn.q.weight``, ``moe.w1``...): a leaf of two dims or more
    other than the router and ``b1`` takes the first dim, in JAX's order
    (a linear weight's in, then out: the port's dims 1, then 0; an expert
    stack's E, then its own), that divides ``n_data`` and that neither
    the expert axis owns (E, with ``n_ep`` above 1) nor the model axis
    (its Megatron dim, with ``T`` above 1); None for the rest."""
    from ..models.moe import MoEBlock, is_expert_leaf
    from .tensor_parallel import split_dim
    block = MoEBlock(cfg, moe, device="meta")
    out = {}
    for name, p in block.named_parameters():
        out[name] = None
        if p.dim() < 2 or name in ("moe.router", "moe.b1", "moe.b2"):
            continue
        owned = {split_dim(cfg, f"layers.0.{name}") if T > 1 else None,
                 0 if n_ep > 1 and is_expert_leaf(name) else None}
        for dim in (1, 0) if name.startswith("attn.") else range(p.dim()):
            if dim not in owned and p.shape[dim] % n_data == 0:
                out[name] = dim
                break
    return out


def _shard_copy(model: nn.Module, dims: Dict[str, Optional[int]], n: int,
                index: int) -> nn.Module:
    """A copy of ``model`` holding block ``index`` of ``n`` of every leaf
    along its ``dims`` entry, with its :class:`FSDPShard`."""
    from .tensor_parallel import _owner, shard_tensor
    out = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in list(out.named_parameters()):
            dim = dims.get(name)
            if dim is None:
                continue
            if p.shape[dim] % n:
                raise ValueError(f"{name} {tuple(p.shape)}: dim {dim} does "
                                 f"not split over {n} data ranks")
            mod, leaf = _owner(out, name)
            setattr(mod, leaf, nn.Parameter(
                shard_tensor(p.detach(), dim, n, index).clone(),
                requires_grad=p.requires_grad))
    out.fsdp_shard = FSDPShard(n, index, dict(dims))
    return out


def shard_params_fsdp(model: nn.Module, mesh=None, *,
                      n: Optional[int] = None,
                      index: Optional[int] = None) -> nn.Module:
    """A copy of the whole ``model`` holding data coordinate ``index`` of
    ``n``'s block of every leaf under :func:`fsdp_specs` (the JAX
    ``shard_params_fsdp``, one rank's addressable part): ``mesh``'s data
    coordinate of its ``n_data``, or ``n`` and ``index`` given."""
    if mesh is not None:
        n, index = mesh.n_data, mesh.data
    return _shard_copy(model, fsdp_specs(model, n), n, index)


def fsdp_shard_params(model: nn.Module, cfg: ModelConfig, mesh=None, *,
                      n: Optional[int] = None,
                      index: Optional[int] = None) -> nn.Module:
    """The pp x fsdp resting layout (the JAX ``fsdp_shard_params``): a copy
    of ``model`` (a pipe rank's view, or its Megatron shard) whose blocks'
    linear matrices hold data coordinate ``index`` of ``n``'s block along
    :func:`fsdp_shard_dims`; ``mesh`` gives both (and the model axis's
    size). The embedding, the head, norms and biases stay whole. A
    ``models.moe.MoELM`` (its expert block and Megatron shard cut first)
    takes :func:`moe_fsdp_shard_dims`, the expert axis's size its
    ``expert`` block count."""
    from .tensor_parallel import model_shard_of
    tp = model_shard_of(model)
    T = 1 if tp is None else tp.n
    if mesh is not None:
        n, index, T = mesh.n_data, mesh.data, mesh.n_model
    if n <= 1:
        raise ValueError("fsdp_shard_params needs a 'data' mesh axis to "
                         "shard parameters over (make_mesh(n_data=...))")
    moe = getattr(model, "moe", None)
    leaf = (fsdp_shard_dims(cfg, n, T) if moe is None
            else moe_fsdp_shard_dims(cfg, moe, n, T, model.expert[0]))
    dims = {name: leaf[name.split(".", 2)[2]] if name.startswith("layers.")
            else None for name, _ in model.named_parameters()}
    return _shard_copy(model, dims, n, index)


def gather_fsdp(shards: List, dims: Optional[Dict[str, Optional[int]]] = None
                ) -> Dict[str, torch.Tensor]:
    """The inverse of the shard copies: the whole state dict from the state
    dicts (or models) of every data coordinate, in order; ``dims`` from
    the first model's :class:`FSDPShard` unless given. A replicated leaf is
    taken from coordinate 0."""
    if dims is None:
        dims = fsdp_shard_of(shards[0]).dims
    states = [s.state_dict() if isinstance(s, nn.Module) else s
              for s in shards]
    return {name: t if dims.get(name) is None else torch.cat(
        [s[name] for s in states], dim=dims[name])
        for name, t in states[0].items()}


class _Run(nn.Module):
    """Holds ``mod`` so ``functional_call`` can swap its parameters for
    the whole tensors while ``fn(mod, *args)`` runs."""

    def __init__(self, mod: nn.Module):
        super().__init__()
        self.mod = mod

    def forward(self, fn, *args):
        return fn(self.mod, *args)


def gathered_call(mod: nn.Module, dims: Dict[str, Optional[int]], mesh, fn,
                  *args):
    """``fn(mod, *args)`` with ``mod``'s sharded parameters (``dims``: its
    own names -> dim or None) replaced by the whole tensors, all gathered
    over the data group in one message just before the call; the gather's
    backward reduce-scatters their gradients into the shards."""
    names = [n for n, d in dims.items() if d is not None]
    if not names:
        return fn(mod, *args)
    fulls = col.fsdp_gather([mod.get_parameter(n) for n in names],
                            [dims[n] for n in names], mesh)
    return torch.func.functional_call(
        _Run(mod), {f"mod.{n}": t for n, t in zip(names, fulls)},
        (fn,) + args)


def sub_dims(dims: Dict[str, Optional[int]], prefix: str
             ) -> Dict[str, Optional[int]]:
    """The entries of ``dims`` under ``prefix`` (``"layers.3."``), by the
    submodule's own names."""
    return {n[len(prefix):]: d for n, d in dims.items()
            if n.startswith(prefix)}


def make_fsdp_grad_fn(cfg: ModelConfig, mesh, device="cuda"):
    """FSDP without a pipeline (the JAX ``make_fsdp_grad_fn``): ``(shard,
    tokens, targets) -> loss`` on a data-only world (:func:`make_fsdp_mesh`),
    ``shard`` the rank's :func:`shard_params_fsdp` copy, ``tokens`` /
    ``targets`` its rows of the global batch
    (``utils.data.batch_sharding``). Each block's leaves are gathered just
    before it runs, the embedding's and the head's once around the
    forward; the gradients land in the shard's ``.grad`` at the shard's
    shapes (reduce-scattered; a replicated leaf's all-reduced). The loss
    is the global batch's ``transformer_loss`` (the local means averaged,
    or with ``cfg.pad_token_id`` the masked NLL over the global valid
    count), on every rank."""
    from ..models.transformer import embed_apply, head_loss, rope_table
    from .mesh import DATA_AXIS
    device = resolve_device(device)
    if mesh.n_pipe != 1 or mesh.n_model != 1 or mesh.n_seq != 1:
        raise ValueError("make_fsdp_grad_fn runs on a data-only world "
                         "(make_fsdp_mesh)")
    n = mesh.n_data

    def grad_fn(model: nn.Module, tokens, targets) -> torch.Tensor:
        shard = fsdp_shard_of(model)
        if shard is None or (shard.n, shard.index) != (n, mesh.data):
            raise ValueError(f"make_fsdp_grad_fn needs this rank's "
                             f"shard_params_fsdp(model, mesh) (holds "
                             f"{shard and (shard.n, shard.index)})")
        tokens = torch.as_tensor(tokens, device=device).long()
        targets = torch.as_tensor(targets, device=device).long()
        pad_scale = None
        if cfg.pad_token_id is not None:
            n_valid = (targets != cfg.pad_token_id).sum().float()
            mesh.all_reduce([n_valid], DATA_AXIS)
            pad_scale = 1.0 / n_valid.clamp_min(1.0)
        top = {k: d for k, d in shard.dims.items()
               if not k.startswith("layers.")}

        def loss_of(m, tokens, targets):
            h = embed_apply(cfg, m, tokens)
            rope = rope_table(cfg, h.shape[1], h.device)
            for i, block in enumerate(m.layers):
                h = gathered_call(
                    block, sub_dims(shard.dims, f"layers.{i}."), mesh,
                    lambda b, x: b(cfg, x, rope), h)
            return head_loss(cfg, m, h, targets, pad_scale)

        with torch.enable_grad():
            loss = gathered_call(model, top, mesh, loss_of, tokens, targets)
            if pad_scale is None:
                loss = loss / n
            loss.backward()
        repl = [p.grad for name, p in model.named_parameters()
                if shard.dims.get(name) is None and p.grad is not None]
        out = loss.detach().clone()
        mesh.all_reduce([out] + repl, DATA_AXIS)
        return out

    return grad_fn
