"""Megatron tensor parallelism over a world's model axis (the counterpart
of the JAX package's ``parallel/tensor_parallel.py``).

JAX runs TP inside ``shard_map`` (the pipeline executor) or by GSPMD
annotations (``make_tp_grad_fn``). The port runs it in a
``torch.distributed`` world (``parallel.mesh``): each rank of a model
group holds one shard of every Megatron-split leaf and runs the block on
its local heads and FFN columns, and the collectives of
:mod:`..ops.collectives` complete it. There is no lockstep form in one
process.

The Megatron placement is data (:func:`split_dim`): per leaf, the torch
weight dim split over the model axis, or None where the leaf is
replicated. Column-parallel leaves (q, k, v and the FFN's input
projections, with their biases) split dim 0, the output features;
row-parallel ones (the attention output and the FFN's output projection)
split dim 1, the input features, and keep their bias replicated (added
once, after the reduce). GQA kv projections split their kv heads; the
Qwen2 family's q/k/v biases split with their matrices. Norms, embeddings
and the head are replicated, except the untied head under vocab-parallel
cross entropy, which splits the vocab (dim 0 of ``out.weight``, and the
reference arch's bias). A MoE block (``models.moe.MoEBlock``) places its
attention as a dense block does and splits each expert's ffn dim: ``w1``
[E, d, f] on f and ``b1`` [E, f] on f (column-parallel), ``w2`` [E, f,
d] on f (row-parallel); the router, ``b2`` and the norms are replicated
(the JAX ``_moe_layer_specs``). A rank's expert block is cut first
(``parallel.expert_parallel.ep_shard_model``), then its Megatron shard
of that. Shards are contiguous blocks in model-coordinate
order, as the JAX ``NamedSharding`` lays them out.

The compositions JAX has: pp x fsdp x tp, where a matrix is split over
the model axis on its Megatron dim and over the data axis on another
(``parallel.fsdp.fsdp_shard_dims`` skips the Megatron dim; cut a rank's
shard first, then its FSDP shard of that); and pp x tp x seq, where each
model rank's heads cross its own seq group, under Ulysses only when the
local head count divides by the seq-axis size
(``parallel.seq_parallel``).

The decoders (``parallel.pipelined_decode``, ``serving.engine``) run the
JAX pipe x model decode mesh on a (pipe 1, data 1, model T) world, each
rank on its shard of every lockstep stage with the embedding and the
head whole (``shard_model(..., vocab_parallel=False)``, held by
:func:`check_block_shard`): their caches hold :func:`kv_shard_heads`
heads, and :func:`check_decode_mesh` refuses other axes.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Iterable, List, Optional

import torch
import torch.nn as nn

from ..utils.config import ModelConfig, ScheduleConfig

# leaf name (the part after "layers.{i}.") -> weight dim split; biases of
# column-parallel leaves split with them, those of row-parallel ones not
_COLUMN = ("q", "k", "v", "lin1", "w1", "w3")
_ROW = ("o", "lin2", "w2")
# a MoE FFN's leaves (JAX's layout, experts leading) -> the ffn dim split
# (the JAX ``_moe_layer_specs``); the router and ``b2`` are replicated
_MOE = {"w1": 2, "b1": 1, "w2": 1}


def resolve_tp_overlap(mode: str, axis_size: int, seq_len: int) -> str:
    """A ``ModelConfig.tp_overlap`` value resolved (the JAX
    ``resolve_tp_overlap``): ``"none"`` keeps the copy/all-reduce block;
    ``"ring"`` demands the collective-matmul ring and raises where the
    sequence does not split ``axis_size`` ways; ``"auto"`` resolves to
    ``"none"``, as JAX does off a TPU: no H100 measurement has chosen a
    cut-over."""
    if mode not in ("none", "ring", "auto"):
        raise ValueError(f"tp_overlap must be 'none', 'ring' or 'auto', "
                         f"got {mode!r}")
    if mode == "ring":
        if not (axis_size > 1 and seq_len % axis_size == 0):
            raise ValueError(
                f"tp_overlap='ring' needs seq_len ({seq_len}) divisible by "
                f"the model-axis size ({axis_size}) > 1")
        return "ring"
    return "none"


def tp_all_gather_matmul(x_loc: torch.Tensor, weight: torch.Tensor, mesh,
                         mode: str = "none") -> torch.Tensor:
    """The up-projection over a sequence-sharded input: ``all_gather(x,
    seq) @ weight.T`` -> [B, S, F/T]. ``"ring"`` overlaps the gather into
    the matmul (bitwise the same rows); ``"none"`` gathers, then
    multiplies."""
    from ..ops import collectives as col
    if mode == "ring":
        return col.all_gather_matmul(x_loc, weight, mesh)
    return torch.nn.functional.linear(col.all_gather_seq(x_loc, mesh), weight)


def tp_matmul_reduce_scatter(z: torch.Tensor, weight: torch.Tensor, mesh,
                             mode: str = "none") -> torch.Tensor:
    """The down-projection completing into a sequence-sharded output:
    ``reduce_scatter(z @ weight.T, seq)`` -> [B, S/T, d]. ``"ring"`` sums
    in the ring's order (numerically, not bitwise, the unfused form)."""
    from ..ops import collectives as col
    if mode == "ring":
        return col.matmul_reduce_scatter(z, weight, mesh)
    return col.reduce_scatter_seq(torch.nn.functional.linear(z, weight),
                                  mesh)


def split_dim(cfg: ModelConfig, name: str,
              vocab_parallel: bool = False) -> Optional[int]:
    """The dim of parameter ``name`` (the port's names) split over the
    model axis, or None where it is replicated (see the module doc)."""
    parts = name.split(".")
    if parts[0] == "layers":
        leaf, kind = parts[-2], parts[-1]
        if leaf == "moe":
            return _MOE.get(kind)
        if leaf in _COLUMN:
            return 0
        if leaf in _ROW:
            return 1 if kind == "weight" else None
        return None
    if parts[0] == "out" and vocab_parallel and not cfg.tie_embeddings:
        return 0
    return None


def check_tp(cfg: ModelConfig, T: int, vocab_parallel: bool = False) -> None:
    """The Megatron shape contract (the JAX ``_check_tp_divisibility`` and
    ``make_pipeline_step``'s vocab checks)."""
    if vocab_parallel:
        if T <= 1:
            raise ValueError("tp_vocab_parallel needs a 'model' mesh axis")
        if cfg.vocab_size % T:
            raise ValueError(f"vocab_size={cfg.vocab_size} must divide over "
                             f"the model-axis size {T}")
    if T <= 1:
        return
    n_kv = cfg.n_kv_heads or cfg.n_heads
    if cfg.n_heads % T or n_kv % T or cfg.ffn_dim % T:
        raise ValueError(
            f"tensor parallelism needs n_heads ({cfg.n_heads}), "
            f"n_kv_heads ({n_kv}) and ffn_dim ({cfg.ffn_dim}) divisible "
            f"by the model-axis size {T}")


def kv_shard_heads(cfg: ModelConfig, mesh) -> int:
    """The kv heads a model rank caches: ``n_kv_heads / T`` (the JAX
    decoders' ``Hkv/tp_size`` cache shard)."""
    return cfg.kv_heads // (1 if mesh is None else mesh.n_model)


def check_decode_mesh(mesh, what: str) -> int:
    """The decoder's and the serving engine's mesh contract; returns T.
    A data, seq or expert axis raises the JAX refusal (``what`` is
    ``"decode"`` or ``"serving"``); a pipe axis above 1 raises the port's:
    both run their D stages in lockstep in each rank's process."""
    if mesh is None:
        return 1
    for ax, n in mesh.shape.items():
        if ax not in ("pipe", "model") and n > 1:
            if what == "decode":
                raise NotImplementedError(
                    f"pipelined decode composes pipe x model meshes; axis "
                    f"{ax!r} has size {n} (batch scoring via "
                    "make_pipeline_forward supports the full mesh space)")
            raise NotImplementedError(
                f"the serving executor composes pipe x model meshes; axis "
                f"{ax!r} has size {n}")
    if mesh.n_pipe > 1:
        raise NotImplementedError(
            f"the port's {what} runs its stages in lockstep in each model "
            f"rank's process, so its world has pipe 1 (got n_pipe="
            f"{mesh.n_pipe}); stages on ranks, with the ring hop as P2P, "
            "are ROADMAP.md Queue 1, item 15")
    return mesh.n_model


def check_moe_tp(cfg: ModelConfig, moe, T: int) -> None:
    """A MoE model's expert ffn must divide over the model axis (the JAX
    ``_check_moe_mesh``'s TP rule)."""
    if moe is not None and T > 1 and (moe.ffn_dim or cfg.ffn_dim) % T:
        raise ValueError(
            f"MoE expert ffn_dim={moe.ffn_dim or cfg.ffn_dim} must be "
            f"divisible by the model-axis size {T}")


@dataclasses.dataclass(frozen=True)
class TPShard:
    """Which shard a model holds: model coordinate ``index`` of ``n``,
    with or without the vocab-split head."""

    n: int
    index: int
    vocab_parallel: bool = False


def shard_tensor(t: torch.Tensor, dim: Optional[int], n: int,
                 index: int) -> torch.Tensor:
    """Block ``index`` of ``n`` of ``t`` along ``dim`` (``t`` itself where
    ``dim`` is None)."""
    if dim is None:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size)


def _owner(model: nn.Module, name: str):
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf


def shard_model(model: nn.Module, cfg: ModelConfig, mesh=None, *,
                n: Optional[int] = None, index: Optional[int] = None,
                vocab_parallel: bool = False) -> nn.Module:
    """A copy of ``model`` (a whole model or a pipe rank's view) holding
    only model coordinate ``index``'s shard of every split leaf (the JAX
    ``shard_params``, one rank's addressable part): ``mesh``'s model
    coordinate of its ``n_model``, or ``n`` and ``index`` given. The copy
    records its :class:`TPShard` as ``.tp_shard``."""
    if mesh is not None:
        n, index = mesh.n_model, mesh.model
    check_tp(cfg, n, vocab_parallel and n > 1)
    check_moe_tp(cfg, getattr(model, "moe", None), n)
    out = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in list(out.named_parameters()):
            dim = split_dim(cfg, name, vocab_parallel)
            if dim is None or n == 1:
                continue
            mod, leaf = _owner(out, name)
            setattr(mod, leaf, nn.Parameter(
                shard_tensor(p.detach(), dim, n, index).clone(),
                requires_grad=p.requires_grad))
            if isinstance(mod, nn.Linear):
                mod.out_features, mod.in_features = mod.weight.shape
    out.tp_shard = TPShard(n, index, vocab_parallel)
    return out


def _state(x) -> Dict[str, torch.Tensor]:
    return x.state_dict() if isinstance(x, nn.Module) else x


def gather_model(shards: List, cfg: ModelConfig,
                 vocab_parallel: bool = False) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_model`: the whole state dict from the
    state dicts (or models) of every model coordinate, in order. A
    replicated leaf is taken from coordinate 0."""
    states = [_state(s) for s in shards]
    out = {}
    for name, t in states[0].items():
        dim = split_dim(cfg, name, vocab_parallel)
        out[name] = t if dim is None or len(states) == 1 else torch.cat(
            [s[name] for s in states], dim=dim)
    return out


def shard_state(state: Dict[str, torch.Tensor], cfg: ModelConfig,
                shard: TPShard) -> Dict[str, torch.Tensor]:
    """A whole (or pipe-view) state dict cut to ``shard``'s blocks."""
    return {k: shard_tensor(v, split_dim(cfg, k, shard.vocab_parallel),
                            shard.n, shard.index) if shard.n > 1 else v
            for k, v in state.items()}


def model_shard_of(model: nn.Module) -> Optional[TPShard]:
    """The :class:`TPShard` a model holds, or None for a whole one."""
    return getattr(model, "tp_shard", None)


def check_block_shard(model: nn.Module, mesh) -> None:
    """Raise unless ``model`` holds ``mesh``'s model shard of the blocks
    with the embedding and the head whole (``shard_model(...,
    vocab_parallel=False)``), what the decoder and the engine run."""
    shard = model_shard_of(model)
    have = (1, 0, False) if shard is None else (
        shard.n, shard.index, shard.vocab_parallel)
    want = (1, 0, False) if mesh is None else (mesh.n_model, mesh.model,
                                               False)
    if have != want and not (want[0] == 1 and have[0] == 1):
        raise ValueError(
            f"the model holds shard {have[1]} of {have[0]} (vocab_parallel="
            f"{have[2]}); this rank needs shard {want[1]} of {want[0]}: "
            "tensor_parallel.shard_model(model, cfg, mesh, "
            "vocab_parallel=False)")


def sharded_names(model: nn.Module) -> Iterable[str]:
    """The names of ``model``'s parameters split over the model axis."""
    shard = model_shard_of(model)
    if shard is None or shard.n == 1:
        return set()
    return {n for n, _ in model.named_parameters()
            if split_dim(model.cfg, n, shard.vocab_parallel) is not None}


def make_tp_grad_fn(cfg: ModelConfig, mesh, device="cuda"):
    """TP without a pipeline (the JAX ``make_tp_grad_fn``): ``(shard,
    tokens, targets) -> loss`` on a ``make_mesh(n_pipe=1, n_data,
    n_model)`` world, the gradients in ``shard``'s ``.grad``. ``shard`` is
    ``shard_model(model, cfg, mesh, vocab_parallel=True)``: the head split
    over the vocab, as JAX's ``param_specs`` place it (the vocab must
    divide by ``n_model``); ``tokens``/``targets`` the rank's data slice.
    The loss is the single-device ``transformer_loss``, its gradients the
    shard's part of it."""
    from .pipeline import make_pipeline_grad_fn
    if mesh.n_pipe != 1:
        raise ValueError(f"make_tp_grad_fn runs no pipeline: the mesh has "
                         f"n_pipe={mesh.n_pipe}")
    return make_pipeline_grad_fn(cfg, ScheduleConfig("GPipe", 1), 1,
                                 device=device, mesh=mesh,
                                 tp_vocab_parallel=mesh.n_model > 1)
