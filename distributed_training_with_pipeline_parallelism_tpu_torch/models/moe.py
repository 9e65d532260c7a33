"""Mixture-of-Experts feed-forward layers and a MoE decoder LM (the
counterpart of the JAX package's ``models/moe.py``).

- **Capacity-based routing** (GShard, Switch): each expert takes exactly
  ``capacity`` token slots; dispatch and combine are dense one-hot
  tensors, so the layer is four products with static shapes: the
  dispatch einsum, the two batched expert matmuls and the combine einsum.
- **Top-k token-choice gating** with per-slot priority: every token's
  first choice outranks any token's second, positions in an expert's
  queue come from a cumulative sum over (slot, token), and tokens past
  capacity are dropped (combine weight zero: the residual carries them).
- **Load-balancing aux loss** (Switch): ``E * sum_e f_e * p_e``, ``f_e``
  the share of tokens whose first choice is e, ``p_e`` the mean router
  probability; 1 at uniform load.
- **Expert parallelism**: with ``ep`` (a ``parallel.mesh.Mesh`` whose
  expert axis is above 1) a layer holds its expert coordinate's block of
  the expert stacks and the slots travel to their experts and back by
  two all-to-alls over the expert group
  (``ops.collectives.expert_all_to_all``, whose backward is the inverse
  exchange). Without it the same math runs on all E experts: the oracle
  the EP path is held to.
- **Tensor parallelism** (``tp``, a mesh whose model axis is above 1):
  the block attends on its model rank's H/T heads (the dense Megatron
  linears) and every expert's matmuls split over the model axis, ``w1``
  and ``b1`` column-parallel on the ffn dim, ``w2`` row-parallel with one
  all-reduce, ``b2`` replicated and added once (the JAX
  ``_expert_mlp(tp_axis=)``). EP moves whole experts and TP splits each,
  so the two compose; the router stays replicated and f32.
- **Sequence parallelism** (``sp``, a mesh whose seq axis is above 1):
  attention goes through the ring or Ulysses transport of
  ``parallel.seq_parallel`` (with the model rank's heads under TP too);
  the position-wise FFN routes the rank's local tokens with the capacity
  of the local count (the JAX ``moe_layer_apply(sp_axis=)``), and the
  residual and FFN dropout masks are the full sequence's masks' local
  slices. No new collective: the all-to-all stays on the expert axis.

The router computes in f32 whatever the compute dtype. The parameters keep
JAX's layout: ``router`` ``[dim, E]``, ``w1`` ``[E, dim, f]``, ``b1``
``[E, f]``, ``w2`` ``[E, f, dim]``, ``b2`` ``[E, dim]`` (the leading dim
the rank's G = E / n_ep experts under EP, f its f/T columns under TP),
so ``utils.weights`` loads a
JAX ``moe_lm_init`` pytree leaf for leaf. A MoE block attends densely
whatever ``cfg.use_flash_attention`` says, as the JAX ``moe_layer_apply``
calls ``mha_apply`` with its default ``flash=False``: a MoE stage launches
no flash kernel. Its last stage's loss goes through the model's
``select_xent(cfg.use_fused_xent)``, as a dense stage's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import band_mask, scaled_dot_attention
from ..ops.layers import (block_dropout, fold_seed, gelu, seeded_generator,
                          select_masked_xent_sum, select_xent)
from ..utils.config import ModelConfig, resolve_device, torch_dtype
from .transformer import (_c, _linear, _ln, _row, _site, embed_apply,
                          head_apply)

# the leaves of a MoE FFN that hold one block per expert (the JAX
# ``expert_parallel._EXPERT_LEAVES``): sharded over the expert axis
EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Routing hyperparameters (the JAX ``MoEConfig``). ``capacity_factor``
    scales each expert's slot budget ``C = ceil(top_k * T *
    capacity_factor / n_experts)``; ``n_experts`` guarantees no drops.
    ``ffn_dim=None`` inherits the model's ``ffn_dim``."""

    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    ffn_dim: Optional[int] = None

    def __post_init__(self):
        if self.top_k < 1 or self.top_k > self.n_experts:
            raise ValueError(f"top_k={self.top_k} must be in "
                             f"[1, {self.n_experts}]")

    def capacity(self, n_tokens: int) -> int:
        return max(1, math.ceil(self.top_k * n_tokens * self.capacity_factor
                                / self.n_experts))


def is_expert_leaf(name: str) -> bool:
    """Whether parameter ``name`` is an expert stack (a ``w1``, ``b1``,
    ``w2`` or ``b2`` under a ``moe`` module; the JAX ``is_expert_leaf``):
    the leaves the expert axis shards and whose gradients stay local."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" \
        and parts[-1] in EXPERT_LEAVES


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def route(probs: torch.Tensor, top_k: int, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing with per-expert capacity (the JAX
    ``route``): probs [T, E] (f32) -> ``(dispatch, combine, aux)``,
    dispatch and combine [T, E, C] (dispatch the indicator of combine's
    nonzeros, combine the renormalised gates at each token's queue
    position) and the Switch aux scalar. Ties in ``probs`` pick experts
    by ``torch.topk``'s order, which need not be ``jax.lax.top_k``'s."""
    T, E = probs.shape
    gate, idx = torch.topk(probs, top_k, dim=-1)  # [T, k]
    gate = gate / gate.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(idx, E).to(probs.dtype)  # [T, k, E]
    # queue positions: priority is (slot, token) lexicographic
    flat = onehot.transpose(0, 1).reshape(top_k * T, E)
    pos = torch.cumsum(flat, dim=0) - flat
    pos = pos.reshape(top_k, T, E).transpose(0, 1)  # [T, k, E]
    fits = pos < capacity
    keep = onehot * fits
    # a position past capacity has keep 0; clamp it to stay a class
    pos_onehot = F.one_hot(pos.long().clamp_max(capacity - 1),
                           capacity).to(probs.dtype)  # [T, k, E, C]
    combine = torch.einsum("tk,tke,tkec->tec", gate, keep, pos_onehot)
    dispatch = (combine > 0).to(probs.dtype)
    top1 = onehot[:, 0]  # [T, E]
    aux = E * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
    return dispatch, combine, aux


# ---------------------------------------------------------------------------
# The MoE FFN
# ---------------------------------------------------------------------------


class MoEFFN(nn.Module):
    """A MoE feed-forward layer: the router ``[dim, E]`` and the expert
    stacks of its experts in JAX's layout (plain parameters, applied by
    batched products). ``expert`` = ``(n_ep, index)``: the layer holds
    block ``index`` of ``n_ep`` of the experts."""

    # the matrices AdamW decays (the JAX ``adamw`` mask: "w", "w1", "w2")
    decayed_names = ("router", "w1", "w2")

    def __init__(self, dim: int, ffn_dim: int, n_experts: int,
                 expert: Tuple[int, int] = (1, 0), device=None, dtype=None):
        super().__init__()
        n_ep, _ = expert
        if n_experts % n_ep:
            raise ValueError(f"n_experts={n_experts} must divide over "
                             f"{n_ep} expert shards")
        G = n_experts // n_ep
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(dim, n_experts, **kw))
        self.w1 = nn.Parameter(torch.empty(G, dim, ffn_dim, **kw))
        self.b1 = nn.Parameter(torch.empty(G, ffn_dim, **kw))
        self.w2 = nn.Parameter(torch.empty(G, ffn_dim, dim, **kw))
        self.b2 = nn.Parameter(torch.empty(G, dim, **kw))


def _expert_mlp(ffn: MoEFFN, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Each local expert's gelu MLP on its slot block x [G, N, d]; under
    ``tp`` on this model rank's ffn columns (``w1`` [G, d, f/T], ``b1``
    [G, f/T], ``w2`` [G, f/T, d]), the partial outputs summed over the
    model group before the replicated ``b2`` (the JAX ``_expert_mlp``)."""
    from ..ops.collectives import tp_copy, tp_reduce
    x = tp_copy(x, tp)
    h = torch.bmm(x, _c(ffn.w1, x)) + _c(ffn.b1, x)[:, None]
    out = tp_reduce(torch.bmm(gelu(h), _c(ffn.w2, x)), tp)
    return out + _c(ffn.b2, x)[:, None]


def moe_ffn_apply(ffn: MoEFFN, x: torch.Tensor, moe: MoEConfig, ep=None,
                  tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on x [B, S, d] -> ([B, S, d], aux) (the JAX
    ``moe_ffn_apply``). Routing, and so the capacity, is over the B * S
    local tokens. With ``ep`` the slots [E, C, d] go to their experts'
    ranks by one all-to-all over the expert group (``[G, n_ep * C, d]``
    arrive), run there, and come back by the inverse one; with ``tp`` the
    experts run on this model rank's ffn columns (:func:`_expert_mlp`).
    Its parts are ``torch.profiler`` ranges: ``moe_route``,
    ``moe_dispatch``, ``moe_experts`` and ``moe_combine``."""
    from ..ops.collectives import expert_all_to_all
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    E = moe.n_experts
    G = ffn.w1.shape[0]
    n_ep = 1 if ep is None else ep.n_expert
    if G * n_ep != E:
        raise ValueError(
            f"params hold {G} experts, config says {E} (running an "
            f"expert-sharded model without its expert axis?)" if n_ep == 1
            else f"{G} local experts x {n_ep} shards != {E}")
    C = moe.capacity(B * S)
    with torch.profiler.record_function("moe_route"):
        logits = xt.float() @ ffn.router.float()
        dispatch, combine, aux = route(torch.softmax(logits, dim=-1),
                                       moe.top_k, C)
        dispatch = dispatch.to(x.dtype)
        combine = combine.to(x.dtype)
    with torch.profiler.record_function("moe_dispatch"):
        slots = torch.einsum("tec,td->ecd", dispatch, xt)  # [E, C, d]
    if n_ep == 1:
        with torch.profiler.record_function("moe_experts"):
            out = _expert_mlp(ffn, slots, tp)
    else:
        recv = expert_all_to_all(slots, ep)  # [n_ep (source), G, C, d]
        with torch.profiler.record_function("moe_experts"):
            hid = recv.view(n_ep, G, C, d).transpose(0, 1).reshape(
                G, n_ep * C, d)
            hid = _expert_mlp(ffn, hid, tp)
            back = hid.view(G, n_ep, C, d).transpose(0, 1).reshape(E, C, d)
        out = expert_all_to_all(back, ep)
    with torch.profiler.record_function("moe_combine"):
        y = torch.einsum("tec,ecd->td", combine, out)
    return y.reshape(B, S, d), aux



# ---------------------------------------------------------------------------
# The MoE decoder LM (GPT-2 blocks with a MoE FFN)
# ---------------------------------------------------------------------------


class MoEBlock(nn.Module):
    """One MoE decoder block (the JAX ``moe_layer_init`` leaves): ``ln1``,
    causal dense attention ``attn.{q,k,v,o}``, ``ln2``, the MoE FFN
    ``moe``."""

    def __init__(self, cfg: ModelConfig, moe: MoEConfig,
                 expert: Tuple[int, int] = (1, 0), device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.ln1 = nn.LayerNorm(d, eps=1e-5, **kw)
        self.attn = nn.ModuleDict({
            n: nn.Linear(d, d, **kw) for n in ("q", "k", "v", "o")})
        self.ln2 = nn.LayerNorm(d, eps=1e-5, **kw)
        self.moe = MoEFFN(d, moe.ffn_dim or cfg.ffn_dim, moe.n_experts,
                          expert, **kw)


def moe_layer_apply(cfg: ModelConfig, moe: MoEConfig, block: MoEBlock,
                    h: torch.Tensor, ep=None, rng: Optional[int] = None,
                    tp=None, sp=None, sp_attn_impl: str = "ring"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE block on h [b, s, dim] -> (h, aux) (the JAX
    ``moe_layer_apply``): ln1, causal dense attention, the residual, ln2,
    the MoE FFN, the residual. ``rng`` (train mode): the layer's dropout
    seed; sites 0 (the attention probabilities), 1 (the attention
    residual) and 2 (the combined FFN output, position-wise on [b, s, d],
    so its mask does not depend on how the experts are split). ``tp``:
    this model rank's heads and expert ffn columns (the probabilities'
    mask the unsharded one's head block). ``sp``: h is this seq rank's
    chunk [b, S/n_seq, dim]; attention by ``sp_attn_impl`` ("ring" or
    "ulysses", ``parallel.seq_parallel``), the FFN routing the chunk's
    tokens, the residual and FFN masks the unsharded masks' chunks."""
    from ..ops import collectives as col
    b, s, _ = h.shape
    p = cfg.dropout if rng is not None else 0.0
    seq = () if sp is None else ((1, sp.n_seq, sp.seq),)

    def drop(x, j):
        gen = None if p == 0.0 else seeded_generator(fold_seed(rng, j),
                                                     x.device)
        return block_dropout(x, p, gen, seq)

    a = _ln(block.ln1, h)
    if sp is not None:
        from ..parallel.seq_parallel import ATTN_IMPLS
        att = ATTN_IMPLS[sp_attn_impl](
            cfg, block.attn, a, a, sp, True, None, tp,
            None if p == 0.0 else fold_seed(rng, 0))
    else:
        a = col.tp_attention_inputs(a, a, tp)[0]

        def heads(name):
            return _linear(block.attn[name], a).view(b, s, -1, cfg.head_dim)

        mask = band_mask(s, s, None, device=h.device)[None, None]
        att = scaled_dot_attention(
            heads("q"), heads("k"), heads("v"), mask, cfg.dropout,
            _site(cfg, rng, 0, h.device),
            (tp.n_model, tp.model) if col.tp_active(tp) else None)
        att = _row(block.attn["o"], att.reshape(b, s, -1), tp)
    h = h + drop(att, 1)
    y, aux = moe_ffn_apply(block.moe, _ln(block.ln2, h), moe, ep, tp)
    return h + drop(y, 2), aux


def moe_layers_apply(cfg: ModelConfig, moe: MoEConfig, layers,
                     h: torch.Tensor, rng: Optional[int] = None,
                     layer_offset: int = 0, ep=None, tp=None, sp=None,
                     sp_attn_impl: str = "ring"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A slice of MoE blocks over h -> (h, summed aux, f32). ``rng``: the
    microbatch's dropout seed; block ``i`` folds ``layer_offset + i``, its
    global index, so every stage split draws the same masks. ``ep``,
    ``tp``, ``sp`` and ``sp_attn_impl``: as in :func:`moe_layer_apply`."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, block in enumerate(layers):
        rng_l = None if rng is None else fold_seed(rng, layer_offset + i)
        h, a = moe_layer_apply(cfg, moe, block, h, ep, rng_l, tp, sp,
                               sp_attn_impl)
        aux = aux + a
    return h, aux


class MoELM(nn.Module):
    """The MoE LM (the JAX ``moe_lm_init`` tree): GPT-2's embedding
    (``tok``, learned ``pos``), :class:`MoEBlock` layers, the final
    ``norm`` and an untied ``out`` (none under ``cfg.tie_embeddings``). It
    has the attributes a ``Transformer`` gives the pipeline's
    ``embed_apply``, ``head_apply``, ``head_loss`` and
    ``stack_stage_layers`` (``cfg``, ``tok``, ``pos``, ``layers``,
    ``norm``, ``out``), plus ``moe``. ``layers`` (global indices) makes a
    pipe rank's view, as for a ``Transformer``; ``expert`` = ``(n_ep,
    index)`` makes every block hold that block of the experts."""

    def __init__(self, cfg: ModelConfig, moe: MoEConfig, device=None,
                 dtype=None, layers: Optional[Iterable[int]] = None,
                 expert: Tuple[int, int] = (1, 0)):
        super().__init__()
        if cfg.arch != "gpt2":
            raise ValueError("MoE pipeline blocks are gpt2-style; set "
                             "arch='gpt2'")
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.moe = cfg, moe
        self.expert = tuple(expert)
        self.tok = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, **kw))
        self.pos = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.dim, **kw))
        own = set(range(cfg.n_layers) if layers is None else layers)
        self.layers = nn.ModuleList(
            MoEBlock(cfg, moe, expert, **kw) if i in own else nn.Module()
            for i in range(cfg.n_layers))
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-5, **kw)
        if not cfg.tie_embeddings:
            self.out = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return moe_lm_logits_aux(self.cfg, self.moe, self, tokens)[0]


def moe_init_params(cfg: ModelConfig, moe: MoEConfig,
                    generator: torch.Generator, device="cuda",
                    layers: Optional[Iterable[int]] = None,
                    expert: Tuple[int, int] = (1, 0)) -> MoELM:
    """A randomly initialised :class:`MoELM` in ``cfg.storage_dtype`` on
    ``device``, drawn from ``generator`` with the JAX ``moe_lm_init``
    conventions (embeddings N(0, 0.02); router and ``w1``
    uniform(+-1/sqrt(dim)), ``w2`` uniform(+-1/sqrt(ffn)), expert biases
    0; the attention and the head as ``init_params``'s linears; norms 1
    and 0). The numbers differ from the JAX package's for the same seed.
    ``layers`` and ``expert``: a rank's view, holding the whole model's
    values for its blocks and its experts."""
    device = resolve_device(device)
    model = MoELM(cfg, moe, device=device,
                  dtype=torch_dtype(cfg.storage_dtype), layers=layers,
                  expert=expert)
    own = dict(model.named_parameters())
    whole = MoELM(cfg, moe, device="meta")  # every draw, in order
    gdev = generator.device
    f = moe.ffn_dim or cfg.ffn_dim
    with torch.no_grad():
        for name, p in whole.named_parameters():
            leaf = name.split(".")[-1]
            parent = name.split(".")[-2] if "." in name else ""
            if name in ("tok", "pos"):
                x = 0.02 * torch.randn(p.shape, generator=generator,
                                       device=gdev)
            elif parent in ("ln1", "ln2", "norm"):
                x = torch.ones(p.shape) if leaf == "weight" else \
                    torch.zeros(p.shape)
            elif parent == "moe" and leaf in ("b1", "b2"):
                x = torch.zeros(p.shape)
            else:
                if parent == "moe":
                    bound = 1.0 / math.sqrt(f if leaf == "w2" else cfg.dim)
                else:
                    w = name[:-len("bias")] + "weight" if p.dim() == 1 \
                        else name
                    bound = 1.0 / math.sqrt(
                        whole.get_parameter(w).shape[1])
                x = (torch.rand(p.shape, generator=generator, device=gdev)
                     * 2 - 1) * bound
            if name in own:
                own[name].copy_(expert_block(name, x, expert))
    return model


def expert_block(name: str, x, expert: Tuple[int, int]):
    """Block ``index`` of ``n_ep`` of an expert stack's leading (expert)
    dim (a tensor or an array); any other leaf whole."""
    n_ep, index = expert
    if n_ep == 1 or not is_expert_leaf(name):
        return x
    G = x.shape[0] // n_ep
    return x[index * G:(index + 1) * G]


def moe_lm_logits_aux(cfg: ModelConfig, moe: MoEConfig, model: MoELM,
                      tokens: torch.Tensor, ep=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE LM forward: tokens [B, S] -> (logits [B, S, V], the summed
    per-layer aux) (the JAX ``moe_lm_logits_aux``); the head is the token
    table under ``cfg.tie_embeddings``."""
    h = embed_apply(cfg, model, tokens)
    h, aux = moe_layers_apply(cfg, moe, model.layers, h, ep=ep)
    return head_apply(cfg, model, h), aux


def moe_lm_loss(cfg: ModelConfig, moe: MoEConfig, model: MoELM,
                tokens: torch.Tensor, targets: torch.Tensor, ep=None
                ) -> torch.Tensor:
    """CE plus the mean per-layer aux loss times ``aux_loss_weight`` (the
    JAX ``moe_lm_loss``); differentiable. Under ``cfg.pad_token_id`` the
    CE is the masked NLL sum over the valid count, and the aux term stays
    token-uniform (pad positions are routed and take capacity).

    With ``ep`` (an expert-axis mesh; the tokens the rank's batch shard,
    the model its expert shard) the loss is the mean over the expert
    group: under ``pad_token_id`` the NLL sums and valid counts are summed
    over it first. Its backward leaves each rank its share of every
    gradient: the expert stacks' are whole, the other leaves' must be
    summed over the expert group
    (``parallel.expert_parallel.ep_reduce_grads``)."""
    from ..ops.collectives import expert_sum
    logits, aux = moe_lm_logits_aux(cfg, moe, model, tokens, ep)
    aux_term = moe.aux_loss_weight * aux / cfg.n_layers
    n_ep = 1 if ep is None else ep.n_expert
    if cfg.pad_token_id is not None:
        s, n = select_masked_xent_sum(cfg.use_fused_xent)(
            logits, targets, cfg.pad_token_id)
        if n_ep == 1:
            return s / n.clamp_min(1) + aux_term
        n = n.float()
        ep.all_reduce([n], "expert")
        return (expert_sum(s, ep) / n.clamp_min(1.0)
                + expert_sum(aux_term, ep) / n_ep)
    loss = select_xent(cfg.use_fused_xent)(logits, targets) + aux_term
    if n_ep == 1:
        return loss
    return expert_sum(loss, ep) / n_ep
