"""The reference, GPT-2 and llama decoders as ``nn.Module``s (counterpart
of the JAX package's ``models/transformer.py`` for its three archs).

Reference block (``arch="ref_decoder"``, the JAX ``layer_init`` and block
apply, ``models/transformer.py:46-54,98-118``): the reference's
``nn.TransformerDecoderLayer`` called as ``layer(h, h)``: post-LN
self-attention, cross-attention whose memory is the block's own input,
and a relu FFN, with no mask and no positions; q, k, v and o carry
biases. Its embedding is drawn N(0, 1) as ``nn.Embedding``'s, and its
head is a LayerNorm and an untied ``out`` with a bias. GPT-2 block: pre-LN, causal self-attention, residual; LN, MLP with the
tanh GELU, residual. Learned positions. Llama block: pre-RMSNorm,
causal self-attention with RoPE on q and k and grouped-query kv heads
(``n_kv_heads``; optional q/k/v biases, an optional sliding window),
residual; RMSNorm, the gated MLP ``w2(act(w1 x) * w3 x)`` (``silu`` or
the tanh ``gelu``), residual. No positions; ``embed_scale`` multiplies
the embedding outputs by sqrt(dim). The head is a final norm and a linear
without bias, or, under ``cfg.tie_embeddings``, the token table itself
(``logits = norm(h) @ tok.T``). Parameter names follow the JAX pytree's
leaves (GPT-2: ``ln1``, ``attn.{q,k,v,o}``, ``ln2``, ``lin1``, ``lin2``;
llama: ``rms1``, ``attn.{q,k,v,o}``, ``rms2``, ``w1``, ``w2``, ``w3``;
reference: ``self_attn.{q,k,v,o}``, ``cross_attn.{q,k,v,o}``, ``ln1``-``ln3``,
``lin1``, ``lin2``; ``tok`` and GPT-2's ``pos``; ``norm``, ``out``) so
:mod:`..utils.weights` maps one onto the other. Linear weights are
torch's ``[out, in]``.

Train-mode dropout (``cfg.dropout > 0`` and an ``rng`` seed passed down):
the JAX sites and streams (``layer_apply``, ``:73-118``). Layer ``i`` of a
stack whose first global layer is ``layer_offset`` folds
``layer_offset + i`` into the seed, and site ``j`` of the layer folds
``j`` into that: the attention probabilities, each residual branch and
(reference) the FFN's inner activation; GPT-2's embedding folds
``n_layers``. Each site draws its mask from a ``torch.Generator`` seeded
with its folded seed (``ops.layers.fold_seed``), so a mask depends only on
(seed, global layer, site).

Tensor parallelism (``tp``, a ``parallel.mesh.Mesh`` with ``n_model``
above 1, whose rank holds ``parallel.tensor_parallel.shard_model``'s
shard): the JAX ``tp_axis`` path (``models/transformer.py:76-224``,
``ops/attention.py:163-197``). Each attention runs on its H/T local heads
(n_kv/T kv heads) behind ``tp_copy`` on its inputs, with head-sharded
dropout on its probabilities and a row-parallel output projection; each
MLP runs on its F/T columns behind ``tp_copy`` and ends in a row-parallel
projection, or, where ``cfg.tp_overlap`` resolves to ``"ring"`` (no
dropout), through the collective-matmul ring. The reference arch's FFN
activation takes the sharded dropout on its columns. The flash route is
unchanged, at the local head count.

Mixed precision (``cfg.param_dtype`` set): every use casts its parameter
to the activation dtype with ``.to``, a differentiable cast, so gradients
reach the storage-dtype parameters (the JAX ``compute_cast`` inside
autodiff). Without mixed precision the casts are no-ops.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Iterable, Optional

import torch
import torch.nn as nn

from ..ops import collectives as col
from ..ops.attention import (Rope, apply_rope, band_mask, gqa_expand,
                             rope_frequencies, scaled_dot_attention)
from ..ops.flash_attention import flash_attention
from ..ops.layers import (dropout_apply, embedding, fold_seed, gelu,
                          global_pad_scale, layer_norm, linear, relu,
                          rms_norm, seeded_generator, select_masked_xent_sum,
                          select_xent, sharded_dropout_apply, silu)
from ..utils.config import ModelConfig, resolve_device, torch_dtype


def _site(cfg: ModelConfig, rng: Optional[int], word: int,
          device) -> Optional[torch.Generator]:
    """The generator of dropout site ``word`` under seed ``rng`` (the JAX
    ``fold_in(rng, word)``), or None in eval mode or at rate 0."""
    if rng is None or cfg.dropout == 0.0:
        return None
    return seeded_generator(fold_seed(rng, word), device)


def _c(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Parameter ``p`` in the dtype of activation ``x`` (differentiable;
    a no-op when they already agree)."""
    return p if p.dtype == x.dtype else p.to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_table(head_dim: int, n: int, theta: float, scaling,
                device: torch.device) -> Rope:
    return Rope.of(rope_frequencies(head_dim, n, theta, scaling, device))


def rope_table(cfg: ModelConfig, n: int, device) -> Optional[Rope]:
    """cos/sin of the RoPE angles of positions 0 .. n-1 on ``device``
    (None for gpt2: the JAX ``_rope``). Tables are immutable and kept
    (at most 16), so a run computes each once, not once per call."""
    if cfg.arch != "llama":
        return None
    return _rope_table(cfg.head_dim, n, cfg.rope_theta, cfg.rope_scaling,
                       torch.device(device))


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if lin.bias is None else _c(lin.bias, x)
    return linear(x, _c(lin.weight, x), bias)


def _row(lin: nn.Linear, x: torch.Tensor, tp) -> torch.Tensor:
    """``lin`` applied to ``x``; row-parallel under ``tp`` (the JAX
    ``_ffn_out`` / ``tp_output_projection``)."""
    if not col.tp_active(tp):
        return _linear(lin, x)
    bias = None if lin.bias is None else _c(lin.bias, x)
    return col.row_parallel_linear(x, _c(lin.weight, x), bias, tp)


def _shard_of(tp):
    """(n_shards, index) of ``tp``'s model axis."""
    return (tp.n_model, tp.model) if col.tp_active(tp) else (1, 0)


def _ring(cfg: ModelConfig, tp, h: torch.Tensor,
          generator: Optional[torch.Generator]) -> bool:
    """Whether an MLP runs the collective-matmul ring (the JAX
    ``mlp_block`` rule: TP, no dropout, ``tp_overlap`` resolving to
    "ring")."""
    if not col.tp_active(tp) or cfg.tp_overlap == "none" or (
            generator is not None and cfg.dropout > 0.0):
        return False
    from ..parallel.tensor_parallel import resolve_tp_overlap
    return resolve_tp_overlap(cfg.tp_overlap, tp.n_model,
                              h.shape[1]) == "ring"


def _ln(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, _c(ln.weight, x), _c(ln.bias, x))


def attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, causal: bool,
           generator: Optional[torch.Generator] = None,
           tp=None) -> torch.Tensor:
    """Core attention of q [b, s, h, d] over k, v [b, t, h, d] (kv heads
    already expanded): the flash kernel where ``cfg.flash_for`` picks it,
    else dense attention with a causal band (``cfg.sliding_window``) when
    ``causal`` and dropout on its probabilities drawn from ``generator``
    (which ``cfg`` never pairs with the kernel); under ``tp`` the h heads
    are this rank's block and the mask the unsharded one's block."""
    if cfg.flash_for(causal, q.device):
        return flash_attention(q, k, v, causal=causal,
                               window=cfg.sliding_window)
    mask = None
    if causal:
        mask = band_mask(q.shape[1], k.shape[1], cfg.sliding_window,
                         device=q.device)[None, None]
    return scaled_dot_attention(q, k, v, mask, cfg.dropout, generator,
                                _shard_of(tp))


def mha_apply(cfg: ModelConfig, attn: nn.ModuleDict, q_in: torch.Tensor,
              kv_in: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              tp=None) -> torch.Tensor:
    """The reference's multi-head attention (the JAX ``mha_apply``): queries
    from ``q_in`` [b, s, dim], keys and values from ``kv_in`` [b, t, dim],
    no mask and no positions, then the output projection (row-parallel
    over this rank's heads under ``tp``)."""
    b, s, _ = q_in.shape
    q_in, kv_in = col.tp_attention_inputs(q_in, kv_in, tp)

    def heads(name, x):
        return _linear(attn[name], x).view(b, x.shape[1], -1, cfg.head_dim)

    att = attend(cfg, heads("q", q_in), heads("k", kv_in), heads("v", kv_in),
                 False, generator, tp)
    return _row(attn["o"], att.reshape(b, s, -1), tp)


class _Block(nn.Module):
    """What a GPT-2 and a llama block share: the attention half, built
    from the family's ``attn_norm``, ``qkv`` and ``mlp``."""

    def proj(self, att: torch.Tensor, tp=None) -> torch.Tensor:
        """The output projection of attention [b, s, heads * head_dim]
        (row-parallel under ``tp``)."""
        return _row(self.attn["o"], att, tp)

    def forward(self, cfg: ModelConfig, h: torch.Tensor,
                rope: Optional[Rope] = None,
                rng: Optional[int] = None, tp=None) -> torch.Tensor:
        """Full-sequence causal forward on h [b, s, dim] (``rope``: the
        table's rows 0 .. s-1 for llama); differentiable (the flash route
        through the kernels' autograd function). GQA kv heads are
        expanded before attention; the band carries
        ``cfg.sliding_window``. ``rng``: the layer's dropout seed (sites
        0-2: the probabilities, the attention branch, the MLP branch).
        ``tp``: this rank's heads and columns (see the module doc)."""
        b, s, _ = h.shape
        q, k, v = self.qkv(cfg, col.tp_copy(self.attn_norm(h), tp), rope)
        k, v = gqa_expand(k, v, q.shape[2])
        att = attend(cfg, q, k, v, True, _site(cfg, rng, 0, h.device), tp)
        att = self.proj(att.reshape(b, s, -1), tp)
        h = h + dropout_apply(att, cfg.dropout, _site(cfg, rng, 1, h.device))
        return self.mlp(h, _site(cfg, rng, 2, h.device), tp, cfg)


class Block(_Block):
    """One GPT-2 decoder block."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.ln1 = nn.LayerNorm(d, eps=1e-5, **kw)
        self.attn = nn.ModuleDict({
            n: nn.Linear(d, d, **kw) for n in ("q", "k", "v", "o")})
        self.ln2 = nn.LayerNorm(d, eps=1e-5, **kw)
        self.lin1 = nn.Linear(d, cfg.ffn_dim, **kw)
        self.lin2 = nn.Linear(cfg.ffn_dim, d, **kw)
        self.dropout = cfg.dropout

    def attn_norm(self, h: torch.Tensor) -> torch.Tensor:
        return _ln(self.ln1, h)

    def qkv(self, cfg: ModelConfig, a: torch.Tensor,
            rope: Optional[Rope] = None):
        """Project the normalised input [b, s, dim] to q, k, v
        [b, s, heads, head_dim]."""
        b, s, _ = a.shape
        return tuple(_linear(self.attn[n], a).view(b, s, -1, cfg.head_dim)
                     for n in ("q", "k", "v"))

    def mlp(self, h: torch.Tensor,
            generator: Optional[torch.Generator] = None, tp=None,
            cfg: Optional[ModelConfig] = None) -> torch.Tensor:
        """The post-attention half: h + lin2(gelu(lin1(ln2(h)))), the
        branch under dropout drawn from ``generator``; under ``tp`` this
        rank's columns, or the collective-matmul ring (the JAX
        ``mlp_block`` and ``_mlp_block_ring``)."""
        m = _ln(self.ln2, h)
        if cfg is not None and _ring(cfg, tp, h, generator):
            z = col.all_gather_matmul(col.seq_scatter(m, tp),
                                      _c(self.lin1.weight, m), tp)
            z = gelu(z + _c(self.lin1.bias, m))
            ff = col.matmul_reduce_scatter(z, _c(self.lin2.weight, z), tp)
            return h + (col.seq_all_gather(ff, tp) + _c(self.lin2.bias, ff))
        z = gelu(_linear(self.lin1, col.tp_copy(m, tp)))
        return h + dropout_apply(_row(self.lin2, z, tp), self.dropout,
                                 generator)


class LlamaBlock(_Block):
    """One llama decoder block (Llama, Mistral, Qwen2 and Gemma knobs)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, hd = cfg.dim, cfg.head_dim
        bias = cfg.attention_qkv_bias
        self.rms_eps = cfg.rms_eps
        self.act = silu if cfg.mlp_act == "silu" else gelu
        self.rms1 = nn.RMSNorm(d, eps=cfg.rms_eps, **kw)
        self.attn = nn.ModuleDict({
            "q": nn.Linear(d, cfg.n_heads * hd, bias=bias, **kw),
            "k": nn.Linear(d, cfg.kv_heads * hd, bias=bias, **kw),
            "v": nn.Linear(d, cfg.kv_heads * hd, bias=bias, **kw),
            "o": nn.Linear(cfg.n_heads * hd, d, bias=False, **kw)})
        self.rms2 = nn.RMSNorm(d, eps=cfg.rms_eps, **kw)
        self.w1 = nn.Linear(d, cfg.ffn_dim, bias=False, **kw)
        self.w2 = nn.Linear(cfg.ffn_dim, d, bias=False, **kw)
        self.w3 = nn.Linear(d, cfg.ffn_dim, bias=False, **kw)
        self.dropout = cfg.dropout

    def _rms(self, norm: nn.RMSNorm, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, _c(norm.weight, x), self.rms_eps)

    def attn_norm(self, h: torch.Tensor) -> torch.Tensor:
        return self._rms(self.rms1, h)

    def qkv(self, cfg: ModelConfig, a: torch.Tensor, rope: Rope):
        """q [b, s, heads, head_dim] and k, v [b, s, kv_heads, head_dim]
        from the normalised input [b, s, dim], with q and k rotated by
        ``rope`` (rows for the s positions; the JAX ``qkv_project``
        without the GQA expansion)."""
        b, s, _ = a.shape
        hd = cfg.head_dim
        q = _linear(self.attn["q"], a).view(b, s, -1, hd)
        k = _linear(self.attn["k"], a).view(b, s, -1, hd)
        v = _linear(self.attn["v"], a).view(b, s, -1, hd)
        return apply_rope(q, rope), apply_rope(k, rope), v

    def mlp(self, h: torch.Tensor,
            generator: Optional[torch.Generator] = None, tp=None,
            cfg: Optional[ModelConfig] = None) -> torch.Tensor:
        """The post-attention half: h + w2(act(w1 m) * w3 m), m = rms2(h),
        the branch under dropout drawn from ``generator``; under ``tp``
        this rank's columns, or the collective-matmul ring."""
        m = self._rms(self.rms2, h)
        if cfg is not None and _ring(cfg, tp, h, generator):
            ms = col.seq_scatter(m, tp)
            z1 = col.all_gather_matmul(ms, _c(self.w1.weight, m), tp)
            z3 = col.all_gather_matmul(ms, _c(self.w3.weight, m), tp)
            z = self.act(z1) * z3
            ff = col.matmul_reduce_scatter(z, _c(self.w2.weight, z), tp)
            return h + col.seq_all_gather(ff, tp)
        m = col.tp_copy(m, tp)
        z = self.act(_linear(self.w1, m)) * _linear(self.w3, m)
        return h + dropout_apply(_row(self.w2, z, tp), self.dropout,
                                 generator)


class RefDecoderBlock(nn.Module):
    """One reference decoder block: ``nn.TransformerDecoderLayer(dim,
    n_heads, dim_feedforward=ffn_dim)`` called as ``layer(h, h)`` (the JAX
    ``ref_decoder`` block): post-LN self-attention, cross-attention whose
    memory is the block's input, relu FFN; no mask, no positions."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.self_attn = nn.ModuleDict({
            n: nn.Linear(d, d, **kw) for n in ("q", "k", "v", "o")})
        self.cross_attn = nn.ModuleDict({
            n: nn.Linear(d, d, **kw) for n in ("q", "k", "v", "o")})
        self.ln1 = nn.LayerNorm(d, eps=1e-5, **kw)
        self.ln2 = nn.LayerNorm(d, eps=1e-5, **kw)
        self.ln3 = nn.LayerNorm(d, eps=1e-5, **kw)
        self.lin1 = nn.Linear(d, cfg.ffn_dim, **kw)
        self.lin2 = nn.Linear(cfg.ffn_dim, d, **kw)

    def forward(self, cfg: ModelConfig, h: torch.Tensor,
                rope: Optional[Rope] = None,
                rng: Optional[int] = None, tp=None) -> torch.Tensor:
        """h [b, s, dim] -> [b, s, dim]; ``rng``: the layer's dropout seed
        (sites 0-5: self-attention probabilities and branch,
        cross-attention probabilities and branch, the FFN's inner
        activation, the FFN branch; ``nn.TransformerDecoderLayer``'s
        dropout sites). ``tp``: this rank's heads and FFN columns; the
        FFN activation's mask is the unsharded one's block of columns."""
        p = cfg.dropout

        def site(j):
            return _site(cfg, rng, j, h.device)

        sa = mha_apply(cfg, self.self_attn, h, h, site(0), tp)
        x = _ln(self.ln1, h + dropout_apply(sa, p, site(1)))
        ca = mha_apply(cfg, self.cross_attn, x, h, site(2), tp)
        x = _ln(self.ln2, x + dropout_apply(ca, p, site(3)))
        z = relu(_linear(self.lin1, col.tp_copy(x, tp)))
        z = sharded_dropout_apply(z, p, site(4), *_shard_of(tp), shard_dim=-1)
        ff = _row(self.lin2, z, tp)
        return _ln(self.ln3, x + dropout_apply(ff, p, site(5)))


class Transformer(nn.Module):
    """The LM: token embeddings (plus learned positions for GPT-2), the
    family's blocks, a final norm (LayerNorm or RMSNorm), and a head
    (the token table under ``cfg.tie_embeddings``; with a bias for the
    reference arch).

    ``layers`` (global indices) makes a pipe rank's view: only those
    blocks are built; every other entry of ``self.layers`` is an empty
    module, so the blocks keep their global index and parameter names."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None,
                 layers: Optional[Iterable[int]] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.tok = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, **kw))
        if cfg.arch == "gpt2":
            self.pos = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.dim, **kw))
        if cfg.arch == "llama":
            self.norm = nn.RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
        else:
            self.norm = nn.LayerNorm(cfg.dim, eps=1e-5, **kw)
        block = {"ref_decoder": RefDecoderBlock, "gpt2": Block,
                 "llama": LlamaBlock}[cfg.arch]
        own = set(range(cfg.n_layers) if layers is None else layers)
        self.layers = nn.ModuleList(
            block(cfg, **kw) if i in own else nn.Module()
            for i in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.out = nn.Linear(cfg.dim, cfg.vocab_size,
                                 bias=cfg.arch == "ref_decoder", **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer_apply(self.cfg, self, tokens)


_NORMS = ("ln1", "ln2", "ln3", "rms1", "rms2", "norm")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", layers: Optional[Iterable[int]] = None
                ) -> Transformer:
    """A randomly initialised model in ``cfg.storage_dtype`` on
    ``device``, drawn from ``generator`` (the JAX ``transformer_init``
    conventions: embeddings N(0, 0.02), the reference arch's token table
    N(0, 1) as ``nn.Embedding``'s, linear weights and biases
    uniform(+-1/sqrt(fan_in)) as torch's ``nn.Linear``, norm scales 1 and
    biases 0). The numbers differ from the JAX package's for the same
    seed. ``layers``: a pipe rank's view (:class:`Transformer`), holding
    the whole model's values for its blocks (the draws of the other
    blocks are made and dropped)."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device,
                        dtype=torch_dtype(cfg.storage_dtype), layers=layers)
    own = dict(model.named_parameters())
    whole = Transformer(cfg, device="meta")  # every draw, in order
    gdev = generator.device
    with torch.no_grad():
        for name, p in whole.named_parameters():
            if name in ("tok", "pos"):
                std = 1.0 if cfg.arch == "ref_decoder" and name == "tok" \
                    else 0.02
                x = std * torch.randn(p.shape, generator=generator,
                                      device=gdev)
            elif name.split(".")[-2] in _NORMS:
                x = torch.ones(p.shape) if name.endswith("weight") else \
                    torch.zeros(p.shape)
            else:
                w = name[:-len("bias")] + "weight" if p.dim() == 1 else name
                bound = 1.0 / math.sqrt(whole.get_parameter(w).shape[1])
                x = (torch.rand(p.shape, generator=generator, device=gdev)
                     * 2 - 1) * bound
            if name in own:
                own[name].copy_(x)
    return model


def compute_cast(cfg: ModelConfig, model: Transformer) -> Transformer:
    """The model in the compute dtype: itself without mixed precision,
    else a cast copy (the JAX ``compute_cast``)."""
    if not cfg.mixed_precision:
        return model
    return copy.deepcopy(model).to(torch_dtype(cfg.dtype))


def embed_apply(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
                offset=0, rng: Optional[int] = None) -> torch.Tensor:
    """Embeddings of tokens [b, s] at global positions offset ..
    offset+s-1 (``offset`` an int, or the positions themselves as an [s]
    index tensor), in the compute dtype: the token rows, times sqrt(dim)
    under ``cfg.embed_scale``, plus GPT-2's learned positions (the JAX
    ``embed_apply`` and ``_embed_at``), then GPT-2's embedding dropout
    (train mode: ``rng`` is the forward's seed, and the embedding's stream
    folds ``n_layers``, past every layer's)."""
    dt = torch_dtype(cfg.dtype)
    h = embedding(model.tok, tokens).to(dt)
    if cfg.embed_scale:
        h = h * (cfg.dim ** 0.5)
    if cfg.arch == "gpt2":
        pos = (model.pos[offset:offset + tokens.shape[1]]
               if isinstance(offset, int) else model.pos.index_select(0, offset))
        h = h + pos.to(dt)
        h = dropout_apply(h, cfg.dropout,
                          _site(cfg, rng, cfg.n_layers, h.device))
    return h


def body_apply(cfg: ModelConfig, layers, h: torch.Tensor,
               rng: Optional[int] = None,
               layer_offset: int = 0, tp=None) -> torch.Tensor:
    """Run a slice of blocks (any count) over h [b, s, dim] at positions
    0 .. s-1. ``rng`` (train mode) is the dropout seed: block ``i`` folds
    ``layer_offset + i``, its global layer index when the slice is a
    pipeline stage, so every stage split draws the same masks. ``tp``:
    the rank's mesh when the blocks are its model-axis shards."""
    rope = rope_table(cfg, h.shape[1], h.device)
    for i, block in enumerate(layers):
        rng_l = None if rng is None else fold_seed(rng, layer_offset + i)
        h = block(cfg, h, rope, rng_l, tp)
    return h


def head_norm_apply(cfg: ModelConfig, model: Transformer,
                    h: torch.Tensor) -> torch.Tensor:
    """The head's final norm: RMSNorm for llama, LayerNorm for GPT-2."""
    if cfg.arch == "llama":
        return rms_norm(h, _c(model.norm.weight, h), cfg.rms_eps)
    return layer_norm(h, _c(model.norm.weight, h), _c(model.norm.bias, h))


def head_apply(cfg: ModelConfig, model: Transformer,
               h: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocab projection: [..., dim] -> [..., V]; the
    projection is ``tok.T`` under ``cfg.tie_embeddings``. The matmul runs
    on the flattened [N, dim] rows, so the logits come out as the
    contiguous [N, V] the fused-xent kernels read."""
    hn = head_norm_apply(cfg, model, h)
    lead = hn.shape[:-1]
    hn2 = hn.reshape(-1, hn.shape[-1])
    if cfg.tie_embeddings:
        logits = linear(hn2, _c(model.tok, hn))
    else:
        logits = _linear(model.out, hn2)
    return logits.reshape(*lead, logits.shape[-1])


def transformer_apply(cfg: ModelConfig, model: Transformer,
                      tokens: torch.Tensor,
                      rng: Optional[int] = None) -> torch.Tensor:
    """Full-model forward: tokens [B, S] -> logits [B, S, V], computed in
    ``cfg.dtype`` over parameters in ``cfg.storage_dtype``. ``rng``
    (train mode): layer ``i`` folds ``i``, the embedding ``n_layers``, as
    the pipeline does for each microbatch."""
    h = embed_apply(cfg, model, tokens, rng=rng)
    h = body_apply(cfg, model.layers, h, rng)
    return head_apply(cfg, model, h)


def head_loss(cfg: ModelConfig, model: Transformer, h: torch.Tensor,
              targets: torch.Tensor, pad_scale=None, tp=None,
              vocab_parallel: bool = False) -> torch.Tensor:
    """The loss of hidden states h [b, s, dim] (the JAX ``_stage_ce``):
    the head, then the token-mean cross entropy through
    ``select_xent(cfg.use_fused_xent)``, or, with ``cfg.pad_token_id``,
    the masked NLL sum times ``pad_scale`` (see
    ``ops.layers.global_pad_scale``).

    ``vocab_parallel`` (under ``tp``): Megatron's parallel cross entropy
    (the JAX ``_stage_ce_impl`` branch): this rank's vocab columns of the
    head (the vocab-split ``out``; tied, its vocab rows of ``tok`` behind
    ``tp_copy``, so their gradients sum over the group into the whole
    table's), and ``ops.collectives.vocab_parallel_xent``: the ``[N, V]``
    logits never exist and the fused-xent kernel is not on this route,
    as in JAX."""
    if vocab_parallel:
        hn = col.tp_copy(head_norm_apply(cfg, model, h), tp)
        hn2 = hn.reshape(-1, hn.shape[-1])
        if cfg.tie_embeddings:
            v_loc = cfg.vocab_size // tp.n_model
            tok = col.tp_copy(_c(model.tok, hn), tp)
            logits = linear(hn2, tok[tp.model * v_loc:(tp.model + 1) * v_loc])
        else:
            logits = _linear(model.out, hn2)
        tgt = targets.reshape(-1)
        if cfg.pad_token_id is not None:
            s, _ = col.vocab_parallel_masked_xent_sum(logits, tgt, tp,
                                                      cfg.pad_token_id)
            return s * pad_scale
        return col.vocab_parallel_xent(logits, tgt, tp)
    logits = head_apply(cfg, model, h)
    if cfg.pad_token_id is not None:
        s, _ = select_masked_xent_sum(cfg.use_fused_xent)(
            logits, targets, cfg.pad_token_id)
        return s * pad_scale
    return select_xent(cfg.use_fused_xent)(logits, targets)


def transformer_loss(cfg: ModelConfig, model: Transformer,
                     tokens: torch.Tensor, targets: torch.Tensor,
                     rng: Optional[int] = None) -> torch.Tensor:
    """Single-device loss, the objective the pipeline executors are held
    against: token-mean cross entropy, or with ``cfg.pad_token_id`` the
    NLL sum over valid targets divided by their count. ``rng``: the
    dropout seed, as in :func:`transformer_apply` (a pipeline step's
    microbatch ``m`` runs under ``fold_seed(step_seed, m)``)."""
    h = body_apply(cfg, model.layers,
                   embed_apply(cfg, model, tokens, rng=rng), rng)
    pad_scale = (global_pad_scale(targets, cfg.pad_token_id, 1)
                 if cfg.pad_token_id is not None else None)
    return head_loss(cfg, model, h, targets, pad_scale)
