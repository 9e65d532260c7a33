"""The GPT-2 and llama decoders as ``nn.Module``s (counterpart of the JAX
package's ``models/transformer.py`` for ``arch="gpt2"`` and
``arch="llama"``).

GPT-2 block: pre-LN, causal self-attention, residual; LN, MLP with the
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
``tok`` and GPT-2's ``pos``; ``norm``, ``out``) so :mod:`..utils.weights`
maps one onto the other. Linear weights are torch's ``[out, in]``.

Mixed precision (``cfg.param_dtype`` set): every use casts its parameter
to the activation dtype with ``.to``, a differentiable cast, so gradients
reach the storage-dtype parameters (the JAX ``compute_cast`` inside
autodiff). Without mixed precision the casts are no-ops.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import (Rope, apply_rope, band_mask, gqa_expand,
                             rope_frequencies, scaled_dot_attention)
from ..ops.flash_attention import flash_attention
from ..ops.layers import (embedding, gelu, global_pad_scale, layer_norm,
                          linear, rms_norm, select_masked_xent_sum,
                          select_xent, silu)
from ..utils.config import ModelConfig, resolve_device, torch_dtype


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch not in ("gpt2", "llama"):
        raise NotImplementedError(
            f"the port implements arch='gpt2' and 'llama'; {cfg.arch!r} is "
            f"not ported yet")


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


class _Block(nn.Module):
    """What a GPT-2 and a llama block share: the attention half, built
    from the family's ``attn_norm``, ``qkv`` and ``mlp``."""

    def proj(self, att: torch.Tensor) -> torch.Tensor:
        """The output projection of attention [b, s, heads * head_dim]."""
        return _linear(self.attn["o"], att)

    def forward(self, cfg: ModelConfig, h: torch.Tensor,
                rope: Optional[Rope] = None) -> torch.Tensor:
        """Full-sequence causal forward on h [b, s, dim] (``rope``: the
        table's rows 0 .. s-1 for llama); differentiable (the flash route
        through the kernels' autograd function). GQA kv heads are
        expanded before attention; the band carries
        ``cfg.sliding_window``."""
        b, s, _ = h.shape
        q, k, v = self.qkv(cfg, self.attn_norm(h), rope)
        k, v = gqa_expand(k, v, cfg.n_heads)
        if cfg.flash_for(True, h.device):
            att = flash_attention(q, k, v, causal=True,
                                  window=cfg.sliding_window)
        else:
            mask = band_mask(s, s, cfg.sliding_window, device=h.device)
            att = scaled_dot_attention(q, k, v, mask[None, None])
        return self.mlp(h + self.proj(att.reshape(b, s, -1)))


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

    def _ln(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, _c(ln.weight, x), _c(ln.bias, x))

    def attn_norm(self, h: torch.Tensor) -> torch.Tensor:
        return self._ln(self.ln1, h)

    def qkv(self, cfg: ModelConfig, a: torch.Tensor,
            rope: Optional[Rope] = None):
        """Project the normalised input [b, s, dim] to q, k, v
        [b, s, heads, head_dim]."""
        b, s, _ = a.shape
        return tuple(_linear(self.attn[n], a)
                     .view(b, s, cfg.n_heads, cfg.head_dim)
                     for n in ("q", "k", "v"))

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        """The post-attention half: h + lin2(gelu(lin1(ln2(h))))."""
        z = gelu(_linear(self.lin1, self._ln(self.ln2, h)))
        return h + _linear(self.lin2, z)


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
        q = _linear(self.attn["q"], a).view(b, s, cfg.n_heads, hd)
        k = _linear(self.attn["k"], a).view(b, s, cfg.kv_heads, hd)
        v = _linear(self.attn["v"], a).view(b, s, cfg.kv_heads, hd)
        return apply_rope(q, rope), apply_rope(k, rope), v

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        """The post-attention half: h + w2(act(w1 m) * w3 m), m = rms2(h)."""
        m = self._rms(self.rms2, h)
        z = self.act(_linear(self.w1, m)) * _linear(self.w3, m)
        return h + _linear(self.w2, z)


class Transformer(nn.Module):
    """The LM: token embeddings (plus learned positions for GPT-2), the
    family's blocks, a final norm (LayerNorm or RMSNorm), and a head
    without bias (the token table under ``cfg.tie_embeddings``)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        _check_arch(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.tok = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, **kw))
        if cfg.arch == "gpt2":
            self.pos = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.dim, **kw))
            block, self.norm = Block, nn.LayerNorm(cfg.dim, eps=1e-5, **kw)
        else:
            block = LlamaBlock
            self.norm = nn.RMSNorm(cfg.dim, eps=cfg.rms_eps, **kw)
        self.layers = nn.ModuleList(
            block(cfg, **kw) for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.out = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer_apply(self.cfg, self, tokens)


_NORMS = ("ln1", "ln2", "rms1", "rms2", "norm")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A randomly initialised model in ``cfg.storage_dtype`` on
    ``device``, drawn from ``generator`` (the JAX ``transformer_init``
    conventions: embeddings N(0, 0.02), linear weights and biases
    uniform(+-1/sqrt(fan_in)) as torch's ``nn.Linear``, norm scales 1 and
    biases 0). The numbers differ from the JAX package's for the same
    seed."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device,
                        dtype=torch_dtype(cfg.storage_dtype))
    gdev = generator.device
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("tok", "pos"):
                x = 0.02 * torch.randn(p.shape, generator=generator,
                                       device=gdev)
            elif name.split(".")[-2] in _NORMS:
                x = torch.ones(p.shape) if name.endswith("weight") else \
                    torch.zeros(p.shape)
            else:
                w = name[:-len("bias")] + "weight" if p.dim() == 1 else name
                bound = 1.0 / math.sqrt(model.get_parameter(w).shape[1])
                x = (torch.rand(p.shape, generator=generator, device=gdev)
                     * 2 - 1) * bound
            p.copy_(x)
    return model


def compute_cast(cfg: ModelConfig, model: Transformer) -> Transformer:
    """The model in the compute dtype: itself without mixed precision,
    else a cast copy (the JAX ``compute_cast``)."""
    if not cfg.mixed_precision:
        return model
    return copy.deepcopy(model).to(torch_dtype(cfg.dtype))


def embed_apply(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
                offset=0) -> torch.Tensor:
    """Embeddings of tokens [b, s] at global positions offset ..
    offset+s-1 (``offset`` an int, or the positions themselves as an [s]
    index tensor), in the compute dtype: the token rows, times sqrt(dim)
    under ``cfg.embed_scale``, plus GPT-2's learned positions (the JAX
    ``embed_apply`` and ``_embed_at``)."""
    dt = torch_dtype(cfg.dtype)
    h = embedding(model.tok, tokens).to(dt)
    if cfg.embed_scale:
        h = h * (cfg.dim ** 0.5)
    if cfg.arch == "gpt2":
        pos = (model.pos[offset:offset + tokens.shape[1]]
               if isinstance(offset, int) else model.pos.index_select(0, offset))
        h = h + pos.to(dt)
    return h


def body_apply(cfg: ModelConfig, layers, h: torch.Tensor) -> torch.Tensor:
    """Run a slice of blocks (any count) over h [b, s, dim] at positions
    0 .. s-1."""
    rope = rope_table(cfg, h.shape[1], h.device)
    for block in layers:
        h = block(cfg, h, rope)
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
    w = model.tok if cfg.tie_embeddings else model.out.weight
    logits = linear(hn.reshape(-1, hn.shape[-1]), _c(w, hn))
    return logits.reshape(*lead, logits.shape[-1])


def transformer_apply(cfg: ModelConfig, model: Transformer,
                      tokens: torch.Tensor) -> torch.Tensor:
    """Full-model forward: tokens [B, S] -> logits [B, S, V], computed in
    ``cfg.dtype`` over parameters in ``cfg.storage_dtype``."""
    _check_arch(cfg)
    h = embed_apply(cfg, model, tokens)
    h = body_apply(cfg, model.layers, h)
    return head_apply(cfg, model, h)


def head_loss(cfg: ModelConfig, model: Transformer, h: torch.Tensor,
              targets: torch.Tensor, pad_scale=None) -> torch.Tensor:
    """The loss of hidden states h [b, s, dim] (the JAX ``_stage_ce``):
    the head, then the token-mean cross entropy through
    ``select_xent(cfg.use_fused_xent)``, or, with ``cfg.pad_token_id``,
    the masked NLL sum times ``pad_scale`` (see
    ``ops.layers.global_pad_scale``)."""
    logits = head_apply(cfg, model, h)
    if cfg.pad_token_id is not None:
        s, _ = select_masked_xent_sum(cfg.use_fused_xent)(
            logits, targets, cfg.pad_token_id)
        return s * pad_scale
    return select_xent(cfg.use_fused_xent)(logits, targets)


def transformer_loss(cfg: ModelConfig, model: Transformer,
                     tokens: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Single-device loss, the objective the pipeline executors are held
    against: token-mean cross entropy, or with ``cfg.pad_token_id`` the
    NLL sum over valid targets divided by their count."""
    _check_arch(cfg)
    h = body_apply(cfg, model.layers, embed_apply(cfg, model, tokens))
    pad_scale = (global_pad_scale(targets, cfg.pad_token_id, 1)
                 if cfg.pad_token_id is not None else None)
    return head_loss(cfg, model, h, targets, pad_scale)
