"""The GPT-2 decoder as ``nn.Module``s (counterpart of the JAX package's
``models/transformer.py`` for ``arch="gpt2"``).

Block: pre-LN, causal self-attention, residual; LN, MLP with the tanh
GELU, residual. Learned positions; the head is a final LN and a linear
without bias, or, under ``cfg.tie_embeddings``, the token table itself
(``logits = norm(h) @ tok.T``). Parameter names follow the JAX pytree's
leaves (``ln1``, ``attn.{q,k,v,o}``, ``ln2``, ``lin1``, ``lin2``; ``tok``,
``pos``; ``norm``, ``out``) so :mod:`..utils.weights` maps one onto the
other. Linear weights are torch's ``[out, in]``.

Mixed precision (``cfg.param_dtype`` set): every use casts its parameter
to the activation dtype with ``.to``, a differentiable cast, so gradients
reach the storage-dtype parameters (the JAX ``compute_cast`` inside
autodiff). Without mixed precision the casts are no-ops.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn as nn

from ..ops.attention import band_mask, scaled_dot_attention
from ..ops.flash_attention import flash_attention
from ..ops.layers import (embedding, gelu, global_pad_scale, layer_norm,
                          linear, select_masked_xent_sum, select_xent)
from ..utils.config import ModelConfig, resolve_device, torch_dtype


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch != "gpt2":
        raise NotImplementedError(
            f"the port implements arch='gpt2'; {cfg.arch!r} is not ported yet")


def _c(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Parameter ``p`` in the dtype of activation ``x`` (differentiable;
    a no-op when they already agree)."""
    return p if p.dtype == x.dtype else p.to(x.dtype)


class Block(nn.Module):
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

    def _linear(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return linear(x, _c(lin.weight, x), _c(lin.bias, x))

    def _ln(self, ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, _c(ln.weight, x), _c(ln.bias, x))

    def qkv(self, cfg: ModelConfig, a: torch.Tensor):
        """Project the normalised input [b, s, dim] to q, k, v
        [b, s, heads, head_dim]."""
        b, s, _ = a.shape
        return tuple(self._linear(self.attn[n], a)
                     .view(b, s, cfg.n_heads, cfg.head_dim)
                     for n in ("q", "k", "v"))

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        """The post-attention half: h + lin2(gelu(lin1(ln2(h))))."""
        z = gelu(self._linear(self.lin1, self._ln(self.ln2, h)))
        return h + self._linear(self.lin2, z)

    def forward(self, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward on h [b, s, dim]; differentiable
        (the flash route through the kernels' autograd function)."""
        b, s, _ = h.shape
        q, k, v = self.qkv(cfg, self._ln(self.ln1, h))
        if cfg.flash_for(True, h.device):
            att = flash_attention(q, k, v, causal=True)
        else:
            att = scaled_dot_attention(
                q, k, v, band_mask(s, s, device=h.device)[None, None])
        return self.mlp(h + self._linear(self.attn["o"], att.reshape(b, s, -1)))


class Transformer(nn.Module):
    """GPT-2: token and position embeddings, blocks, final LN, and a head
    without bias (the token table under ``cfg.tie_embeddings``)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        _check_arch(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.tok = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, **kw))
        self.pos = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.dim, **kw))
        self.layers = nn.ModuleList(
            Block(cfg, **kw) for _ in range(cfg.n_layers))
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-5, **kw)
        if not cfg.tie_embeddings:
            self.out = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer_apply(self.cfg, self, tokens)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A randomly initialised model in ``cfg.storage_dtype`` on
    ``device``, drawn from ``generator`` (the JAX ``transformer_init``
    conventions: embeddings N(0, 0.02), linear weights and biases
    uniform(+-1/sqrt(fan_in)) as torch's ``nn.Linear``, norms 1 and 0).
    The numbers differ from the JAX package's for the same seed."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device,
                        dtype=torch_dtype(cfg.storage_dtype))
    gdev = generator.device
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in ("tok", "pos"):
                x = 0.02 * torch.randn(p.shape, generator=generator,
                                       device=gdev)
            elif name.split(".")[-2] in ("ln1", "ln2", "norm"):
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
                offset: int = 0) -> torch.Tensor:
    """Token plus position embeddings for tokens [b, s] at global
    positions offset .. offset+s-1, in the compute dtype."""
    dt = torch_dtype(cfg.dtype)
    h = embedding(model.tok, tokens).to(dt)
    return h + model.pos[offset:offset + tokens.shape[1]].to(dt)


def body_apply(cfg: ModelConfig, layers, h: torch.Tensor) -> torch.Tensor:
    """Run a slice of blocks (any count) over h [b, s, dim]."""
    for block in layers:
        h = block(cfg, h)
    return h


def head_apply(cfg: ModelConfig, model: Transformer,
               h: torch.Tensor) -> torch.Tensor:
    """Final LN and the vocab projection: [..., dim] -> [..., V]; the
    projection is ``tok.T`` under ``cfg.tie_embeddings``. The matmul runs
    on the flattened [N, dim] rows, so the logits come out as the
    contiguous [N, V] the fused-xent kernels read."""
    hn = layer_norm(h, _c(model.norm.weight, h), _c(model.norm.bias, h))
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
