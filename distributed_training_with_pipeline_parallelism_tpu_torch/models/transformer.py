"""The GPT-2 decoder as ``nn.Module``s (counterpart of the JAX package's
``models/transformer.py`` for ``arch="gpt2"``).

Block: pre-LN, causal self-attention, residual; LN, MLP with the tanh
GELU, residual. Learned positions; the head is a final LN and an untied
linear without bias. Parameter names follow the JAX pytree's leaves
(``ln1``, ``attn.{q,k,v,o}``, ``ln2``, ``lin1``, ``lin2``; ``tok``,
``pos``; ``norm``, ``out``) so :mod:`..utils.weights` maps one onto the
other. Linear weights are torch's ``[out, in]``.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn as nn

from ..ops.attention import band_mask, scaled_dot_attention
from ..ops.flash_attention import flash_attention
from ..ops.layers import embedding, gelu, layer_norm, linear
from ..utils.config import ModelConfig, resolve_device, torch_dtype


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch != "gpt2":
        raise NotImplementedError(
            f"the port implements arch='gpt2'; {cfg.arch!r} is not ported yet")


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

    def qkv(self, cfg: ModelConfig, a: torch.Tensor):
        """Project the normalised input [b, s, dim] to q, k, v
        [b, s, heads, head_dim]."""
        b, s, _ = a.shape
        return tuple(
            linear(a, self.attn[n].weight, self.attn[n].bias)
            .view(b, s, cfg.n_heads, cfg.head_dim) for n in ("q", "k", "v"))

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        """The post-attention half: h + lin2(gelu(lin1(ln2(h))))."""
        m = layer_norm(h, self.ln2.weight, self.ln2.bias)
        z = gelu(linear(m, self.lin1.weight, self.lin1.bias))
        return h + linear(z, self.lin2.weight, self.lin2.bias)

    def forward(self, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward on h [b, s, dim]."""
        b, s, _ = h.shape
        a = layer_norm(h, self.ln1.weight, self.ln1.bias)
        q, k, v = self.qkv(cfg, a)
        if cfg.flash_for(True, h.device):
            att = flash_attention(q, k, v, causal=True)
        else:
            att = scaled_dot_attention(
                q, k, v, band_mask(s, s, device=h.device)[None, None])
        o = self.attn["o"]
        h = h + linear(att.reshape(b, s, -1), o.weight, o.bias)
        return self.mlp(h)


class Transformer(nn.Module):
    """GPT-2: token and position embeddings, blocks, final LN, untied
    head without bias."""

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
    positions offset .. offset+s-1."""
    h = embedding(model.tok, tokens)
    return h + model.pos[offset:offset + tokens.shape[1]]


def head_apply(cfg: ModelConfig, model: Transformer,
               h: torch.Tensor) -> torch.Tensor:
    """Final LN and the vocab projection: [..., dim] -> [..., V]."""
    hn = layer_norm(h, model.norm.weight, model.norm.bias)
    lead = hn.shape[:-1]
    logits = linear(hn.reshape(-1, hn.shape[-1]), model.out.weight)
    return logits.reshape(*lead, logits.shape[-1])


def transformer_apply(cfg: ModelConfig, model: Transformer,
                      tokens: torch.Tensor) -> torch.Tensor:
    """Full-model forward: tokens [B, S] -> logits [B, S, V]."""
    _check_arch(cfg)
    model = compute_cast(cfg, model)
    h = embed_apply(cfg, model, tokens)
    for block in model.layers:
        h = block(cfg, h)
    return head_apply(cfg, model, h)
