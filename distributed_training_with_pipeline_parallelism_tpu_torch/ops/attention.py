"""Dense attention pieces (counterparts of the JAX package's
``ops/attention.py``): RoPE (with the Llama-3.1 frequency scaling), the
causal/window band mask, the GQA head repeat and scaled dot-product
attention on ``[b, s, h, dh]``, with dropout on its probabilities."""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .layers import sharded_dropout_apply

# the score of a masked element in the flash kernel and its plain
# version: a large finite negative, so exp underflows to exactly 0 and a
# fully-dead row never computes inf - inf
NEG_INF = -1e30


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     scaling: Optional[tuple] = None,
                     device=None) -> torch.Tensor:
    """RoPE angles [max_seq_len, head_dim // 2] f32 (the JAX
    ``rope_frequencies``, its f32 arithmetic in the same order).

    ``scaling`` is Llama-3.1's ``(factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings)``: wavelengths
    shorter than ``orig/high`` keep their frequency, longer than
    ``orig/low`` divide by ``factor``, and the band between (both edges
    strict) interpolates.

    Computed on the CPU and then moved to ``device``: a CUDA division by
    a scalar multiplies by its reciprocal, and ``scalar / tensor`` in
    torch does so on either device, which rounds twice; here every
    quotient is one f32 division, as XLA computes it."""
    def f32(c):
        return torch.tensor(c, dtype=torch.float32)

    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    inv = f32(1.0) / torch.pow(theta, exps)
    if scaling is not None:
        factor, low_f, high_f, orig_max = scaling
        wavelen = f32(2.0 * math.pi) / inv
        smooth = (f32(orig_max) / wavelen - low_f) / (high_f - low_f)
        mid = (1.0 - smooth) * inv / factor + smooth * inv
        inv = torch.where(wavelen > orig_max / low_f, inv / factor,
                          torch.where(wavelen < orig_max / high_f, inv, mid))
    t = torch.arange(max_seq_len, dtype=torch.float32)
    return torch.outer(t, inv).to(device)


class Rope(NamedTuple):
    """cos and sin [s, head_dim // 2] f32 of a run of RoPE angles (taken
    once per table, not once per layer)."""
    cos: torch.Tensor
    sin: torch.Tensor

    @classmethod
    def of(cls, angles: torch.Tensor) -> "Rope":
        return cls(torch.cos(angles), torch.sin(angles))

    def rows(self, start: int, n: int) -> "Rope":
        """The rows of positions ``start .. start+n-1`` (views)."""
        return Rope(self.cos[start:start + n], self.sin[start:start + n])


def apply_rope(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """Rotate [b, s, h, d] queries or keys by per-position angles (``rope``
    of [s, d//2]), halves not interleaved; the rotation runs in f32 and
    the result is cast back to x's dtype, as the JAX ``apply_rope``."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = rope.cos[None, :, None, :]
    sin = rope.sin[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def band_mask(n_q: int, n_k: int, window: Optional[int] = None,
              q_offset: int = 0, device=None) -> torch.Tensor:
    """Causal [n_q, n_k] bool mask, optionally banded to a sliding window:
    query i (at global position q_offset + i) sees keys in
    ``[pos - window + 1, pos]``."""
    iq = q_offset + torch.arange(n_q, device=device)[:, None]
    ik = torch.arange(n_k, device=device)[None, :]
    mask = iq >= ik
    if window is not None:
        mask &= iq - ik < window
    return mask


def gqa_expand(k: torch.Tensor, v: torch.Tensor, n_heads: int):
    """Repeat kv heads (dim 2) up to n_heads, each kv head ``n_heads /
    n_kv`` times in place (``repeat_interleave``'s order, written as an
    expand and a copy, which a CUDA graph captures); a no-op for MHA."""
    n_kv = k.shape[2]
    if n_kv != n_heads:
        rep = n_heads // n_kv

        def expand(x):
            b, t, _, hd = x.shape
            return x[:, :, :, None].expand(b, t, n_kv, rep, hd).reshape(
                b, t, n_heads, hd)

        k, v = expand(k), expand(v)
    return k, v


@functools.lru_cache(maxsize=None)
def attention_scale(head_dim: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(head_dim)`` computed in ``dtype``, as the JAX
    ``scaled_dot_attention`` computes it: the square root rounded to the
    dtype, then its reciprocal rounded again. Returned as a Python float
    (exact in ``dtype``), so a device tensor never waits on a host copy."""
    return float(1.0 / torch.sqrt(torch.tensor(head_dim, dtype=dtype)))


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         head_shard: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """q [b,s,h,d] x k/v [b,t,h,d] -> [b,s,h,d]. ``mask`` broadcasts
    against the [b,h,s,t] scores; False positions get the dtype's most
    negative finite value. Softmax runs in f32 whatever the activation
    dtype, as in the JAX package. ``generator`` (train mode) applies
    dropout to the probabilities, as torch's ``MultiheadAttention`` does.
    ``head_shard`` = (n_shards, index) where the h heads are one
    tensor-parallel block of all of them: the mask is the unsharded one's
    block of heads (``ops.layers.sharded_dropout_apply``)."""
    scale = attention_scale(q.shape[-1], q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    n, index = head_shard or (1, 0)
    probs = sharded_dropout_apply(probs, dropout_rate, generator, n, index,
                                  shard_dim=1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
