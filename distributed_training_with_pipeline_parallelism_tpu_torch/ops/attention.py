"""Dense attention pieces (counterparts of the JAX package's
``ops/attention.py``): the causal/window band mask, the GQA head repeat
and scaled dot-product attention on ``[b, s, h, dh]``."""

from __future__ import annotations

import functools
from typing import Optional

import torch

# the score of a masked element in the flash kernel and its plain
# version: a large finite negative, so exp underflows to exactly 0 and a
# fully-dead row never computes inf - inf
NEG_INF = -1e30


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
    """Repeat kv heads (dim 2) up to n_heads; a no-op for MHA."""
    n_kv = k.shape[2]
    if n_kv != n_heads:
        rep = n_heads // n_kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


@functools.lru_cache(maxsize=None)
def attention_scale(head_dim: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(head_dim)`` computed in ``dtype``, as the JAX
    ``scaled_dot_attention`` computes it: the square root rounded to the
    dtype, then its reciprocal rounded again. Returned as a Python float
    (exact in ``dtype``), so a device tensor never waits on a host copy."""
    return float(1.0 / torch.sqrt(torch.tensor(head_dim, dtype=dtype)))


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [b,s,h,d] x k/v [b,t,h,d] -> [b,s,h,d]. ``mask`` broadcasts
    against the [b,h,s,t] scores; False positions get the dtype's most
    negative finite value. Softmax runs in f32 whatever the activation
    dtype, as in the JAX package."""
    scale = attention_scale(q.shape[-1], q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
