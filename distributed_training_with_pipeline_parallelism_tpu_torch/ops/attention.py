"""Dense attention pieces (counterparts of the JAX package's
``ops/attention.py``): the causal/window band mask, the GQA head repeat
and scaled dot-product attention on ``[b, s, h, dh]``."""

from __future__ import annotations

import math
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


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [b,s,h,d] x k/v [b,t,h,d] -> [b,s,h,d]. ``mask`` broadcasts
    against the [b,h,s,t] scores; False positions get the dtype's most
    negative finite value. Softmax runs in f32 whatever the activation
    dtype, as in the JAX package."""
    # a Python scale: a device tensor made from a host number would copy
    # (and synchronise) once per call
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
