"""Ulysses all-to-all sequence parallelism (the counterpart of the JAX
package's ``parallel/ulysses.py``; DeepSpeed-Ulysses, arXiv:2309.14509).

Activations stay sequence-split ``[B, S/D, dim]`` through the
position-wise compute. Around the attention core the seq group's
all-to-all (``ops.collectives.seq_all_to_all``) re-splits them by head:
each rank then holds the whole sequence for H/D of the heads, runs
ordinary dense attention (``ops.attention.scaled_dot_attention``, as JAX
calls its dense ``scaled_dot_attention``), and the inverse all-to-all
gives the sequence split back. The backward of each exchange is the
inverse exchange. The parallel degree is capped by the head count.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops import collectives as col
from ..ops.attention import band_mask, gqa_expand, scaled_dot_attention
from ..ops.layers import seeded_generator
from .ring_attention import qkv_project


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sp, causal: bool = False, dropout_rate: float = 0.0,
                      dropout_seed: Optional[int] = None,
                      window: Optional[int] = None,
                      head_block=(1, 0)) -> torch.Tensor:
    """Exact attention of this rank's chunk with the sequence split over
    ``sp``'s seq group (the JAX ``ulysses_attention``): q, k, v [batch,
    seq_local, heads, head_dim]. Q's heads must divide by the axis size.
    K/V may carry fewer (GQA) heads: where those divide by the axis size
    they cross unexpanded and are expanded after the exchange, else they
    are expanded first. After the head scatter each rank holds the whole
    sequence, so the (windowed) causal band is the dense one.

    ``dropout_seed`` (train mode): the probabilities [b, h/D, S, S] after
    the scatter are a head block of the unsharded ones, so their mask is
    that block of the unsharded mask (``scaled_dot_attention``'s
    ``head_shard``). ``head_block`` = (n, index) places the local heads
    among all of them where they are themselves a block (a model rank's
    heads under tensor parallelism): the block this rank takes is then
    ``index * D + seq`` of ``n * D``."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and window >= 1")
    D = sp.n_seq
    h, h_kv = q.shape[2], k.shape[2]
    if h % D != 0:
        raise ValueError(f"Ulysses needs n_heads % axis size == 0 "
                         f"({h} % {D})")
    if h_kv % D != 0:  # too few kv heads to split: expand first
        k, v = gqa_expand(k, v, h)
    q, k, v = (col.seq_all_to_all(x, sp, 2, 1) for x in (q, k, v))
    k, v = gqa_expand(k, v, q.shape[2])  # a no-op where expanded already
    mask = None
    if causal:
        s = q.shape[1]
        mask = band_mask(s, s, window, device=q.device)[None, None]
    gen = None
    if dropout_seed is not None and dropout_rate > 0.0:
        gen = seeded_generator(dropout_seed, q.device)
    n, index = head_block
    out = scaled_dot_attention(q, k, v, mask, dropout_rate, gen,
                               (n * D, index * D + sp.seq))
    return col.seq_all_to_all(out, sp, 1, 2)


def ulysses_mha_apply(cfg, attn: nn.ModuleDict, q_in: torch.Tensor,
                      kv_in: torch.Tensor, sp, causal: bool = False,
                      rope=None, tp=None, dropout_seed: Optional[int] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """The sequence-parallel twin of ``models.transformer.mha_apply`` (the
    JAX ``ulysses_mha_apply``, with :func:`.ring_attention.ring_mha_apply`'s
    signature): local projections (``rope`` rotates the rows at their
    global positions, before the scatter), the all-to-all attention core,
    the output projection. Under ``tp`` the projections are this model
    rank's heads, which must divide by the seq-axis size, and each model
    rank exchanges its own heads over its seq group. The dropout mask is
    the unsharded mask's block of this rank's heads (JAX folds the model
    coordinate into the key instead)."""
    from ..models.transformer import _row
    b, s, _ = q_in.shape
    q_in, kv_in = col.tp_attention_inputs(q_in, kv_in, tp)
    q, k, v = qkv_project(cfg, attn, q_in, kv_in, rope)
    block = (tp.n_model, tp.model) if col.tp_active(tp) else (1, 0)
    out = ulysses_attention(q, k, v, sp, causal, cfg.dropout, dropout_seed,
                            window, block)
    return _row(attn["o"], out.reshape(b, s, -1), tp)
