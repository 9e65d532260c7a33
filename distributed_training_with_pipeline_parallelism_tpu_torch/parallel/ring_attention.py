"""Ring attention: exact attention with the sequence split over a world's
seq axis (the counterpart of the JAX package's
``parallel/ring_attention.py``).

Each seq rank holds one chunk of the sequence. The K/V chunks travel the
seq ring (``ops.collectives.seq_shift``, one hop a step, K and V in one
message) while every rank folds each arriving chunk into its queries'
attention with the online-softmax recurrence of flash attention (Liu et
al., arXiv:2310.01889). Memory is O(seq / n_seq) a rank. Gradients come
from autograd through the loop: the hop's backward is the hop back, so
the backward is itself a ring pass, as JAX's ``ppermute`` transpose makes
it. The block maths is plain torch in f32, as the JAX is plain jnp; no
attention kernel is called.

Every step runs, masked blocks included (the JAX ring's static
schedule), so every rank of a seq group posts the same hops in the same
order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops import collectives as col
from ..ops.attention import (NEG_INF, apply_rope, attention_scale,
                             gqa_expand, rope_frequencies)
from ..ops.layers import fold_seed, seeded_generator


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sp,
                   causal: bool = False, dropout_rate: float = 0.0,
                   dropout_seed: Optional[int] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """Exact attention of this rank's query chunk over the whole sequence
    (the JAX ``ring_attention``). ``sp`` is the rank's
    ``parallel.mesh.Mesh``; q, k, v are its chunks [batch, seq_local,
    heads, head_dim] (K/V heads expanded to Q's before the call for GQA).
    Returns the chunk's output [batch, seq_local, heads, head_dim] in q's
    dtype, the unsharded attention's rows up to float association.

    ``dropout_seed`` (train mode) drops attention probabilities after the
    softmax (torch's semantics): the denominator accumulates the raw
    probabilities and only the value product takes the mask, scaled by
    1/(1 - rate). The mask of the block of query chunk ``qc`` and key
    chunk ``kc`` is drawn from ``fold_seed(fold_seed(dropout_seed, qc),
    kc)`` at the block's shape, so it does not depend on which ring step
    handles the pair (the JAX keying; an oracle rebuilds the whole mask
    block by block).

    ``window`` (causal only) keeps keys in ``[i - window + 1, i]`` for
    query position i, by the same global-coordinate block mask as the
    causal one."""
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal attention and window >= 1")
    D, my = sp.n_seq, sp.seq
    b, s_q, h, dh = q.shape
    s_kv = k.shape[1]
    scale = attention_scale(dh, torch.float32)
    use_dropout = dropout_seed is not None and dropout_rate > 0.0
    dev = q.device
    qf = q.float()
    m = torch.full((b, h, s_q), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s_q), dtype=torch.float32, device=dev)
    o = torch.zeros((b, h, s_q, dh), dtype=torch.float32, device=dev)
    iq = torch.arange(s_q, device=dev)[:, None] + my * s_q
    kv = torch.stack([k, v])  # one message a hop
    for step in range(D):
        src = (my - step) % D  # the chunk in hand came ``step`` hops
        k_cur, v_cur = kv.unbind(0)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * scale
        if causal:
            ik = torch.arange(s_kv, device=dev)[None, :] + src * s_kv
            keep = iq >= ik
            if window is not None:
                keep = keep & (iq - ik < window)
            s = torch.where(keep[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a fully masked row: exp(NEG_INF - NEG_INF) would be 1
        p = torch.exp(s - m_new[..., None])
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1)
        if use_dropout:
            g = seeded_generator(fold_seed(fold_seed(dropout_seed, my), src),
                                 dev)
            drop = torch.rand(s.shape, generator=g, device=dev) >= \
                dropout_rate
            p = torch.where(drop, p, 0.0) / (1.0 - dropout_rate)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v_cur.float())
        m = m_new
        if step + 1 < D:
            kv = col.seq_shift(kv, sp, +1)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def qkv_project(cfg, attn: nn.ModuleDict, q_in: torch.Tensor,
                kv_in: torch.Tensor, rope=None):
    """q [b, s, heads, head_dim] from ``q_in`` and k, v [b, t, kv_heads,
    head_dim] from ``kv_in`` through ``attn``'s projections (with their
    biases), q and k rotated by ``rope`` where given (the JAX
    ``qkv_project`` without the GQA expansion)."""
    from ..models.transformer import _linear
    b, s, _ = q_in.shape
    t, hd = kv_in.shape[1], cfg.head_dim
    q = _linear(attn["q"], q_in).view(b, s, -1, hd)
    k = _linear(attn["k"], kv_in).view(b, t, -1, hd)
    v = _linear(attn["v"], kv_in).view(b, t, -1, hd)
    if rope is not None:
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    return q, k, v


def ring_mha_apply(cfg, attn: nn.ModuleDict, q_in: torch.Tensor,
                   kv_in: torch.Tensor, sp, causal: bool = False, rope=None,
                   tp=None, dropout_seed: Optional[int] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """The sequence-parallel twin of ``models.transformer.mha_apply`` (the
    JAX ``ring_mha_apply``): the projections are position-wise, so local;
    attention runs over the ring. ``rope``: this chunk's rows
    (:func:`local_rope_angles`). Under ``tp`` the projections are this
    model rank's heads, the ring carries its K/V heads over the seq
    group, the output projection is row-parallel, and the dropout seed
    folds the model coordinate (each model rank holds other heads, as in
    JAX)."""
    from ..models.transformer import _row
    b, s, _ = q_in.shape
    q_in, kv_in = col.tp_attention_inputs(q_in, kv_in, tp)
    q, k, v = qkv_project(cfg, attn, q_in, kv_in, rope)
    k, v = gqa_expand(k, v, q.shape[2])
    if dropout_seed is not None and col.tp_active(tp):
        dropout_seed = fold_seed(dropout_seed, tp.model)
    out = ring_attention(q, k, v, sp, causal, cfg.dropout, dropout_seed,
                         window)
    return _row(attn["o"], out.reshape(b, s, -1), tp)


def local_rope_angles(cfg, seq_local: int, sp, device=None) -> torch.Tensor:
    """RoPE angles [seq_local, head_dim // 2] of this seq rank's global
    positions ``seq * seq_local ..`` (the JAX ``local_rope_angles``)."""
    full = rope_frequencies(cfg.head_dim, seq_local * sp.n_seq,
                            cfg.rope_theta, cfg.rope_scaling, device)
    return full[sp.seq * seq_local:(sp.seq + 1) * seq_local]
