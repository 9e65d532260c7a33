"""Sequence parallelism: the blocks over a world's seq axis (the
counterpart of the JAX package's ``parallel/seq_parallel.py``).

The activations of a stage are split along the sequence over the seq
group (``parallel.mesh.Mesh.n_seq`` ranks, each holding ``[b, S/n_seq,
dim]``). Embeddings, norms and MLPs are position-wise, so they run on the
local chunk; the attention core runs under ``attn_impl``: ``"ring"``
(the K/V ring, :mod:`.ring_attention`) or ``"ulysses"`` (the head
all-to-all, :mod:`.ulysses`). Loss and gradients are the unsharded
model's up to float association. It composes with the data axis, the
pipeline executor (``make_pipeline_grad_fn(mesh=...)`` on a mesh with
``n_seq`` above 1), tensor parallelism (each model rank's heads cross its
own seq group) and FSDP.

Dropout (train mode, ``rng`` a seed): the residual, FFN and embedding
masks are the local chunks of the unsharded masks (drawn at the whole
sequence's shape from the site's generator, the chunk kept), and the
Ulysses probability masks are the unsharded masks' head blocks, so a
sequence-parallel step draws the unsharded step's masks; the ring draws
its own block masks (:func:`.ring_attention.ring_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.transformer import (_linear, _ln, _row, embed_apply,
                                  head_loss, rope_table)
from ..ops import collectives as col
from ..ops.layers import (block_dropout, fold_seed, gelu, relu,
                          select_masked_xent_sum, seeded_generator)
from .ring_attention import ring_mha_apply
from .ulysses import ulysses_mha_apply

ATTN_IMPLS = {"ring": ring_mha_apply, "ulysses": ulysses_mha_apply}


def check_attn_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {sorted(ATTN_IMPLS)}, "
                         f"got {attn_impl!r}")


def local_rope(cfg, seq_local: int, sp, device):
    """The RoPE table's rows of this seq rank's positions (None off
    llama)."""
    table = rope_table(cfg, seq_local * sp.n_seq, device)
    return None if table is None else table.rows(sp.seq * seq_local,
                                                 seq_local)


def sp_layer_apply(cfg, block, h: torch.Tensor, sp, rope=None,
                   attn_impl: str = "ring", rng: Optional[int] = None,
                   tp=None) -> torch.Tensor:
    """The sequence-split twin of a block's forward (the JAX
    ``sp_layer_apply``) on this rank's chunk ``h`` [b, S/n_seq, dim]:
    ``rope`` the chunk's rows (:func:`local_rope`), ``rng`` the layer's
    dropout seed (the block's sites), ``tp`` this rank's Megatron heads
    and columns (the ring of the collective matmuls is not used here, as
    in JAX)."""
    mha = ATTN_IMPLS[attn_impl]
    p = cfg.dropout if rng is not None else 0.0
    seq = (1, sp.n_seq, sp.seq)

    def seed(j):
        return None if p == 0.0 else fold_seed(rng, j)

    def drop(x, j, *shards):
        gen = None if p == 0.0 else seeded_generator(seed(j), x.device)
        return block_dropout(x, p, gen, (seq,) + shards)

    if cfg.arch == "ref_decoder":
        sa = mha(cfg, block.self_attn, h, h, sp, False, None, tp, seed(0))
        x = _ln(block.ln1, h + drop(sa, 1))
        ca = mha(cfg, block.cross_attn, x, h, sp, False, None, tp, seed(2))
        x = _ln(block.ln2, x + drop(ca, 3))
        z = relu(_linear(block.lin1, col.tp_copy(x, tp)))
        if col.tp_active(tp):  # this rank's FFN columns too
            z = drop(z, 4, (z.ndim - 1, tp.n_model, tp.model))
        else:
            z = drop(z, 4)
        return _ln(block.ln3, x + drop(_row(block.lin2, z, tp), 5))
    a = block.attn_norm(h)
    attn = mha(cfg, block.attn, a, a, sp, True, rope, tp, seed(0),
               cfg.sliding_window if cfg.arch == "llama" else None)
    h = h + drop(attn, 1)
    if cfg.arch == "gpt2":
        m = col.tp_copy(_ln(block.ln2, h), tp)
        ff = _row(block.lin2, gelu(_linear(block.lin1, m)), tp)
    else:
        m = col.tp_copy(block._rms(block.rms2, h), tp)
        ff = _row(block.w2, block.act(_linear(block.w1, m))
                  * _linear(block.w3, m), tp)
    return h + drop(ff, 2)


def sp_embed_apply(cfg, model, tokens: torch.Tensor, sp,
                   rng: Optional[int] = None) -> torch.Tensor:
    """The embedding of this rank's chunk of tokens [b, S/n_seq] (the JAX
    ``sp_embed_apply``): GPT-2's learned positions offset by the chunk's
    start, and its embedding dropout (train mode, ``rng`` the forward's
    seed) the chunk of the unsharded mask."""
    s_local = tokens.shape[1]
    h = embed_apply(cfg, model, tokens, offset=sp.seq * s_local)
    if cfg.arch == "gpt2" and rng is not None and cfg.dropout > 0.0:
        gen = seeded_generator(fold_seed(rng, cfg.n_layers), h.device)
        h = block_dropout(h, cfg.dropout, gen, ((1, sp.n_seq, sp.seq),))
    return h


def sp_body_apply(cfg, layers, h: torch.Tensor, sp, attn_impl: str = "ring",
                  rng: Optional[int] = None, layer_offset: int = 0,
                  tp=None) -> torch.Tensor:
    """The sequence-split twin of ``models.transformer.body_apply`` (the
    JAX ``sp_body_apply``): the blocks over this rank's chunk, block i's
    dropout seed folding ``layer_offset + i`` (its global index)."""
    rope = local_rope(cfg, h.shape[1], sp, h.device)
    for i, block in enumerate(layers):
        rng_l = None if rng is None else fold_seed(rng, layer_offset + i)
        h = sp_layer_apply(cfg, block, h, sp, rope, attn_impl, rng_l, tp)
    return h


def make_sp_loss_fn(cfg, mesh, attn_impl: str = "ring"):
    """The sequence-parallel loss (the JAX ``make_sp_loss_fn``) on a world
    of one pipe stage: ``(model, tokens, targets) -> loss`` with this
    rank's chunks [B, S/n_seq] (``utils.data.batch_sharding(mesh)``) and
    the whole model. The loss is the unsharded ``transformer_loss``: the
    local mean summed over the seq group and divided by its size, or,
    with ``cfg.pad_token_id``, the masked NLL summed over the group over
    the valid count summed likewise (not a mean of per-chunk means). It
    is differentiable: ``backward`` leaves this rank's share of each
    gradient in ``.grad``, and their sum over the seq group
    (``mesh.all_reduce(grads, "seq")``) is the whole gradient, as JAX's
    transpose sums the replicated parameters' cotangents. ``attn_impl``:
    "ring" (no cap on the degree) or "ulysses" (the heads must divide by
    the axis size)."""
    check_attn_impl(attn_impl)
    D = mesh.n_seq

    def loss_fn(model, tokens: torch.Tensor, targets: torch.Tensor):
        h = sp_embed_apply(cfg, model, tokens, mesh)
        h = sp_body_apply(cfg, model.layers, h, mesh, attn_impl)
        if cfg.pad_token_id is not None:
            from ..models.transformer import head_apply
            s, n = select_masked_xent_sum(cfg.use_fused_xent)(
                head_apply(cfg, model, h), targets, cfg.pad_token_id)
            s = col.seq_sum(s, mesh)
            n = col.seq_sum(n.float(), mesh)
            return s / n.clamp_min(1.0)
        return col.seq_sum(head_loss(cfg, model, h, targets), mesh) / D

    return loss_fn


def sp_mesh_check(cfg, mesh, attn_impl: str, tp=None) -> None:
    """The executor's refusals for ``sp_attn_impl`` (the JAX
    ``make_pipeline_grad_fn``'s message) and, on a seq axis under
    Ulysses, a (local) head count that does not divide by the axis size
    (the JAX ``ulysses_attention``'s rule, raised at build time)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"sp_attn_impl must be 'ring' or 'ulysses', "
                         f"got {attn_impl!r}")
    if mesh is None or mesh.n_seq == 1 or attn_impl != "ulysses":
        return
    h = cfg.n_heads // (tp.n_model if col.tp_active(tp) else 1)
    if h % mesh.n_seq:
        raise ValueError(f"Ulysses needs n_heads % axis size == 0 "
                         f"({h} % {mesh.n_seq})")

