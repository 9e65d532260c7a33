"""Megatron tensor parallelism's collectives over a world's model group
(the counterpart of the JAX package's ``ops/collectives.py``).

A rank's ``mesh`` (``parallel.mesh.Mesh`` with ``n_model`` above 1) holds
one shard of each Megatron-split leaf; the ranks of one (data, pipe)
coordinate form its model group. Where JAX writes ``custom_vjp``s over
``psum`` inside ``shard_map``, the port writes ``torch.autograd.Function``s
over ``Mesh.all_reduce`` on that group:

- :func:`tp_copy`: identity forward, all-reduce backward. It marks a
  replicated activation entering column-parallel weights: each shard
  contributes a partial input cotangent, and they are summed.
- :func:`tp_reduce`: all-reduce forward, identity backward. It completes
  a row-parallel matmul: the partial outputs are summed, and the output
  cotangent, already replicated, flows to every shard unchanged.

Every model-axis all-reduce runs inside a ``torch.profiler`` span
``tp_all_reduce``. The vocab-parallel cross entropy (:func:`vocab_parallel_xent`)
never builds the ``[..., V]`` logits: an all-reduce max, then one
all-reduce of the sum of exps and the target's logit together.

The collective-matmul ring (:func:`all_gather_matmul`,
:func:`matmul_reduce_scatter`, :func:`seq_all_gather`) moves chunks
round the model group by ``Mesh.ring_post``: ``T - 1`` hops each, every
hop posted before the chunk matmul it overlaps, on the model group under
its own tag, so no hop can match a pipe hand-off pending beside it. Their
backwards are the conjugate rings (a gather's is a reduce-scatter and the
reverse), written out in each ``Function``'s ``backward``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import MODEL_AXIS as MODEL


def tp_active(mesh) -> bool:
    """Whether ``mesh`` (a ``parallel.mesh.Mesh`` or None) splits the
    blocks over a model axis."""
    return mesh is not None and mesh.n_model > 1


def _all_reduce(mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or maxed) over the model group, as a new tensor."""
    out = t.detach().clone()
    with torch.profiler.record_function("tp_all_reduce"):
        mesh.all_reduce([out], MODEL, op=op)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity forward, all-reduce of the cotangent over the model group
    backward (the JAX ``tp_copy``); the identity without a model axis."""
    return _Copy.apply(x, mesh) if tp_active(mesh) else x


def tp_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-reduce over the model group forward, identity backward (the JAX
    ``tp_reduce``); the identity without a model axis."""
    return _Reduce.apply(x, mesh) if tp_active(mesh) else x


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], mesh) -> torch.Tensor:
    """A row-parallel linear (the JAX ``row_parallel_linear``): this
    shard's ``x @ weight.T`` partial (``weight`` [out, in / T]), summed
    over the model group, then the replicated bias added once."""
    y = tp_reduce(F.linear(x, weight), mesh)
    return y if bias is None else y + bias


def tp_attention_inputs(q_in: torch.Tensor, kv_in: torch.Tensor, mesh):
    """Mark the replicated inputs of the column-parallel q/k/v projections
    (the JAX ``tp_attention_inputs``): self-attention (one tensor) takes
    one copy, so its cotangent is reduced once."""
    if not tp_active(mesh):
        return q_in, kv_in
    if kv_in is q_in:
        q_in = kv_in = tp_copy(q_in, mesh)
    else:
        q_in, kv_in = tp_copy(q_in, mesh), tp_copy(kv_in, mesh)
    return q_in, kv_in


def _vocab_parallel_nll(logits_local: torch.Tensor, targets: torch.Tensor,
                        mesh) -> torch.Tensor:
    """Per-position NLL over vocab-sharded logits (the JAX
    ``_vocab_parallel_nll``): model rank ``my`` holds the vocab slice
    ``[my * Vl, (my + 1) * Vl)``. The max is a no-grad all-reduce max;
    the sum of exps and the target's logit (from the shard that owns it,
    0 elsewhere) are summed over the group in one all-reduce."""
    v_local = logits_local.shape[-1]
    x = logits_local.float()
    with torch.no_grad():
        m = _all_reduce(mesh, x.max(dim=-1).values, op="max")
    local_t = targets.long() - mesh.model * v_local
    hit = (local_t >= 0) & (local_t < v_local)
    tl_part = torch.gather(x, -1, local_t.clamp(0, v_local - 1)[..., None])
    parts = torch.stack([torch.exp(x - m[..., None]).sum(dim=-1),
                         torch.where(hit, tl_part[..., 0], 0.0)])
    sum_exp, tl = tp_reduce(parts, mesh).unbind(0)
    return torch.log(sum_exp) + m - tl


def vocab_parallel_xent(logits_local: torch.Tensor, targets: torch.Tensor,
                        mesh) -> torch.Tensor:
    """Mean token-wise cross entropy of vocab-sharded logits."""
    return _vocab_parallel_nll(logits_local, targets, mesh).mean()


def vocab_parallel_masked_xent_sum(logits_local: torch.Tensor,
                                   targets: torch.Tensor, mesh, pad_id: int):
    """The ignore-index twin: NLL sum over non-pad positions and the valid
    count (``ops.layers.masked_xent_sum``'s contract)."""
    nll = _vocab_parallel_nll(logits_local, targets, mesh)
    valid = targets != pad_id
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


# ---------------------------------------------------------------------------
# The collective-matmul ring
# ---------------------------------------------------------------------------


def _ring_gather(x_loc: torch.Tensor, fn: Callable, mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cat_k fn(chunk_k), cat_k chunk_k)`` over the model group's
    sequence chunks (chunk k is rank k's ``x_loc``, dim 1): after k hops
    of the -1 ring this rank holds chunk ``(my + k) % T``; each hop is
    posted before the matmul of the chunk in hand."""
    T, my = mesh.n_model, mesh.model
    outs, chunks = [None] * T, [None] * T
    chunk = x_loc
    for k in range(T):
        nxt = mesh.ring_post(chunk, -1) if k + 1 < T else None
        idx = (my + k) % T
        outs[idx], chunks[idx] = fn(chunk), chunk
        if nxt is not None:
            chunk = mesh.ring_wait(nxt)
    return torch.cat(outs, dim=1), torch.cat(chunks, dim=1)


def _ring_reduce_scatter(z: torch.Tensor, fn: Callable, mesh
                         ) -> torch.Tensor:
    """This rank's chunk of the model group's sum of ``fn(z)`` over
    sequence chunks (dim 1): the accumulator travels the +1 ring; at step
    k the rank adds its product for the chunk ``T - 1 - k`` hops
    downstream, the hop of the accumulator posted before that matmul (the
    fixed ring order of the JAX ``matmul_reduce_scatter``)."""
    T, my = mesh.n_model, mesh.model
    C = z.shape[1] // T
    acc = None
    for k in range(T):
        idx = ((my - k - 1) % T) * C
        hop = mesh.ring_post(acc, +1) if acc is not None else None
        blk = fn(z[:, idx:idx + C])
        acc = blk if hop is None else mesh.ring_wait(hop) + blk
    return acc


def _mm(w: torch.Tensor) -> Callable:
    return lambda c: torch.matmul(c, w)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_loc, weight, mesh):
        out, x_full = _ring_gather(x_loc, lambda c: F.linear(c, weight),
                                   mesh)
        ctx.save_for_backward(x_full, weight)
        ctx.mesh = mesh
        return out

    @staticmethod
    def backward(ctx, g):
        x_full, weight = ctx.saved_tensors
        g = g.contiguous()
        gx = _ring_reduce_scatter(g, _mm(weight), ctx.mesh)
        gw = g.reshape(-1, g.shape[-1]).t() @ x_full.reshape(
            -1, x_full.shape[-1])
        return gx, gw, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, weight, mesh):
        ctx.save_for_backward(z, weight)
        ctx.mesh = mesh
        return _ring_reduce_scatter(z, lambda c: F.linear(c, weight), mesh)

    @staticmethod
    def backward(ctx, g):
        z, weight = ctx.saved_tensors
        gz, g_full = _ring_gather(g.contiguous(), _mm(weight), ctx.mesh)
        gw = g_full.reshape(-1, g_full.shape[-1]).t() @ z.reshape(
            -1, z.shape[-1])
        return gz, gw, None


class _SeqAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_loc, mesh):
        ctx.mesh, ctx.c = mesh, x_loc.shape[1]
        return _ring_gather(x_loc, lambda c: c, mesh)[1]

    @staticmethod
    def backward(ctx, g):
        my, c = ctx.mesh.model, ctx.c
        return g[:, my * c:(my + 1) * c], None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        c = x.shape[1] // mesh.n_model
        return x[:, mesh.model * c:(mesh.model + 1) * c]

    @staticmethod
    def backward(ctx, g):
        return _ring_gather(g.contiguous(), lambda c: c, ctx.mesh)[1], None


def all_gather_matmul(x_loc: torch.Tensor, weight: torch.Tensor, mesh
                      ) -> torch.Tensor:
    """``all_gather(x, seq) @ weight.T`` with the gather overlapped into
    the matmul (the JAX ``all_gather_matmul``): ``x_loc`` [B, C, d] is
    this rank's sequence chunk, ``weight`` [F_loc, d] the column-parallel
    shard; returns [B, T*C, F_loc]. Each chunk's rows are the unfused
    product's rows."""
    return _AllGatherMatmul.apply(x_loc, weight, mesh)


def matmul_reduce_scatter(z: torch.Tensor, weight: torch.Tensor, mesh
                          ) -> torch.Tensor:
    """``reduce_scatter(z @ weight.T, seq)`` with the scatter overlapped
    into the matmul (the JAX ``matmul_reduce_scatter``): ``z`` [B, T*C,
    F_loc], ``weight`` [d, F_loc] the row-parallel shard; returns this
    rank's chunk [B, C, d] of the group's sum, in the ring's order
    (numerically, not bitwise, the unfused sum)."""
    return _MatmulReduceScatter.apply(z, weight, mesh)


def seq_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """Replicated [B, S, d] -> this rank's chunk [B, S/T, d]: a slice
    forward, the chunk gather backward (the JAX ``seq_scatter``)."""
    return _SeqScatter.apply(x, mesh)


def seq_all_gather(x_loc: torch.Tensor, mesh) -> torch.Tensor:
    """Chunks [B, S/T, d] -> the replicated [B, S, d] over the ring; the
    conjugate slice backward (the JAX ``seq_all_gather``)."""
    return _SeqAllGather.apply(x_loc, mesh)


def ring_matmul_hops(axis_size: int, n_collective_matmuls: int) -> int:
    """Hops the ring forms post: ``axis_size - 1`` for each
    :func:`all_gather_matmul`, :func:`matmul_reduce_scatter` and
    :func:`seq_all_gather` (and for each of their backwards)."""
    return (int(axis_size) - 1) * int(n_collective_matmuls)


# ---------------------------------------------------------------------------
# The unfused forms (tp_overlap="none"): one collective, then the matmul
# ---------------------------------------------------------------------------


def _gather_seq(x_loc: torch.Tensor, mesh) -> torch.Tensor:
    T = mesh.n_model
    out = torch.empty((T,) + tuple(x_loc.shape), dtype=x_loc.dtype,
                      device=x_loc.device)
    with torch.profiler.record_function("tp_all_gather"):
        mesh.all_gather(out.view(-1), x_loc.detach().contiguous().view(-1),
                        MODEL)
    return torch.cat(out.unbind(0), dim=1)


def _scatter_seq(y: torch.Tensor, mesh) -> torch.Tensor:
    T = mesh.n_model
    b, s = y.shape[:2]
    c = s // T
    flat = y.detach().reshape(b, T, c, *y.shape[2:]).transpose(0, 1)
    out = torch.empty((b, c) + tuple(y.shape[2:]), dtype=y.dtype,
                      device=y.device)
    with torch.profiler.record_function("tp_reduce_scatter"):
        mesh.reduce_scatter(out.view(-1), flat.contiguous().view(-1), MODEL)
    return out


class _AllGatherSeqFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_loc, mesh):
        ctx.mesh = mesh
        return _gather_seq(x_loc, mesh)

    @staticmethod
    def backward(ctx, g):
        return _scatter_seq(g, ctx.mesh), None


class _ReduceScatterSeqFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        return _scatter_seq(y, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.mesh), None


def all_gather_seq(x_loc: torch.Tensor, mesh) -> torch.Tensor:
    """One all-gather of sequence chunks (dim 1) over the model group;
    reduce-scatter backward."""
    return _AllGatherSeqFn.apply(x_loc, mesh)


def reduce_scatter_seq(y: torch.Tensor, mesh) -> torch.Tensor:
    """One reduce-scatter over the model group along the sequence (dim
    1); all-gather backward."""
    return _ReduceScatterSeqFn.apply(y, mesh)
