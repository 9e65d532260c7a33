"""The collectives of a world's model, seq and data groups with their
autograd transposes (the counterpart of the JAX package's
``ops/collectives.py``, and of the transposes ``shard_map`` gives
``ppermute``, ``all_to_all``, ``psum`` and ``all_gather``).

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
``tp_all_reduce``, and :func:`tp_all_gather` (the decoders'
vocab-parallel greedy head) inside ``tp_all_gather``; both are counted,
with their host seconds, in ``Mesh.tp_stats``. The vocab-parallel cross
entropy (:func:`vocab_parallel_xent`) never builds the ``[..., V]``
logits: an all-reduce max, then one all-reduce of the sum of exps and
the target's logit together.

The collective-matmul ring (:func:`all_gather_matmul`,
:func:`matmul_reduce_scatter`, :func:`seq_all_gather`) moves chunks
round the model group by ``Mesh.ring_post``: ``T - 1`` hops each, every
hop posted before the chunk matmul it overlaps, on the model group under
its own tag, so no hop can match a pipe hand-off pending beside it. Their
backwards are the conjugate rings (a gather's is a reduce-scatter and the
reverse), written out in each ``Function``'s ``backward``.

Sequence parallelism's (``parallel.seq_parallel``), over the seq group:

- :func:`seq_shift`: one hop of the seq ring forward (``Mesh.seq_shift``,
  to the next seq rank), the hop back backward (the transpose of JAX's
  ``ppermute``: the cotangent goes to the rank the value came from);
- :func:`seq_all_to_all`: the tiled all-to-all that scatters one dim and
  gathers another (Ulysses' head scatter); its backward is the inverse
  exchange, the dims swapped (JAX ``all_to_all``'s transpose);
- :func:`seq_sum`: the sum over the seq group forward, the identity
  backward (the loss's ``psum``: each rank's cotangent reaches its own
  share, and the replicated parameters' gradients are summed later).

Expert parallelism's (``models.moe``, ``parallel.expert_parallel``), over
the expert group: :func:`expert_all_to_all`, MoE's slot exchange (the
all-to-all above on the expert axis, split and concatenated along dim 0,
so its backward is the same exchange), and :func:`expert_sum`. Every rank
of an expert group shares its pipe coordinate and so its row of the tick
table, and builds the same autograd graph: the exchanges of forward and
backward are posted in one order on every rank of the group, on the
group's own communicator (no pipe hand-off or seq exchange can match
them).

FSDP's (``parallel.fsdp``), over the data group: :func:`fsdp_gather`
all-gathers a list of shards, each along its own dim, in one message,
and reduce-scatters their gradients back in one message (JAX
``all_gather``'s transpose, ``psum_scatter``). Its spans are
``fsdp_gather`` and ``fsdp_reduce_scatter``; the seq ring's hops are
``sp_shift``, the seq all-to-alls ``sp_all_to_all`` and the expert ones
``ep_all_to_all``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import DATA_AXIS as DATA
from ..parallel.mesh import EXPERT_AXIS as EXPERT
from ..parallel.mesh import MODEL_AXIS as MODEL
from ..parallel.mesh import SEQ_AXIS as SEQ


def tp_active(mesh) -> bool:
    """Whether ``mesh`` (a ``parallel.mesh.Mesh`` or None) splits the
    blocks over a model axis."""
    return mesh is not None and mesh.n_model > 1


@contextlib.contextmanager
def _model_span(mesh, kind: str):
    """A model-axis collective: its profiler span ``kind``, counted with
    its host seconds in ``mesh.tp_stats``."""
    t = time.perf_counter()
    with torch.profiler.record_function(kind):
        yield
    stat = mesh.tp_stats.setdefault(kind, [0, 0.0])
    stat[0] += 1
    stat[1] += time.perf_counter() - t


def _all_reduce(mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or maxed) over the model group, as a new tensor."""
    out = t.detach().clone()
    with _model_span(mesh, "tp_all_reduce"):
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


def tp_all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of every rank of the model group, stacked in model-coordinate
    order: [T, *x.shape] (the JAX ``all_gather`` over the model axis; no
    gradient: the decoders' greedy head is its one user)."""
    out = x.new_empty((mesh.n_model * x.numel(),))
    with _model_span(mesh, "tp_all_gather"):
        mesh.all_gather(out, x.reshape(-1), MODEL)
    return out.view(mesh.n_model, *x.shape)


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


# ---------------------------------------------------------------------------
# Sequence parallelism: the seq ring, the all-to-all and the loss sum
# ---------------------------------------------------------------------------


def _shift(x: torch.Tensor, mesh, offset: int) -> torch.Tensor:
    with torch.profiler.record_function("sp_shift"):
        return mesh.seq_shift(x.detach().contiguous(), offset)


class _SeqShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, offset):
        ctx.mesh, ctx.offset = mesh, offset
        return _shift(x, mesh, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, -ctx.offset), None, None


def seq_shift(x: torch.Tensor, mesh, offset: int = 1) -> torch.Tensor:
    """``x`` to seq coordinate ``seq + offset``, and what ``seq - offset``
    sent, returned (the JAX ``ppermute`` of ring attention); backward the
    hop back."""
    return _SeqShift.apply(x, mesh, offset)


# an axis's all-to-all span and the mesh's counter of them (None: none)
_A2A = {SEQ: ("sp_all_to_all", None), EXPERT: ("ep_all_to_all", "a2a")}


def _all_to_all(x: torch.Tensor, mesh, split_dim: int, concat_dim: int,
                axis: str) -> torch.Tensor:
    """Block j of ``x`` along ``split_dim`` to rank j of ``axis``; the
    blocks received, in the axis's order, concatenated along
    ``concat_dim``."""
    _, n = mesh._group(axis)
    parts = torch.stack(x.detach().chunk(n, dim=split_dim))
    out = torch.empty_like(parts)
    span, counter = _A2A[axis]
    with torch.profiler.record_function(span):
        mesh.all_to_all(out, parts, axis)
    if counter is not None:
        setattr(mesh, counter, getattr(mesh, counter) + 1)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split_dim, concat_dim, axis):
        ctx.mesh, ctx.dims, ctx.axis = mesh, (split_dim, concat_dim), axis
        return _all_to_all(x, mesh, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, ctx.mesh, concat_dim, split_dim, ctx.axis),
                None, None, None, None)


def seq_all_to_all(x: torch.Tensor, mesh, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over the seq group (the JAX ``all_to_all(...,
    tiled=True)``): ``x``'s ``split_dim`` is cut into ``n_seq`` blocks,
    block j goes to seq rank j, and the blocks this rank receives are
    concatenated along ``concat_dim`` in seq order. Its backward is the
    inverse exchange."""
    return _AllToAll.apply(x, mesh, split_dim, concat_dim, SEQ)


def expert_all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """MoE's slot exchange over the expert group (the JAX ``all_to_all(x,
    'expert', 0, 0)``): ``x`` [n_expert * G, ...] is cut into n_expert
    blocks along dim 0, block j goes to expert rank j, and the blocks
    received are stacked in expert order along dim 0. Its backward is
    the same exchange of the cotangent (the inverse of this one). Each
    call counts one on ``mesh.a2a``; span ``ep_all_to_all``."""
    return _AllToAll.apply(x, mesh, 0, 0, EXPERT)


class _AxisSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        out = x.detach().clone()
        mesh.all_reduce([out], axis)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def seq_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the seq group forward, the identity backward
    (the JAX loss ``psum`` under ``shard_map``)."""
    return _AxisSum.apply(x, mesh, SEQ)


def expert_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the expert group forward, the identity
    backward (the JAX MoE loss's ``psum`` over 'expert')."""
    return _AxisSum.apply(x, mesh, EXPERT)


# ---------------------------------------------------------------------------
# FSDP: the just-in-time gather and its reduce-scatter
# ---------------------------------------------------------------------------


def _blocks(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """[n, numel / n]: ``t``'s n blocks along ``dim``, each flattened."""
    return torch.stack(t.chunk(n, dim=dim)).reshape(n, -1)


def _gather(shards: Sequence[torch.Tensor], dims: Sequence[int],
            mesh) -> List[torch.Tensor]:
    n = mesh.n_data
    flat = torch.cat([s.detach().reshape(-1) for s in shards])
    out = torch.empty((n, flat.numel()), dtype=flat.dtype, device=flat.device)
    with torch.profiler.record_function("fsdp_gather"):
        mesh.all_gather(out.view(-1), flat, DATA)
    fulls, offset = [], 0
    for s, dim in zip(shards, dims):
        k = s.numel()
        parts = out[:, offset:offset + k].reshape((n,) + tuple(s.shape))
        fulls.append(torch.cat(parts.unbind(0), dim=dim))
        offset += k
    return fulls


def _reduce_scatter(grads: Sequence[torch.Tensor], dims: Sequence[int],
                    mesh) -> List[torch.Tensor]:
    n = mesh.n_data
    flat = torch.cat([_blocks(g, dim, n) for g, dim in zip(grads, dims)],
                     dim=1)
    out = torch.empty(flat.shape[1], dtype=flat.dtype, device=flat.device)
    with torch.profiler.record_function("fsdp_reduce_scatter"):
        mesh.reduce_scatter(out, flat.reshape(-1), DATA)
    parts, offset = [], 0
    for g in grads:
        k = g.numel() // n
        parts.append(out[offset:offset + k])
        offset += k
    return parts


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dims, *shards):
        ctx.mesh, ctx.dims = mesh, dims
        ctx.shapes = [s.shape for s in shards]
        ctx.like = shards[0].new_empty(())
        return tuple(_gather(shards, dims, mesh))

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.mesh.n_data
        grads = [ctx.like.new_zeros([d * (n if i == dim else 1)
                                     for i, d in enumerate(shape)])
                 if g is None else g.contiguous()
                 for g, shape, dim in zip(grads, ctx.shapes, ctx.dims)]
        parts = _reduce_scatter(grads, ctx.dims, ctx.mesh)
        return (None, None) + tuple(p.view(shape) for p, shape in
                                    zip(parts, ctx.shapes))


def fsdp_gather(shards: Sequence[torch.Tensor], dims: Sequence[int],
                mesh) -> List[torch.Tensor]:
    """The whole tensors of this data rank's ``shards`` (shard k of each
    is data rank k's block along its ``dims`` entry), all-gathered over
    the data group in one message (the JAX ``all_gather(..., tiled=True)``
    of each leaf). Backward, the gradients of the whole tensors are summed
    over the data group and each rank keeps its blocks, in one
    reduce-scatter (the JAX ``psum_scatter``)."""
    if not shards:
        return []
    return list(_FSDPGather.apply(mesh, tuple(dims), *shards))
