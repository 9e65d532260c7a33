"""The pipeline executor: the stage split, the training tick executor and
the forward-only eval executor (counterparts of the JAX package's
``parallel/pipeline.py``: ``stack_stage_layers`` ``:199``,
``_stage_index_map`` ``:190``, ``make_pipeline_grad_fn`` ``:589``,
``_fwd_tick_table`` ``:1962`` and ``make_pipeline_loss_fn`` ``:2328``; its
last-stage loss ``_stage_ce`` ``:251`` is ``models.transformer.head_loss``).
The JAX ``unstack_stage_layers`` (``:220``) has no counterpart: the port's
stages are views of the model's own blocks, not stacked copies, so the
gradients land in the model's ``.grad`` directly.

The executor runs the compiled ``[T, D, 17]`` tick table (the JAX
``tick``, ``:1244-1460``). Each tick, each device banks its arrivals on
the four channels (+1 forward, column 0; -1 backward, 4; -1 forward, 14;
+1 backward, 16), runs its forward unit (columns 1-3) and its local
forward hop (13), its backward unit (5-8) and local backward hop (15),
then its weight-gradient unit (9-12); each hand-over leaves at the end of
the tick by the route of the stage that sent it. A *transport* carries
the hand-overs:

- :class:`LockstepTransport` (the default): all D devices in this
  process, in lockstep, each hand-over in its receiver's mailbox;
- :class:`DistTransport` (``mesh=`` a :class:`.mesh.Mesh`): this process
  runs only its own device's row of the table and the hand-overs are
  ``torch.distributed`` sends and receives between pipe ranks, posted
  together at the end of each tick.

``comm_overlap`` chooses where an arrival is banked (the JAX
``pipeline.py:713-727``): ``"none"`` at the top of the tick, ``"ring"``
just before the unit that ``schedules.overlap_bank_stages`` names, so
under the distributed transport the hop overlaps the tick's earlier
units. Both give the same bits.

With a model axis (``mesh.n_model`` above 1) each rank holds its model
coordinate's Megatron shard of its stages
(``parallel.tensor_parallel.shard_model``) and runs its row of the table
on it: the blocks complete over the model group mid-unit
(``ops.collectives``), and the hand-offs go to the rank of the same model
coordinate in the next pipe stage. ``tp_vocab_parallel`` splits the last
stage's cross entropy over the vocab (the JAX ``_stage_ce_impl``).

With ``fsdp=True`` (pp x fsdp, ZeRO-3 inside the pipeline) each rank's
blocks hold their data coordinate's shards (``parallel.fsdp``), each unit
gathers its chunk's layers over the data group just in time and its
backward reduce-scatters their gradients, so they rest at 1/n_data. With
a seq axis (``mesh.n_seq`` above 1) each rank holds its chunk of every
sequence and the stages run ``parallel.seq_parallel``'s blocks; the
hand-offs carry the chunks.

With ``moe=`` (a ``models.moe.MoEConfig``) the stages are MoE blocks
(``models.moe.MoELM``): each unit's stage returns its output and its
layers' summed routing aux loss, which enters the stage's objective. With
an expert axis (``mesh.n_expert`` above 1) each rank holds its expert
coordinate's block of the experts, the MoE FFNs exchange their slots over
the expert group, and the expert axis doubles as a batch axis (the batch
splits over data x expert). MoE blocks compose with the model axis (each
expert's ffn Megatron-split), with FSDP (their matrices gathered per unit
on the dims ``parallel.fsdp.moe_fsdp_shard_dims`` gives) and with a seq
axis (attention by the ring or Ulysses, routing the chunk's tokens).
:func:`make_pipeline_forward` is pipelined batch inference over the eval
executor's table: the merged logits.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..analysis import maybe_verify_forward_table, maybe_verify_schedule
from ..models.transformer import (Transformer, body_apply, embed_apply,
                                  head_apply, head_loss)
from ..ops.layers import fold_seed, global_pad_scale
from ..utils.config import (ModelConfig, ScheduleConfig, resolve_device,
                            torch_dtype)
from .mesh import DATA_AXIS, EXPERT_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh
from .schedules import (BANK_BEFORE_B, BANK_BEFORE_F, BANK_BEFORE_W,
                        BANK_END, CHANNELS, COL_BWD_ASLOT, COL_BWD_GSLOT,
                        COL_BWD_LOCAL_SLOT, COL_BWD_M, COL_BWD_V,
                        COL_FWD_LOCAL_SLOT, COL_FWD_M, COL_FWD_SLOT,
                        COL_FWD_V, COL_W_ASLOT, COL_W_GSLOT, COL_W_M,
                        COL_W_V, F, Action, _allocate_slots, bfs_order,
                        bwd_route, compile_schedule, fwd_route,
                        overlap_bank_stages, placement_stage_of,
                        schedule_placement, schedule_ticks)

# mesh axes of the JAX executor: each runs as an axis of a
# torch.distributed world (``mesh=``)
_AXIS_ITEMS = {
    "data": "a 'data' axis runs over a torch.distributed world (ROADMAP.md "
            "Queue 1, item 8): pass mesh=make_mesh(n_pipe, n_data) on each "
            "rank of a parallel.mesh.launch world",
    "model": "a 'model' axis (tensor parallelism) has no form in one "
             "process; it runs over a torch.distributed world: pass "
             "mesh=make_mesh(n_pipe, n_data, n_model) on each rank of a "
             "parallel.mesh.launch world, with the rank's "
             "parallel.tensor_parallel.shard_model",
    "seq": "a 'seq' axis (sequence parallelism) runs over a "
           "torch.distributed world: pass mesh=make_mesh(n_pipe, n_data, "
           "n_model, n_seq) on each rank of a parallel.mesh.launch world, "
           "with the rank's chunk of each batch (utils.data."
           "batch_sharding)",
    "expert": "an 'expert' axis (expert parallelism) runs over a "
              "torch.distributed world: pass mesh=make_mesh(n_pipe, n_data, "
              "n_expert=E) and moe= on each rank of a parallel.mesh.launch "
              "world, with the rank's expert shard (from_jax_params(..., "
              "expert=(E, mesh.expert)))",
}
COMM_OVERLAP = ("none", "ring", "auto")


def _stage_index_map(n_devices: int, n_virtual: int,
                     placement: str = "wrap") -> np.ndarray:
    """[D, V] array: the global stage held by (device, chunk); wrap:
    ``v * D + d``; vshape (ZBV): ``d`` for chunk 0, ``2D - 1 - d`` for
    chunk 1."""
    return np.array([[placement_stage_of(placement, d, v, n_devices)
                      for v in range(n_virtual)] for d in range(n_devices)])


def stack_stage_layers(layers: nn.ModuleList, n_devices: int,
                       n_virtual: int = 1, placement: str = "wrap"
                       ) -> List[List[nn.ModuleList]]:
    """Split ``layers`` over S = D * V stages: ``[D][V]`` slices, where
    device d's chunk v holds stage ``s = placement_stage_of(d, v)``, i.e.
    layers ``s * L/S .. (s+1) * L/S - 1`` (the blocks are shared, not
    copied)."""
    n = len(layers)
    S = n_devices * n_virtual
    if n % S != 0:
        raise ValueError(f"n_layers={n} must divide evenly into {S} stages")
    lps = n // S
    idx = _stage_index_map(n_devices, n_virtual, placement)
    return [[nn.ModuleList(layers[s * lps:(s + 1) * lps]) for s in row]
            for row in idx.tolist()]


def _check_axes(axes: Optional[Dict[str, int]]) -> None:
    """Raise for any mesh axis other than the pipe of size > 1, naming the
    ``ROADMAP.md`` item that ports it."""
    for name, size in (axes or {}).items():
        if name not in _AXIS_ITEMS:
            raise ValueError(f"unknown mesh axis {name!r}; expected one of "
                             f"{sorted(_AXIS_ITEMS)}")
        if size > 1:
            raise NotImplementedError(
                f"a {name!r} axis of size {size} in axes= is not run by "
                f"this executor: {_AXIS_ITEMS[name]}")


def owned_layers(n_layers: int, sched: ScheduleConfig, n_pipe: int,
                 pipe: int) -> List[int]:
    """The global layer indices pipe coordinate ``pipe`` holds under
    ``sched``'s placement: its V chunks' stages, ``n_layers / (n_pipe *
    V)`` layers each (a rank's view, ``init_params(..., layers=)``)."""
    V = sched.n_virtual
    S = n_pipe * V
    if n_layers % S != 0:
        raise ValueError(f"n_layers={n_layers} must divide evenly into "
                         f"{S} stages")
    lps = n_layers // S
    placement = schedule_placement(sched.name)
    return sorted(i for v in range(V)
                  for s in (placement_stage_of(placement, pipe, v, n_pipe),)
                  for i in range(s * lps, (s + 1) * lps))


class LockstepTransport:
    """Every device in this process, in lockstep: a hand-over waits in its
    receiver's mailbox until the next tick (the single-process transport
    of ``ROADMAP.md``)."""

    def __init__(self, n_devices: int, channels=CHANNELS):
        self.devices = range(n_devices)
        self.channels = channels

    def begin(self, shape, dtype) -> None:
        D = len(self.devices)
        self._inbox = [[None] * D for _ in self.channels]
        self._outbox = [[None] * D for _ in self.channels]

    def send(self, t: int, d: int, ci: int, x: torch.Tensor) -> None:
        off = self.channels[ci][1]
        self._outbox[ci][(d + off) % len(self.devices)] = x

    def arrival(self, t: int, d: int, ci: int) -> torch.Tensor:
        return self._inbox[ci][d]

    def end_tick(self, t: int) -> None:
        D = len(self.devices)
        self._inbox = self._outbox
        self._outbox = [[None] * D for _ in self.channels]

    def finish(self) -> None:
        pass


def _check_hops(table: np.ndarray, channels, sends) -> None:
    """Every hand-over the table sends at tick t is banked by its receiver
    at t + 1, and every bank has its sender (``sends``: (t, d, ci)
    triples): the pairing the distributed transport posts blind."""
    T, D = table.shape[:2]
    banks = {(t - 1, (d - channels[ci][1]) % D, ci)
             for t in range(1, T) for d in range(D)
             for ci, (_, _, col) in enumerate(channels)
             if table[t, d, col] >= 0}
    if any(table[0, d, col] >= 0 for d in range(D) for _, _, col in channels):
        raise RuntimeError("the tick table banks an arrival at tick 0")
    if set(sends) != banks:
        raise RuntimeError(
            f"the tick table's hand-overs do not pair: sent without a bank "
            f"{sorted(set(sends) - banks)[:4]}, banked without a send "
            f"{sorted(banks - set(sends))[:4]}")


class DistTransport:
    """This rank's row of the table over ``torch.distributed``: at the end
    of tick t the rank posts its sends to pipe peers ``(d + offset) % D``
    and its receives for tick t + 1 (where its row's bank column is set,
    from ``(d - offset) % D``) in one ``batch_isend_irecv``, sends sorted
    by channel, so every rank posts them in one order; the channel is the
    message tag. :meth:`arrival` waits for one receive. A tick's sends are
    waited for at the end of the next tick, which frees their buffers.
    The waits and the posts are ``torch.profiler`` spans
    (``handoff_wait``, ``handoff_post``); with a ``telemetry`` recorder
    (``utils.telemetry.PipelineTelemetry``) the host seconds of each wait
    are also added to its ``wait_s``."""

    def __init__(self, mesh: Mesh, table: np.ndarray, channels=CHANNELS,
                 telemetry=None):
        # autograd imports this module (and sympy, seconds on a busy host)
        # at the first backward that is handed its output's gradient: in a
        # world that is each rank's first backward unit, which waits for
        # the next rank's, so the imports would run one rank after another
        # down the pipe. Here every rank pays it at once.
        import torch.fx.experimental.symbolic_shapes  # noqa: F401
        self.mesh = mesh
        self.devices = [mesh.pipe]
        self.channels = channels
        self.telemetry = telemetry
        d = mesh.pipe
        self._recv_plan = [[ci for ci, (_, _, col) in enumerate(channels)
                            if table[t, d, col] >= 0]
                           for t in range(table.shape[0])]

    def begin(self, shape, dtype) -> None:
        self._meta = (tuple(shape), dtype)
        self._pending: Dict = {}
        self._sends: List = []
        self._inflight: List = []

    def send(self, t: int, d: int, ci: int, x: torch.Tensor) -> None:
        self._sends.append((ci, x))

    def arrival(self, t: int, d: int, ci: int) -> torch.Tensor:
        work, buf = self._pending.pop((t, ci))
        with torch.profiler.record_function("handoff_wait"):
            if self.telemetry is None:
                return self.mesh.landed(work, buf)
            t0 = time.perf_counter()
            x = self.mesh.landed(work, buf)
            self.telemetry.add_wait(time.perf_counter() - t0)
            return x

    def end_tick(self, t: int) -> None:
        with torch.profiler.record_function("handoff_post"):
            self._post(t)

    def _post(self, t: int) -> None:
        D, d = self.mesh.n_pipe, self.mesh.pipe
        shape, dtype = self._meta
        sends = [(x, (d + self.channels[ci][1]) % D, ci)
                 for ci, x in sorted(self._sends, key=lambda e: e[0])]
        plan = self._recv_plan[t + 1] if t + 1 < len(self._recv_plan) \
            else []
        recvs = [(shape, dtype, (d - self.channels[ci][1]) % D, ci)
                 for ci in plan]
        send_works, received = self.mesh.exchange(sends, recvs)
        for work, _ in self._inflight:
            work.wait()
        self._inflight = send_works
        self._sends = []
        for ci, wb in zip(plan, received):
            self._pending[(t + 1, ci)] = wb

    def finish(self) -> None:
        for work, _ in self._inflight:
            work.wait()
        self._inflight = []
        if self._pending:
            raise RuntimeError(f"arrivals never banked: "
                               f"{sorted(self._pending)}")


def _tp_of(cfg: ModelConfig, mesh: Optional[Mesh],
           tp_vocab_parallel: bool) -> Optional[Mesh]:
    """The mesh whose model group splits the blocks, or None; checks the
    Megatron shape contract (``tensor_parallel.check_tp``)."""
    from .tensor_parallel import check_tp
    T = 1 if mesh is None else mesh.n_model
    check_tp(cfg, T, tp_vocab_parallel)
    return mesh if T > 1 else None


def _check_shard(model: nn.Module, tp: Optional[Mesh],
                 tp_vocab_parallel: bool) -> None:
    from .tensor_parallel import model_shard_of
    if tp is None:
        return
    shard = model_shard_of(model)
    want = (tp.n_model, tp.model, tp_vocab_parallel)
    if shard is None or (shard.n, shard.index, shard.vocab_parallel) != want:
        raise ValueError(
            f"under a model axis the model must be this rank's shard: "
            f"parallel.tensor_parallel.shard_model(model, cfg, mesh, "
            f"vocab_parallel={tp_vocab_parallel}) (holds {shard})")


def _check_fsdp(model: nn.Module, fsdp: bool, mesh: Optional[Mesh]) -> None:
    from .fsdp import fsdp_shard_of
    shard = fsdp_shard_of(model)
    if not fsdp:
        if shard is not None:
            raise ValueError("the model holds FSDP shards: pass fsdp=True")
        return
    if shard is None or (shard.n, shard.index) != (mesh.n_data, mesh.data):
        raise ValueError(
            f"under fsdp=True the model must be this rank's shard: "
            f"parallel.fsdp.fsdp_shard_params(model, cfg, mesh) (holds "
            f"{shard and (shard.n, shard.index)})")


def _check_fsdp_args(fsdp: bool, mesh: Optional[Mesh],
                     remat_backward) -> None:
    """The JAX ``make_pipeline_grad_fn``'s fsdp refusals."""
    if fsdp and (mesh is None or mesh.n_data <= 1):
        raise ValueError("fsdp=True needs a 'data' mesh axis to shard "
                         "parameters over")
    if fsdp and remat_backward is False:
        raise ValueError(
            "remat_backward=False is incompatible with fsdp=True: the "
            "stage body's residuals would pin each tick's just-in-time "
            "all-gathered full weights per in-flight microbatch, "
            "voiding the ZeRO-3 residency bound")


def _layers_runner(cfg: ModelConfig, mesh: Optional[Mesh], tp, fsdp: bool,
                   sp_attn_impl: str, moe=None):
    """``run(layers, dims, x, rng, offset) -> (y, aux)``: the blocks
    ``layers`` (a ``ModuleList``) over x, the dense body or, on a seq
    axis, the sequence-split one; under FSDP inside ``gathered_call``
    (``dims``: the list's own parameter names -> data dim). ``aux`` is
    None, or with ``moe`` the MoE blocks' summed routing aux loss (their
    experts exchanged over the mesh's expert group where it is above 1,
    on the model rank's heads and ffn columns under ``tp``, over the seq
    rank's chunk by ``sp_attn_impl`` on a seq axis)."""
    from .fsdp import gathered_call
    from .seq_parallel import sp_body_apply
    sp = mesh if mesh is not None and mesh.n_seq > 1 else None
    if moe is not None:
        from ..models.moe import moe_layers_apply
        ep = mesh if mesh is not None and mesh.n_expert > 1 else None

        def body(layers, x, rng, offset):
            return moe_layers_apply(cfg, moe, layers, x, rng, offset, ep, tp,
                                    sp, sp_attn_impl)
    elif sp is not None:
        def body(layers, x, rng, offset):
            return sp_body_apply(cfg, layers, x, sp, sp_attn_impl, rng,
                                 offset, tp), None
    else:
        def body(layers, x, rng, offset):
            return body_apply(cfg, layers, x, rng, offset, tp), None

    def run(layers, dims, x, rng, offset):
        if not fsdp:
            return body(layers, x, rng, offset)
        return gathered_call(layers, dims, mesh, body, x, rng, offset)

    return run


def _check_moe_mesh(cfg: ModelConfig, moe, T: int, n_ep: int) -> None:
    """The JAX ``_check_moe_mesh``: gpt2 blocks, experts that divide over
    the expert axis, an expert ffn that divides over the model axis."""
    if cfg.arch != "gpt2":
        raise ValueError("MoE pipeline blocks are gpt2-style; set "
                         "arch='gpt2'")
    if moe.n_experts % n_ep:
        raise ValueError(f"n_experts={moe.n_experts} must divide over "
                         f"{n_ep} expert shards")
    from .tensor_parallel import check_moe_tp
    check_moe_tp(cfg, moe, T)


def _check_moe(cfg: ModelConfig, moe, mesh: Optional[Mesh]) -> None:
    """The MoE refusals of the JAX executor: an expert axis without a
    ``MoEConfig``, and ``_check_moe_mesh``. MoE composes with every other
    axis and with FSDP."""
    n_ep = 1 if mesh is None else mesh.n_expert
    if n_ep > 1 and moe is None:
        raise ValueError("mesh has an 'expert' axis but no MoEConfig given")
    if moe is None:
        return
    _check_moe_mesh(cfg, moe, 1 if mesh is None else mesh.n_model, n_ep)


def _check_expert(model: nn.Module, moe, mesh: Optional[Mesh]) -> None:
    """A MoE model must hold this rank's block of the experts."""
    if moe is None:
        return
    want = (1, 0) if mesh is None or mesh.n_expert == 1 \
        else (mesh.n_expert, mesh.expert)
    have = getattr(model, "expert", None)
    if have != want:
        raise ValueError(
            f"the MoE model holds expert block {have}, this rank needs "
            f"{want} (from_jax_params(..., moe=, expert=(n_expert, "
            f"mesh.expert)))")


def _embedder(cfg: ModelConfig, mesh: Optional[Mesh]):
    """``embed(model, tokens, rng)``: the dense embedding, or on a seq
    axis the chunk's (``seq_parallel.sp_embed_apply``)."""
    if mesh is None or mesh.n_seq == 1:
        return lambda model, toks, rng=None: embed_apply(cfg, model, toks,
                                                         rng=rng)
    from .seq_parallel import sp_embed_apply
    return lambda model, toks, rng=None: sp_embed_apply(cfg, model, toks,
                                                        mesh, rng)


def _chunk_dims(model: nn.Module, layers: nn.ModuleList, first: int
                ) -> Dict[str, Optional[int]]:
    """The FSDP dims of a chunk of ``model``'s blocks whose first is
    global layer ``first``, by the chunk's own parameter names."""
    from .fsdp import fsdp_shard_of
    shard = fsdp_shard_of(model)
    if shard is None:
        return {}
    out = {}
    for name, _ in layers.named_parameters():
        j, rest = name.split(".", 1)
        out[name] = shard.dims.get(f"layers.{first + int(j)}.{rest}")
    return out


def _replicated(model: nn.Module) -> List[nn.Parameter]:
    """The parameters every pipe rank holds: the embedding, the final norm
    and the head (everything outside ``layers``)."""
    return [p for n, p in model.named_parameters()
            if not n.startswith("layers.")]


def mesh_device(device, mesh: Optional[Mesh], n_stages: int
                ) -> torch.device:
    """The device an entry point computes on: ``resolve_device(device)``,
    or with a mesh this rank's device, which ``device`` must name (its
    type, and its index where given), and whose ``n_pipe`` must be
    ``n_stages``."""
    device = resolve_device(device)
    if mesh is None:
        return device
    if mesh.n_pipe != n_stages:
        raise ValueError(f"n_stages={n_stages} but the mesh has "
                         f"n_pipe={mesh.n_pipe}")
    if device.type != mesh.device.type or device.index not in (
            None, mesh.device.index):
        raise ValueError(f"device={str(device)!r} but this rank computes on "
                         f"{mesh.device} (parallel.mesh.rank_device)")
    return mesh.device


def _pad_scale(cfg: ModelConfig, targets, M: int, mesh: Optional[Mesh]):
    """``global_pad_scale`` over the whole global batch: the valid count
    sums over the data axis (the JAX ``data_axis`` psum) and the seq and
    expert axes (its ``shard_axes``), whose shares the epilogue sums
    unscaled."""
    if cfg.pad_token_id is None:
        return None
    if mesh is None or mesh.n_data * mesh.n_seq * mesh.n_expert == 1:
        return global_pad_scale(targets, cfg.pad_token_id, M)
    n_valid = (targets != cfg.pad_token_id).sum().float()
    for axis in (DATA_AXIS, SEQ_AXIS, EXPERT_AXIS):
        mesh.all_reduce([n_valid], axis)
    return M * mesh.n_data / n_valid.clamp_min(1.0)


def make_pipeline_grad_fn(cfg: ModelConfig, sched: ScheduleConfig,
                          n_stages: int, remat_backward=None,
                          device="cuda", axes: Optional[Dict[str, int]] = None,
                          mesh: Optional[Mesh] = None,
                          comm_overlap: str = "none",
                          tp_vocab_parallel: bool = False,
                          telemetry=None, dynamics=None,
                          sp_attn_impl: str = "ring", fsdp: bool = False,
                          moe=None) -> Callable[..., torch.Tensor]:
    """``(model, tokens, targets) -> loss``: one pipelined forward and
    backward over ``n_stages`` (D) devices under ``sched``, with the
    gradients accumulated into the parameters' ``.grad`` (zero them
    first). ``tokens``/``targets`` are [B, S] with B divisible by
    ``sched.n_microbatches`` (M); microbatches split dim 0.

    Without ``mesh`` all D devices run in this process, in lockstep. With
    ``mesh`` (this rank's :class:`.mesh.Mesh`, ``mesh.n_pipe == D``) the
    rank runs only its pipe coordinate's row of the table and exchanges
    the hand-overs with its pipe peers (:class:`DistTransport`). Then
    ``model`` is the rank's view (``init_params`` or ``from_jax_params``
    with ``layers=owned_layers(...)``, or a whole model, whose other
    blocks stay unused) and ``tokens``/``targets`` are the rank's slice of
    the global batch (``utils.data.batch_sharding``). After the ticks (the
    JAX epilogue, ``pipeline.py:1683-1712``) the loss, held by the last
    stage's rank, is summed over the pipe group; the gradients of the
    replicated embedding, final norm and head are summed over the pipe
    group, so every pipe rank holds them whole (tied: ``tok`` takes both
    halves); layer gradients stay where their stage ran. With
    ``mesh.n_data > 1`` the loss and every gradient are averaged over the
    data group; a call with ``reduce_data=False`` averages only the loss
    (the train step's ZeRO-1 reduce-scatters the gradients instead).

    ``comm_overlap``: ``"none"`` banks every arrival at the top of its
    tick (the lockstep); ``"ring"`` banks each channel just before the
    unit that ``schedules.overlap_bank_stages`` names, so a hop overlaps
    the tick's earlier units; ``"auto"`` is ``"ring"`` (the executor is
    always unrolled). All three give the same bits.

    With ``cfg.dropout > 0`` the function takes a fourth argument, the
    step's seed (an int; the JAX step's PRNG key), and runs train-mode
    dropout. Microbatch ``m`` runs under ``fold_seed(step_seed, m)`` and
    each layer folds its global index into that (the JAX contract,
    ``parallel/pipeline.py:604-607``), so the masks depend only on (step
    seed, microbatch, global layer, site), never on (D, V) or the
    placement: every schedule and stage split computes the loss and
    gradients of :func:`..models.transformer.transformer_loss` averaged
    over the microbatches with ``rng = fold_seed(step_seed, m)``. With
    ``mesh.n_data > 1`` the step seed first folds the data coordinate
    (JAX ``:983-987``), so data replicas draw other masks. Every
    recompute re-seeds the same streams, so it redraws the masks its
    forward drew.

    The loss matches the JAX executor: the last stage takes the token-mean
    cross entropy of its microbatch, the loss is the mean over
    microbatches, and the gradients are those of that mean (the last
    stage seeds its backward with 1/M, so every cotangent on the -1 ring
    carries the 1/M scale).

    ``remat_backward`` (the JAX ``pipeline.py:865`` rule):

    - ``None``: rematerialise at D > 1; at D == 1, plain autograd over the
      microbatches (no tick table to run) unless the schedule splits its
      backward.
    - ``True``: the forward unit runs under ``no_grad`` and keeps only the
      stage input in its activation slot; the backward unit re-runs the
      stage under autograd, back-propagates the incoming cotangent (or,
      on the last stage, the loss) and sends the input's gradient on.
    - ``False``: stored; the forward unit keeps its autograd graph until
      its backward unit. A split-backward schedule raises ``ValueError``.

    Under a split-backward schedule (ZBH1, ZBV, a registered
    ``split_backward`` order) the backward is two units, both
    rematerialising: B recomputes the stage and takes only the input's
    gradient (``torch.autograd.grad``; on the last stage it adds the
    microbatch's loss to the total), W recomputes it again and
    back-propagates the same cotangent into the stage's parameters (the
    head's on the last stage; on stage 0, which has no B, the embedding's
    through a recomputed embedding). W reads the saved input and the
    cotangent last, so it frees their slots.

    With ``mesh.n_model > 1`` (tensor parallelism, the JAX ``tp_axis``
    path) ``model`` is the rank's shard of its view
    (``parallel.tensor_parallel.shard_model``; ``ValueError`` otherwise):
    the blocks run on its heads and columns and complete over the model
    group, the hand-offs go between ranks of one model coordinate, and
    the epilogue is the one above: the model-sharded leaves stay sharded,
    the replicated ones come out equal on every model rank (their
    cotangents are complete before they reach them). ``tp_vocab_parallel``
    splits the last stage's head and cross entropy over the vocab (the
    JAX ``_stage_ce_impl``); it needs ``n_model > 1`` and a vocab that
    divides by it. Heads, kv heads and ``ffn_dim`` must divide by
    ``n_model``.

    ``fsdp=True`` (pp x fsdp, ZeRO-3 in the pipeline; the JAX ``fsdp``)
    needs a data axis; ``model`` is then the rank's
    ``parallel.fsdp.fsdp_shard_params`` copy, whose blocks' matrices hold
    their data coordinate's block (``parallel.fsdp.fsdp_shard_dims``;
    under a model axis on another dim than the Megatron one). Each F, B
    and W unit gathers its chunk's matrices over the data group just in
    time (one all-gather a unit, span ``fsdp_gather``) and the unit's
    backward reduce-scatters their gradients (one a unit, span
    ``fsdp_reduce_scatter``), so the gradients land in the shards'
    ``.grad`` already summed over the data group. The epilogue scales
    them by 1/n_data and averages only the replicated leaves over the data
    group (the JAX ``:1695-1711``). It always rematerialises:
    ``remat_backward=False`` raises ``ValueError``, as in JAX.

    With a seq axis (``mesh.n_seq`` above 1, sequence parallelism)
    ``tokens``/``targets`` are the rank's chunk [B_local, S/n_seq] of each
    sequence (``utils.data.batch_sharding``); the first stage embeds the
    chunk at its global positions and every stage runs the
    sequence-split blocks of ``parallel.seq_parallel`` under
    ``sp_attn_impl`` ("ring" or "ulysses"; Ulysses needs the rank's
    heads to divide by ``n_seq``), so the hand-offs are [mb, S/n_seq,
    dim]. The last stage takes its chunk's mean cross entropy over
    ``n_seq`` (under ``pad_token_id`` the masked sum over the global
    valid count); the epilogue sums the loss and every gradient over the
    seq group after the data average.

    ``moe`` (a ``models.moe.MoEConfig``; the JAX ``moe``): ``model`` is a
    ``models.moe.MoELM`` and the stages run its MoE blocks, which attend
    densely (no flash kernel) and return their summed routing aux loss
    with their output. Each unit adds ``aux_loss_weight / n_layers /
    n_expert`` times its stage's aux to the stage's objective (JAX
    ``:1116-1119``), so a backward unit back-propagates the output's
    cotangent and that scale (both times 1/M) together; the reported loss
    is the cross entropy plus the aux term, the mean over microbatches of
    ``models.moe.moe_lm_loss`` (capacity and the routing statistics are a
    microbatch's). Every schedule runs it; under a split schedule the W
    unit carries the router's and the expert stacks' gradients. Dropout
    (``cfg.dropout > 0``) draws at sites 0-2 of each layer, keyed on the
    global layer, so the masks do not depend on (D, V). With
    ``mesh.n_expert`` above 1 (the JAX 'expert' axis) ``model`` holds this
    rank's block of the experts (``from_jax_params(..., moe=,
    expert=(n_expert, mesh.expert))``), the MoE FFNs exchange their slots
    over the expert group, the batch splits over data x expert
    (``utils.data.batch_sharding``), the dropout seed folds the expert
    coordinate after the data one, and the epilogue sums the loss and
    every gradient but the expert stacks' over the expert group (each
    rank's share was divided by ``n_expert``). MoE composes with the
    other axes as dense blocks do: with a model axis ``model`` is the
    rank's Megatron shard of its expert block (each expert's ffn split,
    the router replicated, ``parallel.tensor_parallel.shard_model``), with
    ``fsdp`` its FSDP shard of that (``parallel.fsdp.fsdp_shard_params``,
    the MoE dims), and on a seq axis each rank routes its chunk's tokens
    with the chunk's capacity. An expert axis without ``moe`` raises
    ``ValueError``, as do JAX's ``_check_moe_mesh`` rules (gpt2 blocks, E
    divisible by ``n_expert``, the expert ffn by ``n_model``).

    ``axes``: a ``"data"``, ``"model"``, ``"seq"`` or ``"expert"`` entry
    above 1 raises ``NotImplementedError`` pointing at ``mesh``.

    ``telemetry`` (a ``utils.telemetry.PipelineTelemetry``, default None)
    records a measured timeline: the table is attached with the
    ``"unrolled"`` executor, and each step stamps ``STEP_START`` before
    tick 0, ``TICK t`` once tick t's hand-offs are posted and
    ``STEP_END`` after the last tick (on the card, CUDA events on the
    current stream: no synchronisation inside the step). The plain D = 1
    step has no ticks and is one ``"scan"`` segment. With ``mesh`` the
    transport adds its arrival waits to ``telemetry.wait_s`` and, after
    the epilogue, every rank hands its stamps to global rank 0
    (``PipelineTelemetry.merge_world``, one gather over the world).
    Without it the step records nothing and makes no extra call. The
    stamps change no value: a stamped step's loss and gradients are the
    unstamped step's bit for bit.

    ``dynamics`` (truthy, default None; the JAX ``dynamics``) makes the
    function return ``(loss, sq_mb)``: ``sq_mb[m]`` (an [M] f32 tensor on
    the device) is microbatch m's squared gradient norm, the gradient of
    its own loss (the units back-propagate loss / M, so their squares are
    scaled by M^2). Each unit that produces parameter gradients (the full
    backward; under a split schedule the W unit, with the embedding's on
    stage 0 and the head's on the last stage) adds the squared norms of
    the gradients it produced, read by hooks on the parameters before
    autograd adds them into ``.grad`` (one fused reduction a unit), so the
    loss and every ``.grad`` are the dynamics-off step's bit for bit. The
    stages partition an untied model's parameters, so the sum over them
    is the microbatch's whole norm; with ``mesh`` it is summed over the
    pipe group and averaged over the data group (each data replica holds
    other microbatches). As in JAX it raises ``ValueError`` for tied
    embeddings, a model axis, the 1-stage plain path and the stored
    backward where JAX runs it as its phase-stored program
    (``remat_backward=False`` with GPipe, BFS or D = 1).
    """
    device = mesh_device(device, mesh, n_stages)
    _check_axes(axes)
    tp = _tp_of(cfg, mesh, tp_vocab_parallel)
    from .seq_parallel import sp_mesh_check
    sp_mesh_check(cfg, mesh, sp_attn_impl, tp)
    _check_moe(cfg, moe, mesh)
    if comm_overlap not in COMM_OVERLAP:
        raise ValueError(f"comm_overlap={comm_overlap!r}: choose one of "
                         f"{COMM_OVERLAP}")
    D, V, M = n_stages, sched.n_virtual, sched.n_microbatches
    cs = compile_schedule(sched.name, D, V, M)  # raises on a bad (D, V, M)
    maybe_verify_schedule(cs)
    S = D * V
    if cfg.n_layers % S != 0:
        raise ValueError(f"n_layers={cfg.n_layers} must divide evenly into "
                         f"{S} stages")
    split = cs.split_backward
    placement = cs.placement
    if split and remat_backward is False:
        raise ValueError(
            f"remat_backward=False is incompatible with split-backward "
            f"schedule {sched.name!r}: its W units re-derive parameter "
            f"grads from saved inputs by design (that recompute is what "
            f"fills the bubble ticks)")
    _check_fsdp_args(fsdp, mesh, remat_backward)
    plain = (D == 1 and remat_backward is None and not split
             and moe is None)
    remat = remat_backward is None or bool(remat_backward)
    n_seq = 1 if mesh is None else mesh.n_seq
    n_ep = 1 if mesh is None else mesh.n_expert
    if dynamics:
        _check_dynamics(cfg, tp, plain, remat_backward, split, placement,
                        sched.name, D, fsdp, n_seq, moe, n_ep)
    # each rank's share of the global mean: the epilogue sums the seq and
    # expert shares (JAX ``loss_norm``)
    loss_norm = n_seq * n_ep
    aux_scale = (0.0 if moe is None
                 else moe.aux_loss_weight / cfg.n_layers / loss_norm)
    table = cs.table
    inv = 1.0 / M
    lps = cfg.n_layers // S
    use_dropout = cfg.dropout > 0.0
    # per tick, the stage before which each channel banks
    banks = (overlap_bank_stages(table) if comm_overlap != "none"
             else np.zeros((table.shape[0], len(CHANNELS)), np.int8))
    channel_of = {(buf, off): ci for ci, (buf, off, _) in enumerate(CHANNELS)}

    def stage_of(d, v):
        return placement_stage_of(placement, d, v, D)

    def send_channel(kind, s):
        """The channel of stage s's hand-over, or None when it stays on
        the device (the V's turn) or there is none."""
        if kind == "act":
            if s == S - 1:
                return None
            route = fwd_route(placement, s, D)
        else:
            if s == 0:
                return None
            route = bwd_route(placement, s, D)
        return None if route == "local" else channel_of[(kind, int(route))]

    transport = None
    if mesh is not None and not plain:
        sends = [(t, d, ci) for t in range(table.shape[0]) for d in range(D)
                 for kind, col_m, col_v in (("act", COL_FWD_M, COL_FWD_V),
                                            ("grad", COL_BWD_M, COL_BWD_V))
                 if table[t, d, col_m] >= 0
                 for ci in (send_channel(kind, stage_of(
                     d, int(table[t, d, col_v]))),)
                 if ci is not None]
        _check_hops(table, CHANNELS, sends)
        transport = DistTransport(mesh, table, telemetry=telemetry)
    elif not plain:
        transport = LockstepTransport(D)
    if telemetry is not None:
        from ..utils import telemetry as _tm
        telemetry.attach(table, None, "scan" if plain else "unrolled")

    def grad_fn(model: Transformer, tokens, targets,
                step_seed: Optional[int] = None, *,
                reduce_data: bool = True):
        if not dynamics:
            return step(model, tokens, targets, step_seed, reduce_data, None)
        with _UnitGrads(model, M) as units:
            loss = step(model, tokens, targets, step_seed, reduce_data,
                        units)
            sq_mb = units.sq_mb(loss.device) * float(M * M)
        if mesh is not None:
            mesh.all_reduce([sq_mb], PIPE_AXIS)
            if mesh.n_data > 1:
                sq_mb.mul_(1.0 / mesh.n_data)
                mesh.all_reduce([sq_mb], DATA_AXIS)
        return loss, sq_mb

    run_layers = _layers_runner(cfg, mesh, tp, fsdp, sp_attn_impl, moe)
    embed_of = _embedder(cfg, mesh)

    def step(model: Transformer, tokens, targets, step_seed, reduce_data,
             units: Optional["_UnitGrads"]) -> torch.Tensor:
        """One step; ``units`` (dynamics) banks each backward and W
        unit's parameter gradients."""
        if use_dropout and step_seed is None:
            raise ValueError(f"dropout={cfg.dropout} > 0: pass the step's "
                             f"seed as the fourth argument")
        _check_shard(model, tp, tp_vocab_parallel)
        _check_fsdp(model, fsdp, mesh)
        _check_expert(model, moe, mesh)
        seed = step_seed if use_dropout else None
        if seed is not None and mesh is not None and mesh.n_data > 1:
            seed = fold_seed(seed, mesh.data)
        if seed is not None and n_ep > 1:
            # the expert axis doubles as a batch axis: its shards hold
            # other tokens, so they draw other masks (JAX ``:988-994``)
            seed = fold_seed(seed, mesh.expert)
        tokens = torch.as_tensor(tokens, device=device).long()
        targets = torch.as_tensor(targets, device=device).long()
        b, seq = tokens.shape
        if b % M:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_microbatches={M}")
        toks = tokens.view(M, b // M, seq)
        tgts = targets.view(M, b // M, seq)

        def mb_rng(m):
            """Microbatch ``m``'s dropout seed (None in eval mode)."""
            return None if seed is None else fold_seed(seed, m)

        def embed(m):
            return embed_of(model, toks[m], mb_rng(m))

        pad_scale = _pad_scale(cfg, targets, M, mesh)

        def head(y, tgt):
            ce = head_loss(cfg, model, y, tgt, pad_scale, tp,
                           tp_vocab_parallel)
            # a chunk's mean over the seq and expert axes: the epilogue's
            # sums make the global mean (the pad scale holds its own count)
            return ce / loss_norm if loss_norm > 1 and pad_scale is None \
                else ce

        loss = torch.zeros((), dtype=torch.float32, device=device)
        if telemetry is not None:
            telemetry.emit(_tm.STEP_START, 0, device)
        if plain:
            dims = _chunk_dims(model, model.layers, 0)
            with torch.enable_grad():
                for m in range(M):
                    y, _ = run_layers(model.layers, dims, embed(m),
                                      mb_rng(m), 0)
                    ce = head(y, tgts[m])
                    (ce * inv).backward()
                    loss += ce.detach()
            if telemetry is None:
                return _epilogue(model, loss * inv, mesh, reduce_data, fsdp)
            telemetry.emit(_tm.STEP_END, 0, device)
            return _stamped_epilogue(model, loss * inv, reduce_data)

        stages = stack_stage_layers(model.layers, D, V, placement)
        dims = [[_chunk_dims(model, stages[d][v], stage_of(d, v) * lps)
                 for v in range(V)] for d in range(D)]

        def stage_body(d, v, x, m):
            """Device d's chunk v on microbatch m -> (y, aux or None); its
            first layer's global index keys the dropout streams."""
            return run_layers(stages[d][v], dims[d][v], x, mb_rng(m),
                              stage_of(d, v) * lps)

        act: List[List] = [[None] * cs.n_act_slots for _ in range(D)]
        grad: List[List] = [[None] * cs.n_grad_slots for _ in range(D)]
        graphs: List[Dict] = [dict() for _ in range(D)]  # stored: slot -> (x, y)
        bufs = {"act": act, "grad": grad}

        def forward_unit(d, row):
            v, m, slot = (int(row[c]) for c in (COL_FWD_V, COL_FWD_M,
                                                 COL_FWD_SLOT))
            s = stage_of(d, v)
            if remat:
                with torch.no_grad():
                    x = embed(m) if s == 0 else act[d][slot]
                    act[d][slot] = x  # the saved stage input
                    y, _ = stage_body(d, v, x, m)
            else:
                with torch.enable_grad():
                    x = embed(m) if s == 0 \
                        else act[d][slot].detach().requires_grad_()
                    act[d][slot] = x
                    y, aux = stage_body(d, v, x, m)
                graphs[d][slot] = (x, y, aux)
                y = y.detach()
            return s, y

        def objective(d, v, s, m, y, aux, gslot):
            """(loss or None, outputs, their cotangents) to back-propagate
            from stage s: on the last stage its microbatch's loss and the
            loss / M, else the body output and the stored incoming
            cotangent; with MoE blocks also the stage's aux term / M (a
            scalar, whose cotangent is 1)."""
            if s == S - 1:
                ce = head(y, tgts[m])
                outs, cots = [ce * inv], [None]
            else:
                ce, outs, cots = None, [y], [grad[d][gslot]]
            if aux is not None:
                outs.append(aux * (aux_scale * inv))
                cots.append(None)
            return ce, outs, cots

        def report(aux):
            """The stage's aux share of the reported loss."""
            nonlocal loss
            if aux is not None:
                loss += aux.detach() * aux_scale

        def release(d, aslot, gslot, s):
            """The unit that reads the saved input and cotangent last frees
            their slots."""
            act[d][aslot] = None
            if s < S - 1:
                grad[d][gslot] = None

        def backward_unit(d, row):
            """The full backward, or under a split schedule its input-grad
            half (dgrad): returns (stage, input cotangent or None)."""
            nonlocal loss
            v, m, aslot, gslot = (int(row[c]) for c in (
                COL_BWD_V, COL_BWD_M, COL_BWD_ASLOT, COL_BWD_GSLOT))
            s = stage_of(d, v)
            with torch.enable_grad():
                if split:  # stage 0 has no B
                    x = act[d][aslot].detach().requires_grad_()
                    ce, outs, cots = objective(d, v, s, m,
                                               *stage_body(d, v, x, m), gslot)
                    gx, = torch.autograd.grad(outs, x, grad_outputs=cots)
                    if ce is not None:
                        loss += ce.detach()
                    return s, gx
                if remat:
                    # stage 0 recomputes its embedding under autograd, so
                    # the input's gradient flows on into the tables
                    x = embed(m) if s == 0 \
                        else act[d][aslot].detach().requires_grad_()
                    y, aux = stage_body(d, v, x, m)
                else:
                    x, y, aux = graphs[d].pop(aslot)
                ce, outs, cots = objective(d, v, s, m, y, aux, gslot)
                torch.autograd.backward(outs, cots)
                if ce is not None:
                    loss += ce.detach()
                report(aux)
            release(d, aslot, gslot, s)
            return s, (x.grad if s > 0 else None)

        def wgrad_unit(d, row):
            """The weight-grad half of a split backward: the stage's
            parameters (and the embedding's on stage 0, the head's on the
            last stage) from a second recompute; sends nothing."""
            v, m, aslot, gslot = (int(row[c]) for c in (
                COL_W_V, COL_W_M, COL_W_ASLOT, COL_W_GSLOT))
            s = stage_of(d, v)
            params = list(stages[d][v].parameters())
            with torch.enable_grad():
                if s == 0:  # the embedding's gradient through a recompute
                    x = embed(m)
                    params += [model.tok] + (
                        [model.pos] if cfg.arch == "gpt2" else [])
                else:
                    x = act[d][aslot]
                y, aux = stage_body(d, v, x, m)
                _, outs, cots = objective(d, v, s, m, y, aux, gslot)
                if s == S - 1:
                    params += list(model.norm.parameters()) + (
                        [model.tok] if cfg.tie_embeddings
                        else list(model.out.parameters()))
                torch.autograd.backward(outs, cots, inputs=params)
                report(aux)  # W runs once for every stage's microbatch
            release(d, aslot, gslot, s)

        transport.begin((b // M, seq, cfg.dim), torch_dtype(cfg.dtype))
        for t in range(table.shape[0]):
            for d in transport.devices:
                row = table[t, d]
                due = banks[t]

                def bank(stage):
                    for ci, (buf, _, col) in enumerate(CHANNELS):
                        if row[col] >= 0 and due[ci] == stage:
                            bufs[buf][d][row[col]] = transport.arrival(
                                t, d, ci)

                bank(BANK_BEFORE_F)
                if row[COL_FWD_M] >= 0:
                    s, y = forward_unit(d, row)
                    ci = send_channel("act", s)
                    if ci is not None:
                        transport.send(t, d, ci, y)
                    elif s < S - 1:
                        act[d][row[COL_FWD_LOCAL_SLOT]] = y
                bank(BANK_BEFORE_B)
                if row[COL_BWD_M] >= 0:
                    if units is not None:
                        units.begin()
                    s, gx = backward_unit(d, row)
                    if units is not None:
                        units.bank(int(row[COL_BWD_M]))
                    ci = send_channel("grad", s)
                    if ci is not None:
                        transport.send(t, d, ci, gx)
                    elif s > 0:
                        grad[d][row[COL_BWD_LOCAL_SLOT]] = gx
                bank(BANK_BEFORE_W)
                if row[COL_W_M] >= 0:
                    if units is not None:
                        units.begin()
                    wgrad_unit(d, row)
                    if units is not None:
                        units.bank(int(row[COL_W_M]))
                bank(BANK_END)
            transport.end_tick(t)
            if telemetry is not None:
                telemetry.emit(_tm.TICK, t, device)
        transport.finish()
        if telemetry is None:
            return _epilogue(model, loss * inv, mesh, reduce_data, fsdp)
        telemetry.emit(_tm.STEP_END, 0, device)
        return _stamped_epilogue(model, loss * inv, reduce_data)

    def _stamped_epilogue(model, loss, reduce_data):
        """The epilogue, then a world's rank hands its stamps to global
        rank 0."""
        loss = _epilogue(model, loss, mesh, reduce_data, fsdp)
        if mesh is not None:
            telemetry.merge_world(mesh)
        return loss

    return grad_fn


def _check_dynamics(cfg: ModelConfig, tp, plain: bool, remat_backward,
                    split: bool, placement: str, name: str, D: int,
                    fsdp: bool = False, n_seq: int = 1, moe=None,
                    n_ep: int = 1) -> None:
    """``dynamics``' refusals, the JAX ``make_pipeline_grad_fn``'s."""
    blockers = []
    if moe is not None:
        blockers.append("moe")
    if fsdp:
        blockers.append("fsdp")
    if tp is not None:
        blockers.append("a 'model' mesh axis")
    if n_seq > 1:
        blockers.append("a 'seq' mesh axis")
    if n_ep > 1:
        blockers.append("an 'expert' mesh axis")
    if cfg.tie_embeddings:
        # the tied table takes gradients on the first stage and the last,
        # so the per-stage squared norms no longer sum to |g_m|^2
        blockers.append("tie_embeddings")
    if blockers:
        raise ValueError(
            "dynamics per-microbatch accumulation needs stages to "
            "partition the parameters (dense untied pipe x data "
            "mesh); unsupported here: " + ", ".join(blockers))
    if plain:
        raise ValueError(
            "dynamics=True needs the tick executor's per-microbatch "
            "gradients; the degenerate 1-stage fast path computes one "
            "fused full-batch gradient — pass remat_backward=True")
    if (remat_backward is False and not split and placement == "wrap"
            and (D == 1 or name in ("GPipe", "BFS"))):
        raise ValueError(
            "dynamics=True needs per-microbatch gradients; the "
            "phase-stored program differentiates through its forward "
            "tick scan and never materializes them — pass "
            "remat_backward=True for the tick executor")


class _UnitGrads:
    """``dynamics``' hooks: while open, every parameter gradient autograd
    computes lands in :attr:`sink` before it is added into ``.grad``;
    :meth:`bank` takes the squared norms of one unit's (one fused
    reduction), kept per microbatch on the device."""

    def __init__(self, model: nn.Module, n_microbatches: int):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.norms: List[List[torch.Tensor]] = [
            [] for _ in range(n_microbatches)]
        self.sink: List[torch.Tensor] = []

    def __enter__(self) -> "_UnitGrads":
        self.handles = [p.register_hook(self.sink.append)
                        for p in self.params]
        return self

    def __exit__(self, *exc) -> None:
        for h in self.handles:
            h.remove()

    def begin(self) -> None:
        self.sink.clear()

    def bank(self, m: int) -> None:
        if self.sink:
            self.norms[m].append(torch.stack(torch._foreach_norm(
                self.sink, 2, dtype=torch.float32)))
        self.sink.clear()

    def sq_mb(self, device) -> torch.Tensor:
        """[M] f32: each microbatch's banked squared norms, summed."""
        return torch.stack([
            torch.cat(n).square().sum() if n
            else torch.zeros((), dtype=torch.float32, device=device)
            for n in self.norms])


def _epilogue(model: nn.Module, loss: torch.Tensor, mesh: Optional[Mesh],
              reduce_data: bool, fsdp: bool = False) -> torch.Tensor:
    """The reductions after the ticks (see :func:`make_pipeline_grad_fn`);
    ``loss`` is this rank's share, already scaled by 1/M. Without a mesh
    it is the loss. Under FSDP the sharded leaves were summed over the
    data group by their units' reduce-scatters, so they only take the
    1/n_data (a second sum would multiply them by n_data); on a seq axis
    every gradient and the loss are then summed over the seq group (each
    chunk's share of the global mean), and on an expert axis the loss and
    every gradient but the expert stacks' over the expert group (each
    batch shard's share; an expert stack's gradient is whole on its rank,
    every token having reached it by the all-to-all, JAX
    ``:1720-1734``)."""
    if mesh is None:
        return loss
    from .fsdp import fsdp_names
    repl = _replicated(model)
    for p in repl:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh.all_reduce([loss] + [p.grad for p in repl], PIPE_AXIS)
    if mesh.n_data > 1:
        nd = 1.0 / mesh.n_data
        sharded = fsdp_names(model) if fsdp else set()
        red = [loss]
        if reduce_data:
            red += [p.grad for n, p in model.named_parameters()
                    if p.grad is not None and n not in sharded]
        torch._foreach_mul_(red, nd)
        mesh.all_reduce(red, DATA_AXIS)
        if sharded:
            torch._foreach_mul_([p.grad for n, p in model.named_parameters()
                                 if p.grad is not None and n in sharded], nd)
    if mesh.n_seq > 1:
        mesh.all_reduce([loss] + [p.grad for p in model.parameters()
                                  if p.grad is not None], SEQ_AXIS)
    if mesh.n_expert > 1:
        from ..models.moe import is_expert_leaf
        mesh.all_reduce([loss] + [p.grad for n, p in model.named_parameters()
                                  if p.grad is not None
                                  and not is_expert_leaf(n)], EXPERT_AXIS)
    return loss


def _fwd_tick_table(D: int, V: int, M: int):
    """Forward-only tick table of the eval executor (the JAX
    ``_fwd_tick_table``, bit-identical): the F actions of the
    breadth-first order over V wrap-placed chunks, tick-scheduled and
    slot-allocated with the training tables' machinery. Returns (table
    [T, D, 4] int32 with columns (store_slot, fv, fm, src_slot),
    n_slots); store_slot banks the previous tick's +1-ring arrival,
    src_slot is where this tick's F reads its input (-1: the first stage,
    which embeds)."""
    forders = [[a for a in order if a.op == F]
               for order in bfs_order(D, V, M)]
    ticks, T = schedule_ticks(forders, D, V)
    S = D * V
    # F(s, m)'s output arrives at device (s+1) % D at tick + 1 and is read
    # by F(s+1, m)'s tick, never later than the last compute tick
    events = {d: [] for d in range(D)}
    for a, t in ticks.items():
        if a.stage + 1 < S:
            nxt = Action(a.stage + 1, F, a.microbatch)
            events[(a.stage + 1) % D].append((t + 1, ticks[nxt], nxt))
    slot_of, n_slots = {}, 0
    for d in range(D):
        assign, n = _allocate_slots(events[d])
        slot_of.update(assign)
        n_slots = max(n_slots, n)
    table = np.full((T, D, 4), -1, dtype=np.int32)
    for a, t in ticks.items():
        d = a.stage % D
        table[t, d, 1] = a.stage // D
        table[t, d, 2] = a.microbatch
        if a.stage > 0:
            table[t, d, 3] = slot_of[a]
    for d in range(D):
        for arrive, _, key in events[d]:
            table[arrive, d, 0] = slot_of[key]
    n_slots = max(n_slots, 1)
    maybe_verify_forward_table(table, D, V, M, n_slots)
    return table, n_slots


def _forward_runner(cfg: ModelConfig, sched: ScheduleConfig, D: int,
                    device: torch.device, mesh: Optional[Mesh], tp,
                    fsdp: bool, sp_attn_impl: str, moe):
    """``run(model, tokens, last)``: the rows of :func:`_fwd_tick_table`
    (every schedule's forward order is fill-drain over ``sched.n_virtual``
    wrap-placed chunks), in eval mode, over the lockstep transport or,
    with ``mesh``, this rank's row over the distributed one (the +1
    forward channel only). ``last(y, m)`` takes the last stage's output of
    microbatch m. The shared body of :func:`make_pipeline_loss_fn` and
    :func:`make_pipeline_forward` (the JAX ``_build_forward_program``)."""
    run_layers = _layers_runner(cfg, mesh, tp, fsdp, sp_attn_impl, moe)
    embed_of = _embedder(cfg, mesh)
    V, M = sched.n_virtual, sched.n_microbatches
    S = D * V
    if cfg.n_layers % S != 0:
        raise ValueError(f"n_layers={cfg.n_layers} must divide evenly into "
                         f"{S} stages")
    table, n_slots = _fwd_tick_table(D, V, M)
    lps = cfg.n_layers // S
    channels = (("act", +1, 0),)  # the store column banks the +1 ring
    if mesh is None:
        transport = LockstepTransport(D, channels)
    else:
        _check_hops(table, channels, [
            (t, d, 0) for t in range(table.shape[0]) for d in range(D)
            if table[t, d, 2] >= 0
            and placement_stage_of("wrap", d, int(table[t, d, 1]), D) < S - 1])
        transport = DistTransport(mesh, table, channels)

    def run(model, tokens, last) -> None:
        _check_expert(model, moe, mesh)
        b, seq = tokens.shape
        if b % M:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_microbatches={M}")
        toks = tokens.view(M, b // M, seq)
        stages = stack_stage_layers(model.layers, D, V)
        dims = [[_chunk_dims(model, stages[d][v],
                             placement_stage_of("wrap", d, v, D) * lps)
                 for v in range(V)] for d in range(D)]
        act: List[List] = [[None] * n_slots for _ in range(D)]
        transport.begin((b // M, seq, cfg.dim), torch_dtype(cfg.dtype))
        for t in range(table.shape[0]):
            for d in transport.devices:
                store, v, m, src = (int(c) for c in table[t, d])
                if store >= 0:
                    act[d][store] = transport.arrival(t, d, 0)
                if m < 0:
                    continue
                s = placement_stage_of("wrap", d, v, D)
                if s == 0:
                    x = embed_of(model, toks[m])
                else:
                    x, act[d][src] = act[d][src], None  # read once
                y, _ = run_layers(stages[d][v], dims[d][v], x, None, s * lps)
                if s == S - 1:
                    last(y, m)
                else:
                    transport.send(t, d, 0, y)
            transport.end_tick(t)
        transport.finish()

    return run


def _eval_checks(cfg: ModelConfig, mesh: Optional[Mesh], axes,
                 tp_vocab_parallel: bool, sp_attn_impl: str, fsdp: bool,
                 moe):
    """The eval executor's refusals; returns the model axis's mesh or
    None."""
    _check_axes(axes)
    tp = _tp_of(cfg, mesh, tp_vocab_parallel)
    from .seq_parallel import sp_mesh_check
    sp_mesh_check(cfg, mesh, sp_attn_impl, tp)
    if fsdp and (mesh is None or mesh.n_data <= 1):
        raise ValueError("fsdp eval needs a 'data' mesh axis (matching "
                         "the training-side pp x fsdp support)")
    _check_moe(cfg, moe, mesh)
    return tp


def make_pipeline_loss_fn(cfg: ModelConfig, sched: ScheduleConfig,
                          n_stages: int, device="cuda",
                          axes: Optional[Dict[str, int]] = None,
                          mesh: Optional[Mesh] = None,
                          tp_vocab_parallel: bool = False,
                          sp_attn_impl: str = "ring", fsdp: bool = False,
                          moe=None) -> Callable[..., torch.Tensor]:
    """``(model, tokens, targets) -> loss``: the forward-only pipelined
    loss over ``n_stages`` (D) devices, the evaluation twin of
    :func:`make_pipeline_grad_fn` (the JAX ``make_pipeline_loss_fn``).

    It runs the rows of :func:`_fwd_tick_table` (every schedule's forward
    order is fill-drain over ``sched.n_virtual`` wrap-placed chunks) under
    ``torch.no_grad()``, in eval mode (no dropout), through the training
    executor's ``embed_apply`` / ``body_apply`` / ``head_loss``: no
    backward, no recompute, and no autograd graph (the kernels' saved
    tensors go with their forward). The last stage takes each
    microbatch's token-mean cross entropy; the loss is the mean over the
    M microbatches, the single-device ``transformer_loss`` of the whole
    batch. With ``mesh`` the rank runs its row over the same transport as
    the training step, on the +1 forward channel only, and the loss is
    summed over the pipe group and averaged over the data group, so every
    rank returns the global batch's loss. ``axes``, a model axis,
    ``tp_vocab_parallel``, a seq axis with ``sp_attn_impl`` and ``fsdp``
    (each chunk's matrices gathered just in time, the JAX eval's
    ``:2145-2152``) are as in :func:`make_pipeline_grad_fn`.

    ``moe``: the stages are a ``models.moe.MoELM``'s MoE blocks, on an
    expert axis too (as in :func:`make_pipeline_grad_fn`; the loss is
    summed over the expert group). The eval loss is the cross entropy
    only: the routing aux is a training regulariser, so the stages' aux
    is dropped (the JAX MoE eval convention, ``utils/train.py:337-341``).
    """
    device = mesh_device(device, mesh, n_stages)
    tp = _eval_checks(cfg, mesh, axes, tp_vocab_parallel, sp_attn_impl,
                      fsdp, moe)
    loss_norm = 1 if mesh is None else mesh.n_seq * mesh.n_expert
    M = sched.n_microbatches
    run = _forward_runner(cfg, sched, n_stages, device, mesh, tp, fsdp,
                          sp_attn_impl, moe)

    @torch.no_grad()
    def loss_fn(model: Transformer, tokens, targets) -> torch.Tensor:
        _check_shard(model, tp, tp_vocab_parallel)
        _check_fsdp(model, fsdp, mesh)
        tokens = torch.as_tensor(tokens, device=device).long()
        targets = torch.as_tensor(targets, device=device).long()
        b, seq = targets.shape
        if b % M:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_microbatches={M}")
        tgts = targets.view(M, b // M, seq)
        pad_scale = _pad_scale(cfg, targets, M, mesh)
        loss = torch.zeros((), dtype=torch.float32, device=device)

        def last(y, m):
            nonlocal loss
            ce = head_loss(cfg, model, y, tgts[m], pad_scale, tp,
                           tp_vocab_parallel)
            loss += ce / loss_norm if pad_scale is None else ce

        run(model, tokens, last)
        loss = loss / M
        if mesh is not None:
            mesh.all_reduce([loss], PIPE_AXIS)
            if mesh.n_data > 1:
                loss = loss / mesh.n_data
                mesh.all_reduce([loss], DATA_AXIS)
            mesh.all_reduce([loss], SEQ_AXIS)
            mesh.all_reduce([loss], EXPERT_AXIS)
        return loss

    return loss_fn


def make_pipeline_forward(cfg: ModelConfig, sched: ScheduleConfig,
                          n_stages: int, device="cuda",
                          axes: Optional[Dict[str, int]] = None,
                          mesh: Optional[Mesh] = None
                          ) -> Callable[..., torch.Tensor]:
    """``(model, tokens) -> logits [B, S, V]`` in f32: pipelined batch
    inference (the JAX ``make_pipeline_forward``, the parity twin of
    upstream's ``PipelineScheduleSingle.step`` return value). The eval
    executor's fill-drain rows over ``sched.n_virtual`` wrap-placed
    chunks, under ``torch.no_grad()`` in eval mode; the last stage runs
    ``head_apply`` on each microbatch and the microbatches' logits are
    merged back along the batch. No schedule is compiled (every
    schedule's forward order is fill-drain), so any M >= 1 runs: 1F1B's
    M >= D does not apply. ``n_layers`` must divide over D * V.

    With ``mesh`` (data x pipe x model worlds) ``tokens`` is the rank's
    data shard (``utils.data.batch_sharding``) and every rank returns that
    shard's logits, which the last pipe stage hands its pipe peers (the
    sum over the pipe group of zeros elsewhere, JAX's ``psum``). Under a
    model axis the stages run Megatron TP on the rank's shard
    (``parallel.tensor_parallel.shard_model``, the head replicated), so
    every model rank returns the same full logits. A seq or expert axis
    raises ``NotImplementedError`` (JAX's words: the contract is
    materialised full-batch logits; ``make_pipeline_loss_fn`` serves those
    meshes' eval)."""
    device = mesh_device(device, mesh, n_stages)
    for axis, n in (("seq", 1 if mesh is None else mesh.n_seq),
                    ("expert", 1 if mesh is None else mesh.n_expert)):
        if n > 1:
            raise NotImplementedError(
                f"make_pipeline_forward supports data x pipe x model meshes "
                f"(got a '{axis}' axis); for eval losses on SP/MoE meshes "
                f"use make_pipeline_loss_fn")
    tp = _eval_checks(cfg, mesh, axes, False, "ring", False, None)
    D, V, M = n_stages, sched.n_virtual, sched.n_microbatches
    if M < 1:
        raise ValueError(f"n_microbatches={M} must be >= 1")
    if cfg.n_layers % (D * V):
        raise ValueError(f"n_layers={cfg.n_layers} must divide over "
                         f"{D * V} stages")
    run = _forward_runner(cfg, sched, D, device, mesh, tp, False, "ring",
                          None)

    @torch.no_grad()
    def forward(model: Transformer, tokens) -> torch.Tensor:
        _check_shard(model, tp, False)
        tokens = torch.as_tensor(tokens, device=device).long()
        b, seq = tokens.shape
        if b % M:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_microbatches={M}")
        out = torch.zeros((M, b // M, seq, cfg.vocab_size),
                          dtype=torch.float32, device=device)

        def last(y, m):
            out[m] = head_apply(cfg, model, y).float()

        run(model, tokens, last)
        if mesh is not None:
            # the logits live on the last pipe stage; zeros elsewhere
            mesh.all_reduce([out], PIPE_AXIS)
        return out.view(b, seq, cfg.vocab_size)

    return forward
