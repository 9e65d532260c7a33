"""The pipeline executor: the stage split, the training tick executor and
the forward-only eval executor (counterparts of the JAX package's
``parallel/pipeline.py``: ``stack_stage_layers`` ``:199``,
``_stage_index_map`` ``:190``, ``make_pipeline_grad_fn`` ``:589``,
``_fwd_tick_table`` ``:1962`` and ``make_pipeline_loss_fn`` ``:2328``; its
last-stage loss ``_stage_ce`` ``:251`` is ``models.transformer.head_loss``).
The JAX ``unstack_stage_layers`` (``:220``) has no counterpart: the port's
stages are views of the model's own blocks, not stacked copies, so the
gradients land in the model's ``.grad`` directly.

All D stages run in one process on one device, in lockstep over the
compiled ``[T, D, 17]`` tick table (the JAX ``tick``, ``:1244-1460``, with
``comm_overlap="none"``). Each tick, each device banks last tick's
arrivals on the four channels (+1 forward, column 0; -1 backward, 4; -1
forward, 14; +1 backward, 16), runs its forward unit (columns 1-3) and
its local forward hop (13), its backward unit (5-8) and local backward
hop (15), then its weight-gradient unit (9-12); each hand-over goes to
its receiver's mailbox at the end of the tick by the route of the stage
that sent it (the single-process lockstep transport of ``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.transformer import (Transformer, body_apply, embed_apply,
                                  head_loss)
from ..ops.layers import fold_seed, global_pad_scale
from ..utils.config import ModelConfig, ScheduleConfig, resolve_device
from .schedules import (CHANNELS, COL_BWD_ASLOT, COL_BWD_GSLOT,
                        COL_BWD_LOCAL_SLOT, COL_BWD_M, COL_BWD_V,
                        COL_FWD_LOCAL_SLOT, COL_FWD_M, COL_FWD_SLOT,
                        COL_FWD_V, COL_W_ASLOT, COL_W_GSLOT, COL_W_M,
                        COL_W_V, F, Action, _allocate_slots, bfs_order,
                        bwd_route, compile_schedule, fwd_route,
                        placement_stage_of, schedule_ticks)

# mesh axes of the JAX executor that the single-device port does not run
_AXIS_ITEMS = {
    "data": "ROADMAP.md Queue 1, item 8 (torch.distributed transport)",
    "model": "ROADMAP.md Queue 1, item 11 (tensor parallelism)",
    "seq": "ROADMAP.md Queue 1, item 11 (sequence parallelism)",
    "expert": "ROADMAP.md Queue 1, item 11 (expert parallelism)",
}


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
                f"a {name!r} axis of size {size} is not ported yet: "
                f"{_AXIS_ITEMS[name]}")


def make_pipeline_grad_fn(cfg: ModelConfig, sched: ScheduleConfig,
                          n_stages: int, remat_backward=None,
                          device="cuda", axes: Optional[Dict[str, int]] = None
                          ) -> Callable[..., torch.Tensor]:
    """``(model, tokens, targets) -> loss``: one pipelined forward and
    backward over ``n_stages`` (D) lockstep devices under ``sched``, with
    the gradients accumulated into the parameters' ``.grad`` (zero them
    first). ``tokens``/``targets`` are [B, S] with B divisible by
    ``sched.n_microbatches`` (M); microbatches split dim 0.

    With ``cfg.dropout > 0`` the function takes a fourth argument, the
    step's seed (an int; the JAX step's PRNG key), and runs train-mode
    dropout. Microbatch ``m`` runs under ``fold_seed(step_seed, m)`` and
    each layer folds its global index into that (the JAX contract,
    ``parallel/pipeline.py:604-607``), so the masks depend only on (step
    seed, microbatch, global layer, site), never on (D, V) or the
    placement: every schedule and stage split computes the loss and
    gradients of :func:`..models.transformer.transformer_loss` averaged
    over the microbatches with ``rng = fold_seed(step_seed, m)``. Every
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

    Raises ``NotImplementedError`` for any ``axes`` entry (``"data"``,
    ``"model"``, ``"seq"``, ``"expert"``) of size > 1, naming the
    ``ROADMAP.md`` item that ports it.
    """
    device = resolve_device(device)
    _check_axes(axes)
    D, V, M = n_stages, sched.n_virtual, sched.n_microbatches
    cs = compile_schedule(sched.name, D, V, M)  # raises on a bad (D, V, M)
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
    plain = D == 1 and remat_backward is None and not split
    remat = remat_backward is None or bool(remat_backward)
    table = cs.table
    inv = 1.0 / M
    lps = cfg.n_layers // S
    use_dropout = cfg.dropout > 0.0

    def stage_of(d, v):
        return placement_stage_of(placement, d, v, D)

    def grad_fn(model: Transformer, tokens, targets,
                step_seed: Optional[int] = None) -> torch.Tensor:
        if use_dropout and step_seed is None:
            raise ValueError(f"dropout={cfg.dropout} > 0: pass the step's "
                             f"seed as the fourth argument")
        seed = step_seed if use_dropout else None
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
            return embed_apply(cfg, model, toks[m], rng=mb_rng(m))

        pad_scale = (global_pad_scale(targets, cfg.pad_token_id, M)
                     if cfg.pad_token_id is not None else None)
        loss = torch.zeros((), dtype=torch.float32, device=device)
        if plain:
            with torch.enable_grad():
                for m in range(M):
                    y = body_apply(cfg, model.layers, embed(m), mb_rng(m))
                    ce = head_loss(cfg, model, y, tgts[m], pad_scale)
                    (ce * inv).backward()
                    loss += ce.detach()
            return loss * inv

        stages = stack_stage_layers(model.layers, D, V, placement)

        def stage_body(d, v, x, m):
            """Device d's chunk v on microbatch m; its first layer's global
            index keys the dropout streams."""
            return body_apply(cfg, stages[d][v], x, mb_rng(m),
                              stage_of(d, v) * lps)

        act: List[List] = [[None] * cs.n_act_slots for _ in range(D)]
        grad: List[List] = [[None] * cs.n_grad_slots for _ in range(D)]
        graphs: List[Dict] = [dict() for _ in range(D)]  # stored: slot -> (x, y)
        bufs = {"act": act, "grad": grad}
        # mailboxes: last tick's hand-overs per channel and receiving device
        inbox = {(buf, off): [None] * D for buf, off, _ in CHANNELS}

        def forward_unit(d, row):
            v, m, slot = (int(row[c]) for c in (COL_FWD_V, COL_FWD_M,
                                                 COL_FWD_SLOT))
            s = stage_of(d, v)
            if remat:
                with torch.no_grad():
                    x = embed(m) if s == 0 else act[d][slot]
                    act[d][slot] = x  # the saved stage input
                    y = stage_body(d, v, x, m)
            else:
                with torch.enable_grad():
                    x = embed(m) if s == 0 \
                        else act[d][slot].detach().requires_grad_()
                    act[d][slot] = x
                    y = stage_body(d, v, x, m)
                graphs[d][slot] = (x, y)
                y = y.detach()
            return s, y

        def objective(d, v, s, m, y, gslot):
            """(loss or None, output, its cotangent) to back-propagate from
            stage s: on the last stage its microbatch's loss and the loss
            / M, else the body output and the stored incoming
            cotangent."""
            if s == S - 1:
                ce = head_loss(cfg, model, y, tgts[m], pad_scale)
                return ce, ce * inv, None
            return None, y, grad[d][gslot]

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
                    ce, out, g = objective(d, v, s, m, stage_body(d, v, x, m),
                                           gslot)
                    gx, = torch.autograd.grad(out, x, grad_outputs=g)
                    if ce is not None:
                        loss += ce.detach()
                    return s, gx
                if remat:
                    # stage 0 recomputes its embedding under autograd, so
                    # the input's gradient flows on into the tables
                    x = embed(m) if s == 0 \
                        else act[d][aslot].detach().requires_grad_()
                    y = stage_body(d, v, x, m)
                else:
                    x, y = graphs[d].pop(aslot)
                ce, out, g = objective(d, v, s, m, y, gslot)
                torch.autograd.backward(out, g)
                if ce is not None:
                    loss += ce.detach()
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
                _, out, g = objective(d, v, s, m, stage_body(d, v, x, m),
                                      gslot)
                if s == S - 1:
                    params += list(model.norm.parameters()) + (
                        [model.tok] if cfg.tie_embeddings
                        else list(model.out.parameters()))
                torch.autograd.backward(out, g, inputs=params)
            release(d, aslot, gslot, s)

        for t in range(table.shape[0]):
            sends = {key: [None] * D for key in inbox}
            for d in range(D):
                row = table[t, d]
                for buf, off, col in CHANNELS:
                    if row[col] >= 0:
                        bufs[buf][d][row[col]] = inbox[(buf, off)][d]
                if row[COL_FWD_M] >= 0:
                    s, y = forward_unit(d, row)
                    if s < S - 1:
                        route = fwd_route(placement, s, D)
                        if route == "local":
                            act[d][row[COL_FWD_LOCAL_SLOT]] = y
                        else:
                            sends[("act", int(route))][d] = y
                if row[COL_BWD_M] >= 0:
                    s, gx = backward_unit(d, row)
                    if s > 0:
                        route = bwd_route(placement, s, D)
                        if route == "local":
                            grad[d][row[COL_BWD_LOCAL_SLOT]] = gx
                        else:
                            sends[("grad", int(route))][d] = gx
                if row[COL_W_M] >= 0:
                    wgrad_unit(d, row)
            inbox = {(buf, off): [sends[(buf, off)][(d - off) % D]
                                  for d in range(D)] for buf, off in inbox}
        return loss * inv

    return grad_fn


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
    return table, max(n_slots, 1)


def make_pipeline_loss_fn(cfg: ModelConfig, sched: ScheduleConfig,
                          n_stages: int, device="cuda",
                          axes: Optional[Dict[str, int]] = None
                          ) -> Callable[..., torch.Tensor]:
    """``(model, tokens, targets) -> loss``: the forward-only pipelined
    loss over ``n_stages`` (D) lockstep devices, the evaluation twin of
    :func:`make_pipeline_grad_fn` (the JAX ``make_pipeline_loss_fn``).

    It runs the rows of :func:`_fwd_tick_table` (every schedule's forward
    order is fill-drain over ``sched.n_virtual`` wrap-placed chunks) under
    ``torch.no_grad()``, in eval mode (no dropout), through the training
    executor's ``embed_apply`` / ``body_apply`` / ``head_loss``: no
    backward, no recompute, and no autograd graph (the kernels' saved
    tensors go with their forward). The last stage takes each
    microbatch's token-mean cross entropy; the loss is the mean over the
    M microbatches, the single-device ``transformer_loss`` of the whole
    batch. Other mesh axes raise as :func:`make_pipeline_grad_fn`'s do.
    """
    device = resolve_device(device)
    _check_axes(axes)
    D, V, M = n_stages, sched.n_virtual, sched.n_microbatches
    S = D * V
    if cfg.n_layers % S != 0:
        raise ValueError(f"n_layers={cfg.n_layers} must divide evenly into "
                         f"{S} stages")
    table, n_slots = _fwd_tick_table(D, V, M)
    lps = cfg.n_layers // S

    @torch.no_grad()
    def loss_fn(model: Transformer, tokens, targets) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=device).long()
        targets = torch.as_tensor(targets, device=device).long()
        b, seq = tokens.shape
        if b % M:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_microbatches={M}")
        toks = tokens.view(M, b // M, seq)
        tgts = targets.view(M, b // M, seq)
        pad_scale = (global_pad_scale(targets, cfg.pad_token_id, M)
                     if cfg.pad_token_id is not None else None)
        stages = stack_stage_layers(model.layers, D, V)
        act: List[List] = [[None] * n_slots for _ in range(D)]
        fwd_in: List = [None] * D
        loss = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(table.shape[0]):
            send: List = [None] * D
            for d in range(D):
                store, v, m, src = (int(c) for c in table[t, d])
                if store >= 0:
                    act[d][store] = fwd_in[d]
                if m < 0:
                    continue
                s = placement_stage_of("wrap", d, v, D)
                if s == 0:
                    x = embed_apply(cfg, model, toks[m])
                else:
                    x, act[d][src] = act[d][src], None  # read once
                y = body_apply(cfg, stages[d][v], x, None, s * lps)
                if s == S - 1:
                    loss += head_loss(cfg, model, y, tgts[m], pad_scale)
                else:
                    send[d] = y
            fwd_in = [send[(d - 1) % D] for d in range(D)]
        return loss / M

    return loss_fn
