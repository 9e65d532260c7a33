"""Pipeline-schedule IR: per-device action orders, tick scheduling and the
``[T, D, 17]`` tick tables the executor runs.

The port's own copy of the JAX package's
``distributed_training_with_pipeline_parallelism_tpu/parallel/schedules.py``:
the custom-schedule registry (``:47-96``), the orders (``:118-424``: GPipe,
1F1B, Interleaved-1F1B, BFS and the zero-bubble ZBH1 and ZBV with their
split backward), the placements (``:427-455``), ``schedule_ticks``
``:457``, ``validate_order`` ``:526``, the column layout and routes
(``:588-622``), ``CompiledSchedule`` ``:625``, ``_allocate_slots``
``:656``, ``compile_schedule``/``compile_order`` ``:683``/``:705``,
``verify_table`` ``:829``, ``table_unit_activity`` ``:1483``, the ring
classifier ``overlap_bank_stages`` (``:1523-1617``), and the
bubble and time models (``:1636-1826``). The tables are bit-identical to
the JAX package's (``tests/test_torch_schedules.py``,
``tests/test_torch_zero_bubble.py``). Not ported: the schedule artifacts
and their pins (``:975-1340``), which stand on ``analysis/table_check.py``
(``ROADMAP.md`` Queue 1, item 12), and the phase compression
(``:1348-1540``), XLA compile economics whose counterpart here is CUDA
graphs over the tick executor (Queue 2).

1. **Action orders**: for each device an ordered list of
   ``Action(stage, op, microbatch)``; ``op`` is F, B (the full backward,
   or the input-gradient half under a split schedule) or W (the
   weight-gradient half).
2. **Tick scheduling**: an ASAP list scheduler gives each action a tick:
   one action per device per tick, list order per device, and one tick of
   transfer latency for a dependency across devices.
3. **Tick tables**: dense int32 arrays, one row per (tick, device), naming
   the slots each unit reads and writes and the route of each hand-over.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

F = "F"
B = "B"  # full backward, or input-grad (dgrad) only under a split schedule
W = "W"  # weight-grad (wgrad): split schedules only

SPLIT_BACKWARD_SCHEDULES = frozenset({"ZBH1", "ZBV"})

# User-registered schedules: name -> (order_fn, split_backward), with
# ``order_fn(n_devices, n_virtual, n_microbatches) -> List[List[Action]]``.
_CUSTOM_SCHEDULES: Dict[str, Tuple[object, bool]] = {}


def register_schedule(name: str, order_fn, split_backward: bool = False,
                      overwrite: bool = False) -> None:
    """Register a custom pipeline schedule under ``name``.

    ``order_fn(n_devices, n_virtual, n_microbatches)`` returns per-device
    action lists of :class:`Action` (wrap placement: device(stage) =
    stage % n_devices). The order is validated, deadlock-checked,
    tick-scheduled, slot-allocated and verified by the built-ins'
    machinery and runs on the unmodified executor. With
    ``split_backward`` the order emits dgrad ``B`` + wgrad ``W`` pairs
    (no ``B`` on stage 0)."""
    if not overwrite and (name in BUILTIN_SCHEDULE_NAMES
                          or name in _CUSTOM_SCHEDULES):
        raise ScheduleError(f"schedule {name!r} already exists")
    if name in BUILTIN_SCHEDULE_NAMES:
        raise ScheduleError(f"cannot overwrite built-in schedule {name!r}")
    _CUSTOM_SCHEDULES[name] = (order_fn, split_backward)


def unregister_schedule(name: str) -> None:
    _CUSTOM_SCHEDULES.pop(name, None)


def is_split_backward(name: str) -> bool:
    if name in _CUSTOM_SCHEDULES:
        return _CUSTOM_SCHEDULES[name][1]
    return name in SPLIT_BACKWARD_SCHEDULES


def is_custom(name: str) -> bool:
    return name in _CUSTOM_SCHEDULES


def schedule_names() -> Tuple[str, ...]:
    return BUILTIN_SCHEDULE_NAMES + tuple(_CUSTOM_SCHEDULES)


BUILTIN_SCHEDULE_NAMES = ("GPipe", "1F1B", "Interleaved1F1B", "ZBH1", "BFS",
                          "ZBV")


def check_schedule_name(name: str) -> None:
    """A built-in or registered schedule, else ValueError listing every
    option."""
    if name not in schedule_names():
        raise ValueError(f"unknown schedule {name!r}; expected one of "
                         f"{schedule_names()}")


def schedule_placement(name: str) -> str:
    return "vshape" if name == "ZBV" else "wrap"


@dataclasses.dataclass(frozen=True)
class Action:
    stage: int  # global stage index in [0, n_stages)
    op: str  # F, B or W
    microbatch: int


class ScheduleError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Per-device action orders
# ---------------------------------------------------------------------------


def gpipe_order(n_devices: int, n_microbatches: int) -> List[List[Action]]:
    """Fill-drain: per stage, M forwards then M backwards, both in
    increasing microbatch order."""
    orders = []
    for d in range(n_devices):
        acts = [Action(d, F, m) for m in range(n_microbatches)]
        acts += [Action(d, B, m) for m in range(n_microbatches)]
        orders.append(acts)
    return orders


def one_f_one_b_order(n_devices: int, n_microbatches: int) -> List[List[Action]]:
    """1F1B: a warmup of (D-1-d) forwards, then alternating F/B, then the
    remaining backwards. Requires M >= D."""
    D, M = n_devices, n_microbatches
    if M < D:
        raise ScheduleError(f"1F1B requires n_microbatches >= n_devices ({M} < {D})")
    orders = []
    for d in range(D):
        warmup = min(M, D - 1 - d)
        acts = [Action(d, F, m) for m in range(warmup)]
        nf, nb = warmup, 0
        while nf < M:  # steady state: one forward, one backward
            acts.append(Action(d, F, nf))
            nf += 1
            acts.append(Action(d, B, nb))
            nb += 1
        acts += [Action(d, B, m) for m in range(nb, M)]
        orders.append(acts)
    return orders


def interleaved_order(n_devices: int, n_virtual: int,
                      n_microbatches: int) -> List[List[Action]]:
    """Interleaved 1F1B over V virtual stages per device (Megatron-LM
    style): forwards in rounds of ``M // num_rounds`` microbatches per
    virtual stage, warmup ``(V-1) * mb_per_round + 2 * (D-1-d)``, then
    one-forward-one-backward, backward virtual order reversed. V == 1 is
    plain 1F1B."""
    D, V, M = n_devices, n_virtual, n_microbatches
    if V == 1:
        return one_f_one_b_order(D, M)
    num_rounds = max(1, M // D)
    if M % num_rounds != 0:
        raise ScheduleError(
            f"Interleaved1F1B requires n_microbatches % num_rounds == 0 "
            f"(M={M}, num_rounds={num_rounds})")
    mbpr = M // num_rounds  # microbatches per round

    def fwd_vm(i: int) -> Tuple[int, int]:
        return (i // mbpr) % V, (i // (mbpr * V)) * mbpr + (i % mbpr)

    def bwd_vm(j: int) -> Tuple[int, int]:
        return V - 1 - ((j // mbpr) % V), (j // (mbpr * V)) * mbpr + (j % mbpr)

    total = M * V
    orders = []
    for d in range(D):
        warmup = min(total, (V - 1) * mbpr + 2 * (D - 1 - d))
        acts = []
        nf = nb = 0
        for _ in range(warmup):
            v, m = fwd_vm(nf)
            acts.append(Action(v * D + d, F, m))
            nf += 1
        while nf < total:  # steady state
            v, m = fwd_vm(nf)
            acts.append(Action(v * D + d, F, m))
            nf += 1
            v, m = bwd_vm(nb)
            acts.append(Action(v * D + d, B, m))
            nb += 1
        while nb < total:  # cooldown
            v, m = bwd_vm(nb)
            acts.append(Action(v * D + d, B, m))
            nb += 1
        orders.append(acts)
    return orders


def bfs_order(n_devices: int, n_virtual: int,
              n_microbatches: int) -> List[List[Action]]:
    """Breadth-first: GPipe over V virtual stages per device; all forwards
    in (virtual, microbatch) order, then all backwards with the virtual
    order reversed. V == 1 is GPipe."""
    D, V, M = n_devices, n_virtual, n_microbatches
    orders = []
    for d in range(D):
        acts = [Action(v * D + d, F, m) for v in range(V) for m in range(M)]
        acts += [Action(v * D + d, B, m)
                 for v in reversed(range(V)) for m in range(M)]
        orders.append(acts)
    return orders


def _zb_greedy_order(D: int, M: int, S: int, device_of,
                     live_cap_of, label: str) -> List[List[Action]]:
    """The greedy priority synthesis of the zero-bubble schedules: at each
    tick every device takes its highest-priority ready action, dgrad
    ``B`` first (it unblocks a neighbour), then ``F``, then ``W``, deeper
    stages first, then older microbatches, so weight-gradient work sinks
    into the ticks that would otherwise be bubbles. Stage 0 has no ``B``
    (its ``W`` carries the whole parameter and embedding backward);
    ``live_cap_of(d)`` bounds device d's in-flight forwards (F count minus
    W count: W releases the saved input)."""
    remaining = {(s, F, m) for s in range(S) for m in range(M)}
    remaining |= {(s, W, m) for s in range(S) for m in range(M)}
    remaining |= {(s, B, m) for s in range(1, S) for m in range(M)}
    done: Dict[Tuple[int, str, int], int] = {}
    orders: List[List[Action]] = [[] for _ in range(D)]
    t = 0
    limit = 8 * len(remaining) + 64

    def ready(s, op, m, now):
        if op == F:
            if s == 0:
                return True
            d = done.get((s - 1, F, m))
            return d is not None and d + 1 <= now
        if (s, F, m) not in done:
            return False
        if op == W:
            if s == 0:
                d = done.get((1, B, m))
                return d is not None and d + 1 <= now
            if s == S - 1:
                return True
            return (s, B, m) in done
        if s == S - 1:  # dgrad B
            return True
        d = done.get((s + 1, B, m))
        return d is not None and d + 1 <= now

    def priority(s, op, m):
        return ({B: 0, F: 1, W: 2}[op], -s, m)

    n_f = [0] * D
    n_w = [0] * D
    while remaining:
        if t > limit:
            raise ScheduleError(f"{label} synthesis deadlocked")
        for d in range(D):
            cands = sorted(
                ((s, op, m) for (s, op, m) in remaining
                 if device_of(s) == d and ready(s, op, m, t)
                 and not (op == F and n_f[d] - n_w[d] >= live_cap_of(d))),
                key=lambda a: priority(*a))
            if cands:
                s, op, m = cands[0]
                remaining.discard((s, op, m))
                done[(s, op, m)] = t
                orders[d].append(Action(s, op, m))
                if op == F:
                    n_f[d] += 1
                elif op == W:
                    n_w[d] += 1
        t += 1
    return orders


def zb_h1_order(n_devices: int, n_microbatches: int) -> List[List[Action]]:
    """ZB-H1 (Qi et al., arXiv:2401.10241): the backward split into an
    input-gradient ``B`` on the critical path and a weight-gradient ``W``
    that fills bubble ticks. One stage per device; in-flight cap
    ``2D - d``, which meets the ``3M + D - 1`` makespan of
    :func:`analytic_bubble_fraction`."""
    D, M = n_devices, n_microbatches
    if D < 2:
        raise ScheduleError("ZBH1 requires n_devices >= 2 (loss lives on the "
                            "last stage's dgrad unit, which stage 0 elides)")
    if M < D:
        raise ScheduleError(f"ZBH1 requires n_microbatches >= n_devices ({M} < {D})")
    return _zb_greedy_order(D, M, D, lambda s: s,
                            lambda d: 2 * D - d, "ZBH1")


def zb_v_order(n_devices: int, n_microbatches: int) -> List[List[Action]]:
    """ZB-V (Qi et al., arXiv:2401.10241 §4): two chunks per device in the
    V placement (device d holds stages d and 2D-1-d, so the last forward
    stage and the first backward stage share device 0) with the split
    backward; the greedy synthesis under an in-flight cap of 2D + 2 per
    device."""
    D, M = n_devices, n_microbatches
    if D < 2:
        raise ScheduleError("ZBV requires n_devices >= 2")
    if M < 2 * D:
        raise ScheduleError(
            f"ZBV requires n_microbatches >= 2 * n_devices ({M} < {2 * D}); "
            f"fewer microbatches cannot fill the V's steady state")
    return _zb_greedy_order(D, M, 2 * D,
                            lambda s: placement_device_of("vshape", s, D),
                            lambda d: 2 * D + 2, "ZBV")


def build_order(name: str, n_devices: int, n_virtual: int,
                n_microbatches: int) -> List[List[Action]]:
    if name in _CUSTOM_SCHEDULES:
        return _CUSTOM_SCHEDULES[name][0](n_devices, n_virtual, n_microbatches)
    if name == "ZBV":
        if n_virtual != 2:
            raise ScheduleError("ZBV runs exactly 2 chunks per device "
                                "(set n_virtual=2)")
        return zb_v_order(n_devices, n_microbatches)
    if name in ("ZBH1", "GPipe", "1F1B") and n_virtual != 1:
        raise ScheduleError(f"{name} supports a single stage per device")
    if name == "ZBH1":
        return zb_h1_order(n_devices, n_microbatches)
    if name == "GPipe":
        return gpipe_order(n_devices, n_microbatches)
    if name == "1F1B":
        return one_f_one_b_order(n_devices, n_microbatches)
    if name == "Interleaved1F1B":
        return interleaved_order(n_devices, n_virtual, n_microbatches)
    if name == "BFS":
        return bfs_order(n_devices, n_virtual, n_microbatches)
    raise ScheduleError(f"unknown schedule {name!r}")


# ---------------------------------------------------------------------------
# Stage placements
# ---------------------------------------------------------------------------
#
# "wrap" (the reference's ``stage = rank + world_size * v``): device(s) =
# s % D; every hand-over rides +1 (forward) / -1 (backward) on the ring.
# "vshape" (ZB-V): device(s) = s for s < D, else 2D-1-s. The s = D-1 -> D
# hand-over stays on the device; chunk-1 forwards ride -1, their
# cotangents +1.


def placement_device_of(placement: str, stage: int, D: int) -> int:
    if placement == "wrap":
        return stage % D
    if placement == "vshape":
        return stage if stage < D else 2 * D - 1 - stage
    raise ScheduleError(f"unknown placement {placement!r}")


def placement_chunk_of(placement: str, stage: int, D: int) -> int:
    """The local chunk v with ``placement_stage_of(device, v) == stage``."""
    if placement == "wrap":
        return stage // D
    if placement == "vshape":
        return 0 if stage < D else 1
    raise ScheduleError(f"unknown placement {placement!r}")


def placement_stage_of(placement: str, d: int, v: int, D: int) -> int:
    if placement == "wrap":
        return v * D + d
    if placement == "vshape":
        return d if v == 0 else 2 * D - 1 - d
    raise ScheduleError(f"unknown placement {placement!r}")


# ---------------------------------------------------------------------------
# Tick scheduling (ASAP list scheduler)
# ---------------------------------------------------------------------------


def schedule_ticks(orders: List[List[Action]], n_devices: int, n_virtual: int,
                   placement: str = "wrap") -> Tuple[Dict[Action, int], int]:
    """Assign each action a tick; returns (action -> tick, makespan).

    One action per device per tick, per-device list order; F(s, m) needs
    F(s-1, m) done at least one tick earlier, B(s, m) needs F(s, m) and
    B(s+1, m) done at least one tick earlier, and W(s, m) needs its own
    B(s, m) (stage 0, which has none: B(1, m) one tick earlier; the last
    stage: F only). A deadlocked order raises instead of hanging."""
    D = n_devices
    S = D * n_virtual
    n_actions = sum(len(o) for o in orders)
    done: Dict[Action, int] = {}
    ptr = [0] * D
    t = 0
    limit = 4 * n_actions + 4 * S + 16

    def ready(a: Action, now: int) -> bool:
        if a.op == F:
            if a.stage == 0:
                return True
            dep = Action(a.stage - 1, F, a.microbatch)
            return dep in done and done[dep] + 1 <= now
        if Action(a.stage, F, a.microbatch) not in done:
            return False
        if a.op == W:
            if a.stage == 0:
                dep = Action(1, B, a.microbatch)
                return dep in done and done[dep] + 1 <= now
            if a.stage == S - 1:
                return True
            return Action(a.stage, B, a.microbatch) in done
        if a.stage == S - 1:
            return True
        dep = Action(a.stage + 1, B, a.microbatch)
        return dep in done and done[dep] + 1 <= now

    while any(ptr[d] < len(orders[d]) for d in range(D)):
        if t > limit:
            raise ScheduleError("schedule deadlocked: no progress within tick limit")
        for d in range(D):
            if ptr[d] >= len(orders[d]):
                continue
            a = orders[d][ptr[d]]
            if placement_device_of(placement, a.stage, D) != d:
                raise ScheduleError(f"action {a} listed on device {d}")
            if ready(a, t):
                done[a] = t
                ptr[d] += 1
        t += 1
    return done, t


def validate_order(orders: List[List[Action]], n_devices: int, n_virtual: int,
                   n_microbatches: int, split_backward: bool = False,
                   placement: str = "wrap") -> None:
    """Every (stage, microbatch) has exactly one F and one full B (under a
    split schedule: one W, and one dgrad B on every stage but 0), F
    precedes B/W on its device, W follows its dgrad twin (whose saved
    slots it reads), and the tick scheduler completes. Messages carry a
    (device, index) location prefix."""
    S = n_devices * n_virtual
    seen: Dict[Action, int] = {}
    for d, order in enumerate(orders):
        pos = {}
        for i, a in enumerate(order):
            if a in seen:
                raise ScheduleError(
                    f"(device {d}, index {i}): duplicate action {a} "
                    f"(first listed on device {seen[a]})")
            seen[a] = d
            pos[a] = i
        for a in order:
            if a.op in (B, W):
                fa = Action(a.stage, F, a.microbatch)
                if fa not in pos or pos[fa] > pos[a]:
                    raise ScheduleError(
                        f"(device {d}, index {pos[a]}): backward before "
                        f"forward: {a}")
            if a.op == W and a.stage >= 1:
                ba = Action(a.stage, B, a.microbatch)
                if ba not in pos or pos[ba] > pos[a]:
                    raise ScheduleError(
                        f"(device {d}, index {pos[a]}): {a} precedes its "
                        f"dgrad twin {ba}, whose saved slots it aliases")
    want = {Action(s, F, m) for s in range(S) for m in range(n_microbatches)}
    if split_backward:
        want |= {Action(s, W, m) for s in range(S) for m in range(n_microbatches)}
        want |= {Action(s, B, m) for s in range(1, S) for m in range(n_microbatches)}
    else:
        want |= {Action(s, B, m) for s in range(S) for m in range(n_microbatches)}
    if set(seen) != want:
        raise ScheduleError(
            f"action set mismatch: {len(seen)} actions vs expected {len(want)} "
            f"(missing {list(want - set(seen))[:4]}, "
            f"extra {list(set(seen) - want)[:4]})")
    schedule_ticks(orders, n_devices, n_virtual,
                   placement=placement)  # raises on deadlock


# ---------------------------------------------------------------------------
# Tick tables
# ---------------------------------------------------------------------------

# Columns of the per-(tick, device) table; -1 means "no-op this tick".
COL_STORE_F_SLOT = 0  # store +1-ring fwd arrival -> act_buf[slot]
COL_FWD_V, COL_FWD_M, COL_FWD_SLOT = 1, 2, 3  # forward unit: (v, m), input slot
COL_STORE_B_SLOT = 4  # store -1-ring grad arrival -> grad_buf[slot]
COL_BWD_V, COL_BWD_M = 5, 6  # backward unit: (v, m)
COL_BWD_ASLOT, COL_BWD_GSLOT = 7, 8  # saved-input slot, incoming-grad slot
COL_W_V, COL_W_M = 9, 10  # weight-grad unit (split schedules): (v, m)
COL_W_ASLOT, COL_W_GSLOT = 11, 12  # its saved-input slot, incoming-grad slot
# V-placement routes (always -1 under the wrap placement)
N_COLS_CLASSIC = 13  # the wrap-placement-only column count
COL_FWD_LOCAL_SLOT = 13  # fwd output -> own act_buf[slot] (same-device hop)
COL_STORE_F_NEG_SLOT = 14  # store -1-ring fwd arrival -> act_buf[slot]
COL_BWD_LOCAL_SLOT = 15  # bwd cotangent -> own grad_buf[slot]
COL_STORE_B_POS_SLOT = 16  # store +1-ring grad arrival -> grad_buf[slot]
N_COLS = 17

# The four hand-over channels as (buffer, ring offset, bank column), in
# the executor's bank order: device d receives on a channel what device
# (d - offset) % D sent on it, and banks it into the column's slot.
CHANNELS = (("act", +1, COL_STORE_F_SLOT), ("grad", -1, COL_STORE_B_SLOT),
            ("act", -1, COL_STORE_F_NEG_SLOT),
            ("grad", +1, COL_STORE_B_POS_SLOT))


# The ring channels in the bank order of ``CHANNELS``, as (bank column,
# buffer). Under ``comm_overlap="ring"`` an arrival waits in its receive
# buffer across the tick until its bank stage, so the hop that carries it
# overlaps the tick's earlier units (the JAX double-buffered discipline).
OVERLAP_CHANNELS: Tuple[Tuple[int, str], ...] = tuple(
    (col, buf) for buf, _, col in CHANNELS)

# Bank stages: stage k banks just before unit k, units ordered F (0), B
# (1), W (2); stage 3 is the end of the tick. Stage 0 is the lockstep.
BANK_BEFORE_F, BANK_BEFORE_B, BANK_BEFORE_W, BANK_END = 0, 1, 2, 3


def overlap_bank_stages(table: np.ndarray) -> np.ndarray:
    """The latest safe bank stage per (tick, ring channel): ``[T, 4]``
    int8, channels in :data:`OVERLAP_CHANNELS` order (the JAX function,
    bit-identical). A channel's arrival must be banked before the first
    unit of its tick, on any device, that reads or writes the slot it
    banks into (F: its input slot and the local forward slot; B: the
    saved-input, incoming-gradient and local backward slots; W: its
    saved-input and gradient slots); with no such unit it banks at the
    end of the tick. Banking earlier is always lockstep-correct, so
    taking the minimum over devices keeps every executor that banks at
    these stages bit-identical to the lockstep one. Two channels of one
    buffer that bank into the same slot in one tick take the same stage,
    so their lockstep order decides."""
    table = np.asarray(table)
    if table.ndim != 3 or table.shape[2] < N_COLS:
        raise ScheduleError(
            f"overlap_bank_stages needs a [T, D, {N_COLS}] training table, "
            f"got shape {table.shape}")
    T, D, _ = table.shape
    out = np.full((T, len(OVERLAP_CHANNELS)), BANK_END, dtype=np.int8)
    f_on = table[:, :, COL_FWD_M] >= 0
    b_on = table[:, :, COL_BWD_M] >= 0
    w_on = table[:, :, COL_W_M] >= 0
    # (stage, active mask, slot column, buffer): a write pins the bank
    # before its unit as a read does
    touches = (
        (BANK_BEFORE_F, f_on, COL_FWD_SLOT, "act"),
        (BANK_BEFORE_F, table[:, :, COL_FWD_LOCAL_SLOT] >= 0,
         COL_FWD_LOCAL_SLOT, "act"),
        (BANK_BEFORE_B, b_on, COL_BWD_ASLOT, "act"),
        (BANK_BEFORE_B, b_on, COL_BWD_GSLOT, "grad"),
        (BANK_BEFORE_B, table[:, :, COL_BWD_LOCAL_SLOT] >= 0,
         COL_BWD_LOCAL_SLOT, "grad"),
        (BANK_BEFORE_W, w_on, COL_W_ASLOT, "act"),
        (BANK_BEFORE_W, w_on, COL_W_GSLOT, "grad"),
    )
    for ci, (bank_col, kind) in enumerate(OVERLAP_CHANNELS):
        slots = table[:, :, bank_col]
        banked = slots >= 0
        if not banked.any():
            continue
        stage = np.full((T, D), BANK_END, dtype=np.int8)
        for st, on, slot_col, k in touches:
            if k != kind:
                continue
            hit = banked & on & (table[:, :, slot_col] == slots)
            stage = np.where(hit, np.minimum(stage, st), stage)
        stage = np.where(banked, stage, BANK_END)
        out[:, ci] = stage.min(axis=1)
    for i, j in ((0, 2), (1, 3)):
        si = table[:, :, OVERLAP_CHANNELS[i][0]]
        sj = table[:, :, OVERLAP_CHANNELS[j][0]]
        clash = ((si >= 0) & (sj >= 0) & (si == sj)).any(axis=1)
        if clash.any():
            m = np.minimum(out[:, i], out[:, j])
            out[:, i] = np.where(clash, m, out[:, i])
            out[:, j] = np.where(clash, m, out[:, j])
    return out

def fwd_route(placement: str, s: int, D: int) -> str:
    """Where F(s)'s output travels to reach stage s+1: '+1' ring, '-1'
    ring, or 'local' (same device)."""
    if placement == "wrap":
        return "+1"
    if s == D - 1:
        return "local"  # the V's turning point
    return "+1" if s < D - 1 else "-1"


def bwd_route(placement: str, s: int, D: int) -> str:
    """Where B(s)'s cotangent travels to reach stage s-1."""
    if placement == "wrap":
        return "-1"
    if s == D:
        return "local"
    return "+1" if s > D else "-1"


@dataclasses.dataclass(frozen=True)
class CompiledSchedule:
    name: str
    n_devices: int
    n_virtual: int
    n_microbatches: int
    table: np.ndarray  # [T, D, N_COLS] int32
    makespan: int
    ticks: Dict[Action, int]
    n_act_slots: int
    n_grad_slots: int
    # True when B actions are dgrad-only and W actions carry the parameter
    # gradients; captured at compile time, so a later unregister cannot
    # change a compiled schedule's meaning
    split_backward: bool = False
    # "wrap" (stage = v*D + d) or "vshape" (ZBV: device d holds stages d
    # and 2D-1-d)
    placement: str = "wrap"

    @property
    def n_stages(self) -> int:
        return self.n_devices * self.n_virtual

    @property
    def uses_reverse_routes(self) -> bool:
        """True when the table uses the -1 fwd / +1 bwd channels or local
        hops."""
        return bool(np.any(self.table[:, :, N_COLS_CLASSIC:] >= 0))


def _allocate_slots(events: List[Tuple[int, int, object]]
                    ) -> Tuple[Dict[object, int], int]:
    """Greedy interval slot allocation over (store_tick, release_tick, key):
    a slot is written at ``store_tick`` and free for stores from
    ``release_tick + 1``. Returns (key -> slot, n_slots)."""
    by_store = sorted(events, key=lambda e: (e[0], e[1]))
    free: List[int] = []
    in_use: List[Tuple[int, int]] = []  # (release_tick, slot)
    n_slots = 0
    assign: Dict[object, int] = {}
    for store, release, key in by_store:
        while in_use and in_use[0][0] < store:
            _, slot = heapq.heappop(in_use)
            heapq.heappush(free, slot)
        if free:
            slot = heapq.heappop(free)
        else:
            slot = n_slots
            n_slots += 1
        assign[key] = slot
        heapq.heappush(in_use, (release, slot))
    return assign, n_slots


def compile_schedule(name: str, n_devices: int, n_virtual: int,
                     n_microbatches: int) -> CompiledSchedule:
    """Generate, validate and lower a schedule to its verified tick table."""
    orders = build_order(name, n_devices, n_virtual, n_microbatches)
    return compile_order(name, orders, n_devices, n_virtual, n_microbatches,
                         split_backward=is_split_backward(name),
                         placement=schedule_placement(name))


def compile_order(name: str, orders: List[List[Action]], n_devices: int,
                  n_virtual: int, n_microbatches: int, *,
                  split_backward: bool = False, placement: str = "wrap",
                  verify: bool = True) -> CompiledSchedule:
    """Lower explicit per-device orders to a tick table, then check it with
    :func:`verify_table` (unless ``verify=False``; validation and the
    deadlock check always run).

    Activation lifetimes per device: the input of stage s for microbatch m
    is stored one tick after its producer F(s-1, m) ran (at the producer's
    own tick for a same-device hop, at the forward's own tick for stage 0,
    whose embedding is computed in place) and last read by B(s, m), or by
    W(s, m) under a split schedule. Cotangent lifetimes mirror this for
    B(s+1, m)."""
    D, V, M = n_devices, n_virtual, n_microbatches
    validate_order(orders, D, V, M, split_backward=split_backward,
                   placement=placement)
    ticks, T_compute = schedule_ticks(orders, D, V, placement=placement)
    S = D * V

    def device_of(s):
        return placement_device_of(placement, s, D)

    T = T_compute + 1  # arrivals land one tick after their producer

    def release_of(s, m):
        return max(ticks[r] for r in (Action(s, B, m), Action(s, W, m))
                   if r in ticks)

    act_events: List[List[Tuple[int, int, object]]] = [[] for _ in range(D)]
    grad_events: List[List[Tuple[int, int, object]]] = [[] for _ in range(D)]
    for a, t in ticks.items():
        if a.op != F:
            continue
        if a.stage == 0:
            store = t
        else:
            pt = ticks[Action(a.stage - 1, F, a.microbatch)]
            local = fwd_route(placement, a.stage - 1, D) == "local"
            store = pt if local else pt + 1
        act_events[device_of(a.stage)].append(
            (store, release_of(a.stage, a.microbatch),
             (a.stage, a.microbatch)))
    for s in range(S - 1):
        for m in range(M):
            pt = ticks[Action(s + 1, B, m)]
            local = bwd_route(placement, s + 1, D) == "local"
            grad_events[device_of(s)].append(
                (pt if local else pt + 1, release_of(s, m), (s, m)))

    act_assign, n_act = [], 0
    grad_assign, n_grad = [], 0
    for d in range(D):
        assign, n = _allocate_slots(act_events[d])
        act_assign.append(assign)
        n_act = max(n_act, n)
        assign, n = _allocate_slots(grad_events[d])
        grad_assign.append(assign)
        n_grad = max(n_grad, n)
    n_grad = max(n_grad, 1)  # executor buffers cannot be zero-sized

    table = np.full((T, D, N_COLS), -1, dtype=np.int32)
    for a, t in ticks.items():
        d = device_of(a.stage)
        v = placement_chunk_of(placement, a.stage, D)
        if a.op == F:
            table[t, d, COL_FWD_V] = v
            table[t, d, COL_FWD_M] = a.microbatch
            table[t, d, COL_FWD_SLOT] = act_assign[d][(a.stage, a.microbatch)]
            if a.stage < S - 1:
                nd = device_of(a.stage + 1)
                nslot = act_assign[nd][(a.stage + 1, a.microbatch)]
                route = fwd_route(placement, a.stage, D)
                if route == "local":
                    table[t, d, COL_FWD_LOCAL_SLOT] = nslot
                elif route == "+1":
                    table[t + 1, nd, COL_STORE_F_SLOT] = nslot
                else:
                    table[t + 1, nd, COL_STORE_F_NEG_SLOT] = nslot
        elif a.op == B:
            table[t, d, COL_BWD_V] = v
            table[t, d, COL_BWD_M] = a.microbatch
            table[t, d, COL_BWD_ASLOT] = act_assign[d][(a.stage, a.microbatch)]
            if a.stage < S - 1:
                table[t, d, COL_BWD_GSLOT] = grad_assign[d][(a.stage, a.microbatch)]
            if a.stage > 0:
                pd = device_of(a.stage - 1)
                pslot = grad_assign[pd][(a.stage - 1, a.microbatch)]
                route = bwd_route(placement, a.stage, D)
                if route == "local":
                    table[t, d, COL_BWD_LOCAL_SLOT] = pslot
                elif route == "-1":
                    table[t + 1, pd, COL_STORE_B_SLOT] = pslot
                else:
                    table[t + 1, pd, COL_STORE_B_POS_SLOT] = pslot
        else:  # W
            table[t, d, COL_W_V] = v
            table[t, d, COL_W_M] = a.microbatch
            table[t, d, COL_W_ASLOT] = act_assign[d][(a.stage, a.microbatch)]
            if a.stage < S - 1:
                table[t, d, COL_W_GSLOT] = grad_assign[d][(a.stage, a.microbatch)]
    while T > 1 and np.all(table[T - 1] == -1):  # trim empty trailing ticks
        T -= 1
    cs = CompiledSchedule(name, D, V, M, table[:T], T, ticks, n_act, n_grad,
                          split_backward=split_backward, placement=placement)
    if verify:
        verify_table(cs)
    return cs


def verify_table(cs: CompiledSchedule) -> None:
    """Symbolic interpreter over the table: runs the executor's store /
    compute / hand-over contract (four ring channels, +1 and -1 in each
    direction, and same-device hops) on labels and checks that every
    forward reads its stage input and every backward and weight-gradient
    unit its saved input and incoming cotangent. Raises ScheduleError on a
    stale read, a missing value or a unit that never runs."""
    D, S = cs.n_devices, cs.n_stages
    pl = cs.placement
    bufs = {"act": [dict() for _ in range(D)],    # slot -> ("act", stage, mb)
            "grad": [dict() for _ in range(D)]}  # slot -> ("gout", stage, mb)
    act, grad = bufs["act"], bufs["grad"]
    # last tick's hand-overs per channel and receiving device
    inbox = {(buf, off): [None] * D for buf, off, _ in CHANNELS}
    fwd_done, bwd_done, w_done = set(), set(), set()

    def saved(d, t, unit, s, m, aslot, gslot):
        got = act[d].get(aslot)
        if got != ("act", s, m):
            raise ScheduleError(
                f"(device {d}, tick {t}): {unit}(stage={s}, mb={m}) "
                f"saved-input slot {aslot} holds {got}")
        if s < S - 1:
            gg = grad[d].get(gslot)
            if gg != ("gout", s, m):
                raise ScheduleError(
                    f"(device {d}, tick {t}): {unit}(stage={s}, mb={m}) grad "
                    f"slot {gslot} holds {gg}")

    for t in range(cs.table.shape[0]):
        sends = {key: [None] * D for key in inbox}
        for d in range(D):
            row = cs.table[t, d]
            for buf, off, col in CHANNELS:
                if row[col] >= 0:
                    reg = inbox[(buf, off)][d]
                    if reg is None:
                        raise ScheduleError(
                            f"(device {d}, tick {t}): {buf} store from the "
                            f"{off:+d} ring of an empty register")
                    bufs[buf][d][int(row[col])] = reg
            if row[COL_FWD_M] >= 0:
                s = placement_stage_of(pl, d, int(row[COL_FWD_V]), D)
                m = int(row[COL_FWD_M])
                slot = int(row[COL_FWD_SLOT])
                if s == 0:
                    act[d][slot] = ("act", 0, m)  # embed computed in place
                got = act[d].get(slot)
                if got != ("act", s, m):
                    raise ScheduleError(
                        f"(device {d}, tick {t}): F(stage={s}, mb={m}) read slot {slot} "
                        f"holding {got}")
                if s < S - 1:
                    route = fwd_route(pl, s, D)
                    if route == "local":
                        if row[COL_FWD_LOCAL_SLOT] < 0:
                            raise ScheduleError(
                                f"(device {d}, tick {t}): F(stage={s}) local route "
                                f"without COL_FWD_LOCAL_SLOT")
                        act[d][int(row[COL_FWD_LOCAL_SLOT])] = ("act", s + 1, m)
                    else:
                        sends[("act", int(route))][d] = ("act", s + 1, m)
                fwd_done.add((s, m))
            if row[COL_BWD_M] >= 0:
                s = placement_stage_of(pl, d, int(row[COL_BWD_V]), D)
                m = int(row[COL_BWD_M])
                saved(d, t, "B", s, m, int(row[COL_BWD_ASLOT]),
                      int(row[COL_BWD_GSLOT]))
                if s > 0:
                    route = bwd_route(pl, s, D)
                    if route == "local":
                        if row[COL_BWD_LOCAL_SLOT] < 0:
                            raise ScheduleError(
                                f"(device {d}, tick {t}): B(stage={s}) local route "
                                f"without COL_BWD_LOCAL_SLOT")
                        grad[d][int(row[COL_BWD_LOCAL_SLOT])] = ("gout", s - 1, m)
                    else:
                        sends[("grad", int(route))][d] = ("gout", s - 1, m)
                bwd_done.add((s, m))
            if row[COL_W_M] >= 0:
                s = placement_stage_of(pl, d, int(row[COL_W_V]), D)
                m = int(row[COL_W_M])
                saved(d, t, "W", s, m, int(row[COL_W_ASLOT]),
                      int(row[COL_W_GSLOT]))
                w_done.add((s, m))
        inbox = {(buf, off): [sends[(buf, off)][(d - off) % D]
                              for d in range(D)] for buf, off in inbox}
    want = {(s, m) for s in range(S) for m in range(cs.n_microbatches)}
    if cs.split_backward:
        want_b = {(s, m) for s in range(1, S) for m in range(cs.n_microbatches)}
        ok = fwd_done == want and bwd_done == want_b and w_done == want
    else:
        ok = fwd_done == want and bwd_done == want and not w_done
    if not ok:
        raise ScheduleError("table does not execute every (stage, microbatch)")


def table_unit_activity(table: np.ndarray) -> np.ndarray:
    """Each (tick, device) cell of a tick table as ``[T, D, 4]`` 0/1 in
    (F, B, W, idle) order; ``idle`` is set only when no unit runs. Takes
    the 4-column forward-only table (column 2 is the forward microbatch)
    and the training table."""
    table = np.asarray(table)
    if table.ndim != 3:
        raise ScheduleError(f"expected [T, D, n_cols] table, got shape "
                            f"{table.shape}")
    n_cols = table.shape[2]
    f = table[:, :, COL_FWD_M] >= 0 if n_cols > COL_FWD_M else (
        table[:, :, n_cols - 2] >= 0)
    b = (table[:, :, COL_BWD_M] >= 0 if n_cols > COL_BWD_M
         else np.zeros(table.shape[:2], bool))
    w = (table[:, :, COL_W_M] >= 0 if n_cols > COL_W_M
         else np.zeros(table.shape[:2], bool))
    return np.stack([f, b, w, ~(f | b | w)], axis=-1).astype(np.int64)


# ---------------------------------------------------------------------------
# Bubble and time models
# ---------------------------------------------------------------------------


def analytic_bubble_fraction(name: str, n_devices: int, n_virtual: int,
                             n_microbatches: int,
                             cs: Optional[CompiledSchedule] = None) -> float:
    """Ideal bubble fraction in unit-cost ticks: (D-1)/(M + D - 1) for
    GPipe and 1F1B, (D-1)/(M*V + D - 1) for Interleaved1F1B and BFS.

    ZBH1 / ZBV: ``1 - busy / makespan`` with the makespans ``3M + D - 1``
    / ``6M + D - 1`` and the mean busy work ``3M - M/D`` / ``6M - M/D``
    (stage 0 runs no B, which this mean counts as idle; see
    :func:`paper_bubble_fraction`). A registered schedule has no closed
    form: its unit-cost tick simulation (``cs`` saves a recompile)."""
    D, M = n_devices, n_microbatches
    if name in _CUSTOM_SCHEDULES:
        if cs is None:
            cs = compile_schedule(name, D, n_virtual, M)
        return simulated_bubble(cs, w_f=1.0, w_b=1.0, w_w=1.0)[
            "bubble_fraction"]
    if name == "ZBH1":
        return 1.0 - (3 * M - M / D) / (3 * M + D - 1)
    if name == "ZBV":
        return 1.0 - (6 * M - M / D) / (6 * M + D - 1)
    V = n_virtual if name in ("Interleaved1F1B", "BFS") else 1
    return (D - 1) / (M * V + D - 1)


def paper_bubble_fraction(name: str, n_devices: int, n_virtual: int,
                          n_microbatches: int) -> float:
    """The bubble under the zero-bubble paper's uniform-work accounting:
    ``(D-1)/(3M+D-1)`` for ZBH1, ``(D-1)/(6M+D-1)`` for ZBV, and
    :func:`analytic_bubble_fraction` for every other schedule."""
    D, M = n_devices, n_microbatches
    if name == "ZBH1":
        return (D - 1) / (3 * M + D - 1)
    if name == "ZBV":
        return (D - 1) / (6 * M + D - 1)
    return analytic_bubble_fraction(name, n_devices, n_virtual,
                                    n_microbatches)


def simulated_bubble(cs: CompiledSchedule, w_f: float = 1.0,
                     w_b: float = 2.0, w_w: float = 1.0) -> Dict[str, float]:
    """Bubble of the compiled tick schedule when a forward tick costs
    ``w_f``, a backward tick ``w_b`` (2: the stored backward; 3: the
    rematerialising one, the executor's default at D > 1; about ``w_f``
    for a split schedule's dgrad B) and a weight-gradient tick ``w_w``.
    Lockstep: each tick lasts as long as its most expensive active device;
    the bubble is each device's idle share of the summed ticks, averaged
    (and its max)."""
    T = cs.makespan
    tick_cost = np.zeros(T + 1)
    busy = np.zeros(cs.n_devices)
    weight = {F: w_f, B: w_b, W: w_w}
    for a, t in cs.ticks.items():
        w = weight[a.op]
        tick_cost[t] = max(tick_cost[t], w)
        busy[placement_device_of(cs.placement, a.stage, cs.n_devices)] += w
    makespan = float(tick_cost.sum())
    per_device = 1.0 - busy / makespan
    return {
        "makespan": makespan,
        "bubble_fraction": float(per_device.mean()),
        "bubble_fraction_max": float(per_device.max()),
    }


def async_makespan(name: str, n_devices: int, n_virtual: int,
                   n_microbatches: int, w_f: float = 1.0, w_b: float = 2.0,
                   w_w: float = 1.0, comm: float = 0.0) -> float:
    """Makespan of a schedule's per-device orders under an asynchronous
    runtime (the reference's ``torch.distributed.pipelining``): each
    device runs its next action as soon as its inputs have arrived, with
    no lockstep tick. Costs are per action and scale by 1/V (an action
    covers 1/V of a device's layers); ``comm`` is charged on every
    inter-stage hop."""
    D, V, M = n_devices, n_virtual, n_microbatches
    S = D * V
    orders = build_order(name, D, V, M)
    end: Dict[Action, float] = {}
    free = [0.0] * D
    ptr = [0] * D
    scale = 1.0 / V
    weight = {F: w_f * scale, B: w_b * scale, W: w_w * scale}

    def dep_ends(a: Action):
        if a.op == F:
            if a.stage == 0:
                return [0.0]
            dep = Action(a.stage - 1, F, a.microbatch)
            return [end[dep] + comm] if dep in end else None
        if a.op == W:
            dep = (Action(1, B, a.microbatch) if a.stage == 0
                   else Action(a.stage, B, a.microbatch))
            if dep not in end:
                return None
            return [end[dep] + (comm if a.stage == 0 else 0.0)]
        fw = Action(a.stage, F, a.microbatch)
        if fw not in end:
            return None
        needs = [end[fw]]
        if a.stage < S - 1:
            up = Action(a.stage + 1, B, a.microbatch)
            if up not in end:
                return None
            needs.append(end[up] + comm)
        return needs

    remaining = sum(len(o) for o in orders)
    while remaining:
        progressed = False
        for d in range(D):
            while ptr[d] < len(orders[d]):
                a = orders[d][ptr[d]]
                deps = dep_ends(a)
                if deps is None:
                    break
                start = max([free[d]] + deps)
                end[a] = start + weight[a.op]
                free[d] = end[a]
                ptr[d] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise ScheduleError(f"async simulation deadlocked for {name} "
                                f"(D={D}, V={V}, M={M})")
    return max(free)


def predicted_throughput(name: str, n_devices: int, n_virtual: int,
                         n_microbatches: int, tokens_per_step: int,
                         w_f: float = 1.0, w_b: float = 2.0,
                         comm: float = 0.0) -> float:
    """Tokens per unit time from :func:`async_makespan`, one unit being one
    full-model microbatch forward; comparable across schedules and V at
    fixed (D, M, model)."""
    ms = async_makespan(name, n_devices, n_virtual, n_microbatches,
                        w_f=w_f, w_b=w_b, comm=comm)
    return tokens_per_step / ms
