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
``tests/test_torch_zero_bubble.py``). Also here: the certified schedule
artifacts with their loader and pins (``:975-1340``; the artifacts are
JAX's byte for byte) and the phase compression (``:1348-1540``), which no
executor runs (the port's executor walks the ticks; the phases' JAX use
is XLA's compile economics) and which the static verifier holds to its
round trip (``tests/test_torch_table_check.py``).

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
import hashlib
import heapq
import json
from typing import Dict, List, Optional, Sequence, Tuple

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
    _ARTIFACT_PINS.pop(name, None)


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
    cs = compile_order(name, orders, n_devices, n_virtual, n_microbatches,
                       split_backward=is_split_backward(name),
                       placement=schedule_placement(name))
    verify_artifact_pin(cs)
    return cs


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
# Schedule artifacts: certified, versioned JSON for searched (or otherwise
# externally produced) schedules. An artifact carries the per-device
# orders, the compiled table, a fingerprint over its metadata and, from the
# search, the embedded TableReport summary and predicted cost. Loading
# recompiles the orders and certifies the stored table cell by cell.
# ---------------------------------------------------------------------------

SCHEDULE_ARTIFACT_VERSION = 1
SCHEDULE_ARTIFACT_KIND = "schedule_artifact"

# artifact-backed registered schedules: name -> pin; every compile
# re-checks it (:func:`verify_artifact_pin`), so a re-registered order
# function cannot swap a certified table
_ARTIFACT_PINS: Dict[str, Dict[str, str]] = {}


def table_digest(table: np.ndarray) -> str:
    """Content digest of a tick table (shape + little-endian int32
    cells)."""
    arr = np.ascontiguousarray(np.asarray(table, dtype="<i4"))
    h = hashlib.sha256()
    h.update(repr(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


_FINGERPRINT_FIELDS = (
    "artifact_version", "kind", "name", "n_devices", "n_virtual",
    "n_microbatches", "placement", "split_backward", "n_act_slots",
    "n_grad_slots", "makespan", "verifier_version", "table_digest")


def _artifact_fingerprint(art: Dict[str, object]) -> str:
    payload = {k: art.get(k) for k in _FINGERPRINT_FIELDS}
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _orders_from_ticks(cs: CompiledSchedule) -> List[List[Action]]:
    """The per-device orders behind a compiled schedule, from its tick
    map (one unit per device per tick)."""
    if not cs.ticks:
        raise ScheduleError(
            f"schedule {cs.name!r} has no tick map; cannot recover "
            "per-device orders for an artifact")
    orders: List[List[Action]] = [[] for _ in range(cs.n_devices)]
    key = lambda kv: (kv[1], kv[0].stage, kv[0].op, kv[0].microbatch)
    for a, _t in sorted(cs.ticks.items(), key=key):
        orders[placement_device_of(cs.placement, a.stage,
                                   cs.n_devices)].append(a)
    return orders


def schedule_artifact(cs: CompiledSchedule, *,
                      orders: Optional[List[List[Action]]] = None,
                      seed: Optional[int] = None,
                      table_report: Optional[Dict[str, object]] = None,
                      predicted: Optional[Dict[str, object]] = None,
                      baselines: Optional[Dict[str, object]] = None,
                      search: Optional[Dict[str, object]] = None
                      ) -> Dict[str, object]:
    """The versioned JSON-serialisable artifact of ``cs``.
    ``table_report`` (a ``TableReport.summary()``) and ``predicted`` (the
    cost model's dict) are embedded as they are. ``config_fingerprint``
    signs the metadata fields; the cells are covered by ``table_digest``
    and by the loader's recompile-and-diff."""
    if orders is None:
        orders = _orders_from_ticks(cs)
    art: Dict[str, object] = {
        "artifact_version": SCHEDULE_ARTIFACT_VERSION,
        "kind": SCHEDULE_ARTIFACT_KIND,
        "name": cs.name,
        "n_devices": int(cs.n_devices),
        "n_virtual": int(cs.n_virtual),
        "n_microbatches": int(cs.n_microbatches),
        "placement": cs.placement,
        "split_backward": bool(cs.split_backward),
        "n_act_slots": int(cs.n_act_slots),
        "n_grad_slots": int(cs.n_grad_slots),
        "makespan": int(cs.makespan),
        "orders": [[[int(a.stage), a.op, int(a.microbatch)] for a in order]
                   for order in orders],
        "table": np.asarray(cs.table, dtype=np.int32).tolist(),
        "table_digest": table_digest(cs.table),
    }
    from ..analysis import VERIFIER_VERSION  # analysis imports this module
    art["verifier_version"] = VERIFIER_VERSION
    if seed is not None:
        art["seed"] = int(seed)
    if table_report is not None:
        art["table_report"] = table_report
    if predicted is not None:
        art["predicted"] = predicted
    if baselines is not None:
        art["baselines"] = baselines
    if search is not None:
        art["search"] = search
    art["config_fingerprint"] = _artifact_fingerprint(art)
    return art


def schedule_artifact_bytes(art: Dict[str, object]) -> bytes:
    """The canonical (byte-deterministic) JSON encoding of an artifact."""
    return (json.dumps(art, sort_keys=True) + "\n").encode()


def save_schedule_artifact(art: Dict[str, object], path) -> None:
    with open(path, "wb") as fh:
        fh.write(schedule_artifact_bytes(art))


def _art_err(label: str, field: str, msg: str) -> ScheduleError:
    return ScheduleError(f"schedule artifact {label}: field {field!r}: {msg}")


def _load_artifact_dict(source) -> Tuple[Dict[str, object], str]:
    if isinstance(source, dict):
        return source, "<dict>"
    label = str(source)
    try:
        with open(source, "r", encoding="utf-8") as fh:
            art = json.load(fh)
    except OSError as e:
        raise ScheduleError(f"schedule artifact {label}: unreadable: {e}")
    except json.JSONDecodeError as e:
        raise ScheduleError(f"schedule artifact {label}: invalid JSON: {e}")
    if not isinstance(art, dict):
        raise ScheduleError(
            f"schedule artifact {label}: top level must be a JSON object, "
            f"got {type(art).__name__}")
    return art, label


def _validated_int(art: Dict[str, object], label: str, key: str,
                   minimum: int) -> int:
    v = art.get(key)
    if not isinstance(v, int) or isinstance(v, bool) or v < minimum:
        raise _art_err(label, key, f"must be an int >= {minimum}, got {v!r}")
    return v


def _artifact_table(art: Dict[str, object], label: str, D: int,
                    makespan: int) -> np.ndarray:
    """The stored table, its structure checked: a located error for a
    ragged, float, mis-shaped or sub -1 table."""
    raw = art.get("table")
    if not isinstance(raw, list) or not raw:
        raise _art_err(label, "table",
                       f"must be a non-empty [T][D][{N_COLS}] nested list")
    try:
        arr = np.asarray(raw)
    except ValueError as e:  # ragged nesting
        raise _art_err(label, "table", f"not a rectangular array: {e}")
    if arr.dtype == object or arr.ndim != 3:
        raise _art_err(label, "table",
                       f"must be rank-3 [T, D, {N_COLS}], got shape "
                       f"{arr.shape} ({arr.dtype})")
    if not np.issubdtype(arr.dtype, np.integer):
        raise _art_err(label, "table",
                       f"dtype mismatch: cells must be integers, got {arr.dtype}")
    if arr.shape[2] != N_COLS:
        raise _art_err(label, "table",
                       f"column-count mismatch: {arr.shape[2]} columns != "
                       f"N_COLS {N_COLS}")
    if arr.shape[1] != D:
        raise _art_err(label, "table",
                       f"shape mismatch: {arr.shape[1]} device rows != "
                       f"n_devices {D}")
    if arr.shape[0] != makespan:
        raise _art_err(label, "table",
                       f"shape mismatch: {arr.shape[0]} ticks != makespan "
                       f"{makespan}")
    if (arr < -1).any():
        t, d, c = (int(x) for x in np.argwhere(arr < -1)[0])
        raise _art_err(label, "table",
                       f"cell (device {d}, tick {t}, col {c}) = "
                       f"{int(arr[t, d, c])} is below -1")
    return arr.astype(np.int32)


def _artifact_orders(art: Dict[str, object], label: str,
                     D: int) -> List[List[Action]]:
    raw_orders = art.get("orders")
    if not isinstance(raw_orders, list) or len(raw_orders) != D:
        raise _art_err(label, "orders",
                       f"must be a list of {D} per-device action lists, got "
                       f"{type(raw_orders).__name__} of length "
                       f"{len(raw_orders) if isinstance(raw_orders, list) else '?'}")
    orders: List[List[Action]] = []
    for d, dev in enumerate(raw_orders):
        if not isinstance(dev, list):
            raise _art_err(label, f"orders[{d}]", "must be a list")
        out: List[Action] = []
        for i, item in enumerate(dev):
            if (not isinstance(item, (list, tuple)) or len(item) != 3
                    or not isinstance(item[0], int) or isinstance(item[0], bool)
                    or item[1] not in (F, B, W)
                    or not isinstance(item[2], int) or isinstance(item[2], bool)):
                raise _art_err(label, f"orders[{d}][{i}]",
                               f"must be [stage:int, op in 'FBW', mb:int], "
                               f"got {item!r}")
            out.append(Action(int(item[0]), str(item[1]), int(item[2])))
        orders.append(out)
    return orders


def _load_schedule_artifact_impl(source, verify: bool
                                 ) -> Tuple[CompiledSchedule, Dict[str, object],
                                            List[List[Action]], str]:
    art, label = _load_artifact_dict(source)
    # schema first: every mismatch is a located ScheduleError
    ver = art.get("artifact_version")
    if ver != SCHEDULE_ARTIFACT_VERSION:
        raise _art_err(label, "artifact_version",
                       f"unsupported version {ver!r} "
                       f"(this build reads {SCHEDULE_ARTIFACT_VERSION})")
    if art.get("kind") != SCHEDULE_ARTIFACT_KIND:
        raise _art_err(label, "kind",
                       f"expected {SCHEDULE_ARTIFACT_KIND!r}, got "
                       f"{art.get('kind')!r}")
    name = art.get("name")
    if not isinstance(name, str) or not name:
        raise _art_err(label, "name", f"must be a non-empty string, got {name!r}")
    D = _validated_int(art, label, "n_devices", 1)
    V = _validated_int(art, label, "n_virtual", 1)
    M = _validated_int(art, label, "n_microbatches", 1)
    n_act = _validated_int(art, label, "n_act_slots", 1)
    n_grad = _validated_int(art, label, "n_grad_slots", 1)
    makespan = _validated_int(art, label, "makespan", 1)
    placement = art.get("placement")
    if placement not in ("wrap", "vshape"):
        raise _art_err(label, "placement",
                       f"must be 'wrap' or 'vshape', got {placement!r}")
    split = art.get("split_backward")
    if not isinstance(split, bool):
        raise _art_err(label, "split_backward", f"must be a bool, got {split!r}")
    if not isinstance(art.get("table_digest"), str):
        raise _art_err(label, "table_digest", "must be a hex string")
    # an edited metadata field fails here, before any numpy work
    fp = art.get("config_fingerprint")
    want_fp = _artifact_fingerprint(art)
    if fp != want_fp:
        raise _art_err(
            label, "config_fingerprint",
            "stale fingerprint: metadata was edited after the artifact was "
            f"signed (stored {str(fp)[:12]!r}, recomputed {want_fp[:12]!r})")
    table = _artifact_table(art, label, D, makespan)
    orders = _artifact_orders(art, label, D)
    # the orders are the authority: recompile them and certify the stored
    # table against the result, cell by cell
    try:
        cs = compile_order(name, orders, D, V, M, split_backward=split,
                           placement=placement)
    except ScheduleError as e:
        raise ScheduleError(
            f"schedule artifact {label}: orders do not compile: {e}")
    if cs.n_act_slots != n_act:
        raise _art_err(label, "n_act_slots",
                       f"{n_act} != recompiled {cs.n_act_slots}")
    if cs.n_grad_slots != n_grad:
        raise _art_err(label, "n_grad_slots",
                       f"{n_grad} != recompiled {cs.n_grad_slots}")
    if cs.table.shape != table.shape or not np.array_equal(cs.table, table):
        k = min(cs.table.shape[0], table.shape[0])
        diff = np.argwhere(cs.table[:k] != table[:k])
        if diff.size:
            t, d, c = (int(x) for x in diff[0])
            from ..analysis.table_check import COLUMN_NAMES
            raise ScheduleError(
                f"schedule artifact {label}: certification failed at "
                f"(device {d}, tick {t}, {COLUMN_NAMES.get(c, f'col {c}')}): "
                f"stored cell {int(table[t, d, c])} != certified value "
                f"{int(cs.table[t, d, c])} (table tampered or stale)")
        raise _art_err(label, "table",
                       f"tick count {table.shape[0]} != recompiled "
                       f"{cs.table.shape[0]}")
    if art["table_digest"] != table_digest(table):
        raise _art_err(label, "table_digest",
                       "digest does not match the stored table")
    if verify:  # the full static certification, and the embedded report
        from ..analysis.table_check import check_table
        report = check_table(cs)
        if report.hazards:
            raise ScheduleError(
                f"schedule artifact {label}: certification failed: "
                f"{report.hazards[0]}")
        emb = art.get("table_report")
        if emb is not None:
            if not isinstance(emb, dict):
                raise _art_err(label, "table_report", "must be an object")
            if emb.get("ok") is False or emb.get("n_hazards", 0):
                raise _art_err(label, "table_report",
                               "embeds a non-clean TableReport; refusing to "
                               "load an uncertified artifact")
            summary = report.summary()
            for key in ("makespan", "predicted_ppermutes"):
                if key in emb and emb[key] != summary[key]:
                    raise _art_err(label, f"table_report.{key}",
                                   f"{emb[key]!r} != recomputed "
                                   f"{summary[key]!r}")
    else:
        from ..analysis import maybe_verify_schedule
        maybe_verify_schedule(cs)
    return cs, art, orders, label


def load_schedule_artifact(source, *, verify: bool = True) -> CompiledSchedule:
    """Load a schedule artifact (a path or a dict) into a
    :class:`CompiledSchedule`. In order: the JSON schema (shape, dtype,
    column count), the metadata's ``config_fingerprint``, the recompiled
    orders against every stored cell (a changed cell fails with its
    device, tick and column), then ``check_table``. Each failure is a
    :class:`ScheduleError` naming the artifact and the field. With
    ``verify=False`` ``check_table`` is left to ``DTPP_VERIFY_TABLES``."""
    return _load_schedule_artifact_impl(source, verify)[0]


def register_schedule_artifact(source, *, name: Optional[str] = None,
                               overwrite: bool = True) -> CompiledSchedule:
    """Load, certify and register an artifact as a named schedule:
    ``compile_schedule(name, D, V, M)`` (and so ``ScheduleConfig``,
    ``fit`` and the sweep) then resolves it like a built-in, pinned to
    the certified table's digest."""
    cs, art, orders, label = _load_schedule_artifact_impl(source, True)
    reg_name = name if name is not None else cs.name
    if cs.placement != "wrap":
        raise ScheduleError(
            f"schedule artifact {label}: only wrap-placement artifacts can "
            "be registered (vshape placement is reserved for the ZBV builtin)")

    def order_fn(D: int, V: int, M: int) -> List[List[Action]]:
        want = (cs.n_devices, cs.n_virtual, cs.n_microbatches)
        if (D, V, M) != want:
            raise ScheduleError(
                f"schedule {reg_name!r} was certified for n_devices={want[0]}, "
                f"n_virtual={want[1]}, n_microbatches={want[2]}; requested "
                f"({D}, {V}, {M}) — re-run the search for this config")
        return [list(order) for order in orders]

    register_schedule(reg_name, order_fn, split_backward=cs.split_backward,
                      overwrite=overwrite)
    _ARTIFACT_PINS[reg_name] = {
        "table_digest": str(art["table_digest"]),
        "config_fingerprint": str(art["config_fingerprint"]),
        "source": label,
    }
    if reg_name != cs.name:
        cs = dataclasses.replace(cs, name=reg_name)
    return cs


def registered_artifact_info(name: str) -> Optional[Dict[str, str]]:
    """The pin (table digest, fingerprint, source) of an artifact-backed
    schedule name, or None."""
    info = _ARTIFACT_PINS.get(name)
    return dict(info) if info is not None else None


def verify_artifact_pin(cs: CompiledSchedule) -> None:
    """For an artifact-backed name, the compiled table's digest against
    the certified pin; raises :class:`ScheduleError` when they part."""
    pin = _ARTIFACT_PINS.get(cs.name)
    if pin is None:
        return
    got = table_digest(cs.table)
    if got != pin["table_digest"]:
        raise ScheduleError(
            f"schedule {cs.name!r}: compiled table digest {got[:12]}... does "
            f"not match the certified artifact pin "
            f"{pin['table_digest'][:12]}... (source {pin['source']}) — the "
            "registered orders no longer produce the certified table")


# ---------------------------------------------------------------------------
# Phase compression: the periodic steady state of a tick table. No
# executor runs phases (the port's executor walks the ticks); the static
# verifier holds the compress -> replay round trip.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phase:
    """One maximal periodic run of table rows ``[start, start + period *
    reps)``: repetition k is ``base + k * stride`` (``base`` the first
    repetition's ``[period, D, n_cols]`` rows, ``stride`` 0 on inactive
    entries), so the active/idle pattern ``base >= 0`` is the same in
    every repetition."""

    start: int
    period: int
    reps: int
    base: np.ndarray    # [period, D, n_cols] int32
    stride: np.ndarray  # [period, D, n_cols] int32; 0 on inactive entries

    @property
    def length(self) -> int:
        return self.period * self.reps

    def pattern_key(self) -> Tuple[int, bytes]:
        """The identity of the active/idle pattern."""
        return (self.period, (self.base >= 0).tobytes())


def rows_of(phase: Phase) -> np.ndarray:
    """One phase's rows ``[length, D, n_cols]`` from its descriptor."""
    ks = np.arange(phase.reps, dtype=phase.base.dtype)
    blocks = phase.base[None] + ks[:, None, None, None] * phase.stride[None]
    return blocks.reshape(phase.reps * phase.period, *phase.base.shape[1:])


def replay_phases(phases: Sequence[Phase]) -> np.ndarray:
    """The whole table from its phases (:func:`compress_schedule`'s
    inverse, bit for bit)."""
    return np.concatenate([rows_of(p) for p in phases], axis=0)


def compress_schedule(table: np.ndarray,
                      max_period: Optional[int] = None) -> Tuple[Phase, ...]:
    """Segment a tick table into maximal periodic runs (the JAX function,
    bit-identical). A run of period p from row t needs every repetition's
    active/idle mask equal to the first's and its active entries advancing
    affinely (``base + k * stride``). Greedy: at each row the (period,
    reps) that covers most rows, the smallest period on ties; a row that
    starts no run of two repetitions is a ``period=1, reps=1`` phase. The
    result is checked against :func:`replay_phases` before it is
    returned."""
    table = np.asarray(table)
    T = table.shape[0]
    if max_period is None:
        max_period = min(T // 2, 64)
    phases: List[Phase] = []
    t = 0
    while t < T:
        best = None  # (coverage, -period, period, reps, stride)
        rem = T - t
        for p in range(1, min(max_period, rem // 2) + 1):
            base = table[t:t + p]
            mask = base >= 0
            nxt = table[t + p:t + 2 * p]
            if ((nxt >= 0) != mask).any():
                continue
            stride = np.where(mask, nxt - base, 0).astype(table.dtype)
            if not np.array_equal(base + stride, nxt):
                continue  # an inactive entry is not -1
            reps = 2
            while t + (reps + 1) * p <= T:
                blk = table[t + reps * p:t + (reps + 1) * p]
                # the mask is compared on its own: an active entry walking
                # onto -1 by arithmetic must not count as a match
                if (((blk >= 0) == mask).all()
                        and np.array_equal(blk, base + reps * stride)):
                    reps += 1
                else:
                    break
            cand = (p * reps, -p, p, reps, stride)
            if best is None or cand[:2] > best[:2]:
                best = cand
        if best is not None:
            _, _, p, reps, stride = best
            phases.append(Phase(t, p, reps, table[t:t + p].copy(), stride))
            t += p * reps
        else:
            phases.append(Phase(t, 1, 1, table[t:t + 1].copy(),
                                np.zeros((1,) + table.shape[1:],
                                         dtype=table.dtype)))
            t += 1
    out = tuple(phases)
    if not np.array_equal(replay_phases(out), table):  # pragma: no cover
        raise ScheduleError("phase compression self-check failed: replay "
                            "does not reconstruct the tick table")
    return out


def phase_stats(phases: Sequence[Phase]) -> Dict[str, int]:
    """Rows, phases and distinct active/idle patterns."""
    return {
        "n_rows": sum(p.length for p in phases),
        "n_phases": len(phases),
        "n_unique_patterns": len({p.pattern_key() for p in phases}),
    }


def phase_spans(phases: Sequence[Phase]) -> List[Tuple[int, int]]:
    """``[(start_tick, n_ticks)]`` per phase; they tile ``[0, makespan)``."""
    return [(p.start, p.length) for p in phases]


def phase_unit_activity(phases: Sequence[Phase]) -> np.ndarray:
    """Per phase and device, the ticks in (F, B, W, idle): ``[n_phases,
    D, 4]``."""
    return np.stack([table_unit_activity(rows_of(p)).sum(axis=0)
                     for p in phases])


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
