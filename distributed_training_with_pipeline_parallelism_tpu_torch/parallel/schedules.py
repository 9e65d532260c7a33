"""Pipeline-schedule IR: per-device action orders, tick scheduling and the
``[T, D, 17]`` tick tables the executor runs.

The port's own copy of what GPipe, 1F1B, Interleaved-1F1B and BFS need from
``distributed_training_with_pipeline_parallelism_tpu/parallel/schedules.py``
(orders ``:118``-``:240``, ``schedule_ticks`` ``:457``, ``validate_order``
``:526``, the column layout ``:588``, ``CompiledSchedule`` ``:625``,
``_allocate_slots`` ``:656``, ``compile_schedule``/``compile_order``
``:683``/``:705``, ``verify_table`` ``:829``, ``analytic_bubble_fraction``
``:1636``). Those schedules use the wrap placement (global stage
``v * D + d`` on device ``d``) and the full backward, so only the wrap
routes (+1 ring forward, -1 ring backward) are kept; the tables keep all 17
columns, with the split-backward W columns (9-12) and the V-placement route
columns (13-16) at -1, and are bit-identical to the JAX package's
(``tests/test_torch_schedules.py``). The split-backward and V-placement
schedules (ZBH1, ZBV) and the artifact/search layer are not ported yet
(``ROADMAP.md`` Queue 1, item 4).

1. **Action orders**: for each device an ordered list of
   ``Action(stage, op, microbatch)``.
2. **Tick scheduling**: an ASAP list scheduler gives each action a tick:
   one action per device per tick, list order per device, and one tick of
   transfer latency for a dependency across devices.
3. **Tick tables**: dense int32 arrays, one row per (tick, device), naming
   the slots each unit reads and writes.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Tuple

import numpy as np

F = "F"
B = "B"

SCHEDULE_NAMES = ("GPipe", "1F1B", "Interleaved1F1B", "BFS")
# schedules of the JAX package that need the split backward (W units) or
# the V placement; the port raises NotImplementedError for them
NOT_PORTED = ("ZBH1", "ZBV")
NOT_PORTED_ITEM = ("ROADMAP.md Queue 1, item 4 (split-backward W units and "
                   "V-placement routes: table columns 9-16)")


@dataclasses.dataclass(frozen=True)
class Action:
    stage: int  # global stage index in [0, n_stages)
    op: str  # F or B
    microbatch: int


class ScheduleError(ValueError):
    pass


def check_schedule_name(name: str) -> None:
    """A schedule the port runs, else NotImplementedError (a JAX-package
    schedule not ported yet) or ValueError (unknown)."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"schedule {name!r} is not ported yet: "
                                  f"{NOT_PORTED_ITEM}")
    if name not in SCHEDULE_NAMES:
        raise ValueError(f"unknown schedule {name!r}; expected one of "
                         f"{SCHEDULE_NAMES}")


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


def build_order(name: str, n_devices: int, n_virtual: int,
                n_microbatches: int) -> List[List[Action]]:
    check_schedule_name(name)
    if name in ("GPipe", "1F1B") and n_virtual != 1:
        raise ScheduleError(f"{name} supports a single stage per device")
    if name == "GPipe":
        return gpipe_order(n_devices, n_microbatches)
    if name == "1F1B":
        return one_f_one_b_order(n_devices, n_microbatches)
    if name == "Interleaved1F1B":
        return interleaved_order(n_devices, n_virtual, n_microbatches)
    return bfs_order(n_devices, n_virtual, n_microbatches)


# ---------------------------------------------------------------------------
# Wrap placement: stage s lives on device s % D as its chunk s // D; an
# activation rides the +1 ring to the next stage, a cotangent the -1 ring.
# ---------------------------------------------------------------------------


def device_of(stage: int, n_devices: int) -> int:
    return stage % n_devices


def chunk_of(stage: int, n_devices: int) -> int:
    return stage // n_devices


def stage_of(device: int, chunk: int, n_devices: int) -> int:
    return chunk * n_devices + device


# ---------------------------------------------------------------------------
# Tick scheduling (ASAP list scheduler)
# ---------------------------------------------------------------------------


def schedule_ticks(orders: List[List[Action]], n_devices: int,
                   n_virtual: int) -> Tuple[Dict[Action, int], int]:
    """Assign each action a tick; returns (action -> tick, makespan).

    One action per device per tick, per-device list order; F(s, m) needs
    F(s-1, m) done at least one tick earlier (the ring hop), B(s, m) needs
    F(s, m) and B(s+1, m) done at least one tick earlier. A deadlocked order
    raises instead of hanging."""
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
            if device_of(a.stage, D) != d:
                raise ScheduleError(f"action {a} listed on device {d}")
            if ready(a, t):
                done[a] = t
                ptr[d] += 1
        t += 1
    return done, t


def validate_order(orders: List[List[Action]], n_devices: int, n_virtual: int,
                   n_microbatches: int) -> None:
    """Every (stage, microbatch) has exactly one F and one B, F precedes B
    on its device, and the tick scheduler completes. Messages carry a
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
            if a.op == B:
                fa = Action(a.stage, F, a.microbatch)
                if fa not in pos or pos[fa] > pos[a]:
                    raise ScheduleError(
                        f"(device {d}, index {pos[a]}): backward before "
                        f"forward: {a}")
    want = {Action(s, op, m) for s in range(S) for op in (F, B)
            for m in range(n_microbatches)}
    if set(seen) != want:
        raise ScheduleError(
            f"action set mismatch: {len(seen)} actions vs expected {len(want)} "
            f"(missing {list(want - set(seen))[:4]}, "
            f"extra {list(set(seen) - want)[:4]})")
    schedule_ticks(orders, n_devices, n_virtual)  # raises on deadlock


# ---------------------------------------------------------------------------
# Tick tables
# ---------------------------------------------------------------------------

# Columns of the per-(tick, device) table; -1 means "no-op this tick".
COL_STORE_F_SLOT = 0  # store +1-ring fwd arrival -> act_buf[slot]
COL_FWD_V, COL_FWD_M, COL_FWD_SLOT = 1, 2, 3  # forward unit: (v, m), input slot
COL_STORE_B_SLOT = 4  # store -1-ring grad arrival -> grad_buf[slot]
COL_BWD_V, COL_BWD_M = 5, 6  # backward unit: (v, m)
COL_BWD_ASLOT, COL_BWD_GSLOT = 7, 8  # saved-input slot, incoming-grad slot
# 9-12: the split backward's W unit; 13-16: the V placement's routes. The
# port's schedules never fill them; the executor raises if a table does.
COL_W_V = 9
N_COLS = 17


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

    @property
    def n_stages(self) -> int:
        return self.n_devices * self.n_virtual


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
    return compile_order(name, orders, n_devices, n_virtual, n_microbatches)


def compile_order(name: str, orders: List[List[Action]], n_devices: int,
                  n_virtual: int, n_microbatches: int) -> CompiledSchedule:
    """Lower explicit per-device orders to a tick table, then check it with
    :func:`verify_table`.

    Activation lifetimes per device: the input of stage s for microbatch m
    is stored one tick after its producer F(s-1, m) ran (at the forward's
    own tick for stage 0, whose embedding is computed in place) and last
    read by B(s, m). Cotangent lifetimes mirror this for B(s+1, m)."""
    D, V, M = n_devices, n_virtual, n_microbatches
    validate_order(orders, D, V, M)
    ticks, T_compute = schedule_ticks(orders, D, V)
    S = D * V
    T = T_compute + 1  # arrivals land one tick after their producer

    act_events: List[List[Tuple[int, int, object]]] = [[] for _ in range(D)]
    grad_events: List[List[Tuple[int, int, object]]] = [[] for _ in range(D)]
    for a, t in ticks.items():
        if a.op != F:
            continue
        store = t if a.stage == 0 else ticks[Action(a.stage - 1, F, a.microbatch)] + 1
        release = ticks[Action(a.stage, B, a.microbatch)]
        act_events[device_of(a.stage, D)].append(
            (store, release, (a.stage, a.microbatch)))
    for s in range(S - 1):
        for m in range(M):
            grad_events[device_of(s, D)].append(
                (ticks[Action(s + 1, B, m)] + 1, ticks[Action(s, B, m)], (s, m)))

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
        d = device_of(a.stage, D)
        v = chunk_of(a.stage, D)
        if a.op == F:
            table[t, d, COL_FWD_V] = v
            table[t, d, COL_FWD_M] = a.microbatch
            table[t, d, COL_FWD_SLOT] = act_assign[d][(a.stage, a.microbatch)]
            if a.stage < S - 1:
                nd = device_of(a.stage + 1, D)
                table[t + 1, nd, COL_STORE_F_SLOT] = \
                    act_assign[nd][(a.stage + 1, a.microbatch)]
        else:
            table[t, d, COL_BWD_V] = v
            table[t, d, COL_BWD_M] = a.microbatch
            table[t, d, COL_BWD_ASLOT] = act_assign[d][(a.stage, a.microbatch)]
            if a.stage < S - 1:
                table[t, d, COL_BWD_GSLOT] = grad_assign[d][(a.stage, a.microbatch)]
            if a.stage > 0:
                pd = device_of(a.stage - 1, D)
                table[t + 1, pd, COL_STORE_B_SLOT] = \
                    grad_assign[pd][(a.stage - 1, a.microbatch)]
    while T > 1 and np.all(table[T - 1] == -1):  # trim empty trailing ticks
        T -= 1
    cs = CompiledSchedule(name, D, V, M, table[:T], T, ticks, n_act, n_grad)
    verify_table(cs)
    return cs


def verify_table(cs: CompiledSchedule) -> None:
    """Symbolic interpreter over the table: runs the executor's store /
    compute / ring-hop contract on labels and checks that every forward
    reads its stage input and every backward its saved input and incoming
    cotangent. Raises ScheduleError on a stale read, a missing value or a
    unit that never runs."""
    D, S = cs.n_devices, cs.n_stages
    act = [dict() for _ in range(D)]   # slot -> ("act", stage, mb)
    grad = [dict() for _ in range(D)]  # slot -> ("gout", stage, mb)
    fwd_in = [None] * D  # delivered by last tick's +1 ring hop
    bwd_in = [None] * D  # ... -1 ring hop
    fwd_done, bwd_done = set(), set()
    if np.any(cs.table[:, :, COL_W_V:] >= 0):
        raise ScheduleError("table fills split-backward or V-placement "
                            "columns (9-16), which the port does not run")
    for t in range(cs.table.shape[0]):
        fwd_send = [None] * D
        bwd_send = [None] * D
        for d in range(D):
            row = cs.table[t, d]
            if row[COL_STORE_F_SLOT] >= 0:
                if fwd_in[d] is None:
                    raise ScheduleError(f"(device {d}, tick {t}): fwd store of empty register")
                act[d][int(row[COL_STORE_F_SLOT])] = fwd_in[d]
            if row[COL_STORE_B_SLOT] >= 0:
                if bwd_in[d] is None:
                    raise ScheduleError(f"(device {d}, tick {t}): bwd store of empty register")
                grad[d][int(row[COL_STORE_B_SLOT])] = bwd_in[d]
            if row[COL_FWD_M] >= 0:
                s = stage_of(d, int(row[COL_FWD_V]), D)
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
                    fwd_send[d] = ("act", s + 1, m)
                fwd_done.add((s, m))
            if row[COL_BWD_M] >= 0:
                s = stage_of(d, int(row[COL_BWD_V]), D)
                m = int(row[COL_BWD_M])
                aslot = int(row[COL_BWD_ASLOT])
                got = act[d].get(aslot)
                if got != ("act", s, m):
                    raise ScheduleError(
                        f"(device {d}, tick {t}): B(stage={s}, mb={m}) saved-input slot "
                        f"{aslot} holds {got}")
                if s < S - 1:
                    gslot = int(row[COL_BWD_GSLOT])
                    gg = grad[d].get(gslot)
                    if gg != ("gout", s, m):
                        raise ScheduleError(
                            f"(device {d}, tick {t}): B(stage={s}, mb={m}) grad slot "
                            f"{gslot} holds {gg}")
                if s > 0:
                    bwd_send[d] = ("gout", s - 1, m)
                bwd_done.add((s, m))
        fwd_in = [fwd_send[(d - 1) % D] for d in range(D)]
        bwd_in = [bwd_send[(d + 1) % D] for d in range(D)]
    want = {(s, m) for s in range(S) for m in range(cs.n_microbatches)}
    if fwd_done != want or bwd_done != want:
        raise ScheduleError("table does not execute every (stage, microbatch)")


def analytic_bubble_fraction(name: str, n_devices: int, n_virtual: int,
                             n_microbatches: int) -> float:
    """Ideal bubble fraction in unit-cost ticks: (D-1)/(M + D - 1) for
    GPipe and 1F1B, (D-1)/(M*V + D - 1) for Interleaved1F1B and BFS."""
    check_schedule_name(name)
    D, M = n_devices, n_microbatches
    V = n_virtual if name in ("Interleaved1F1B", "BFS") else 1
    return (D - 1) / (M * V + D - 1)
