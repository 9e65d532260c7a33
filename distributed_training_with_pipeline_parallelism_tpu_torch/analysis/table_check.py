"""The static table verifier: a slot-lifetime dataflow analysis over tick
tables (the port's own copy of the JAX package's
``analysis/table_check.py``, host numpy throughout).

:func:`..parallel.schedules.verify_table` is the compile-time gate: it
raises on the first violation of the store / compute / hand-over
contract. :func:`check_table` interprets the same contract over a
``[T, D, 17]`` table but keeps going, and returns a :class:`TableReport`
whose :class:`Hazard` entries carry the exact (device, tick, column) of
every read of a wrong value, overwrite of a live one or double store,
every hand-over sent without a bank or banked without a send, and every
route that disagrees with :func:`fwd_route` / :func:`bwd_route`.

On top of the hazards, the report carries what a clean table proves:

- per device, the slot high-water marks (``act_slots_used``,
  ``act_live_peak`` and the gradient twins): the activation memory bound
  the memory model prices;
- per ring channel, ``cells`` (bank entries) and ``hop_ticks`` (ticks
  with at least one bank): the hand-overs the executor sends, whose sum
  over the live channels is ``predicted_ppermutes``, the hop count the
  cost model prices;
- the ``compress_schedule`` -> ``replay_phases`` round trip and the unit
  counts against the action set ``validate_order`` demands;
- the double-buffered ring's discipline: ``overlap_bank_stages``'s bank
  points re-derived unit by unit, with each channel's exposed and
  overlappable hops, the static proof behind ``comm_overlap="ring"``'s
  bitwise parity.

The reports, hazard strings and summaries are the JAX module's exactly
(``tests/test_torch_table_check.py``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..parallel.schedules import (BANK_BEFORE_B, BANK_BEFORE_F, BANK_BEFORE_W,
                                  COL_BWD_ASLOT, COL_BWD_GSLOT,
                                  COL_BWD_LOCAL_SLOT, COL_BWD_M, COL_BWD_V,
                                  COL_FWD_LOCAL_SLOT, COL_FWD_M, COL_FWD_SLOT,
                                  COL_FWD_V, COL_STORE_B_POS_SLOT,
                                  COL_STORE_B_SLOT, COL_STORE_F_NEG_SLOT,
                                  COL_STORE_F_SLOT, COL_W_ASLOT, COL_W_GSLOT,
                                  COL_W_M, COL_W_V, OVERLAP_CHANNELS,
                                  CompiledSchedule, ScheduleError, bwd_route,
                                  compress_schedule, fwd_route,
                                  overlap_bank_stages, phase_spans,
                                  placement_stage_of, replay_phases,
                                  table_unit_activity)

# Column-index -> name, for exact hazard locations ("which cell is wrong").
COLUMN_NAMES: Dict[int, str] = {
    COL_STORE_F_SLOT: "COL_STORE_F_SLOT",
    COL_FWD_V: "COL_FWD_V",
    COL_FWD_M: "COL_FWD_M",
    COL_FWD_SLOT: "COL_FWD_SLOT",
    COL_STORE_B_SLOT: "COL_STORE_B_SLOT",
    COL_BWD_V: "COL_BWD_V",
    COL_BWD_M: "COL_BWD_M",
    COL_BWD_ASLOT: "COL_BWD_ASLOT",
    COL_BWD_GSLOT: "COL_BWD_GSLOT",
    COL_W_V: "COL_W_V",
    COL_W_M: "COL_W_M",
    COL_W_ASLOT: "COL_W_ASLOT",
    COL_W_GSLOT: "COL_W_GSLOT",
    COL_FWD_LOCAL_SLOT: "COL_FWD_LOCAL_SLOT",
    COL_STORE_F_NEG_SLOT: "COL_STORE_F_NEG_SLOT",
    COL_BWD_LOCAL_SLOT: "COL_BWD_LOCAL_SLOT",
    COL_STORE_B_POS_SLOT: "COL_STORE_B_POS_SLOT",
}

# The four ring channels: (report key, bank column, sender ring offset).
# A value banked from channel (key, col) at tick t was sent at t-1 by the
# device ``(d - offset) % D``, the executor's hand-over to its pipe peer.
RING_CHANNELS: Tuple[Tuple[str, int, int], ...] = (
    ("fwd_ring_pos", COL_STORE_F_SLOT, +1),
    ("bwd_ring_neg", COL_STORE_B_SLOT, -1),
    ("fwd_ring_neg", COL_STORE_F_NEG_SLOT, -1),
    ("bwd_ring_pos", COL_STORE_B_POS_SLOT, +1),
)


@dataclasses.dataclass(frozen=True)
class Hazard:
    """One verified violation, located to the exact table cell.

    ``kind`` is a stable machine-readable tag; ``device``/``tick`` are -1
    for findings about the whole table (unit counts, compression).
    """

    kind: str
    device: int
    tick: int
    column: str
    detail: str

    def location(self) -> str:
        return f"(device {self.device}, tick {self.tick}, {self.column})"

    def __str__(self) -> str:
        return f"{self.location()} {self.kind}: {self.detail}"


@dataclasses.dataclass
class TableReport:
    """Structured result of one static table verification."""

    name: str
    kind: str  # "train" | "forward" | "serving"
    n_devices: int
    n_virtual: int
    n_microbatches: int
    placement: str
    split_backward: bool
    makespan: int
    hazards: List[Hazard]
    # static memory bound: per-device max slot index in use + 1, and the
    # peak number of simultaneously-live values (<= slots used)
    act_slots_used: List[int]
    grad_slots_used: List[int]
    act_live_peak: List[int]
    grad_live_peak: List[int]
    n_act_slots: int
    n_grad_slots: int
    # channel key -> {"cells": stores in the table, "hop_ticks": ticks with
    # >= 1 store — the hand-overs the executor sends on the channel}
    comm: Dict[str, Dict[str, int]]
    unit_counts: Dict[str, int]
    compression: Dict[str, int]
    # channel key -> {"exposed_hop_ticks", "overlappable_hop_ticks"}: the
    # verified two-buffer discipline (train tables only; {} otherwise).
    # exposed + overlappable == the channel's hop_ticks.
    overlap: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.hazards

    @property
    def predicted_ppermutes(self) -> int:
        """The ring hops the table needs: per live channel, one a tick
        that banks from it. The reverse channels count only when the
        table routes through them."""
        keys = ["fwd_ring_pos", "bwd_ring_neg"]
        if self.uses_reverse_routes:
            keys += ["fwd_ring_neg", "bwd_ring_pos"]
        return sum(self.comm[k]["hop_ticks"] for k in keys if k in self.comm)

    @property
    def uses_reverse_routes(self) -> bool:
        return any(self.comm.get(k, {}).get("cells", 0) > 0
                   for k in ("fwd_ring_neg", "bwd_ring_pos",
                             "fwd_local", "bwd_local"))

    def summary(self) -> Dict[str, object]:
        """JSON-able digest (embedded in schedule artifacts and in the
        ``static_analysis`` section of a run report)."""
        return {
            "name": self.name,
            "kind": self.kind,
            "n_devices": self.n_devices,
            "n_virtual": self.n_virtual,
            "n_microbatches": self.n_microbatches,
            "placement": self.placement,
            "split_backward": self.split_backward,
            "makespan": self.makespan,
            "ok": self.ok,
            "n_hazards": len(self.hazards),
            "hazards": [str(h) for h in self.hazards],
            "act_slots_used": list(self.act_slots_used),
            "grad_slots_used": list(self.grad_slots_used),
            "act_live_peak": list(self.act_live_peak),
            "grad_live_peak": list(self.grad_live_peak),
            "n_act_slots": self.n_act_slots,
            "n_grad_slots": self.n_grad_slots,
            "comm": {k: dict(v) for k, v in self.comm.items()},
            "predicted_ppermutes": self.predicted_ppermutes,
            "unit_counts": dict(self.unit_counts),
            "compression": dict(self.compression),
            "overlap": {k: dict(v) for k, v in self.overlap.items()},
            "overlappable_hop_ticks": sum(
                v["overlappable_hop_ticks"] for v in self.overlap.values()),
        }


def _comm_volume(table: np.ndarray) -> Dict[str, Dict[str, int]]:
    """Per-channel stores (``cells``) and live hop ticks (``hop_ticks``).

    A store at tick t is fed by the hand-over at the end of tick t-1, so
    hop ticks are counted over ``t >= 1`` (a tick-0 store has no sender
    and is flagged as a hazard elsewhere).
    """
    out: Dict[str, Dict[str, int]] = {}
    for key, col, _ in RING_CHANNELS:
        stores = table[:, :, col] >= 0
        out[key] = {
            "cells": int(stores.sum()),
            "hop_ticks": int(stores[1:].any(axis=1).sum()),
        }
    for key, col in (("fwd_local", COL_FWD_LOCAL_SLOT),
                     ("bwd_local", COL_BWD_LOCAL_SLOT)):
        out[key] = {"cells": int((table[:, :, col] >= 0).sum()),
                    "hop_ticks": 0}
    return out


def hops_per_tick(table: np.ndarray) -> np.ndarray:
    """``[T]`` int64: the ring hops sent at the end of each tick, ``[t-1]``
    counting the channels with a store at tick t (one hop serves every
    device). Summed over a table's live channels it is
    :attr:`TableReport.predicted_ppermutes`; the cost model spreads it over
    the ticks for its overlapped bound."""
    table = np.asarray(table)
    hops = np.zeros(table.shape[0], dtype=np.int64)
    for _, col, _ in RING_CHANNELS:
        hops[:-1] += (table[1:, :, col] >= 0).any(axis=1)
    return hops


# Per-unit slot touches the deferred-bank discipline must not reorder
# against: (unit label, bank stage the unit runs after, activity column,
# ((slot column, buffer kind), ...)). A bank deferred past the unit's
# stage while the unit reads OR writes the banked slot breaks lockstep
# equivalence (reads would see the new arrival early; writes must land
# after the bank so the unit's write stays last).
_OVERLAP_UNIT_TOUCHES: Tuple[Tuple[str, int, int, Tuple[Tuple[int, str], ...]],
                             ...] = (
    ("F", BANK_BEFORE_F, COL_FWD_M,
     ((COL_FWD_SLOT, "act"), (COL_FWD_LOCAL_SLOT, "act"))),
    ("B", BANK_BEFORE_B, COL_BWD_M,
     ((COL_BWD_ASLOT, "act"), (COL_BWD_GSLOT, "grad"),
      (COL_BWD_LOCAL_SLOT, "grad"))),
    ("W", BANK_BEFORE_W, COL_W_M,
     ((COL_W_ASLOT, "act"), (COL_W_GSLOT, "grad"))),
)

# OVERLAP_CHANNELS shares RING_CHANNELS' column order; the overlap stats
# take the comm dict's channel keys.
_OVERLAP_KEYS: Tuple[str, ...] = tuple(key for key, _, _ in RING_CHANNELS)


def _overlap_discipline(table: np.ndarray,
                        hazards: List[Hazard]) -> Dict[str, Dict[str, int]]:
    """Verify the two-buffer (deferred-bank) ring discipline and count
    exposed vs overlappable hops per channel.

    ``schedules.overlap_bank_stages`` is the executor's single source of
    truth for where each arrival is committed; this check re-derives the
    constraint set independently (unit by unit, device by device) and
    flags any tick where a claimed bank stage is deferred past a unit that
    reads or writes the banked slot (``overlap-stage``), or where two
    same-buffer channels landing in one slot are assigned different
    stages, losing the lockstep write order (``overlap-order``). A clean
    report therefore *proves* the staged executor bit-equivalent to the
    lockstep one on this table.

    Returns per-channel ``{"exposed_hop_ticks", "overlappable_hop_ticks"}``
    over ticks ``t >= 1`` (same attribution as ``hop_ticks``): a hop whose
    arrival banks at stage 0 fences the next tick's first unit (exposed);
    any later stage lets the hop overlap the units before its bank point.
    """
    st = overlap_bank_stages(table)
    T = table.shape[0]
    out: Dict[str, Dict[str, int]] = {}
    for ci, (bank_col, kind) in enumerate(OVERLAP_CHANNELS):
        slots = table[:, :, bank_col]  # [T, D]; -1 = no bank
        banked = slots >= 0
        live = banked[1:].any(axis=1)  # per tick t >= 1
        deferred = st[1:, ci] > BANK_BEFORE_F
        out[_OVERLAP_KEYS[ci]] = {
            "exposed_hop_ticks": int((live & ~deferred).sum()),
            "overlappable_hop_ticks": int((live & deferred).sum()),
        }
        # soundness: no unit ordered before the bank touches the slot
        for label, unit_stage, m_col, slot_cols in _OVERLAP_UNIT_TOUCHES:
            if not (st[:, ci] > unit_stage).any():
                continue
            on = table[:, :, m_col] >= 0
            for slot_col, k in slot_cols:
                if k != kind:
                    continue
                touch = (table[:, :, slot_col] >= 0
                         if slot_col in (COL_FWD_LOCAL_SLOT,
                                         COL_BWD_LOCAL_SLOT)
                         else on)
                bad = (banked & touch & (table[:, :, slot_col] == slots)
                       & (st[:, ci] > unit_stage)[:, None])
                for t, d in np.argwhere(bad):
                    hazards.append(Hazard(
                        "overlap-stage", int(d), int(t),
                        COLUMN_NAMES[bank_col],
                        f"bank of slot {int(slots[t, d])} deferred to stage "
                        f"{int(st[t, ci])} but the {label} unit "
                        f"({COLUMN_NAMES[slot_col]}) touches it at stage "
                        f"{unit_stage}"))
    # same-buffer channels landing in the same slot must bank in lockstep
    # order, which the executor only preserves inside one stage
    for i, j in ((0, 2), (1, 3)):
        si = table[:, :, OVERLAP_CHANNELS[i][0]]
        sj = table[:, :, OVERLAP_CHANNELS[j][0]]
        clash = (si >= 0) & (sj >= 0) & (si == sj)
        for t in np.nonzero(clash.any(axis=1))[0]:
            if st[t, i] != st[t, j]:
                d = int(np.nonzero(clash[t])[0][0])
                hazards.append(Hazard(
                    "overlap-order", d, int(t),
                    COLUMN_NAMES[OVERLAP_CHANNELS[j][0]],
                    f"channels {_OVERLAP_KEYS[i]}/{_OVERLAP_KEYS[j]} bank "
                    f"slot {int(si[t, d])} at different stages "
                    f"({int(st[t, i])} vs {int(st[t, j])})"))
    return out


class _SlotFile:
    """One device's slot-addressed buffer under symbolic interpretation,
    with value liveness (outstanding expected reads) for WAR detection."""

    def __init__(self, label: str, n_slots: int):
        self.label = label
        self.n_slots = n_slots
        self.value: Dict[int, Tuple] = {}       # slot -> symbolic value
        self.reads_left: Dict[int, List[int]] = {}  # slot -> pending read ticks
        self.max_slot = -1
        self.live = 0
        self.live_peak = 0
        # optional write-event recorder (set by _TrainInterp): entries
        # (t, d, label, slot, column, prev_value, pending) let
        # recheck_after_swap re-derive prefix WAR hazards under a *new*
        # read schedule without reinterpreting the prefix
        self.log: Optional[List[Tuple]] = None

    def write(self, slot: int, val: Tuple, t: int, d: int, column: int,
              expected_reads: List[int], hazards: List[Hazard],
              written_this_tick: Dict[int, int]) -> None:
        self.max_slot = max(self.max_slot, slot)
        if slot in written_this_tick:
            hazards.append(Hazard(
                "double-store", d, t, COLUMN_NAMES[column],
                f"{self.label} slot {slot} written twice in one tick "
                f"(first via {COLUMN_NAMES[written_this_tick[slot]]})"))
        written_this_tick[slot] = column
        pending = [r for r in self.reads_left.get(slot, []) if r >= t]
        if self.log is not None:
            self.log.append((t, d, self.label, slot, column,
                             self.value.get(slot), tuple(pending)))
        if pending:
            hazards.append(Hazard(
                "overwrite-live", d, t, COLUMN_NAMES[column],
                f"{self.label} slot {slot} overwritten while "
                f"{self.value.get(slot)} still has reads at ticks "
                f"{pending}"))
        else:
            if self.reads_left.get(slot):
                self.live -= 1  # previous value retired cleanly
        self.value[slot] = val
        self.reads_left[slot] = list(expected_reads)
        if self.reads_left[slot]:
            self.live += 1
            self.live_peak = max(self.live_peak, self.live)

    def read(self, slot: int, expect: Tuple, t: int, d: int, column: int,
             what: str, hazards: List[Hazard]) -> None:
        self.max_slot = max(self.max_slot, slot)
        got = self.value.get(slot)
        if got != expect:
            hazards.append(Hazard(
                "read-wrong-value", d, t, COLUMN_NAMES[column],
                f"{what} expected {expect} in {self.label} slot {slot}, "
                f"found {got}"))
        pend = self.reads_left.get(slot)
        if pend and t in pend:
            pend.remove(t)
            if not pend:
                self.live -= 1


def _expected_reads(table: np.ndarray, placement: str, D: int
                    ) -> Tuple[Dict, Dict]:
    """Read schedule per device and value, derived from the table itself:
    ``act_reads[d][(s, m)]`` / ``grad_reads[d][(s, m)]`` -> sorted ticks at
    which the table claims to read that value. Drives WAR liveness (a
    corrupted read column simply shifts the claimed schedule — the
    symbolic value check still catches the mismatch)."""
    T = table.shape[0]
    act_reads: Dict[int, Dict[Tuple[int, int], List[int]]] = \
        {d: {} for d in range(D)}
    grad_reads: Dict[int, Dict[Tuple[int, int], List[int]]] = \
        {d: {} for d in range(D)}
    for t in range(T):
        for d in range(D):
            row = table[t, d]
            if row[COL_FWD_M] >= 0:
                s = placement_stage_of(placement, d, int(row[COL_FWD_V]), D)
                act_reads[d].setdefault((s, int(row[COL_FWD_M])),
                                        []).append(t)
            for vcol, mcol in ((COL_BWD_V, COL_BWD_M), (COL_W_V, COL_W_M)):
                if row[mcol] >= 0:
                    s = placement_stage_of(placement, d, int(row[vcol]), D)
                    m = int(row[mcol])
                    act_reads[d].setdefault((s, m), []).append(t)
                    grad_reads[d].setdefault((s, m), []).append(t)
    return act_reads, grad_reads


class _TrainInterp:
    """The symbolic interpreter behind :func:`check_table`, restructured as
    a resumable object so the schedule-search loop can snapshot per-tick
    state and revalidate only the suffix after a local move
    (:func:`recheck_after_swap`). ``run_tick`` is the exact per-tick
    contract: arrival stores, then F/B/W units, then send/recv pairing and
    register rotation."""

    def __init__(self, cs: CompiledSchedule):
        self.cs = cs
        self.table = np.asarray(cs.table)
        self.T, self.D = self.table.shape[0], cs.n_devices
        self.S, self.M = cs.n_stages, cs.n_microbatches
        self.pl = cs.placement
        self.hazards: List[Hazard] = []
        self.act_reads, self.grad_reads = _expected_reads(
            self.table, self.pl, self.D)
        self.act = [_SlotFile("act_buf", cs.n_act_slots)
                    for _ in range(self.D)]
        self.grad = [_SlotFile("grad_buf", cs.n_grad_slots)
                     for _ in range(self.D)]
        # channel registers: the value last tick's hand-over delivered
        self.regs: Dict[str, List[Optional[Tuple]]] = {
            key: [None] * self.D for key, _, _ in RING_CHANNELS}
        self.fwd_done: Dict[Tuple[int, int], int] = {}
        self.bwd_done: Dict[Tuple[int, int], int] = {}
        self.w_done: Dict[Tuple[int, int], int] = {}
        self.b_slots: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
        self.f_slots: Dict[Tuple[int, int], int] = {}

    def _check_bounds(self, slot, n_slots, t, d, col, label):
        if slot >= n_slots:
            self.hazards.append(Hazard(
                "slot-out-of-bounds", d, t, COLUMN_NAMES[col],
                f"{label} slot {slot} >= declared n_slots {n_slots}"))

    def run_tick(self, t: int) -> None:
        table, D, S, pl = self.table, self.D, self.S, self.pl
        cs, hazards = self.cs, self.hazards
        act, grad = self.act, self.grad
        act_reads, grad_reads = self.act_reads, self.grad_reads
        check_bounds = self._check_bounds
        fwd_done, bwd_done, w_done = self.fwd_done, self.bwd_done, self.w_done
        b_slots, f_slots = self.b_slots, self.f_slots
        T = self.T

        sends: Dict[str, List[Optional[Tuple]]] = {
            key: [None] * D for key, _, _ in RING_CHANNELS}
        for d in range(D):
            row = table[t, d]
            written_act: Dict[int, int] = {}
            written_grad: Dict[int, int] = {}

            # 1. bank ring arrivals (reads channel registers filled at t-1)
            for key, col, _ in RING_CHANNELS:
                slot = int(row[col])
                if slot < 0:
                    continue
                buf = act[d] if col in (COL_STORE_F_SLOT,
                                        COL_STORE_F_NEG_SLOT) else grad[d]
                reads = act_reads if buf is act[d] else grad_reads
                check_bounds(slot, buf.n_slots, t, d, col, buf.label)
                val = self.regs[key][d]
                if val is None:
                    hazards.append(Hazard(
                        "store-empty-register", d, t, COLUMN_NAMES[col],
                        f"{key} store into {buf.label} slot {slot} but no "
                        f"value arrived on the channel (dropped or "
                        f"misrouted send at tick {t - 1})"))
                    continue
                buf.write(slot, val, t, d, col,
                          reads[d].get((val[1], val[2]), []), hazards,
                          written_act if buf is act[d] else written_grad)

            # 2. forward unit
            if row[COL_FWD_M] >= 0:
                s = placement_stage_of(pl, d, int(row[COL_FWD_V]), D)
                m = int(row[COL_FWD_M])
                slot = int(row[COL_FWD_SLOT])
                check_bounds(slot, cs.n_act_slots, t, d, COL_FWD_SLOT,
                             "act_buf")
                if s == 0:
                    # embed computed in place: the write IS this tick's F
                    act[d].write(slot, ("act", 0, m), t, d, COL_FWD_SLOT,
                                 act_reads[d].get((0, m), []), hazards,
                                 written_act)
                act[d].read(slot, ("act", s, m), t, d, COL_FWD_SLOT,
                            f"F(stage={s}, mb={m})", hazards)
                if (s, m) in fwd_done:
                    hazards.append(Hazard(
                        "duplicate-unit", d, t, COLUMN_NAMES[COL_FWD_M],
                        f"F(stage={s}, mb={m}) already ran at tick "
                        f"{fwd_done[(s, m)]}"))
                fwd_done[(s, m)] = t
                f_slots[(s, m)] = slot
                # route the output
                if s < S - 1:
                    route = fwd_route(pl, s, D)
                    if route == "local":
                        lslot = int(row[COL_FWD_LOCAL_SLOT])
                        if lslot < 0:
                            hazards.append(Hazard(
                                "route-mismatch", d, t,
                                "COL_FWD_LOCAL_SLOT",
                                f"F(stage={s}) routes 'local' but "
                                f"COL_FWD_LOCAL_SLOT is unset"))
                        else:
                            check_bounds(lslot, cs.n_act_slots, t, d,
                                         COL_FWD_LOCAL_SLOT, "act_buf")
                            act[d].write(
                                lslot, ("act", s + 1, m), t, d,
                                COL_FWD_LOCAL_SLOT,
                                act_reads[d].get((s + 1, m), []), hazards,
                                written_act)
                    else:
                        key = ("fwd_ring_pos" if route == "+1"
                               else "fwd_ring_neg")
                        sends[key][d] = ("act", s + 1, m)
                        if row[COL_FWD_LOCAL_SLOT] >= 0:
                            hazards.append(Hazard(
                                "route-mismatch", d, t,
                                "COL_FWD_LOCAL_SLOT",
                                f"F(stage={s}) routes '{route}' ring but "
                                f"COL_FWD_LOCAL_SLOT is set"))
                elif row[COL_FWD_LOCAL_SLOT] >= 0:
                    hazards.append(Hazard(
                        "route-mismatch", d, t, "COL_FWD_LOCAL_SLOT",
                        f"last stage F(stage={s}) must not route a local "
                        f"hop"))
            elif row[COL_FWD_LOCAL_SLOT] >= 0:
                hazards.append(Hazard(
                    "route-mismatch", d, t, "COL_FWD_LOCAL_SLOT",
                    "local fwd hop without an active forward unit"))

            # 3. backward (full or dgrad) unit
            if row[COL_BWD_M] >= 0:
                s = placement_stage_of(pl, d, int(row[COL_BWD_V]), D)
                m = int(row[COL_BWD_M])
                aslot = int(row[COL_BWD_ASLOT])
                check_bounds(aslot, cs.n_act_slots, t, d, COL_BWD_ASLOT,
                             "act_buf")
                act[d].read(aslot, ("act", s, m), t, d, COL_BWD_ASLOT,
                            f"B(stage={s}, mb={m}) saved input", hazards)
                gslot = int(row[COL_BWD_GSLOT])
                if s < S - 1:
                    check_bounds(gslot, cs.n_grad_slots, t, d,
                                 COL_BWD_GSLOT, "grad_buf")
                    grad[d].read(gslot, ("gout", s, m), t, d, COL_BWD_GSLOT,
                                 f"B(stage={s}, mb={m}) incoming cotangent",
                                 hazards)
                if (s, m) in bwd_done:
                    hazards.append(Hazard(
                        "duplicate-unit", d, t, COLUMN_NAMES[COL_BWD_M],
                        f"B(stage={s}, mb={m}) already ran at tick "
                        f"{bwd_done[(s, m)]}"))
                bwd_done[(s, m)] = t
                b_slots[(d, s, m)] = (aslot, gslot)
                if s > 0:
                    route = bwd_route(pl, s, D)
                    if route == "local":
                        lslot = int(row[COL_BWD_LOCAL_SLOT])
                        if lslot < 0:
                            hazards.append(Hazard(
                                "route-mismatch", d, t,
                                "COL_BWD_LOCAL_SLOT",
                                f"B(stage={s}) routes 'local' but "
                                f"COL_BWD_LOCAL_SLOT is unset"))
                        else:
                            check_bounds(lslot, cs.n_grad_slots, t, d,
                                         COL_BWD_LOCAL_SLOT, "grad_buf")
                            grad[d].write(
                                lslot, ("gout", s - 1, m), t, d,
                                COL_BWD_LOCAL_SLOT,
                                grad_reads[d].get((s - 1, m), []), hazards,
                                written_grad)
                    else:
                        key = ("bwd_ring_neg" if route == "-1"
                               else "bwd_ring_pos")
                        sends[key][d] = ("gout", s - 1, m)
                        if row[COL_BWD_LOCAL_SLOT] >= 0:
                            hazards.append(Hazard(
                                "route-mismatch", d, t,
                                "COL_BWD_LOCAL_SLOT",
                                f"B(stage={s}) routes '{route}' ring but "
                                f"COL_BWD_LOCAL_SLOT is set"))
                elif row[COL_BWD_LOCAL_SLOT] >= 0:
                    hazards.append(Hazard(
                        "route-mismatch", d, t, "COL_BWD_LOCAL_SLOT",
                        "stage 0 backward must not route a cotangent"))
            elif row[COL_BWD_LOCAL_SLOT] >= 0:
                hazards.append(Hazard(
                    "route-mismatch", d, t, "COL_BWD_LOCAL_SLOT",
                    "local bwd hop without an active backward unit"))

            # 4. weight-grad unit (split schedules)
            if row[COL_W_M] >= 0:
                s = placement_stage_of(pl, d, int(row[COL_W_V]), D)
                m = int(row[COL_W_M])
                aslot = int(row[COL_W_ASLOT])
                gslot = int(row[COL_W_GSLOT])
                check_bounds(aslot, cs.n_act_slots, t, d, COL_W_ASLOT,
                             "act_buf")
                act[d].read(aslot, ("act", s, m), t, d, COL_W_ASLOT,
                            f"W(stage={s}, mb={m}) saved input", hazards)
                if s < S - 1:
                    check_bounds(gslot, cs.n_grad_slots, t, d, COL_W_GSLOT,
                                 "grad_buf")
                    grad[d].read(gslot, ("gout", s, m), t, d, COL_W_GSLOT,
                                 f"W(stage={s}, mb={m}) incoming cotangent",
                                 hazards)
                if (s, m) in w_done:
                    hazards.append(Hazard(
                        "duplicate-unit", d, t, COLUMN_NAMES[COL_W_M],
                        f"W(stage={s}, mb={m}) already ran at tick "
                        f"{w_done[(s, m)]}"))
                w_done[(s, m)] = t
                # W must alias the B unit's saved slots, never a recycled
                # copy (split-backward contract; stage 0 has no B — its
                # saved input is F(0, m)'s own slot)
                if (d, s, m) in b_slots:
                    ba, bg = b_slots[(d, s, m)]
                    if aslot != ba:
                        hazards.append(Hazard(
                            "w-slot-alias", d, t, "COL_W_ASLOT",
                            f"W(stage={s}, mb={m}) saved-input slot "
                            f"{aslot} != B's slot {ba}"))
                    if s < S - 1 and gslot != bg:
                        hazards.append(Hazard(
                            "w-slot-alias", d, t, "COL_W_GSLOT",
                            f"W(stage={s}, mb={m}) cotangent slot {gslot} "
                            f"!= B's slot {bg}"))
                elif s == 0 and (0, m) in f_slots \
                        and aslot != f_slots[(0, m)]:
                    hazards.append(Hazard(
                        "w-slot-alias", d, t, "COL_W_ASLOT",
                        f"W(stage=0, mb={m}) saved-input slot {aslot} != "
                        f"F(0, {m})'s slot {f_slots[(0, m)]}"))

        # 5. send/recv pairing per ring direction, then rotate registers.
        # A send with no matching next-tick store silently drops data; a
        # store with no matching previous-tick send banks garbage — both
        # are located at the store cell. (A tick-0 store can pair with
        # nothing: the channel registers start empty.)
        for key, col, offset in RING_CHANNELS:
            if t == 0:
                for d in range(D):
                    if table[0, d, col] >= 0:
                        hazards.append(Hazard(
                            "recv-unpaired", d, 0, COLUMN_NAMES[col],
                            f"{key} store at tick 0 precedes any send"))
            for d in range(D):
                val = sends[key][d]
                dst = (d + offset) % D
                if val is not None:
                    if t + 1 >= T or table[t + 1, dst, col] < 0:
                        hazards.append(Hazard(
                            "send-unpaired", dst, t + 1,
                            COLUMN_NAMES[col],
                            f"{key} send of {val} from device {d} at tick "
                            f"{t} has no receiving store"))
                src = (d - offset) % D
                if (t + 1 < T and table[t + 1, d, col] >= 0
                        and sends[key][src] is None):
                    hazards.append(Hazard(
                        "recv-unpaired", d, t + 1, COLUMN_NAMES[col],
                        f"{key} store at tick {t + 1} has no matching "
                        f"send from device {src} at tick {t}"))
            # rotate: after the hand-over, device d holds what (d - offset)
            # sent — the channel register is indexed by receiver
            self.regs[key] = [sends[key][(d - offset) % D]
                              for d in range(D)]

    # -- snapshot/restore for the incremental recheck fast path ----------

    @staticmethod
    def _snap_files(files: List[_SlotFile]):
        return [(dict(f.value), {k: list(v) for k, v in f.reads_left.items()},
                 f.max_slot, f.live, f.live_peak) for f in files]

    def snapshot(self):
        """Copy of all interpreter state *before* the next run_tick call."""
        return (self._snap_files(self.act), self._snap_files(self.grad),
                {k: list(v) for k, v in self.regs.items()},
                dict(self.fwd_done), dict(self.bwd_done), dict(self.w_done),
                dict(self.b_slots), dict(self.f_slots))

    def restore(self, snap) -> None:
        acts, grads, regs, fd, bd, wd, bs, fs = snap
        for files, saved in ((self.act, acts), (self.grad, grads)):
            for f, (val, rl, ms, lv, lp) in zip(files, saved):
                f.value = dict(val)
                f.reads_left = {k: list(v) for k, v in rl.items()}
                f.max_slot, f.live, f.live_peak = ms, lv, lp
        self.regs = {k: list(v) for k, v in regs.items()}
        self.fwd_done = dict(fd)
        self.bwd_done = dict(bd)
        self.w_done = dict(wd)
        self.b_slots = dict(bs)
        self.f_slots = dict(fs)

    def repatch_reads(self, start: int) -> None:
        """Point restored slot liveness at THIS table's read schedule.

        After restoring a snapshot taken on a different (prefix-identical)
        table, each live value's pending reads must come from the *new*
        table's derived read schedule: for a clean prefix every expected
        read before ``start`` was consumed, so the remainder is exactly the
        new schedule filtered to ``>= start``."""
        for files, reads in ((self.act, self.act_reads),
                             (self.grad, self.grad_reads)):
            for d, f in enumerate(files):
                live = 0
                for slot, val in f.value.items():
                    pend = [r for r in reads[d].get((val[1], val[2]), [])
                            if r >= start]
                    f.reads_left[slot] = pend
                    if pend:
                        live += 1
                f.live = live
                f.live_peak = max(f.live_peak, live)

    def finish(self, *, compression: bool = True) -> TableReport:
        """Global (whole-table) checks + report assembly: unit counts vs
        the action set validate_order demands, and (optionally) the
        phase-compression roundtrip."""
        cs, table, hazards = self.cs, self.table, self.hazards
        T, S, M = self.T, self.S, self.M
        activity = table_unit_activity(table).sum(axis=(0, 1))
        n_f, n_b, n_w = int(activity[0]), int(activity[1]), int(activity[2])
        want_f = S * M
        want_b = (S - 1) * M if cs.split_backward else S * M
        want_w = S * M if cs.split_backward else 0
        for label, got, want, col in (("F", n_f, want_f, COL_FWD_M),
                                      ("B", n_b, want_b, COL_BWD_M),
                                      ("W", n_w, want_w, COL_W_M)):
            if got != want:
                hazards.append(Hazard(
                    "unit-count", -1, -1, COLUMN_NAMES[col],
                    f"{label} unit count {got} != expected {want} "
                    f"(S={S}, M={M}, split_backward={cs.split_backward})"))
        unit_counts = {"F": n_f, "B": n_b, "W": n_w, "idle": int(activity[3])}

        # phase-compression roundtrip (compress self-checks; assert anyway)
        comp: Dict[str, int] = {}
        if compression:
            try:
                phases = compress_schedule(table)
                if not np.array_equal(replay_phases(phases), table):
                    raise ScheduleError("replay does not reconstruct the table")
                spans = phase_spans(phases)
                if sum(n for _, n in spans) != T:
                    raise ScheduleError("phase spans do not tile the table")
                comp = {"n_phases": len(phases), "n_rows": T}
            except ScheduleError as e:
                hazards.append(Hazard("compression-roundtrip", -1, -1,
                                      "table", str(e)))

        return TableReport(
            name=cs.name, kind="train", n_devices=self.D,
            n_virtual=cs.n_virtual, n_microbatches=M, placement=self.pl,
            split_backward=cs.split_backward, makespan=T, hazards=hazards,
            act_slots_used=[a.max_slot + 1 for a in self.act],
            grad_slots_used=[g.max_slot + 1 for g in self.grad],
            act_live_peak=[a.live_peak for a in self.act],
            grad_live_peak=[g.live_peak for g in self.grad],
            n_act_slots=cs.n_act_slots, n_grad_slots=cs.n_grad_slots,
            comm=_comm_volume(table), unit_counts=unit_counts,
            compression=comp,
            overlap=_overlap_discipline(table, hazards))


def check_table(cs: CompiledSchedule) -> TableReport:
    """Statically verify a compiled training schedule's tick table.

    Interprets the executor contract cell by cell (arrival stores, then
    F/B/W units, then routed sends), accumulating every violation as a
    located :class:`Hazard` instead of raising — see the module docstring
    for the full check list."""
    interp = _TrainInterp(cs)
    for t in range(interp.T):
        interp.run_tick(t)
    return interp.finish()


# ---------------------------------------------------------------------------
# Search-loop fast path: digest memoization + incremental suffix recheck
# ---------------------------------------------------------------------------

_REPORT_MEMO: "OrderedDict[Tuple, TableReport]" = OrderedDict()
_REPORT_MEMO_MAX = 256


def _memo_key(cs: CompiledSchedule) -> Tuple:
    from ..parallel.schedules import table_digest
    return (table_digest(cs.table), cs.n_devices, cs.n_virtual,
            cs.n_microbatches, cs.placement, bool(cs.split_backward),
            cs.n_act_slots, cs.n_grad_slots)


def check_table_cached(cs: CompiledSchedule) -> TableReport:
    """:func:`check_table` memoized by table content digest + compile
    metadata (LRU, bounded). The returned report is shared across hits —
    treat it as immutable."""
    key = _memo_key(cs)
    hit = _REPORT_MEMO.get(key)
    if hit is not None:
        _REPORT_MEMO.move_to_end(key)
        return hit
    report = check_table(cs)
    _REPORT_MEMO[key] = report
    while len(_REPORT_MEMO) > _REPORT_MEMO_MAX:
        _REPORT_MEMO.popitem(last=False)
    return report


@dataclasses.dataclass
class TableCheckBaseline:
    """Full check of one table plus per-tick interpreter snapshots, the
    anchor :func:`recheck_after_swap` resumes from."""

    cs: CompiledSchedule
    table: np.ndarray
    report: TableReport
    snapshots: List[Tuple]  # snapshots[t] = state before run_tick(t)
    write_log: List[Tuple]  # every buffer write: (t, d, label, slot, ...)


def check_table_baseline(cs: CompiledSchedule) -> TableCheckBaseline:
    """Run the full :func:`check_table` pass, keeping a state snapshot
    before every tick so nearby candidate tables can be rechecked from the
    first tick that differs instead of from tick 0."""
    interp = _TrainInterp(cs)
    log: List[Tuple] = []
    for f in interp.act + interp.grad:
        f.log = log
    snaps: List[Tuple] = []
    for t in range(interp.T):
        snaps.append(interp.snapshot())
        interp.run_tick(t)
    report = interp.finish()
    return TableCheckBaseline(cs=cs, table=interp.table.copy(),
                              report=report, snapshots=snaps,
                              write_log=log)


# Hazard kinds at tick ``start`` that the resumed interpretation cannot
# re-derive (they were emitted by run_tick(start - 1)'s pairing stage
# against the unchanged row at ``start - 1``) — reused from the baseline.
_PAIRING_KINDS = ("send-unpaired", "recv-unpaired")


def recheck_after_swap(cs_new: CompiledSchedule,
                       baseline: TableCheckBaseline) -> TableReport:
    """Incrementally recheck ``cs_new`` against a clean baseline.

    Finds the first tick where the new table differs from the baseline's,
    restores the interpreter snapshot one tick earlier (pairing checks look
    one row ahead), repoints slot liveness at the new table's read
    schedule, and interprets only the suffix. Falls back to the full
    :func:`check_table` when the baseline has hazards or the compile
    metadata differs. Equivalent to the full check for hazard locations,
    slot high-water marks, unit counts, and comm volume (tested over a
    random-mutation corpus); the phase-compression roundtrip is skipped
    (``compression == {}``) and prefix live peaks are inherited from the
    baseline.
    """
    base_cs = baseline.cs
    if (cs_new.n_devices != base_cs.n_devices
            or cs_new.n_virtual != base_cs.n_virtual
            or cs_new.n_microbatches != base_cs.n_microbatches
            or cs_new.placement != base_cs.placement
            or bool(cs_new.split_backward) != bool(base_cs.split_backward)
            or cs_new.n_act_slots < base_cs.n_act_slots
            or cs_new.n_grad_slots < base_cs.n_grad_slots
            or not baseline.report.ok):
        return check_table(cs_new)
    new = np.asarray(cs_new.table)
    old = baseline.table
    k = min(new.shape[0], old.shape[0])
    diff = np.nonzero((new[:k] != old[:k]).any(axis=(1, 2)))[0]
    if diff.size == 0:
        if (new.shape[0] == old.shape[0]
                and cs_new.n_act_slots == base_cs.n_act_slots
                and cs_new.n_grad_slots == base_cs.n_grad_slots):
            return baseline.report  # identical table
        t0 = k
    else:
        t0 = int(diff[0])
    start = max(0, t0 - 1)
    interp = _TrainInterp(cs_new)
    interp.restore(baseline.snapshots[start])
    interp.repatch_reads(start)
    for t in range(start, interp.T):
        interp.run_tick(t)
    report = interp.finish(compression=False)
    if start > 0:
        # Prefix hazards carry over verbatim (rows < start are identical;
        # pairing hazards AT start were emitted by run_tick(start - 1))...
        prefix = [h for h in baseline.report.hazards
                  if 0 <= h.tick < start
                  or (h.tick == start and h.kind in _PAIRING_KINDS)]
        # ...except WAR liveness: the read schedule is derived from the
        # whole table, so a changed suffix can retroactively make a prefix
        # overwrite hit a still-live value. Claims below t0 are identical
        # (identical rows), so for the clean baseline a prefix write over
        # resident value P becomes overwrite-live iff P's *new* claim list
        # has reads >= t0.
        for (u, d, label, slot, column, prev_val, _pending) in \
                baseline.write_log:
            if u >= start or prev_val is None:
                continue
            reads = (interp.act_reads if label == "act_buf"
                     else interp.grad_reads)
            tail = [r for r in reads[d].get((prev_val[1], prev_val[2]), [])
                    if r >= t0]
            if tail:
                prefix.append(Hazard(
                    "overwrite-live", d, u, COLUMN_NAMES[column],
                    f"{label} slot {slot} overwritten while {prev_val} "
                    f"still has reads at ticks {tail}"))
        report.hazards[:0] = prefix
    return report


def check_forward_table(table: np.ndarray, n_devices: int, n_virtual: int,
                        n_microbatches: int, n_slots: int) -> TableReport:
    """Verify the 4-column forward-only table (``pipeline._fwd_tick_table``:
    columns (store_slot, fv, fm, src_slot), wrap placement, +1 ring only)."""
    table = np.asarray(table)
    T, D = table.shape[0], n_devices
    S, M = n_devices * n_virtual, n_microbatches
    hazards: List[Hazard] = []
    COLS = {0: "STORE_SLOT", 1: "FWD_V", 2: "FWD_M", 3: "SRC_SLOT"}

    # read schedule: value ("act", s, m) read at F(s, m)'s tick
    reads: Dict[int, Dict[Tuple[int, int], List[int]]] = \
        {d: {} for d in range(D)}
    for t in range(T):
        for d in range(D):
            if table[t, d, 2] >= 0 and table[t, d, 3] >= 0:
                s = int(table[t, d, 1]) * D + d
                reads[d].setdefault((s, int(table[t, d, 2])), []).append(t)

    bufs = [_SlotFile("act_buf", n_slots) for _ in range(D)]
    reg: List[Optional[Tuple]] = [None] * D
    fwd_done: Dict[Tuple[int, int], int] = {}
    for t in range(T):
        send: List[Optional[Tuple]] = [None] * D
        for d in range(D):
            store, fv, fm, src = (int(x) for x in table[t, d])
            written: Dict[int, int] = {}
            if store >= 0:
                if store >= n_slots:
                    hazards.append(Hazard(
                        "slot-out-of-bounds", d, t, COLS[0],
                        f"store slot {store} >= n_slots {n_slots}"))
                val = reg[d]
                if val is None:
                    hazards.append(Hazard(
                        "store-empty-register", d, t, COLS[0],
                        f"store into slot {store} with no arrival "
                        f"(dropped send at tick {t - 1})"))
                else:
                    bufs[d].write(store, val, t, d, COL_STORE_F_SLOT,
                                  reads[d].get((val[1], val[2]), []),
                                  hazards, written)
            if fm >= 0:
                s = fv * D + d
                if s > 0:
                    if src < 0:
                        hazards.append(Hazard(
                            "read-wrong-value", d, t, COLS[3],
                            f"F(stage={s}, mb={fm}) has no input slot"))
                    else:
                        bufs[d].read(src, ("act", s, fm), t, d,
                                     COL_FWD_SLOT,
                                     f"F(stage={s}, mb={fm})", hazards)
                if (s, fm) in fwd_done:
                    hazards.append(Hazard(
                        "duplicate-unit", d, t, COLS[2],
                        f"F(stage={s}, mb={fm}) already ran at tick "
                        f"{fwd_done[(s, fm)]}"))
                fwd_done[(s, fm)] = t
                if s + 1 < S:
                    send[d] = ("act", s + 1, fm)
        for d in range(D):
            if t == 0 and table[0, d, 0] >= 0:
                hazards.append(Hazard(
                    "recv-unpaired", d, 0, COLS[0],
                    "fwd store at tick 0 precedes any send"))
            dst = (d + 1) % D
            if send[d] is not None and (
                    t + 1 >= T or table[t + 1, dst, 0] < 0):
                hazards.append(Hazard(
                    "send-unpaired", dst, t + 1, COLS[0],
                    f"fwd send of {send[d]} from device {d} at tick {t} "
                    f"has no receiving store"))
            src_dev = (d - 1) % D
            if (t + 1 < T and table[t + 1, d, 0] >= 0
                    and send[src_dev] is None):
                hazards.append(Hazard(
                    "recv-unpaired", d, t + 1, COLS[0],
                    f"fwd store at tick {t + 1} has no matching send "
                    f"from device {src_dev} at tick {t}"))
        reg = [send[(d - 1) % D] for d in range(D)]

    want = {(s, m) for s in range(S) for m in range(M)}
    if set(fwd_done) != want:
        missing = sorted(want - set(fwd_done))[:4]
        hazards.append(Hazard(
            "unit-count", -1, -1, COLS[2],
            f"{len(fwd_done)} forward units != expected {len(want)} "
            f"(missing {missing})"))

    stores = table[:, :, 0] >= 0
    comm = {"fwd_ring_pos": {"cells": int(stores.sum()),
                             "hop_ticks": int(stores[1:].any(axis=1).sum())},
            "bwd_ring_neg": {"cells": 0, "hop_ticks": 0}}
    return TableReport(
        name="forward", kind="forward", n_devices=D, n_virtual=n_virtual,
        n_microbatches=M, placement="wrap", split_backward=False,
        makespan=T, hazards=hazards,
        act_slots_used=[b.max_slot + 1 for b in bufs],
        grad_slots_used=[0] * D,
        act_live_peak=[b.live_peak for b in bufs],
        grad_live_peak=[0] * D,
        n_act_slots=n_slots, n_grad_slots=0,
        comm=comm,
        unit_counts={"F": len(fwd_done), "B": 0, "W": 0,
                     "idle": int(T * D - len(fwd_done))},
        compression={})


def page_table_hazards(pages, *, refcount, n_pages: int, page_size: int,
                       write_lo: int, write_hi: int, cow_dst: int = -1,
                       slot: int = -1) -> List[Hazard]:
    """Discipline hazards for one slot's planned page-table row (the paged
    serving engine's admission-time check).

    ``pages`` is the allocated prefix of the row (table order: entry
    ``i`` backs positions ``[i*ps, (i+1)*ps)``); ``refcount`` the pool's
    per-page counts; ``[write_lo, write_hi)`` the position span the slot
    will write over its lifetime (cached-prefix end through the final
    chunk's junk tail). Rules:

    - every entry in-bounds and (non-null entries) refcount-live;
    - no duplicate non-null entries (aliased writes would corrupt);
    - the row covers the write span (rows past the last allocated page
      would scatter into the null page and read back garbage);
    - no write lands in a shared (refcount > 1) page — the divergence
      page must have been remapped to a private COW destination
      (``cow_dst``) before admission.
    """
    ps = page_size
    hazards: List[Hazard] = []
    seen: Dict[int, int] = {}
    for i, pg in enumerate(int(p) for p in pages):
        if pg < 0 or pg >= n_pages:
            hazards.append(Hazard(
                "page-oob", slot, i, "page_tbl",
                f"slot {slot} entry {i} -> page {pg} outside "
                f"[0, {n_pages})"))
            continue
        if pg == 0:
            continue  # null page: legal filler, never read as valid
        if refcount[pg] < 1:
            hazards.append(Hazard(
                "page-dead", slot, i, "page_tbl",
                f"slot {slot} entry {i} -> page {pg} is on the free list "
                f"(refcount {int(refcount[pg])})"))
        if pg in seen:
            hazards.append(Hazard(
                "page-dup", slot, i, "page_tbl",
                f"slot {slot} entries {seen[pg]} and {i} alias page {pg}"))
        seen[pg] = i
    if len(pages) * ps < write_hi:
        hazards.append(Hazard(
            "page-underalloc", slot, -1, "page_tbl",
            f"slot {slot}: {len(pages)} pages cover {len(pages) * ps} "
            f"rows < write frontier {write_hi}"))
    for i in range(write_lo // ps, min(-(-write_hi // ps), len(pages))):
        pg = int(pages[i])
        if 0 < pg < n_pages and refcount[pg] > 1 and pg != cow_dst:
            hazards.append(Hazard(
                "page-shared-write", slot, i, "page_tbl",
                f"slot {slot} writes positions in page {pg} "
                f"(refcount {int(refcount[pg])} > 1) without COW"))
    return hazards


def check_page_table(page_tbl, *, refcount, n_pages: int, page_size: int,
                     spans, cow_dst=None, n_devices: int = 1) -> TableReport:
    """Discipline report over a full ``[M, P_max]`` page table.

    ``spans`` is a per-slot list of ``(write_lo, write_hi)`` position
    spans (``(0, 0)`` for an idle slot — its row is skipped); ``cow_dst``
    an optional per-slot COW destination list. Returns a
    :class:`TableReport` of kind ``"serving"``."""
    hazards: List[Hazard] = []
    M = len(page_tbl)
    for slot in range(M):
        lo, hi = spans[slot]
        if hi <= 0:
            continue
        row = [int(p) for p in page_tbl[slot]]
        while row and row[-1] == 0:
            row.pop()  # trailing null filler is not an allocation
        hazards.extend(page_table_hazards(
            row, refcount=refcount, n_pages=n_pages, page_size=page_size,
            write_lo=lo, write_hi=hi,
            cow_dst=(cow_dst[slot] if cow_dst is not None else -1),
            slot=slot))
    return TableReport(
        name="serving_paging", kind="serving", n_devices=n_devices,
        n_virtual=1, n_microbatches=M, placement="wrap",
        split_backward=False, makespan=M, hazards=hazards,
        act_slots_used=[M] * n_devices, grad_slots_used=[0] * n_devices,
        act_live_peak=[M] * n_devices, grad_live_peak=[0] * n_devices,
        n_act_slots=M, n_grad_slots=0,
        comm={"fwd_ring_pos": {"cells": M * n_devices,
                               "hop_ticks": M}},
        unit_counts={"F": M * n_devices, "B": 0, "W": 0, "idle": 0},
        compression={})


def speculative_hazards(*, gamma: int, prefill_chunk: int,
                        slots=()) -> List[Hazard]:
    """Discipline hazards for the speculative engine's metadata. Static
    rules first:

    - ``1 <= gamma`` and ``gamma + 1 <= prefill_chunk`` — the verify
      forward reuses the chunked-prefill channel width ``C``, and the
      rollback-by-overwrite discipline needs the next ``C``-wide write to
      cover every speculative overshoot row (``spec-gamma-oob``);

    then per-slot rules over ``slots``, an optional iterable of dicts
    with ``pos`` (committed token frontier), ``n_accepted`` (the value
    banked from the tok channel), ``committed`` (the paged allocator's
    committed-frontier ledger entry) and ``mapped_rows`` (rows covered by
    the slot's page row; ``None`` for contiguous slots):

    - ``n_accepted`` outside ``[1, gamma + 1]`` would advance the slot
      past the verify chunk or stall it forever (``spec-accept-oob``);
    - a committed frontier ahead of ``pos`` means draft overshoot leaked
      into the radix trie / COW pool (``spec-commit-overrun``);
    - a verify chunk whose junk tail extends past the mapped page span
      would scatter draft writes into unmapped rows
      (``spec-draft-overrun``).
    """
    hazards: List[Hazard] = []
    if gamma < 1:
        hazards.append(Hazard(
            "spec-gamma-oob", -1, -1, "gamma",
            f"gamma={gamma} < 1: speculative program proposes no tokens"))
    if gamma + 1 > prefill_chunk:
        hazards.append(Hazard(
            "spec-gamma-oob", -1, -1, "gamma",
            f"gamma+1={gamma + 1} > prefill_chunk={prefill_chunk}: the "
            f"verify chunk does not fit the channel width, so rejected "
            f"rows would never be overwritten by the next write"))
    for s, row in enumerate(slots or ()):
        slot = int(row.get("slot", s))
        n_acc = row.get("n_accepted")
        if n_acc is not None and not (1 <= int(n_acc) <= gamma + 1):
            hazards.append(Hazard(
                "spec-accept-oob", slot, -1, "tok_chan",
                f"slot {slot} banked n_accepted={int(n_acc)} outside "
                f"[1, {gamma + 1}]"))
        pos = row.get("pos")
        committed = row.get("committed")
        if pos is not None and committed is not None \
                and int(committed) > int(pos):
            hazards.append(Hazard(
                "spec-commit-overrun", slot, -1, "page_tbl",
                f"slot {slot} committed frontier {int(committed)} > "
                f"accepted position {int(pos)}: speculative overshoot "
                f"leaked into committed pages"))
        mapped = row.get("mapped_rows")
        if pos is not None and mapped is not None \
                and int(pos) + prefill_chunk > int(mapped):
            hazards.append(Hazard(
                "spec-draft-overrun", slot, -1, "page_tbl",
                f"slot {slot} verify chunk [{int(pos)}, "
                f"{int(pos) + prefill_chunk}) extends past mapped rows "
                f"{int(mapped)}"))
    return hazards


def check_serving_ring(n_devices: int, n_slots: int,
                       paging=None, speculative=None) -> TableReport:
    """Verify the serving executor's implicit round-robin slot schedule.

    ``serving.engine`` has no tick table: at tick ``u`` device ``d`` serves
    slot ``(u - d) % M`` and the scheduler banks last-stage output into
    slot ``(u - D) % M``. The invariants that make that round robin
    correct are checked over one full period:

    - ``M >= D`` (a slot's state must clear the pipe before it returns);
    - pipeline alignment: device ``d`` at tick ``u`` serves what device
      ``d-1`` served at ``u-1`` (a slot's state moves one stage a tick);
    - bank alignment: the banked slot at ``u`` is the slot device ``D-1``
      served at ``u-1``;
    - per device, each period serves every slot exactly once (permutation).

    ``paging`` (optional) additionally runs the page-table discipline
    check: a dict with ``page_tbl``, ``refcount``, ``n_pages``,
    ``page_size``, ``spans`` and optional ``cow_dst`` as accepted by
    :func:`check_page_table`; its hazards are merged into this report.

    ``speculative`` (optional) runs the widened-metadata discipline
    check for draft-verify programs: a dict with ``gamma``,
    ``prefill_chunk`` and optional ``slots`` as accepted by
    :func:`speculative_hazards`; its hazards are merged too.
    """
    D, M = n_devices, n_slots
    hazards: List[Hazard] = []
    if speculative is not None:
        hazards.extend(speculative_hazards(
            gamma=speculative["gamma"],
            prefill_chunk=speculative["prefill_chunk"],
            slots=speculative.get("slots", ())))
    if paging is not None:
        hazards.extend(check_page_table(
            paging["page_tbl"], refcount=paging["refcount"],
            n_pages=paging["n_pages"], page_size=paging["page_size"],
            spans=paging["spans"], cow_dst=paging.get("cow_dst"),
            n_devices=D).hazards)
    if M < D:
        hazards.append(Hazard(
            "ring-underfull", -1, -1, "n_slots",
            f"n_slots={M} < pipe degree {D}: a slot would be re-admitted "
            f"while its previous request is still in flight"))
    else:
        for u in range(M):
            for d in range(1, D):
                if (u - d) % M != ((u - 1) - (d - 1)) % M:
                    hazards.append(Hazard(
                        "ring-misaligned", d, u, "serve_slot",
                        f"device {d} at tick {u} does not serve device "
                        f"{d - 1}'s tick-{u - 1} slot"))
            if (u - D) % M != ((u - 1) - (D - 1)) % M:
                hazards.append(Hazard(
                    "ring-misaligned", D - 1, u, "bank_slot",
                    f"banked slot at tick {u} is not the last stage's "
                    f"tick-{u - 1} output"))
        for d in range(D):
            served = {(u - d) % M for u in range(M)}
            if served != set(range(M)):
                hazards.append(Hazard(
                    "ring-incomplete", d, -1, "serve_slot",
                    f"device {d} serves {sorted(served)} per period, not "
                    f"all {M} slots"))
    return TableReport(
        name="serving", kind="serving", n_devices=D, n_virtual=1,
        n_microbatches=M, placement="wrap", split_backward=False,
        makespan=M, hazards=hazards,
        act_slots_used=[M] * D, grad_slots_used=[0] * D,
        act_live_peak=[M] * D, grad_live_peak=[0] * D,
        n_act_slots=M, n_grad_slots=0,
        comm={"fwd_ring_pos": {"cells": M * D, "hop_ticks": M}},
        unit_counts={"F": M * D, "B": 0, "W": 0, "idle": 0},
        compression={})


def static_analysis_section(reports: List[TableReport],
                            verifier_version: int) -> Dict[str, object]:
    """Assemble the ``RunReport`` manifest's ``static_analysis`` block
    (see ``utils.telemetry.validate_report``) from verified tables."""
    def label(r: TableReport) -> str:
        return (f"{r.name}[D={r.n_devices},V={r.n_virtual},"
                f"M={r.n_microbatches},{r.placement}]")

    return {
        "verifier_version": verifier_version,
        "schedules": [label(r) for r in reports],
        "hazards": sum(len(r.hazards) for r in reports),
        "slot_high_water": {
            label(r): {"act": max(r.act_slots_used, default=0),
                       "grad": max(r.grad_slots_used, default=0)}
            for r in reports},
    }
