"""Pipeline telemetry and run reports: measured tick timelines, their
critical-path attribution and Perfetto traces, serving latency summaries,
and the structured ``RunReport`` manifest with its validator (the port's
own copy of the JAX package's ``utils/telemetry.py``).

- :class:`PipelineTelemetry`: an opt-in recorder the tick executor
  (``parallel.pipeline.make_pipeline_grad_fn(..., telemetry=)``) stamps
  at the step's start, after every tick's hand-offs are posted, and at
  the step's end. Off by default: without a recorder the executor records
  nothing and adds no call. The port's tick loop runs on the host, so it
  stamps per tick, as the JAX ``"unrolled"`` executor does, and attaches
  with that executor name; a step without a tick table (D = 1 with plain
  autograd) is one ``"scan"`` segment.
- On a CUDA device a stamp is a ``torch.cuda.Event(enable_timing=True)``
  recorded on the current stream, so it times the device's tick
  boundary, not the host's enqueue. The events become ``(kind, index,
  t)`` rows on the host's ``time.perf_counter`` clock when the analysis
  first reads them (:attr:`PipelineTelemetry.events`): one
  ``torch.cuda.synchronize`` there, then an anchor event whose host time
  is read once it has run. On the CPU a stamp is ``perf_counter`` itself.
- Memory: at the step boundaries a CUDA recorder samples
  ``torch.cuda.memory_allocated`` and ``max_memory_allocated`` (the
  JAX ``bytes_in_use`` / ``peak_bytes_in_use`` fields, ``device`` the
  card's index). The CPU recorder holds no samples, so
  ``memory_summary()["available"]`` is False, as JAX gives on its CPU.
- In a ``torch.distributed`` world each rank stamps its own row of the
  table; after the step every rank hands its rows to global rank 0
  (:meth:`PipelineTelemetry.merge_world`), which merges them as JAX
  merges its per-device stamps (``spans`` takes the earliest start and
  the latest end of each ``(kind, index)``: the processes of one host
  share its monotonic clock) and keeps each rank's own rows and the host
  seconds it spent waiting for arrivals (``wait_s``, the transport's
  ``handoff_wait`` span): :meth:`PipelineTelemetry.rank_summary`.

Differences from the JAX module: ``probe_of`` has no counterpart (it pins
an ``io_callback`` by dataflow; a CUDA event is ordered by its stream).
The phase executor and its ``phase_stats`` are not ported (the port has
no phase compression), so :meth:`PipelineTelemetry.attach` takes no
phases. ``RunReport.meta`` carries ``torch_version`` and
``cuda_version`` where JAX carries ``jax_version`` and
``jaxlib_version``, and :func:`validate_report` checks those two in
their place; every other rule is JAX's.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SCHEMA_VERSION = 1

# Event kinds of a stamp.
STEP_START, PHASE_START, PHASE_END, TICK, STEP_END = 0, 1, 2, 3, 4
_KIND_NAMES = {STEP_START: "step_start", PHASE_START: "phase_start",
               PHASE_END: "phase_end", TICK: "tick", STEP_END: "step_end"}
EXECUTORS = ("unrolled", "scan")


# ---------------------------------------------------------------------------
# Measured timelines
# ---------------------------------------------------------------------------


class PipelineTelemetry:
    """Host-side collector of the executor's stamps.

    Build time: ``make_pipeline_grad_fn(..., telemetry=tel)`` calls
    :meth:`attach` with the compiled tick table and its executor name.
    Run time: each stamped step calls :meth:`emit` at its boundaries.
    Analysis: :meth:`timeline` / :meth:`stage_breakdown` /
    :meth:`report` after at least one step.
    """

    def __init__(self) -> None:
        self._events: List[Tuple[int, int, float]] = []
        self._pending: List[Tuple[int, int, Any]] = []  # CUDA, unresolved
        self._pending_device: Optional[torch.device] = None
        self._merged = 0  # rows of _events already handed to rank 0
        self.table: Optional[np.ndarray] = None
        self.phases = None
        self.executor: Optional[str] = None
        # live allocator watermarks sampled at step boundaries
        self.memory_samples: List[Dict[str, Any]] = []
        # host seconds this process spent waiting for arrivals
        self.wait_s = 0.0
        # a world's rank 0: each rank's own rows, wait and pipe coordinate
        self.rank_events: Dict[int, List[Tuple[int, int, float]]] = {}
        self.rank_wait_s: Dict[int, float] = {}
        self.rank_pipe: Dict[int, int] = {}

    # -- build time -----------------------------------------------------

    def attach(self, table: np.ndarray, phases, executor: str) -> None:
        """Record the schedule the stamped program runs (the alignment
        target of every stamp). ``executor``: ``"unrolled"`` (a stamp
        per tick) or ``"scan"`` (one whole-step segment)."""
        if phases is not None:
            raise NotImplementedError(
                "the phase executor has no counterpart in the port "
                "(ROADMAP.md Queue 1, item 9: phase compression)")
        if executor not in EXECUTORS:
            raise ValueError(f"executor={executor!r}: one of {EXECUTORS}")
        self.table = np.asarray(table)
        self.phases = None
        self.executor = executor

    # -- run time -------------------------------------------------------

    def emit(self, kind: int, index: int, device=None) -> None:
        """Stamp one boundary now: on a CUDA ``device`` an event recorded
        on its current stream, else the host clock. The step boundaries
        also sample the allocator (:meth:`_sample_memory`)."""
        device = torch.device("cpu" if device is None else device)
        kind, index = int(kind), int(index)
        t = time.perf_counter()
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            self._pending.append((kind, index, ev))
            self._pending_device = device
        else:
            self._events.append((kind, index, t))
        if kind in (STEP_START, STEP_END):
            self._sample_memory(kind, t, device)

    def _resolve(self) -> None:
        """Turn the recorded CUDA events into host-clock rows: wait for
        the card, record an anchor event and read the host clock once it
        has run; each event lies ``elapsed_time`` before the anchor."""
        if not self._pending:
            return
        device = self._pending_device
        torch.cuda.synchronize(device)
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record(torch.cuda.current_stream(device))
        anchor.synchronize()
        now = time.perf_counter()
        for kind, index, ev in self._pending:
            self._events.append((kind, index,
                                 now - ev.elapsed_time(anchor) / 1e3))
        self._pending = []

    @property
    def events(self) -> List[Tuple[int, int, float]]:
        """The recorded ``(kind, index, t)`` rows (resolved on read)."""
        self._resolve()
        return self._events

    @events.setter
    def events(self, rows) -> None:
        self._pending = []
        self._events = list(rows)
        self._merged = 0

    def _sample_memory(self, kind: int, t: float,
                       device: torch.device) -> None:
        """Record the card's allocator watermarks at a step boundary (no
        synchronisation: the allocator's counters are host-side). A CPU
        device has no allocator stats and records nothing."""
        if device.type != "cuda":
            return
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        in_use = int(torch.cuda.memory_allocated(device))
        self.memory_samples.append({
            "kind": _KIND_NAMES.get(kind, str(kind)),
            "device": int(index), "t": t,
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        })

    def add_wait(self, seconds: float) -> None:
        """Count host seconds spent waiting for an arrival."""
        self.wait_s += seconds

    def merge_world(self, mesh) -> None:
        """After a stamped step of a world, on every rank: hand this
        rank's new rows, its wait and its pipe coordinate to global rank
        0 (an ``all_gather_object`` over the world), which adds the other
        ranks' rows to its own and keeps each rank's apart."""
        rows = self.events[self._merged:]
        got = mesh.all_gather_object((mesh.rank, mesh.pipe, rows,
                                      self.wait_s))
        if mesh.rank == 0:
            for rank, pipe, r_rows, wait in got:
                self.rank_events.setdefault(rank, []).extend(r_rows)
                self.rank_wait_s[rank] = wait
                self.rank_pipe[rank] = pipe
                if rank != mesh.rank:
                    self._events.extend(r_rows)
        self._merged = len(self._events)

    def memory_summary(self) -> Dict[str, Any]:
        """The ``live`` subsection of the manifest's ``memory`` block:
        per-device high-water marks over the recorded samples.
        ``available=False`` (no per-device rows) without allocator stats:
        consumers must degrade, not assume."""
        per_dev: Dict[int, Dict[str, int]] = {}
        for s in self.memory_samples:
            d = s["device"]
            row = per_dev.setdefault(
                d, {"device": d, "peak_bytes_in_use": 0,
                    "last_bytes_in_use": 0, "n_samples": 0})
            row["peak_bytes_in_use"] = max(row["peak_bytes_in_use"],
                                           s["peak_bytes_in_use"],
                                           s["bytes_in_use"])
            row["last_bytes_in_use"] = s["bytes_in_use"]
            row["n_samples"] += 1
        rows = [per_dev[d] for d in sorted(per_dev)]
        return {
            "available": bool(rows),
            "n_samples": len(self.memory_samples),
            "per_device": rows,
            "peak_bytes_in_use": (max(r["peak_bytes_in_use"] for r in rows)
                                  if rows else None),
        }

    def reset(self) -> None:
        """Drop the recorded rows, samples and waits (keep the attached
        schedule): call between steps when only the last step's timeline
        is wanted."""
        self.events = []
        self.memory_samples = []
        self.wait_s = 0.0
        self.rank_events = {}
        self.rank_wait_s = {}
        self.rank_pipe = {}

    # -- analysis -------------------------------------------------------

    def spans(self) -> Dict[Tuple[int, int], Tuple[float, float, int]]:
        """Group the stamps: ``(kind, index) -> (t_min, t_max, n)``."""
        out: Dict[Tuple[int, int], Tuple[float, float, int]] = {}
        for kind, idx, t in self.events:
            key = (kind, idx)
            if key in out:
                lo, hi, n = out[key]
                out[key] = (min(lo, t), max(hi, t), n + 1)
            else:
                out[key] = (t, t, 1)
        return out

    def timeline(self) -> List[Dict[str, Any]]:
        """The measured timeline: one record per tick (``"unrolled"``),
        or one whole-step record (``"scan"``). A tick runs from the
        previous tick's stamp (the step's start for tick 0) to its own,
        the latest over the ranks of a world (the straggler defines the
        segment)."""
        if not self.events:
            raise ValueError(
                "no telemetry events recorded — run at least one stamped "
                "step first")
        spans = self.spans()
        records: List[Dict[str, Any]] = []
        if self.executor == "unrolled":
            t0 = spans.get((STEP_START, 0))
            ticks = sorted(i for k, i in spans if k == TICK)
            prev = t0[0] if t0 is not None else None
            for t in ticks:
                _, hi, _ = spans[(TICK, t)]
                records.append({
                    "kind": "tick", "tick": t, "start_tick": t, "n_ticks": 1,
                    "t1": hi,
                    "duration_s": (max(hi - prev, 0.0)
                                   if prev is not None else None),
                })
                prev = hi
        else:  # the whole step: one segment
            start = spans.get((STEP_START, 0))
            end = spans.get((STEP_END, 0))
            if start is None or end is None:
                raise ValueError("scan executor run missing step start/end "
                                 "stamps — incomplete run")
            n = self.table.shape[0] if self.table is not None else 0
            records.append({
                "kind": "step", "start_tick": 0, "n_ticks": n,
                "t0": start[0], "t1": end[1],
                "duration_s": max(end[1] - start[0], 0.0),
            })
        return records

    def stage_breakdown(self) -> Dict[str, Any]:
        """Per-stage measured F/B/W/idle attribution and bubble: each
        segment's measured duration spread uniformly over its ticks, and
        each (device, tick) classified by the table's unit columns
        (``schedules.table_unit_activity``). ``bubble_measured`` per
        stage is its idle share of the measured makespan."""
        from ..parallel.schedules import table_unit_activity
        if self.table is None:
            raise ValueError("no tick table attached")
        activity = table_unit_activity(self.table)  # [T, D, 4] 0/1
        D = activity.shape[1]
        seconds = np.zeros((D, 4))
        total = 0.0
        for rec in self.timeline():
            dur = rec.get("duration_s")
            if dur is None:
                continue
            total += dur
            t0, n = rec["start_tick"], rec["n_ticks"]
            if n <= 0:
                continue
            per_tick = dur / n
            seconds += activity[t0:t0 + n].sum(axis=0) * per_tick
        per_stage = []
        for d in range(D):
            f_s, b_s, w_s, idle_s = (float(x) for x in seconds[d])
            per_stage.append({
                "device": d, "f_s": f_s, "b_s": b_s, "w_s": w_s,
                "idle_s": idle_s,
                "bubble_measured": idle_s / total if total > 0 else 0.0,
            })
        busy = seconds[:, :3].sum()
        split = (seconds[:, :3].sum(axis=0) / busy if busy > 0
                 else np.zeros(3))
        return {
            "total_s": total,
            "per_stage": per_stage,
            "f_frac": float(split[0]), "b_frac": float(split[1]),
            "w_frac": float(split[2]),
            "bubble_measured_mean": float(
                np.mean([s["bubble_measured"] for s in per_stage])),
        }

    def rank_summary(self) -> List[Dict[str, Any]]:
        """A world's rank 0, after :meth:`merge_world`: per rank, the
        seconds of its own tick stamps (``tick_s``), the part of them in
        ticks where its row runs a unit (``busy_tick_s``, each segment
        spread uniformly over its ticks as in :meth:`stage_breakdown`)
        and the host seconds it waited for arrivals (``wait_s``). Empty
        outside a world."""
        from ..parallel.schedules import table_unit_activity
        rows = []
        for rank in sorted(self.rank_events):
            one = PipelineTelemetry()
            one.attach(self.table, None, self.executor)
            one.events = self.rank_events[rank]
            pipe = self.rank_pipe[rank]
            active = table_unit_activity(self.table)[:, pipe, :3].any(axis=1)
            tick_s = busy_s = 0.0
            for rec in one.timeline():
                dur = rec.get("duration_s") or 0.0
                t0, n = rec["start_tick"], rec["n_ticks"]
                tick_s += dur
                if n > 0:
                    busy_s += dur * float(active[t0:t0 + n].sum()) / n
            rows.append({"rank": rank, "pipe": pipe, "tick_s": tick_s,
                         "busy_tick_s": busy_s,
                         "idle_tick_s": tick_s - busy_s,
                         "wait_s": self.rank_wait_s[rank]})
        return rows

    def report(self) -> Dict[str, Any]:
        """The telemetry section embedded in :class:`RunReport`
        manifests (with ``ranks`` on a world's rank 0)."""
        out: Dict[str, Any] = {"executor": self.executor,
                               "n_events": len(self.events)}
        if self.events:
            out["timeline"] = self.timeline()
            if self.table is not None:
                out["stage_breakdown"] = self.stage_breakdown()
        if self.memory_samples:
            out["memory_watermarks"] = self.memory_summary()
        if self.rank_events:
            out["ranks"] = self.rank_summary()
        return out


# ---------------------------------------------------------------------------
# Trace export + critical-path attribution
# ---------------------------------------------------------------------------


def _tick_times(telemetry: PipelineTelemetry):
    """Per-tick ``(t0, duration)`` seconds, relative to the first stamp.

    Segment durations are spread uniformly over the segment's ticks (the
    same attribution model as :meth:`PipelineTelemetry.stage_breakdown`:
    inside one fused scan per-tick variation is not observable). Phase and
    scan segments carry absolute ``t0``/``t1`` stamps; unrolled records
    only a ``t1`` per tick, so starts chain from the previous boundary."""
    if telemetry.table is None:
        raise ValueError("no tick table attached")
    T = int(telemetry.table.shape[0])
    t0 = np.zeros(T)
    dur = np.zeros(T)
    origin = None
    cursor = 0.0
    for rec in telemetry.timeline():
        start, n = rec["start_tick"], rec["n_ticks"]
        d = rec.get("duration_s") or 0.0
        per = d / n if n else 0.0
        if rec.get("t0") is not None:
            if origin is None:
                origin = rec["t0"]
            base = rec["t0"] - origin
        elif rec.get("t1") is not None:
            if origin is None:
                origin = rec["t1"] - d
            base = rec["t1"] - origin - d
        else:
            base = cursor
        for k in range(n):
            if start + k < T:
                t0[start + k] = base + k * per
                dur[start + k] = per
        cursor = base + n * per
    return t0, dur


def _store_channels():
    """(name, store column, sender offset) per ring direction: a store at
    ``(t, d, col)`` banks data ppermuted during tick ``t-1`` by device
    ``(d - offset) % D`` (same convention as
    ``analysis.table_check.RING_CHANNELS``)."""
    from ..parallel.schedules import (COL_STORE_B_POS_SLOT, COL_STORE_B_SLOT,
                                      COL_STORE_F_NEG_SLOT, COL_STORE_F_SLOT)
    return (("fwd_ring_pos", COL_STORE_F_SLOT, +1),
            ("bwd_ring_neg", COL_STORE_B_SLOT, -1),
            ("fwd_ring_neg", COL_STORE_F_NEG_SLOT, -1),
            ("bwd_ring_pos", COL_STORE_B_POS_SLOT, +1))


def critical_path(telemetry: PipelineTelemetry) -> Dict[str, Any]:
    """Attribute each measured tick to compute vs comm vs bubble.

    Under the executor's lockstep model every device waits for the tick's
    straggler, so a tick is *compute* when any device runs a unit (the
    straggler = the device with the heaviest weighted work that tick,
    F=1/B=2/W=1), *comm* when nothing computes but a ring hop is in
    flight (some channel banks a store next tick), and *bubble* when the
    tick does neither. Returns aggregate seconds, the per-tick
    classification, and per-device straggler time — "which stage is the
    step waiting on" as a number.

    Training-table comm is additionally attributed overlap-aware: each
    hop landing at tick ``t`` is classified by its verified bank stage
    (:func:`parallel.schedules.overlap_bank_stages`) into
    ``hops_exposed`` (banks before the first unit — serial even under
    ``comm_overlap="ring"``) vs ``hops_overlappable`` (hides behind the
    units that run before its bank point); the aggregate
    ``exposed_hop_ticks`` / ``overlappable_hop_ticks`` are the same
    counts the cost model's ``comm_overlap`` mode prices."""
    from ..parallel.schedules import (BANK_BEFORE_F, N_COLS,
                                      overlap_bank_stages,
                                      table_unit_activity)
    if telemetry.table is None:
        raise ValueError("no tick table attached")
    table = telemetry.table
    T, D = int(table.shape[0]), int(table.shape[1])
    activity = table_unit_activity(table)  # [T, D, 4]
    t0, dur = _tick_times(telemetry)
    weights = np.array([1.0, 2.0, 1.0, 0.0])
    work = activity.astype(np.float64) @ weights  # [T, D]
    channels = _store_channels()
    store_cols = [col for _, col, _ in channels]
    # overlap-aware hop attribution: classify each landing hop by its
    # verified bank stage (exposed = fences the tick's first unit even
    # under comm_overlap="ring"; overlappable = hides behind the units
    # before its bank point). Forward-only tables have no stage map.
    bank_st = (overlap_bank_stages(table) if table.shape[2] >= N_COLS
               else None)
    agg = {"compute": 0.0, "comm": 0.0, "bubble": 0.0}
    exposed_hops = overlappable_hops = 0
    straggler_s = np.zeros(D)
    per_tick: List[Dict[str, Any]] = []
    for t in range(T):
        hop_in_flight = (t + 1 < T
                         and bool((table[t + 1][:, store_cols] >= 0).any()))
        if work[t].max() > 0:
            cls = "compute"
            straggler = int(work[t].argmax())
            straggler_s[straggler] += dur[t]
        elif hop_in_flight:
            cls, straggler = "comm", None
        else:
            cls, straggler = "bubble", None
        agg[cls] += dur[t]
        row: Dict[str, Any] = {"tick": t, "class": cls,
                               "straggler": straggler,
                               "duration_s": float(dur[t])}
        if bank_st is not None and t >= 1:
            n_exp = n_lap = 0
            for ci, (_, col, _) in enumerate(channels):
                if (table[t][:, col] >= 0).any():
                    if int(bank_st[t, ci]) == BANK_BEFORE_F:
                        n_exp += 1
                    else:
                        n_lap += 1
            if n_exp or n_lap:
                row["hops_exposed"], row["hops_overlappable"] = n_exp, n_lap
            exposed_hops += n_exp
            overlappable_hops += n_lap
        per_tick.append(row)
    sd = int(straggler_s.argmax())
    return {
        "n_ticks": T,
        "total_s": float(dur.sum()),
        "compute_s": float(agg["compute"]),
        "comm_s": float(agg["comm"]),
        "bubble_s": float(agg["bubble"]),
        "exposed_hop_ticks": exposed_hops,
        "overlappable_hop_ticks": overlappable_hops,
        "straggler_s_per_device": [float(x) for x in straggler_s],
        "straggler_device": sd,
        "straggler_stage": f"device {sd}",
        "per_tick": per_tick,
    }


def perfetto_trace(telemetry: PipelineTelemetry,
                   serving_events: Optional[List[Dict[str, Any]]] = None,
                   dynamics_events: Optional[List[Dict[str, Any]]] = None,
                   predicted_tick_s: Optional[Sequence[float]] = None
                   ) -> Dict[str, Any]:
    """The measured timeline as a Chrome-trace/Perfetto JSON object.

    One track (tid) per pipeline device under a single process, one
    complete ``"X"`` slice per (tick, device) unit — named ``F m3`` /
    ``B v1 m2`` / ``W m0`` / ``idle``, categorized by kind — and one
    ``"s"``→``"f"`` flow pair per ring-hop store (cat ``ppermute``,
    anchored mid-slice on the sending and receiving ticks) so arrows in
    the UI show exactly the hops the table predicts; each flow's args
    carry its verified ``bank_stage`` and an ``overlap`` tag
    (``exposed`` = fences the landing tick's first unit,
    ``overlappable`` = hides behind compute under
    ``comm_overlap="ring"``). When the telemetry
    carries live watermark samples, each device additionally gets a
    ``"C"`` counter track (``HBM bytes_in_use``) sampled at step
    boundaries, drawn right next to the F/B/W slices. ``serving_events``:
    RunReport event rows — ``serve_admit``/``serve_finish`` pairs become
    async request slices on a separate "requests" process
    (:func:`perfetto_request_events`). ``dynamics_events``: RunReport
    ``dynamics`` event rows — per-stage grad-norm counter tracks on a
    "training dynamics" process (:func:`perfetto_dynamics_events`).
    ``predicted_tick_s``: a cost model's per-tick predicted seconds
    (length ``T``) — when given, every per-tick slice's args additionally
    carry ``predicted_tick_s`` / ``measured_tick_s`` / ``rel_err``
    (signed, predicted vs measured), so clicking any slice answers "was
    this tick slower than the model said" without leaving the UI. The
    HBM counter track's name is JAX's; the port's samples are the CUDA
    allocator's.
    Timestamps are microseconds from the first stamp, sorted ascending;
    load the written file in ui.perfetto.dev or chrome://tracing."""
    from ..parallel.schedules import (COL_BWD_M, COL_BWD_V, COL_FWD_M,
                                      COL_FWD_V, COL_W_M, COL_W_V)
    if telemetry.table is None:
        raise ValueError("no tick table attached")
    table = telemetry.table
    T, D = int(table.shape[0]), int(table.shape[1])
    n_virtual = max(1, (int(table[..., (COL_FWD_V, COL_BWD_V, COL_W_V),
                                ].max()) + 1))
    t0, dur = _tick_times(telemetry)
    us = 1e6
    events: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": 0, "tid": 0, "ts": 0.0,
        "args": {"name": f"pipeline ({telemetry.executor})"},
    }]
    for d in range(D):
        events.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": d,
                       "ts": 0.0, "args": {"name": f"device {d}"}})
    units = ((COL_FWD_V, COL_FWD_M, "F"), (COL_BWD_V, COL_BWD_M, "B"),
             (COL_W_V, COL_W_M, "W"))
    n_predicted = 0
    for t in range(T):
        ts, width = t0[t] * us, dur[t] * us
        # calibration annotation: the cost model's prediction for this
        # tick next to its measured duration, on every slice of the tick
        pred_args: Dict[str, Any] = {}
        if predicted_tick_s is not None and t < len(predicted_tick_s):
            n_predicted += 1
            p = float(predicted_tick_s[t])
            pred_args = {"predicted_tick_s": p,
                         "measured_tick_s": float(dur[t])}
            if dur[t] > 0:
                pred_args["rel_err"] = (p - float(dur[t])) / float(dur[t])
        for d in range(D):
            row = table[t, d]
            active = 0
            for col_v, col_m, kind in units:
                if row[col_m] >= 0:
                    active += 1
                    v, m = int(row[col_v]), int(row[col_m])
                    name = (f"{kind} v{v} m{m}" if n_virtual > 1
                            else f"{kind} m{m}")
                    events.append({
                        "ph": "X", "name": name, "cat": kind, "pid": 0,
                        "tid": d, "ts": ts, "dur": width,
                        "args": {"tick": t, "v": v, "m": m, **pred_args}})
            if active == 0:
                events.append({"ph": "X", "name": "idle", "cat": "idle",
                               "pid": 0, "tid": d, "ts": ts, "dur": width,
                               "args": {"tick": t, **pred_args}})
    # flow args carry the hop's verified bank stage so overlapped comm
    # reads directly off the arrows: stage 0 arrivals fence the landing
    # tick's first unit (exposed), later stages ride under its compute
    from ..parallel.schedules import (BANK_BEFORE_F, N_COLS,
                                      overlap_bank_stages)
    bank_st = (overlap_bank_stages(table) if table.shape[2] >= N_COLS
               else None)
    flow_id = 0
    n_overlappable = 0
    for t in range(1, T):
        for ci, (name, col, offset) in enumerate(_store_channels()):
            stage = None if bank_st is None else int(bank_st[t, ci])
            overlapped = stage is not None and stage > BANK_BEFORE_F
            for d in range(D):
                if table[t, d, col] >= 0:
                    flow_id += 1
                    n_overlappable += int(overlapped)
                    sender = (d - offset) % D
                    args = ({} if stage is None else
                            {"bank_stage": stage,
                             "overlap": ("overlappable" if overlapped
                                         else "exposed")})
                    events.append({
                        "ph": "s", "id": flow_id, "name": name,
                        "cat": "ppermute", "pid": 0, "tid": sender,
                        "ts": (t0[t - 1] + 0.5 * dur[t - 1]) * us,
                        "args": args})
                    events.append({
                        "ph": "f", "bp": "e", "id": flow_id, "name": name,
                        "cat": "ppermute", "pid": 0, "tid": d,
                        "ts": (t0[t] + 0.5 * dur[t]) * us,
                        "args": args})
    # live HBM counter track: one "C" event per (boundary sample, device),
    # on the same clock as the stamps so the sawtooth lines up with ticks
    n_counters = 0
    if telemetry.memory_samples:
        origin = min(t for _, _, t in telemetry.events)
        for s in telemetry.memory_samples:
            n_counters += 1
            events.append({
                "ph": "C", "name": f"HBM device {s['device']}",
                "cat": "memory", "pid": 0, "tid": 0,
                "ts": max(s["t"] - origin, 0.0) * us,
                "args": {"bytes_in_use": s["bytes_in_use"],
                         "peak_bytes_in_use": s["peak_bytes_in_use"]}})
    if serving_events:
        events.extend(perfetto_request_events(serving_events))
    n_dyn = 0
    if dynamics_events:
        dyn_rows = perfetto_dynamics_events(dynamics_events)
        n_dyn = sum(1 for e in dyn_rows if e["ph"] == "C")
        events.extend(dyn_rows)
    # sorted ts is part of the format contract (and what the schema test
    # pins); metadata first among equals so track names land before slices
    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "M" else 1))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"executor": telemetry.executor, "n_devices": D,
                      "n_ticks": T, "n_flows": flow_id,
                      "n_overlappable_flows": n_overlappable,
                      "n_memory_counters": n_counters,
                      "n_dynamics_counters": n_dyn,
                      "n_predicted_ticks": n_predicted},
    }


def perfetto_request_events(serving_events: List[Dict[str, Any]],
                            pid: int = 1) -> List[Dict[str, Any]]:
    """Per-request async slices from ``serve_admit``/``serve_finish``
    RunReport event rows: one ``"b"``→``"e"`` pair per request id on a
    "requests" process track, laid out on the events' wall clock
    (normalized to the first admit). The slice args carry the on-device
    tick stamps — ``admit_tick``, prompt length / budget from the admit
    row, ``finish_tick``/``n_tokens``/``ttft_ticks`` from the finish row
    — so a TTFT/TPOT outlier in the UI names the exact ticks to inspect
    on the pipeline timeline. Slices land on a per-slot tid, so slot
    reuse reads as a row of back-to-back requests."""
    admits = {}
    finishes = {}
    for row in serving_events or []:
        if row.get("kind") == "serve_admit" and "rid" in row:
            admits[row["rid"]] = row
        elif row.get("kind") == "serve_finish" and "rid" in row:
            finishes[row["rid"]] = row
    if not admits:
        return []
    us = 1e6
    origin = min(r["t"] for r in admits.values())
    out: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0, "ts": 0.0,
        "args": {"name": "serving requests"}}]
    slots = sorted({int(r.get("slot", 0)) for r in admits.values()})
    for slot in slots:
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": slot, "ts": 0.0,
                    "args": {"name": f"slot {slot}"}})
    for rid, adm in sorted(admits.items(), key=lambda kv: kv[1]["t"]):
        fin = finishes.get(rid)
        slot = int(adm.get("slot", 0))
        ts = (adm["t"] - origin) * us
        args = {"rid": rid, "slot": slot,
                "admit_tick": adm.get("tick"),
                "prompt_len": adm.get("prompt_len"),
                "budget": adm.get("budget")}
        if fin is not None:
            args.update({"finish_tick": fin.get("tick"),
                         "n_tokens": fin.get("n_tokens"),
                         "ttft_ticks": fin.get("ttft_ticks")})
        common = {"cat": "request", "id": int(rid), "name": f"req {rid}",
                  "pid": pid, "tid": slot}
        out.append({"ph": "b", "ts": ts, "args": args, **common})
        # unfinished requests (failed / still in flight) close zero-width
        end_ts = (fin["t"] - origin) * us if fin is not None else ts
        out.append({"ph": "e", "ts": end_ts, "args": {}, **common})
    return out


def perfetto_serving_load_events(serving_events: List[Dict[str, Any]],
                                 occupancy: Optional[List[Any]] = None,
                                 queue_depth: Optional[List[Any]] = None,
                                 s_per_tick: Optional[float] = None,
                                 pages_used: Optional[List[Any]] = None,
                                 page_fragmentation: Optional[List[Any]] = None,
                                 acceptance: Optional[List[Any]] = None,
                                 pid: int = 3) -> List[Dict[str, Any]]:
    """The serving-load debugging surface on the **tick clock**: per-slot
    request slices split into *queue wait* vs *execution* sub-spans, plus
    queue-depth and slot-occupancy counter tracks.

    Rides the same ``serve_admit``/``serve_finish`` RunReport rows as
    :func:`perfetto_request_events`, but lays everything out in ticks —
    the exact on-device stamps (``arrival``/``tick`` on the admit row,
    ``tick`` on the finish row) rather than host wall-clock, so a
    latency outlier decomposes visually: a long ``wait`` slice is
    queueing (saturation), a long ``serve`` slice is the ring itself.
    ``occupancy``/``queue_depth`` are ``(tick, n)`` block-boundary
    samples (``ServeResult.occupancy``/``.queue_depth``); each becomes a
    ``"C"`` counter track right under the request rows, so the queue
    ramp that precedes a TTFT blow-up is on screen with it.
    ``s_per_tick`` scales ticks to real time when known (1 tick = 1 us
    otherwise — relative layout is what matters). Admit rows without an
    ``arrival`` field (pre-SLO-observatory streams) degrade to a
    zero-width wait slice. Paged-engine runs add ``pages used`` and
    ``page fragmentation`` counter tracks from the same block-boundary
    samples (``ServeResult.pages_used``/``.page_fragmentation``), so a
    TTFT blow-up under prefix traffic decomposes into queue pressure vs
    page-pool pressure on one screen. Speculative runs add an
    ``acceptance rate`` counter track from ``(tick, alpha)`` samples
    (``ServeResult.acceptance_series``) and nest a ``verify`` sub-span
    under each finished request's serve slice carrying its
    draft-verify gauges (``spec_verify_visits``/``spec_accepted``/
    ``accepted_len_mean`` from the finish row), so an acceptance-rate
    sag lines up with the exact requests it slowed."""
    admits: Dict[Any, Dict[str, Any]] = {}
    finishes: Dict[Any, Dict[str, Any]] = {}
    for row in serving_events or []:
        if row.get("kind") == "serve_admit" and "rid" in row:
            admits[row["rid"]] = row
        elif row.get("kind") == "serve_finish" and "rid" in row:
            finishes[row["rid"]] = row
    if not admits and not occupancy and not queue_depth and not pages_used:
        return []
    tick_us = (s_per_tick * 1e6) if s_per_tick else 1.0
    out: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0, "ts": 0.0,
        "args": {"name": "serving load (ticks)"}}]
    slots = sorted({int(r.get("slot", 0)) for r in admits.values()})
    for slot in slots:
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": slot + 1, "ts": 0.0,
                    "args": {"name": f"slot {slot}"}})
    for rid, adm in sorted(admits.items(),
                           key=lambda kv: kv[1].get("tick", 0)):
        slot = int(adm.get("slot", 0))
        admit_tick = float(adm.get("tick", 0))
        arrival = adm.get("arrival")
        arrival = float(arrival) if isinstance(arrival, (int, float)) \
            else admit_tick
        args = {"rid": rid, "slot": slot, "arrival": arrival,
                "admit_tick": adm.get("tick"),
                "prompt_len": adm.get("prompt_len"),
                "budget": adm.get("budget")}
        if arrival < admit_tick:
            out.append({"ph": "X", "name": f"wait r{rid}",
                        "cat": "queue_wait", "pid": pid, "tid": slot + 1,
                        "ts": arrival * tick_us,
                        "dur": (admit_tick - arrival) * tick_us,
                        "args": args})
        fin = finishes.get(rid)
        end_tick = (float(fin["tick"]) if fin is not None
                    and isinstance(fin.get("tick"), (int, float))
                    else admit_tick)
        fargs = dict(args)
        if fin is not None:
            fargs.update({"finish_tick": fin.get("tick"),
                          "n_tokens": fin.get("n_tokens"),
                          "ttft_ticks": fin.get("ttft_ticks")})
        out.append({"ph": "X", "name": f"serve r{rid}", "cat": "execution",
                    "pid": pid, "tid": slot + 1,
                    "ts": admit_tick * tick_us,
                    "dur": max(end_tick - admit_tick, 0.0) * tick_us,
                    "args": fargs})
        # draft-verify sub-span: equal-duration slice emitted after the
        # serve slice nests under it in the UI; args carry the
        # per-request speculative gauges from the finish row
        if fin is not None and fin.get("spec_verify_visits"):
            out.append({
                "ph": "X", "name": f"verify r{rid} "
                f"x{int(fin['spec_verify_visits'])}",
                "cat": "spec_verify", "pid": pid, "tid": slot + 1,
                "ts": admit_tick * tick_us,
                "dur": max(end_tick - admit_tick, 0.0) * tick_us,
                "args": {"rid": rid,
                         "spec_verify_visits": fin.get("spec_verify_visits"),
                         "spec_accepted": fin.get("spec_accepted"),
                         "accepted_len_mean": fin.get("accepted_len_mean")}})
    for name, series in (("slot occupancy", occupancy),
                         ("queue depth", queue_depth),
                         ("pages used", pages_used)):
        for t, n in series or []:
            out.append({"ph": "C", "name": name, "cat": "serving_load",
                        "pid": pid, "tid": 0, "ts": float(t) * tick_us,
                        "args": {name.replace(" ", "_"): int(n)}})
    for t, f in page_fragmentation or []:
        out.append({"ph": "C", "name": "page fragmentation",
                    "cat": "serving_load", "pid": pid, "tid": 0,
                    "ts": float(t) * tick_us,
                    "args": {"page_fragmentation": float(f)}})
    for t, a in acceptance or []:
        if a is None:
            continue  # pre-first-verify samples carry no rate yet
        out.append({"ph": "C", "name": "acceptance rate",
                    "cat": "serving_load", "pid": pid, "tid": 0,
                    "ts": float(t) * tick_us,
                    "args": {"acceptance_rate": float(a)}})
    return out


def perfetto_dynamics_events(dynamics_events: List[Dict[str, Any]],
                             pid: int = 2) -> List[Dict[str, Any]]:
    """Per-stage grad-norm counter tracks from RunReport ``dynamics``
    event rows (the rows ``fit`` streams at every log sync), one ``"C"``
    counter per (log point, stage) plus global grad-norm and GNS tracks
    — the model-health twin of the HBM sawtooth. The rows carry the
    event stream's wall clock (a different clock than the executor
    stamps), so they land on their own "training dynamics" process,
    normalized to the first dynamics row; within the process, step
    ordering is exact."""
    rows = [r for r in (dynamics_events or [])
            if r.get("kind") == "dynamics" and "t" in r]
    if not rows:
        return []
    us = 1e6
    origin = min(r["t"] for r in rows)
    out: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0, "ts": 0.0,
        "args": {"name": "training dynamics"}}]

    def finite(x):
        return isinstance(x, (int, float)) and np.isfinite(x)

    for r in sorted(rows, key=lambda r: r["t"]):
        ts = (r["t"] - origin) * us
        if finite(r.get("grad_norm")):
            out.append({"ph": "C", "name": "grad_norm", "cat": "dynamics",
                        "pid": pid, "tid": 0, "ts": ts,
                        "args": {"grad_norm": float(r["grad_norm"])}})
        if finite(r.get("gns")):
            out.append({"ph": "C", "name": "gns", "cat": "dynamics",
                        "pid": pid, "tid": 0, "ts": ts,
                        "args": {"gns": float(r["gns"])}})
        for s, v in enumerate(r.get("grad_norm_per_stage") or []):
            if finite(v):
                out.append({
                    "ph": "C", "name": f"grad_norm stage {s}",
                    "cat": "dynamics", "pid": pid, "tid": 0, "ts": ts,
                    "args": {"grad_norm": float(v)}})
    return out


def write_perfetto_trace(telemetry: Optional[PipelineTelemetry], path: str,
                         serving_events: Optional[List[Dict[str, Any]]] = None,
                         dynamics_events: Optional[List[Dict[str, Any]]] = None,
                         serving_load_tracks: Optional[Dict[str, Any]] = None,
                         predicted_tick_s: Optional[Sequence[float]] = None
                         ) -> str:
    """Serialize :func:`perfetto_trace` to ``path``; returns the path.
    With ``telemetry=None`` (a serving-only run has no pipeline
    telemetry) the trace holds just the requests/dynamics tracks.
    ``serving_load_tracks`` (optional) adds the tick-clock serving-load
    process (:func:`perfetto_serving_load_events`): a dict with any of
    ``occupancy``/``queue_depth`` (block-boundary ``(tick, n)`` samples)
    and ``s_per_tick``; the request sub-spans come from
    ``serving_events``. ``predicted_tick_s``: per-tick cost-model
    predictions for the calibration annotations (see
    :func:`perfetto_trace`)."""
    if telemetry is None:
        rows = perfetto_request_events(serving_events or [])
        rows.extend(perfetto_dynamics_events(dynamics_events or []))
        trace: Dict[str, Any] = {
            "traceEvents": rows,
            "displayTimeUnit": "ms",
            "otherData": {"executor": "serving"},
        }
    else:
        trace = perfetto_trace(telemetry, serving_events=serving_events,
                               dynamics_events=dynamics_events,
                               predicted_tick_s=predicted_tick_s)
    if serving_load_tracks is not None:
        trace["traceEvents"].extend(perfetto_serving_load_events(
            serving_events or [],
            occupancy=serving_load_tracks.get("occupancy"),
            queue_depth=serving_load_tracks.get("queue_depth"),
            s_per_tick=serving_load_tracks.get("s_per_tick"),
            pages_used=serving_load_tracks.get("pages_used"),
            page_fragmentation=serving_load_tracks.get(
                "page_fragmentation"),
            acceptance=serving_load_tracks.get("acceptance")))
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return path


# ---------------------------------------------------------------------------
# Serving latency summaries
# ---------------------------------------------------------------------------


def _pct(xs: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99/mean of a latency sample (empty-safe)."""
    if not len(xs):
        return {"p50": None, "p95": None, "p99": None, "mean": None, "n": 0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()), "n": int(a.size)}


def serving_summary(result) -> Dict[str, Any]:
    """Per-request latency and throughput summary of one serving run.

    ``result`` is a :class:`..serving.engine.ServeResult` (duck-typed:
    ``completions`` carrying ``ttft_ticks``/``tpot_ticks``, plus
    ``tokens_out``/``ticks``/``wall_s``/``n_slots``/``policy``/
    ``occupancy``). Latencies are in *ticks* (stamped at token banking),
    with the measured ``s_per_tick`` beside them, so wall-clock latencies
    are one multiply away. Failed completions count apart and stay out of
    the percentile samples. Paged and speculative runs add their gauges
    (:func:`_paged_summary_fields`, :func:`_spec_summary_fields`).
    """
    ok = [c for c in result.completions
          if getattr(c, "status", "ok") == "ok"]
    ttfts = [c.ttft_ticks for c in ok]
    tpots = [c.tpot_ticks for c in ok if c.tpot_ticks is not None]
    waits = [c.admit_wait_ticks for c in ok
             if getattr(c, "admit_wait_ticks", None) is not None]
    service = [c.service_ttft_ticks for c in ok
               if getattr(c, "service_ttft_ticks", None) is not None]
    occ = [int(n) for _, n in result.occupancy]
    qd_series = list(getattr(result, "queue_depth", []) or [])
    qd = [int(n) for _, n in qd_series]
    busy = getattr(result, "busy_ticks", None)
    return {
        "policy": result.policy,
        "n_requests": len(ok),
        "n_failed": len(result.completions) - len(ok),
        "n_slots": int(result.n_slots),
        "ticks": int(result.ticks),
        "busy_ticks": int(busy) if busy is not None else None,
        "wall_s": float(result.wall_s),
        "s_per_tick": (float(result.wall_s) / result.ticks
                       if result.ticks else None),
        "tokens_out": int(result.tokens_out),
        "tokens_per_sec": float(result.tokens_per_sec),
        "goodput": float(result.goodput),
        "goodput_busy": (float(result.goodput_busy)
                         if hasattr(result, "goodput_busy") else None),
        "ttft_ticks": _pct(ttfts),
        "tpot_ticks": _pct(tpots),
        "admit_wait_ticks": _pct(waits),
        "service_ttft_ticks": _pct(service),
        "occupancy_mean": float(np.mean(occ)) if occ else 0.0,
        "occupancy": [[int(t), int(n)] for t, n in result.occupancy],
        "queue_depth_mean": float(np.mean(qd)) if qd else 0.0,
        "queue_depth_max": int(max(qd)) if qd else 0,
        "queue_depth": [[int(t), int(n)] for t, n in qd_series],
        **_paged_summary_fields(result),
        **_spec_summary_fields(result),
    }


def _paged_summary_fields(result) -> Dict[str, Any]:
    """Paged-KV gauges for :func:`serving_summary`: none for a contiguous
    run, whose summary keeps its keys."""
    if not getattr(result, "paged", False):
        return {}
    pages = [int(n) for _, n in (result.pages_used or [])]
    frag = [float(f) for _, f in (result.page_fragmentation or [])]
    return {
        "paged": True,
        "pages_capacity": int(result.pages_capacity),
        "pages_used_mean": float(np.mean(pages)) if pages else 0.0,
        "pages_used_max": int(max(pages)) if pages else 0,
        "pages_used": [[int(t), int(n)] for t, n in result.pages_used],
        "page_fragmentation_mean": (float(np.mean(frag)) if frag else 0.0),
        "page_fragmentation": [[int(t), float(f)]
                               for t, f in result.page_fragmentation],
        "prefix_hit_rate": (float(result.prefix_hit_rate)
                            if result.prefix_hit_rate is not None else 0.0),
        "prefill_skipped_tokens": int(result.prefill_skipped_tokens),
        "n_cow": int(result.n_cow),
        "n_backpressure": int(result.n_backpressure),
    }


def _spec_summary_fields(result) -> Dict[str, Any]:
    """Speculative-decoding gauges for :func:`serving_summary`: none for a
    plain run; the acceptance rate and mean accepted length are None
    until a verify visit ran."""
    if not getattr(result, "speculative", False):
        return {}
    series = list(getattr(result, "acceptance_series", []) or [])
    rate = result.acceptance_rate
    alm = result.accepted_len_mean
    return {
        "speculative": True,
        "gamma": int(result.gamma),
        "spec_verify_visits": int(result.spec_verify_visits),
        "spec_accepted_tokens": int(result.spec_accepted_tokens),
        "acceptance_rate": float(rate) if rate is not None else None,
        "accepted_len_mean": float(alm) if alm is not None else None,
        "acceptance_series": [[int(t), (float(a) if a is not None else None)]
                              for t, a in series],
    }


# ---------------------------------------------------------------------------
# Structured run reports
# ---------------------------------------------------------------------------


class RunReport:
    """Counters / timers / gauges + JSONL events + a single JSON manifest.

    One instance per run (a ``fit`` call, a sweep row, a serving run). With ``out_dir`` set, :meth:`event` streams to
    ``events.jsonl`` as it happens (crash-safe partial record) and
    :meth:`write` drops ``report.json``; without it everything stays
    in-memory and :meth:`manifest` returns the same schema for embedding.
    """

    def __init__(self, out_dir: Optional[str] = None,
                 name: str = "run") -> None:
        self.meta: Dict[str, Any] = {
            "name": name,
            "created_unix": time.time(),
            "torch_version": torch.__version__,
            # the CUDA release torch was built against ("none" for a
            # CPU-only build)
            "cuda_version": torch.version.cuda or "none",
        }
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, Any] = {}
        self.timers: Dict[str, float] = {}
        self.events: List[Dict[str, Any]] = []
        self.telemetry: Optional[Dict[str, Any]] = None
        self.serving: List[Dict[str, Any]] = []
        self.serving_load: Optional[Dict[str, Any]] = None
        self.resilience: Optional[Dict[str, Any]] = None
        self.static_analysis: Optional[Dict[str, Any]] = None
        self.cost_model: Optional[Dict[str, Any]] = None
        self.memory: Optional[Dict[str, Any]] = None
        self.dynamics: Optional[Dict[str, Any]] = None
        self.calibration: Optional[Dict[str, Any]] = None
        self.out_dir = out_dir
        self._events_fh = None
        # the event stream is written from the training loop AND from
        # background threads (resilience.StepWatchdog stall diagnostics)
        self._events_lock = threading.Lock()
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)

    # -- recording ------------------------------------------------------

    def set_meta(self, **fields: Any) -> None:
        """Merge run-identifying fields (config, mesh_shape, schedule,
        phase_stats, backend, ...) into the manifest's ``meta`` block."""
        self.meta.update(fields)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def gauge(self, name: str, value: Any) -> None:
        self.gauges[name] = value

    @contextlib.contextmanager
    def timer(self, name: str):
        """Accumulating wall-clock timer: ``with report.timer("compile_s"):``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] = (self.timers.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def event(self, kind: str, **fields: Any) -> None:
        """Append one timestamped event; streamed to ``events.jsonl`` when
        the report has an output directory."""
        row = {"t": time.time(), "kind": kind, **fields}
        with self._events_lock:  # watchdog threads stream events too
            self.events.append(row)
            if self.out_dir is not None:
                if self._events_fh is None:
                    self._events_fh = open(
                        os.path.join(self.out_dir, "events.jsonl"), "a")
                self._events_fh.write(json.dumps(row, default=_jsonable)
                                      + "\n")
                self._events_fh.flush()

    def attach_telemetry(self, telemetry: PipelineTelemetry) -> None:
        """Embed a measured-timeline section (:meth:`PipelineTelemetry.report`)."""
        self.telemetry = telemetry.report()

    def attach_serving(self, summary: Dict[str, Any]) -> None:
        """Append one serving-run latency summary
        (:func:`serving_summary`) to the manifest's ``serving`` list —
        a benchmark that runs continuous and static policies back to
        back attaches both."""
        self.serving.append(summary)

    def attach_serving_load(self, section: Dict[str, Any]) -> None:
        """Embed an offered-load sweep (``serving.loadgen`` /
        ``serving.slo``: the latency-vs-load curve, the saturation knee,
        the SLO and the reference point) as the ``serving_load`` block."""
        self.serving_load = dict(section)

    def attach_resilience(self, section: Dict[str, Any]) -> None:
        """Embed the run's resilience summary (anomaly, preemption and
        stall counters and the checkpoint-commit stats that
        ``utils.train.fit`` gathers) as the ``resilience`` block."""
        self.resilience = dict(section)

    def attach_static_analysis(self, section: Dict[str, Any]) -> None:
        """Embed a static-verification digest (verifier version,
        schedules checked, hazard count, slot high-water marks) as the
        ``static_analysis`` block."""
        self.static_analysis = dict(section)

    def attach_cost_model(self, section: Dict[str, Any]) -> None:
        """Embed the roofline accounting
        (:func:`..analysis.cost_model.cost_model_section`: predicted
        against measured step time, bubble fractions, ring hops, MFU and
        HFU, the critical-path attribution) as the ``cost_model``
        block."""
        self.cost_model = dict(section)

    def attach_dynamics(self, section: Dict[str, Any]) -> None:
        """Embed a training-dynamics summary (final grad norm,
        gradient-noise scale, per-stage rows, attributed skips, forensic
        bundles) as the ``dynamics`` block."""
        self.dynamics = dict(section)

    def attach_memory(self, section: Dict[str, Any]) -> None:
        """Embed the memory accounting
        (:func:`..analysis.memory_model.memory_model_section`: analytic
        per-device bytes from the table's slot peaks and the live
        allocator watermarks) as the ``memory`` block."""
        self.memory = dict(section)

    def attach_calibration(self, section: Dict[str, Any]) -> None:
        """Embed a predicted-against-measured calibration record (probe
        rows, the raw and corrected error summary, fitted per-hardware
        corrections) as the ``calibration`` block."""
        self.calibration = dict(section)

    # -- output ---------------------------------------------------------

    def manifest(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "meta": _jsonable(self.meta),
            "counters": dict(self.counters),
            "gauges": _jsonable(self.gauges),
            "timers": dict(self.timers),
            "n_events": len(self.events),
        }
        if self.out_dir is not None:
            out["events_path"] = os.path.join(self.out_dir, "events.jsonl")
        else:
            out["events"] = _jsonable(self.events)
        if self.telemetry is not None:
            out["telemetry"] = _jsonable(self.telemetry)
        if self.serving:
            out["serving"] = _jsonable(self.serving)
        if self.serving_load is not None:
            out["serving_load"] = _jsonable(self.serving_load)
        if self.resilience is not None:
            out["resilience"] = _jsonable(self.resilience)
        if self.static_analysis is not None:
            out["static_analysis"] = _jsonable(self.static_analysis)
        if self.cost_model is not None:
            out["cost_model"] = _jsonable(self.cost_model)
        if self.memory is not None:
            out["memory"] = _jsonable(self.memory)
        if self.dynamics is not None:
            out["dynamics"] = _jsonable(self.dynamics)
        if self.calibration is not None:
            out["calibration"] = _jsonable(self.calibration)
        return out

    def write(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Validate + write the manifest (``report.json`` under ``out_dir``
        by default); returns the manifest dict."""
        m = self.manifest()
        validate_report(m)
        if path is None:
            if self.out_dir is None:
                raise ValueError("RunReport has no out_dir; pass a path")
            path = os.path.join(self.out_dir, "report.json")
        with open(path, "w") as fh:
            json.dump(m, fh, indent=2, default=_jsonable)
            fh.write("\n")
        if self._events_fh is not None:
            self._events_fh.close()
            self._events_fh = None
        return m


def _jsonable(x: Any) -> Any:
    """Best-effort conversion to JSON-serializable primitives (numpy
    scalars/arrays, torch tensors as numpy arrays, dataclass-likes,
    tuples)."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if hasattr(x, "__dataclass_fields__"):
        import dataclasses
        return _jsonable(dataclasses.asdict(x))
    return str(x)


def validate_report(manifest: Dict[str, Any]) -> None:
    """Schema check for a RunReport manifest (hand-rolled: the container
    has no jsonschema). Raises ``ValueError`` on the first violation."""
    def fail(msg: str):
        raise ValueError(f"invalid run report: {msg}")

    if not isinstance(manifest, dict):
        fail("manifest must be a dict")
    if manifest.get("schema_version") != SCHEMA_VERSION:
        fail(f"schema_version must be {SCHEMA_VERSION}, got "
             f"{manifest.get('schema_version')!r}")
    meta = manifest.get("meta")
    if not isinstance(meta, dict):
        fail("meta must be a dict")
    for key in ("name", "torch_version", "cuda_version"):
        if not isinstance(meta.get(key), str):
            fail(f"meta.{key} must be a string")
    if not isinstance(meta.get("created_unix"), (int, float)):
        fail("meta.created_unix must be a number")
    counters = manifest.get("counters")
    if not isinstance(counters, dict) or not all(
            isinstance(v, int) for v in counters.values()):
        fail("counters must be a dict of ints")
    if not isinstance(manifest.get("gauges"), dict):
        fail("gauges must be a dict")
    timers = manifest.get("timers")
    if not isinstance(timers, dict) or not all(
            isinstance(v, (int, float)) for v in timers.values()):
        fail("timers must be a dict of numbers")
    if not isinstance(manifest.get("n_events"), int):
        fail("n_events must be an int")
    events = manifest.get("events")
    if events is not None:
        if not isinstance(events, list):
            fail("events must be a list")
        for row in events:
            if not isinstance(row, dict) or not isinstance(
                    row.get("kind"), str) or not isinstance(
                    row.get("t"), (int, float)):
                fail("each event needs a str 'kind' and numeric 't'")
    elif not isinstance(manifest.get("events_path"), str):
        fail("manifest needs either inline 'events' or an 'events_path'")
    tel = manifest.get("telemetry")
    if tel is not None:
        if not isinstance(tel, dict):
            fail("telemetry must be a dict")
        if "timeline" in tel:
            if not isinstance(tel["timeline"], list) or not all(
                    isinstance(r, dict) and "duration_s" in r
                    and "n_ticks" in r for r in tel["timeline"]):
                fail("telemetry.timeline rows need duration_s and n_ticks")
    serving = manifest.get("serving")
    if serving is not None:
        if not isinstance(serving, list):
            fail("serving must be a list of run summaries")
        for row in serving:
            if not isinstance(row, dict):
                fail("each serving summary must be a dict")
            if not isinstance(row.get("policy"), str):
                fail("serving summary needs a str 'policy'")
            for key in ("tokens_out", "ticks", "n_requests"):
                if not isinstance(row.get(key), int):
                    fail(f"serving summary needs an int {key!r}")
            for key in ("wall_s", "tokens_per_sec", "goodput"):
                if not isinstance(row.get(key), (int, float)):
                    fail(f"serving summary needs a numeric {key!r}")
            for key in ("ttft_ticks", "tpot_ticks"):
                if not isinstance(row.get(key), dict):
                    fail(f"serving summary needs a dict {key!r} "
                         "(p50/p95/p99/mean)")
            if "n_failed" in row and not isinstance(row["n_failed"], int):
                fail("serving summary n_failed must be an int")
    sl = manifest.get("serving_load")
    if sl is not None:
        if not isinstance(sl, dict):
            fail("serving_load must be a dict")
        if not isinstance(sl.get("policy"), str):
            fail("serving_load.policy must be a string")
        wl = sl.get("workload")
        if not isinstance(wl, dict) or not isinstance(
                wl.get("mix"), str) or not isinstance(
                wl.get("n_requests"), int):
            fail("serving_load.workload needs a str 'mix' and int "
                 "'n_requests'")
        slo = sl.get("slo")
        if not isinstance(slo, dict) or not isinstance(
                slo.get("ttft_p99_ticks"), (int, float)):
            fail("serving_load.slo needs a numeric ttft_p99_ticks")
        curve = sl.get("curve")
        if not isinstance(curve, list) or not curve:
            fail("serving_load.curve must be a non-empty list")
        loads = []
        for row in curve:
            if not isinstance(row, dict) or not isinstance(
                    row.get("offered_load"), (int, float)):
                fail("serving_load curve rows need a numeric "
                     "'offered_load'")
            loads.append(float(row["offered_load"]))
            for key in ("ticks", "tokens_out"):
                if not isinstance(row.get(key), int):
                    fail(f"serving_load curve rows need an int {key!r}")
            for key in ("ttft_ticks", "tpot_ticks"):
                pct = row.get(key)
                if not isinstance(pct, dict) or "p99" not in pct:
                    fail(f"serving_load curve row {key!r} must be a "
                         "percentile dict carrying p99")
                if pct["p99"] is not None and not isinstance(
                        pct["p99"], (int, float)):
                    fail(f"serving_load curve row {key}.p99 must be a "
                         "number or null")
            # paged-engine gauge columns are optional (contiguous runs
            # omit them) but typed when present
            for key in ("goodput", "queue_depth_mean", "prefix_hit_rate",
                        "pages_used_mean", "page_fragmentation_mean"):
                if key in row and row[key] is not None and not isinstance(
                        row[key], (int, float)):
                    fail(f"serving_load curve row {key!r} must be numeric")
            for key in ("pages_capacity", "pages_used_max", "n_cow",
                        "n_backpressure", "prefill_skipped_tokens"):
                if key in row and row[key] is not None and not isinstance(
                        row[key], int):
                    fail(f"serving_load curve row {key!r} must be an int")
        if any(b <= a for a, b in zip(loads, loads[1:])):
            fail(f"serving_load offered loads must be strictly "
                 f"increasing, got {loads}")
        knee = sl.get("knee")
        if not isinstance(knee, dict) or not isinstance(
                knee.get("detected"), bool):
            fail("serving_load.knee must be a dict with a bool 'detected'")
        for key in ("knee_load", "max_sustainable_load"):
            v = knee.get(key)
            if v is not None and not isinstance(v, (int, float)):
                fail(f"serving_load.knee.{key} must be a number or null")
        if knee["detected"] and not isinstance(
                knee.get("knee_load"), (int, float)):
            fail("serving_load.knee.detected without a numeric knee_load")
        ref = sl.get("reference")
        if ref is not None:
            if not isinstance(ref, dict) or not isinstance(
                    ref.get("offered_load"), (int, float)):
                fail("serving_load.reference needs a numeric "
                     "'offered_load'")
    res = manifest.get("resilience")
    if res is not None:
        if not isinstance(res, dict):
            fail("resilience must be a dict")
        for key in ("anomalies", "anomaly_budget", "stalls", "n_committed",
                    "n_saved", "gc_removed"):
            if key in res and not isinstance(res[key], int):
                fail(f"resilience.{key} must be an int")
        if "preempted" in res and not isinstance(res["preempted"], bool):
            fail("resilience.preempted must be a bool")
    sa = manifest.get("static_analysis")
    if sa is not None:
        if not isinstance(sa, dict):
            fail("static_analysis must be a dict")
        if not isinstance(sa.get("verifier_version"), int):
            fail("static_analysis.verifier_version must be an int")
        if not isinstance(sa.get("schedules"), list) or not all(
                isinstance(s, str) for s in sa["schedules"]):
            fail("static_analysis.schedules must be a list of strings")
        if not isinstance(sa.get("hazards"), int):
            fail("static_analysis.hazards must be an int")
        shw = sa.get("slot_high_water")
        if not isinstance(shw, dict) or not all(
                isinstance(v, dict) and isinstance(v.get("act"), int)
                and isinstance(v.get("grad"), int) for v in shw.values()):
            fail("static_analysis.slot_high_water must map schedule labels "
                 "to {'act': int, 'grad': int}")
    cm = manifest.get("cost_model")
    if cm is not None:
        if not isinstance(cm, dict):
            fail("cost_model must be a dict")
        if not isinstance(cm.get("schedule"), str):
            fail("cost_model.schedule must be a string")
        hw = cm.get("hardware")
        if not isinstance(hw, dict) or not isinstance(
                hw.get("name"), str) or not isinstance(
                hw.get("peak_flops"), (int, float)):
            fail("cost_model.hardware needs a str name and numeric "
                 "peak_flops")
        pred = cm.get("predicted")
        if not isinstance(pred, dict):
            fail("cost_model.predicted must be a dict")
        for key in ("step_s", "step_s_comm_overlap", "bubble_table_exact",
                    "bubble_closed_form"):
            if not isinstance(pred.get(key), (int, float)):
                fail(f"cost_model.predicted.{key} must be a number")
        comm = cm.get("comm")
        if not isinstance(comm, dict) or not isinstance(
                comm.get("hops"), int):
            fail("cost_model.comm needs an int 'hops'")
        measured = cm.get("measured")
        if measured is not None:
            if not isinstance(measured, dict):
                fail("cost_model.measured must be a dict")
            for key in ("step_s", "mfu"):
                if not isinstance(measured.get(key), (int, float)):
                    fail(f"cost_model.measured.{key} must be a number")
        attrib = cm.get("attribution")
        if attrib is not None:
            if not isinstance(attrib, dict):
                fail("cost_model.attribution must be a dict")
            for key in ("compute_s", "comm_s", "bubble_s"):
                if not isinstance(attrib.get(key), (int, float)):
                    fail(f"cost_model.attribution.{key} must be a number")
    mem = manifest.get("memory")
    if mem is not None:
        if not isinstance(mem, dict):
            fail("memory must be a dict")
        if not isinstance(mem.get("schedule"), str):
            fail("memory.schedule must be a string")
        hw = mem.get("hardware")
        if not isinstance(hw, dict) or not isinstance(hw.get("name"), str):
            fail("memory.hardware needs a str name")
        ana = mem.get("analytic")
        if not isinstance(ana, dict):
            fail("memory.analytic must be a dict")
        for key in ("act_slot_bytes", "grad_slot_bytes", "peak_bytes",
                    "params_per_device_bytes"):
            if not isinstance(ana.get(key), (int, float)):
                fail(f"memory.analytic.{key} must be a number")
        devs = ana.get("per_device")
        if not isinstance(devs, list) or not devs:
            fail("memory.analytic.per_device must be a non-empty list")
        for row in devs:
            if not isinstance(row, dict) or not isinstance(
                    row.get("device"), int):
                fail("memory.analytic.per_device rows need an int 'device'")
            for key in ("act_bytes", "grad_bytes", "total_bytes"):
                if not isinstance(row.get(key), (int, float)):
                    fail(f"memory.analytic.per_device.{key} must be a "
                         "number")
        comp = mem.get("compiled")
        if comp is not None:
            if not isinstance(comp, dict):
                fail("memory.compiled must be a dict")
            if "error" not in comp:
                for key in ("argument_bytes", "output_bytes", "temp_bytes"):
                    if not isinstance(comp.get(key), (int, float)):
                        fail(f"memory.compiled.{key} must be a number")
        live = mem.get("live")
        if live is not None:
            if not isinstance(live, dict) or not isinstance(
                    live.get("available"), bool):
                fail("memory.live needs a bool 'available'")
            if not isinstance(live.get("per_device"), list):
                fail("memory.live.per_device must be a list")
    dyn = manifest.get("dynamics")
    if dyn is not None:
        if not isinstance(dyn, dict):
            fail("dynamics must be a dict")
        if not isinstance(dyn.get("n_stages"), int):
            fail("dynamics.n_stages must be an int")
        for key in ("gns_updates", "n_skipped_attributed"):
            if not isinstance(dyn.get(key), int):
                fail(f"dynamics.{key} must be an int")
        # grad_norm_final / gns may be None (no log sync ran / estimator
        # unarmed) or a number; a poisoned final step serializes as the
        # string repr ("nan") — still a valid record of what happened
        for key in ("grad_norm_final", "gns"):
            if key in dyn and not isinstance(
                    dyn[key], (int, float, str, type(None))):
                fail(f"dynamics.{key} must be a number, string or null")
        rows = dyn.get("per_stage")
        if not isinstance(rows, list):
            fail("dynamics.per_stage must be a list")
        for row in rows:
            if not isinstance(row, dict) or not isinstance(
                    row.get("stage"), int):
                fail("dynamics.per_stage rows need an int 'stage'")
            if not isinstance(row.get("nonfinite"), int):
                fail("dynamics.per_stage rows need an int 'nonfinite'")
            for key in ("grad_norm", "grad_max", "param_rms",
                        "update_ratio"):
                if key in row and not isinstance(
                        row[key], (int, float, str)):
                    fail(f"dynamics.per_stage.{key} must be a number "
                         "(or a non-finite repr string)")
        bundles = dyn.get("forensic_bundles")
        if not isinstance(bundles, list) or not all(
                isinstance(b, str) for b in bundles):
            fail("dynamics.forensic_bundles must be a list of filenames")
    cal = manifest.get("calibration")
    if cal is not None:
        if not isinstance(cal, dict):
            fail("calibration must be a dict")
        if not isinstance(cal.get("schema_version"), int):
            fail("calibration.schema_version must be an int")
        rows = cal.get("rows")
        if not isinstance(rows, list):
            fail("calibration.rows must be a list")
        if cal.get("n_rows") != len(rows):
            fail(f"calibration.n_rows ({cal.get('n_rows')!r}) must equal "
                 f"len(rows) ({len(rows)})")
        for row in rows:
            if not isinstance(row, dict):
                fail("calibration.rows entries must be dicts")
            for key in ("schedule", "schedule_family", "backward_policy",
                        "comm_overlap"):
                if not isinstance(row.get(key), str):
                    fail(f"calibration row {key!r} must be a string")
            for key in ("n_devices", "n_microbatches"):
                if not isinstance(row.get(key), int):
                    fail(f"calibration row {key!r} must be an int")
            # predicted/measured/rel_err may be null (backfilled rows with
            # only one side of the comparison) but must be present
            for key in ("predicted_step_s", "measured_step_s", "rel_err"):
                if key not in row:
                    fail(f"calibration row missing {key!r}")
                if row[key] is not None and not isinstance(
                        row[key], (int, float)):
                    fail(f"calibration row {key!r} must be a number or null")
        summary = cal.get("summary")
        if not isinstance(summary, dict):
            fail("calibration.summary must be a dict")
        for key in ("median_abs_rel_err_raw", "median_abs_rel_err_corrected"):
            if key not in summary:
                fail(f"calibration.summary missing {key!r}")
            if summary[key] is not None and not isinstance(
                    summary[key], (int, float)):
                fail(f"calibration.summary.{key} must be a number or null")
        if not isinstance(summary.get("groups"), dict):
            fail("calibration.summary.groups must be a dict")
        corr = cal.get("correction")
        if corr is not None:
            if not isinstance(corr, dict):
                fail("calibration.correction must be a dict")
            for hw_name, factors in corr.items():
                if not isinstance(factors, dict):
                    fail(f"calibration.correction[{hw_name!r}] must be "
                         "a dict")
                for key in ("flops_efficiency", "bandwidth_efficiency"):
                    if not isinstance(factors.get(key), (int, float)):
                        fail(f"calibration.correction[{hw_name!r}].{key} "
                             "must be a number")
        lp = cal.get("ledger_path")
        if lp is not None and not isinstance(lp, str):
            fail("calibration.ledger_path must be a string or null")
