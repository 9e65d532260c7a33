"""The certifying schedule search: a cost-model-guided search over
per-device action orders whose every candidate is a verified tick table
(the port's own copy of the JAX package's
``analysis/schedule_search.py``; host Python and numpy).

:func:`search_schedule` compiles each candidate order with
``parallel.schedules.compile_order``, rejects any that
:func:`.table_check.check_table` does not certify or whose slot
high-water marks exceed the budgets, and scores the rest with the time
model the cost model prices reports with
(:func:`.cost_model.predicted_step_time`). Deterministic for a fixed seed
(a seeded ``random.Random``, no clock):

1. **Seeds**: the ``_zb_greedy_order`` synthesis under several live caps
   for a split-backward spec, the built-in orders otherwise; a seed that
   deadlocks or fails certification is dropped.
2. **Refinement**: seeded simulated annealing over adjacent swaps and
   short reinsertions within one device's order, each candidate
   rechecked from its first changed tick
   (:func:`.table_check.recheck_after_swap`).
3. **Certification**: the winner is recompiled with ``verify_table`` on,
   checked in full and emitted as a versioned artifact
   (``parallel.schedules.schedule_artifact``) with its clean report, its
   predicted cost and the 1F1B baseline.

The artifacts are the JAX package's byte for byte for one spec and seed
(``tests/test_torch_table_check.py``). The package's entry point writes,
reloads and re-searches one (``python -m
distributed_training_with_pipeline_parallelism_tpu_torch.search_schedule``).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..parallel.schedules import (
    Action,
    B,
    CompiledSchedule,
    F,
    ScheduleError,
    W,
    _zb_greedy_order,
    build_order,
    compile_order,
    compile_schedule,
    placement_device_of,
    schedule_artifact,
)
from .cost_model import (backward_weights, comm_overlap_step_time,
                         predicted_step_time)
from .table_check import (
    TableCheckBaseline,
    TableReport,
    check_table,
    check_table_baseline,
    recheck_after_swap,
)

__all__ = [
    "SearchSpec",
    "SearchResult",
    "search_schedule",
    "seed_orders",
    "one_f_one_b_baseline",
]


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """One search problem: a pipeline shape, budgets and knobs.

    ``unit_s`` is the (F, B, W) per-unit cost of the objective; None is
    :func:`.cost_model.backward_weights` of the spec's backward policy
    (``split`` when ``split_backward``, else ``remat``; ``stored`` on one
    device), forward-unit equivalents, which is what
    ``cost_model_section`` prices up to the hardware's scale.
    ``act_slot_budget``/``grad_slot_budget`` bound the per-device slot
    high-water marks (``TableReport.act_slots_used`` /
    ``grad_slots_used``); candidates over budget are rejected as hard
    constraint violations, same as hazards.

    Budgets can also be stated in *bytes* of HBM:
    ``act_bytes_budget``/``grad_bytes_budget`` (e.g. a fraction of
    :attr:`.cost_model.HardwareSpec.hbm_bytes` left after parameters and
    optimizer state) are divided by ``act_slot_bytes``/``grad_slot_bytes``
    (one slot's slab size, :func:`.memory_model.activation_slot_bytes`)
    and floored into an equivalent slot cap; when both a slot and a byte
    budget are given the tighter one wins (:meth:`resolved_slot_budgets`).
    """

    n_devices: int
    n_microbatches: int
    n_virtual: int = 1
    placement: str = "wrap"
    split_backward: bool = True
    seed: int = 0
    iterations: int = 600
    unit_s: Optional[Tuple[float, float, float]] = None
    hop_s: float = 0.0
    act_slot_budget: Optional[int] = None
    grad_slot_budget: Optional[int] = None
    act_bytes_budget: Optional[float] = None
    grad_bytes_budget: Optional[float] = None
    act_slot_bytes: Optional[int] = None
    grad_slot_bytes: Optional[int] = None
    name: str = "Searched"
    # the objective: "step_s" ranks candidates by the lockstep prediction,
    # "comm_overlap" by the double-buffered ring's step_s_comm_overlap;
    # every artifact records both
    objective: str = "step_s"

    def resolved_unit_s(self) -> Tuple[float, float, float]:
        if self.unit_s is not None:
            f, b, w = self.unit_s
            return (float(f), float(b), float(w))
        if self.split_backward:
            policy = "split"
        elif self.n_devices == 1:
            policy = "stored"
        else:
            policy = "remat"
        b, w = backward_weights(policy)
        return (1.0, float(b), float(w))

    def resolved_slot_budgets(self) -> Tuple[Optional[int], Optional[int]]:
        """Effective (act, grad) per-device slot caps: the tighter of the
        slot-count budget and ``floor(bytes_budget / slot_bytes)``."""
        def tighter(slots: Optional[int], bytes_budget: Optional[float],
                    slot_bytes: Optional[int]) -> Optional[int]:
            caps = [] if slots is None else [int(slots)]
            if bytes_budget is not None:
                caps.append(int(float(bytes_budget) // int(slot_bytes)))
            return min(caps) if caps else None
        return (tighter(self.act_slot_budget, self.act_bytes_budget,
                        self.act_slot_bytes),
                tighter(self.grad_slot_budget, self.grad_bytes_budget,
                        self.grad_slot_bytes))

    def validate(self) -> None:
        if self.n_devices < 1:
            raise ScheduleError(f"n_devices must be >= 1, got {self.n_devices}")
        if self.n_microbatches < 1:
            raise ScheduleError(
                f"n_microbatches must be >= 1, got {self.n_microbatches}")
        if self.n_virtual < 1:
            raise ScheduleError(f"n_virtual must be >= 1, got {self.n_virtual}")
        if self.placement not in ("wrap", "vshape"):
            raise ScheduleError(
                f"placement must be 'wrap' or 'vshape', got {self.placement!r}")
        if self.placement == "vshape" and self.n_virtual != 2:
            raise ScheduleError("vshape placement runs exactly 2 chunks per "
                                "device (set n_virtual=2)")
        if self.placement == "vshape" and not self.split_backward:
            raise ScheduleError("vshape search requires split_backward=True "
                                "(the ZB-V executor contract)")
        if self.iterations < 0:
            raise ScheduleError(f"iterations must be >= 0, got {self.iterations}")
        if self.objective not in ("step_s", "comm_overlap"):
            raise ScheduleError(f"objective must be 'step_s' or "
                                f"'comm_overlap', got {self.objective!r}")
        for kind in ("act", "grad"):
            bytes_budget = getattr(self, f"{kind}_bytes_budget")
            slot_bytes = getattr(self, f"{kind}_slot_bytes")
            if bytes_budget is not None:
                if slot_bytes is None or slot_bytes <= 0:
                    raise ScheduleError(
                        f"{kind}_bytes_budget needs {kind}_slot_bytes > 0 to "
                        f"convert bytes into slots (use analysis.memory_model"
                        f".activation_slot_bytes), got {slot_bytes!r}")
                if bytes_budget < slot_bytes:
                    raise ScheduleError(
                        f"{kind}_bytes_budget={bytes_budget} holds zero slots "
                        f"of {slot_bytes} bytes — no schedule can fit")


@dataclasses.dataclass
class SearchResult:
    """A certified winner: the compiled schedule, its clean report, the
    predicted cost it was selected on, baselines, and the versioned JSON
    artifact (``schedules.load_schedule_artifact`` re-certifies it)."""

    spec: SearchSpec
    cs: CompiledSchedule
    orders: List[List[Action]]
    report: TableReport
    predicted: Dict[str, float]
    baselines: Dict[str, Dict[str, float]]
    stats: Dict[str, object]
    artifact: Dict[str, object]

    @property
    def beats_1f1b(self) -> Optional[bool]:
        base = self.baselines.get("1F1B")
        if not base:
            return None
        return (self.predicted["bubble_table_exact"]
                <= base["bubble_table_exact"] + 1e-12)


# ---------------------------------------------------------------------------
# Seeds
# ---------------------------------------------------------------------------


def _greedy_seed_caps(D: int, M: int) -> List[Tuple[str, Callable[[int], int]]]:
    """Live-cap variants for the greedy synthesis: the ZB-H1 cap (2D - d),
    a flat deep bank, a tight memory-lean cap, and effectively-unbounded.
    Distinct caps land in different basins; the annealer refines each."""
    caps: List[Tuple[str, Callable[[int], int]]] = [
        ("zb-cap-2D-d", lambda d: 2 * D - d),
        ("zb-cap-2D+2", lambda d: 2 * D + 2),
        ("zb-cap-D+1", lambda d: D + 1),
        ("zb-cap-M", lambda d: max(M, 1)),
    ]
    return caps


def seed_orders(spec: SearchSpec) -> List[Tuple[str, List[List[Action]]]]:
    """Deterministic seed pool of (label, per-device orders) for a spec.

    Split-backward specs seed from the shared ``_zb_greedy_order``
    synthesis under several live caps (ZB-H1's ``2D - d`` among them, so
    the known-good zero-bubble orders are always in the pool); full-
    backward specs seed from the built-in schedule orders that fit the
    shape. Seeds whose synthesis deadlocks are skipped silently — the
    pool just shrinks.
    """
    D, V, M = spec.n_devices, spec.n_virtual, spec.n_microbatches
    S = D * V
    seeds: List[Tuple[str, List[List[Action]]]] = []
    if spec.split_backward:
        device_of = lambda s: placement_device_of(spec.placement, s, D)
        for label, cap in _greedy_seed_caps(D, M):
            try:
                seeds.append((label, _zb_greedy_order(
                    D, M, S, device_of, cap, f"search seed {label}")))
            except ScheduleError:
                continue
    else:
        names = (["1F1B", "GPipe"] if V == 1 else ["Interleaved1F1B", "BFS"])
        for name in names:
            try:
                seeds.append((f"builtin-{name}", build_order(name, D, V, M)))
            except ScheduleError:
                continue
    if not seeds:
        raise ScheduleError(
            f"schedule search: no feasible seed for D={D}, V={V}, M={M}, "
            f"placement={spec.placement!r}, split={spec.split_backward}")
    return seeds


# ---------------------------------------------------------------------------
# Local moves
# ---------------------------------------------------------------------------


def _device_order_ok(order: Sequence[Action]) -> bool:
    """Cheap necessary condition before paying for a compile: within one
    device, F(s, m) must precede B(s, m) must precede W(s, m) (same stage
    => same device, so the full validator would reject these anyway)."""
    pos: Dict[Tuple[int, str, int], int] = {}
    for i, a in enumerate(order):
        pos[(a.stage, a.op, a.microbatch)] = i
    for (s, op, m), i in pos.items():
        if op == B:
            j = pos.get((s, F, m))
            if j is not None and j > i:
                return False
        elif op == W:
            j = pos.get((s, B, m))
            if j is not None and j > i:
                return False
            j = pos.get((s, F, m))
            if j is not None and j > i:
                return False
    return True


def _mutate(orders: List[List[Action]], rng: random.Random,
            ) -> Optional[List[List[Action]]]:
    """One local move: adjacent swap or short-window reinsertion inside a
    single device's order. Returns new orders, or None when the move is a
    no-op / trivially invalid (caller just draws again)."""
    candidates = [d for d, o in enumerate(orders) if len(o) > 1]
    if not candidates:
        return None
    d = rng.choice(candidates)
    order = list(orders[d])
    n = len(order)
    if rng.random() < 0.6:
        i = rng.randrange(n - 1)
        order[i], order[i + 1] = order[i + 1], order[i]
    else:
        i = rng.randrange(n)
        a = order.pop(i)
        lo, hi = max(0, i - 4), min(len(order), i + 4)
        j = rng.randrange(lo, hi + 1)
        if j == i:
            return None
        order.insert(j, a)
    if not _device_order_ok(order):
        return None
    out = list(orders)
    out[d] = order
    return out


# ---------------------------------------------------------------------------
# Evaluation: compile -> certify -> budget -> price
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Candidate:
    orders: List[List[Action]]
    cs: CompiledSchedule
    report: TableReport
    predicted: Dict[str, float]
    cost: Tuple[float, int, float]


def _evaluate(spec: SearchSpec, orders: List[List[Action]],
              unit_s: Tuple[float, float, float],
              baseline: Optional[TableCheckBaseline],
              stats: Dict[str, int]) -> Optional[_Candidate]:
    try:
        cs = compile_order(spec.name, orders, spec.n_devices, spec.n_virtual,
                           spec.n_microbatches,
                           split_backward=spec.split_backward,
                           placement=spec.placement, verify=False)
    except ScheduleError:
        stats["rejected_compile"] += 1
        return None
    if baseline is not None:
        report = recheck_after_swap(cs, baseline)
    else:
        report = check_table(cs)
    if report.hazards:
        stats["rejected_hazards"] += 1
        return None
    act_cap, grad_cap = spec.resolved_slot_budgets()
    if (act_cap is not None
            and max(report.act_slots_used, default=0) > act_cap):
        stats["rejected_budget"] += 1
        return None
    if (grad_cap is not None
            and max(report.grad_slots_used, default=0) > grad_cap):
        stats["rejected_budget"] += 1
        return None
    predicted = dict(predicted_step_time(cs.table, unit_s, spec.hop_s,
                                         report.predicted_ppermutes))
    predicted.update(comm_overlap_step_time(cs.table, unit_s, spec.hop_s))
    objective_s = (predicted["step_s_comm_overlap"]
                   if spec.objective == "comm_overlap"
                   else predicted["step_s"])
    cost = (objective_s, int(cs.makespan),
            predicted["bubble_table_exact"])
    return _Candidate(orders=orders, cs=cs, report=report,
                      predicted=predicted, cost=cost)


def one_f_one_b_baseline(spec: SearchSpec) -> Optional[Dict[str, float]]:
    """1F1B priced under the same objective (unit and hop costs): the
    baseline every artifact embeds. None when 1F1B does not fit the
    shape."""
    try:
        cs = compile_schedule("1F1B", spec.n_devices, 1, spec.n_microbatches)
    except ScheduleError:
        return None
    report = check_table(cs)
    predicted = predicted_step_time(cs.table, spec.resolved_unit_s(),
                                    spec.hop_s, report.predicted_ppermutes)
    predicted = dict(predicted)
    predicted.update(comm_overlap_step_time(cs.table, spec.resolved_unit_s(),
                                            spec.hop_s))
    predicted["makespan"] = int(cs.makespan)
    predicted["ok"] = bool(report.ok)
    return predicted


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def search_schedule(spec: SearchSpec) -> SearchResult:
    """Run the certifying search and return a :class:`SearchResult`.

    Deterministic for a fixed ``spec`` (byte-identical artifacts across
    runs — seeded ``random.Random``, no timestamps, canonical JSON).
    Raises :class:`~..parallel.schedules.ScheduleError` when no seed is
    feasible or the winner unexpectedly fails final certification.
    """
    spec.validate()
    unit_s = spec.resolved_unit_s()
    rng = random.Random(spec.seed)
    stats: Dict[str, int] = {
        "evaluated": 0, "accepted": 0, "improved": 0,
        "rejected_compile": 0, "rejected_hazards": 0, "rejected_budget": 0,
    }

    # --- seed pool: certify each seed, keep the best as the incumbent.
    seeds = seed_orders(spec)
    best: Optional[_Candidate] = None
    best_seed_label = None
    seed_labels: List[str] = []
    for label, orders in seeds:
        seed_labels.append(label)
        stats["evaluated"] += 1
        cand = _evaluate(spec, orders, unit_s, None, stats)
        if cand is not None and (best is None or cand.cost < best.cost):
            best, best_seed_label = cand, label
    if best is None:
        raise ScheduleError(
            f"schedule search: no seed certified for D={spec.n_devices}, "
            f"V={spec.n_virtual}, M={spec.n_microbatches} "
            f"(budgets act={spec.act_slot_budget}, grad={spec.grad_slot_budget})")

    # --- seeded annealing over local moves. The baseline anchors the
    # incremental recheck; it is rebased whenever the incumbent improves
    # so the suffix being reinterpreted stays short.
    current = best
    baseline = check_table_baseline(current.cs)
    t0_cost = max(current.cost[0], 1e-12)
    for it in range(spec.iterations):
        mutated = _mutate(current.orders, rng)
        if mutated is None:
            continue
        stats["evaluated"] += 1
        cand = _evaluate(spec, mutated, unit_s, baseline, stats)
        if cand is None:
            continue
        # geometric cooling, relative acceptance: early worsening moves of
        # a few percent pass, late ones effectively never.
        temp = 0.02 * (0.995 ** it)
        delta = (cand.cost[0] - current.cost[0]) / t0_cost
        if cand.cost < current.cost or (
                temp > 1e-9 and rng.random() < math.exp(-delta / temp)):
            current = cand
            stats["accepted"] += 1
            if cand.cost < best.cost:
                best, best_seed_label = cand, best_seed_label
                stats["improved"] += 1
                baseline = check_table_baseline(cand.cs)

    # --- final certification: recompile the winner with the executor-
    # contract verifier on, then a full (uncached, non-incremental)
    # check_table. Both must pass for the artifact to exist at all.
    cs = compile_order(spec.name, best.orders, spec.n_devices, spec.n_virtual,
                       spec.n_microbatches, split_backward=spec.split_backward,
                       placement=spec.placement, verify=True)
    report = check_table(cs)
    if not report.ok:
        raise ScheduleError(
            "schedule search: winner failed final certification: "
            + "; ".join(str(h) for h in report.hazards[:4]))
    predicted = dict(predicted_step_time(cs.table, unit_s, spec.hop_s,
                                         report.predicted_ppermutes))
    predicted.update(comm_overlap_step_time(cs.table, unit_s, spec.hop_s))
    predicted["makespan"] = int(cs.makespan)

    baselines: Dict[str, Dict[str, float]] = {}
    base = one_f_one_b_baseline(spec)
    if base is not None:
        baselines["1F1B"] = base

    search_meta: Dict[str, object] = {
        "algorithm": "greedy-seeds+annealing",
        "seed": spec.seed,
        "iterations": spec.iterations,
        "seed_pool": seed_labels,
        "winning_seed": best_seed_label,
        "unit_s": list(unit_s),
        "hop_s": spec.hop_s,
        "act_slot_budget": spec.act_slot_budget,
        "grad_slot_budget": spec.grad_slot_budget,
        "act_bytes_budget": spec.act_bytes_budget,
        "grad_bytes_budget": spec.grad_bytes_budget,
        "act_slot_bytes": spec.act_slot_bytes,
        "grad_slot_bytes": spec.grad_slot_bytes,
        "effective_act_slot_budget": spec.resolved_slot_budgets()[0],
        "effective_grad_slot_budget": spec.resolved_slot_budgets()[1],
        "objective": ("comm_overlap_step_time.step_s_comm_overlap"
                      if spec.objective == "comm_overlap"
                      else "predicted_step_time.step_s"),
        **stats,
    }
    artifact = schedule_artifact(
        cs, orders=best.orders, seed=spec.seed,
        table_report=report.summary(), predicted=predicted,
        baselines=baselines, search=search_meta)
    return SearchResult(spec=spec, cs=cs, orders=best.orders, report=report,
                        predicted=predicted, baselines=baselines,
                        stats=search_meta, artifact=artifact)
