"""SLO accounting for serving: attainment, goodput-under-SLO, and the
saturation knee over an offered-load ramp (the port's own copy of the JAX
package's ``serving/slo.py``; it imports nothing of that package).

Latency targets are quoted in *ticks* (the unit the engine stamps), so an
SLO verdict is deterministic and host-independent; the measured
``s_per_tick`` converts to wall-clock. The headline of a ramp is the
**saturation knee**: the first offered load whose tail latency blows the
target (or whose admission queue diverges), and so the largest load the
engine sustains inside the SLO (``max_sustainable_load``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["SLOSpec", "slo_attainment", "find_knee",
           "serving_load_section"]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request latency targets, in ticks.

    ``ttft_p99_ticks``: the p99 time-to-first-token budget (queue wait
    included — that is the user-visible number, and the one saturation
    destroys first). ``tpot_p99_ticks``: p99 per-output-token budget
    (None = not part of the SLO; an uncontended ring holds TPOT = M
    exactly, so the default guards against scheduler regressions rather
    than load). ``queue_depth_limit``: admission-queue depth above which
    the point counts as diverged even if latency lies inside the budget
    (None = queue depth never vetoes) — the open-loop early-warning
    signal, since queue growth precedes the TTFT blow-up by exactly one
    trace length."""
    ttft_p99_ticks: float
    tpot_p99_ticks: Optional[float] = None
    queue_depth_limit: Optional[float] = None
    name: str = "default"

    def __post_init__(self):
        if not self.ttft_p99_ticks > 0:
            raise ValueError(f"ttft_p99_ticks must be > 0, got "
                             f"{self.ttft_p99_ticks}")
        for key in ("tpot_p99_ticks", "queue_depth_limit"):
            v = getattr(self, key)
            if v is not None and not v > 0:
                raise ValueError(f"{key} must be > 0 (or None), got {v}")

    @classmethod
    def default_for(cls, program) -> "SLOSpec":
        """A target scaled to the ring's geometry: service TTFT is
        bounded by ``ceil(prompt_max/C)`` prefill visits (M ticks apart)
        plus the D-hop flight of the first token, so budget 4x that for
        queueing headroom; TPOT on an uncontended ring is exactly M
        (budget 2x); queue divergence at 4x the slot count."""
        import math
        M, D, C = program.n_slots, program.n_stages, program.prefill_chunk
        service = math.ceil(program.prompt_max / C) * M + D + M
        return cls(ttft_p99_ticks=4.0 * service,
                   tpot_p99_ticks=2.0 * M,
                   queue_depth_limit=4.0 * M,
                   name="auto")

    def summary(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _p99(pct: Optional[Dict[str, Any]]) -> Optional[float]:
    if not isinstance(pct, dict):
        return None
    v = pct.get("p99")
    return float(v) if isinstance(v, (int, float)) else None


def slo_attainment(result, spec: SLOSpec) -> Dict[str, Any]:
    """Per-point SLO accounting over one :class:`..engine.ServeResult`.

    ``attainment``: fraction of served requests whose OWN latencies meet
    every targeted budget (per-request TTFT vs the p99 target — the
    standard per-request attainment convention, so 0.99 attainment means
    the p99 sits exactly at target). ``goodput_under_slo``: tokens from
    SLO-meeting requests per tick — tokens emitted for requests the user
    already gave up on are traffic, not goodput (failed requests count
    against attainment, never toward it)."""
    comps = list(result.completions)
    ok = [c for c in comps if getattr(c, "status", "ok") == "ok"]
    met: List[Any] = []
    for c in ok:
        good = c.ttft_ticks <= spec.ttft_p99_ticks
        if good and spec.tpot_p99_ticks is not None \
                and c.tpot_ticks is not None:
            good = c.tpot_ticks <= spec.tpot_p99_ticks
        if good:
            met.append(c)
    ticks = int(getattr(result, "ticks", 0))
    return {
        "n_ok": len(ok),
        "n_met": len(met),
        "attainment": len(met) / len(comps) if comps else None,
        "goodput_under_slo": (sum(len(c.tokens) for c in met) / ticks
                              if ticks else None),
    }


def _point_violates(row: Dict[str, Any], spec: SLOSpec) -> Optional[str]:
    """The first budget this curve row blows, or None if it sustains."""
    ttft99 = _p99(row.get("ttft_ticks"))
    if ttft99 is not None and ttft99 > spec.ttft_p99_ticks:
        return "ttft_p99"
    if spec.tpot_p99_ticks is not None:
        tpot99 = _p99(row.get("tpot_ticks"))
        if tpot99 is not None and tpot99 > spec.tpot_p99_ticks:
            return "tpot_p99"
    if spec.queue_depth_limit is not None:
        qmax = row.get("queue_depth_max")
        if isinstance(qmax, (int, float)) and qmax > spec.queue_depth_limit:
            return "queue_depth"
    return None


def find_knee(curve: Sequence[Dict[str, Any]], spec: SLOSpec
              ) -> Dict[str, Any]:
    """The saturation knee of an offered-load curve.

    Walks the (strictly increasing) ramp and returns the first point
    that violates ``spec`` — blown p99 TTFT/TPOT or diverged queue —
    as ``knee_load``, with ``max_sustainable_load`` the highest load
    *below* it that sustained. ``detected=False`` means every point
    sustained (the ramp never reached saturation — widen it);
    ``max_sustainable_load=None`` with a detected knee means even the
    lowest point violated (the SLO is unattainable at any swept load).
    """
    knee_load = None
    reason = None
    max_ok = None
    for row in curve:
        load = float(row["offered_load"])
        why = _point_violates(row, spec)
        if why is None:
            if knee_load is None:
                max_ok = load
        elif knee_load is None:
            knee_load, reason = load, why
    return {
        "detected": knee_load is not None,
        "knee_load": knee_load,
        "reason": reason,
        "max_sustainable_load": max_ok,
    }


def serving_load_section(curve: Sequence[Dict[str, Any]],
                         knee: Dict[str, Any], spec: SLOSpec, *,
                         mix: str, n_requests: int, seed: int,
                         policy: str = "continuous",
                         reference_load: Optional[float] = None
                         ) -> Dict[str, Any]:
    """Assemble the ``serving_load`` section (the JAX RunReport
    section's schema): the curve rows, the knee, the SLOSpec, the
    workload descriptor, and the regression *reference*: the curve point
    at ``reference_load`` (default: the lowest swept load), whose p99 TTFT
    is tracked alongside ``max_sustainable_load``."""
    rows = list(curve)
    if not rows:
        raise ValueError("serving_load section needs >= 1 curve row")
    loads = [float(r["offered_load"]) for r in rows]
    if reference_load is None:
        ref_row = rows[0]
    else:
        ref_row = min(rows, key=lambda r: abs(float(r["offered_load"])
                                              - reference_load))
    return {
        "schema_version": 1,
        "policy": policy,
        "workload": {"mix": mix, "n_requests": int(n_requests),
                     "seed": int(seed)},
        "offered_loads": loads,
        "slo": spec.summary(),
        "curve": rows,
        "knee": dict(knee),
        "reference": {
            "offered_load": float(ref_row["offered_load"]),
            "ttft_p99_ticks": _p99(ref_row.get("ttft_ticks")),
            "goodput": ref_row.get("goodput"),
        },
    }
