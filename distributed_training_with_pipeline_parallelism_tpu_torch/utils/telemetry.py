"""Serving latency summaries (the counterpart of the JAX package's
``utils/telemetry.py:serving_summary`` and its ``_pct``; the rest of that
module, the pipeline telemetry and ``RunReport``, is not ported yet:
``ROADMAP.md`` Queue 1, item 12)."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


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
    the percentile samples. The dense engine's fields only: the paged and
    speculative gauges come with those modes.
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
    }
