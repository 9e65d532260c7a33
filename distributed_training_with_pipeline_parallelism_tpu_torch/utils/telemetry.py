"""Serving latency summaries (the counterpart of the JAX package's
``utils/telemetry.py:serving_summary``, its ``_pct`` and its paged and
speculative fields; the rest of that
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
