"""Deterministic open-loop load generation for serving (the port's
counterpart of the JAX package's ``serving/loadgen.py``).

Seeded *workload mixes* (short-chat / long-doc / mixed / shared-prefix
prompt and output length distributions over ``synth_trace``'s capacity
model) and :func:`sweep_offered_load`, which replays a *ramp* of offered
loads through the SAME :class:`.engine.ServingProgram` and reduces each
point to one curve row: latency percentiles (TTFT split into admission
wait and service), queue depth, slot occupancy, goodput and
goodput-under-SLO, and the measured ``s_per_tick``.

Every point of a ramp reuses the same workload seed, so prompt and output
lengths are identical across points and the exponential gaps scale
exactly by ``1/load``: p99 TTFT is monotone in offered load by
construction. Each row's ``predicted_s_per_tick`` is the serving cost
model's per-tick roofline (``analysis.cost_model.
serving_cost_model_section``) beside the measured ``s_per_tick``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .bench import synth_trace
from .engine import Request, ServingEngine

# Prompt/output-length bands per named mix, in tokens. Interactive
# chat: short prompts, mid-length answers. Document tasks: long prompts
# (summarization-shaped), short outputs. "mixed" blends both streams —
# the heterogeneous case continuous batching exists for. The bands are
# the JAX package's, small enough for a program with prompt_max=12 and
# out_max=16; pass ``mixes`` to make_workload for larger ones.
WORKLOAD_MIXES: Dict[str, Dict[str, Any]] = {
    "short_chat": {"prompt_lens": (2, 6), "out_lens": (6, 16)},
    "long_doc": {"prompt_lens": (8, 12), "out_lens": (2, 6)},
    "mixed": {"components": ("short_chat", "long_doc"),
              "fractions": (0.5, 0.5)},
    # shared-system-prompt traffic: every request is a short_chat request
    # with one of ``n_prefixes`` seeded shared prefixes prepended (the
    # workload a radix prefix cache reuses). Offered load stays
    # normalized to the BASE stream's capacity.
    "prefix": {"base": "short_chat", "n_prefixes": 2, "prefix_len": 6},
}


def mean_visits_per_request(prompt_lens: Sequence[int],
                            out_lens: Sequence[int],
                            prefill_chunk: int = 1) -> float:
    """Expected slot visits one request occupies: ``E[ceil(plen/C)] +
    E[budget]`` under discrete-uniform length bands — the analytic twin
    of the per-trace sampled mean ``synth_trace`` normalizes load by.
    The ring serves one slot visit per tick, so capacity is
    ``1 / mean_visits`` requests per tick regardless of M."""
    lo_p, hi_p = int(prompt_lens[0]), int(prompt_lens[1])
    lo_o, hi_o = int(out_lens[0]), int(out_lens[1])
    plens = np.arange(lo_p, hi_p + 1)
    visits = float(np.mean(np.ceil(plens / prefill_chunk)))
    return visits + (lo_o + hi_o) / 2.0


def make_workload(n_requests: int, mix: str = "mixed", *,
                  prefill_chunk: int = 1, load: float = 0.8,
                  vocab_size: int = 64, seed: int = 0,
                  mixes: Optional[Dict[str, Dict[str, Any]]] = None
                  ) -> List[Request]:
    """A seeded request trace for one named workload mix at one offered
    load (in units of ring capacity, as ``synth_trace``).

    Leaf mixes are one ``synth_trace`` call with the mix's length bands.
    Composite mixes (``components`` + ``fractions``) split ``load`` and
    ``n_requests`` across their component streams — each an independent
    Poisson process, so the superposition is again Poisson at the
    summed rate — merge by arrival and renumber rids. Same
    ``(mix, n_requests, seed)`` => byte-identical trace in any process.
    """
    table = mixes if mixes is not None else WORKLOAD_MIXES
    if mix not in table:
        raise ValueError(f"unknown workload mix {mix!r} "
                         f"(have: {sorted(table)})")
    spec = table[mix]
    if "base" in spec:
        # prefix mix: the base stream's trace (same seed discipline, so
        # arrivals/budgets are ramp-stable) with a seeded shared prefix
        # prepended to every prompt. Prefix tokens and the per-request
        # prefix choice derive from ``seed``, so identical across ramp
        # points and across processes.
        base = make_workload(n_requests, spec["base"],
                             prefill_chunk=prefill_chunk, load=load,
                             vocab_size=vocab_size, seed=seed, mixes=table)
        rs = np.random.RandomState(seed + 104729)
        n_pre, pre_len = int(spec["n_prefixes"]), int(spec["prefix_len"])
        prefixes = [[int(t) for t in rs.randint(1, vocab_size,
                                                size=pre_len)]
                    for _ in range(n_pre)]
        choices = rs.randint(0, n_pre, size=len(base))
        return [Request(rid=r.rid,
                        prompt=prefixes[int(choices[i])] + list(r.prompt),
                        max_new_tokens=r.max_new_tokens,
                        arrival=r.arrival)
                for i, r in enumerate(base)]
    if "components" not in spec:
        return synth_trace(n_requests, prompt_lens=spec["prompt_lens"],
                           out_lens=spec["out_lens"],
                           prefill_chunk=prefill_chunk, load=load,
                           vocab_size=vocab_size, seed=seed)
    comps, fracs = spec["components"], spec["fractions"]
    if len(comps) != len(fracs) or abs(sum(fracs) - 1.0) > 1e-9:
        raise ValueError(f"mix {mix!r}: fractions {fracs} must match "
                         "components and sum to 1")
    merged: List[Request] = []
    for j, (comp, frac) in enumerate(zip(comps, fracs)):
        n_j = max(1, int(round(n_requests * frac)))
        # distinct derived seeds per component; deterministic, and the
        # per-component stream is identical across ramp points (only
        # its gaps rescale with load)
        merged.extend(make_workload(
            n_j, comp, prefill_chunk=prefill_chunk, load=load * frac,
            vocab_size=vocab_size, seed=seed + 7919 * (j + 1),
            mixes=table))
    merged.sort(key=lambda r: r.arrival)
    out = []
    for i, r in enumerate(merged):
        out.append(Request(rid=i, prompt=list(r.prompt),
                           max_new_tokens=r.max_new_tokens,
                           arrival=r.arrival))
    # open-loop contract from synth_trace: the first request is waiting
    # when the ring starts
    if out:
        out[0] = Request(rid=0, prompt=out[0].prompt,
                         max_new_tokens=out[0].max_new_tokens, arrival=0.0)
    return out


def _point_row(load: float, summary: Dict[str, Any],
               predicted_s_per_tick: Optional[float],
               slo_point: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """One curve row: the headline columns flattened, with the full
    summary nested."""
    measured = summary.get("s_per_tick")
    row: Dict[str, Any] = {
        "offered_load": float(load),
        "n_requests": summary.get("n_requests"),
        "n_failed": summary.get("n_failed"),
        "ticks": summary.get("ticks"),
        "busy_ticks": summary.get("busy_ticks"),
        "tokens_out": summary.get("tokens_out"),
        "goodput": summary.get("goodput"),
        "goodput_busy": summary.get("goodput_busy"),
        "ttft_ticks": summary.get("ttft_ticks"),
        "tpot_ticks": summary.get("tpot_ticks"),
        "admit_wait_ticks": summary.get("admit_wait_ticks"),
        "service_ttft_ticks": summary.get("service_ttft_ticks"),
        "queue_depth_mean": summary.get("queue_depth_mean"),
        "queue_depth_max": summary.get("queue_depth_max"),
        "occupancy_mean": summary.get("occupancy_mean"),
        "s_per_tick": measured,
        "predicted_s_per_tick": predicted_s_per_tick,
        "predicted_over_measured": (
            predicted_s_per_tick / measured
            if predicted_s_per_tick and measured else None),
        "summary": summary,
    }
    if slo_point is not None:
        row["slo"] = slo_point
    return row


def sweep_offered_load(engine: ServingEngine, loads: Sequence[float], *,
                       mix: str = "mixed", n_requests: int = 24,
                       seed: int = 0, policy: str = "continuous",
                       slo=None, hardware=None,
                       reference_load: Optional[float] = None,
                       mixes: Optional[Dict[str, Dict[str, Any]]] = None
                       ) -> Dict[str, Any]:
    """Replay a ramp of offered loads through ``engine`` and return the
    ``serving_load`` section (:mod:`.slo` assembles it): one curve row per
    point, the saturation knee, the SLOSpec and workload descriptor, on
    one program for the whole ramp.

    ``loads`` must be strictly increasing. ``slo`` is an
    :class:`.slo.SLOSpec` (the program's default when omitted);
    ``hardware`` an ``analysis.cost_model.HardwareSpec`` for the
    predicted per-tick roofline column (default: the program's device's);
    ``reference_load`` names the curve point whose p99 TTFT becomes the
    tracked reference (default: the lowest load); ``mixes`` replaces
    :data:`WORKLOAD_MIXES` (as in :func:`make_workload`)."""
    from ..analysis.cost_model import (detect_hardware,
                                       serving_cost_model_section)
    from ..utils.telemetry import serving_summary
    from .slo import SLOSpec, find_knee, serving_load_section, slo_attainment

    loads = [float(x) for x in loads]
    if len(loads) < 2:
        raise ValueError(f"a sweep needs >= 2 offered loads, got {loads}")
    if any(b <= a for a, b in zip(loads, loads[1:])):
        raise ValueError(f"offered loads must be strictly increasing, "
                         f"got {loads}")
    if slo is None:
        slo = SLOSpec.default_for(engine.program)
    program = engine.program
    if hardware is None:
        hardware = detect_hardware(program.device)
    rows: List[Dict[str, Any]] = []
    for load in loads:
        trace = make_workload(n_requests, mix,
                              prefill_chunk=program.prefill_chunk,
                              load=load, vocab_size=program.cfg.vocab_size,
                              seed=seed, mixes=mixes)
        result = engine.run(trace, policy=policy)
        summary = serving_summary(result)
        # the per-tick roofline does not depend on the load (the ring
        # rolls every tick); each point's row holds it beside its
        # measured s_per_tick
        cm = serving_cost_model_section(
            program.cfg, program.n_stages, program.n_slots, summary,
            hardware=hardware, draft_cfg=program.draft_cfg)
        rows.append(_point_row(load, summary, cm["predicted"]["step_s"],
                               slo_attainment(result, slo)))
    knee = find_knee(rows, slo)
    return serving_load_section(rows, knee, slo, mix=mix,
                                n_requests=n_requests, seed=seed,
                                policy=policy,
                                reference_load=reference_load)
