"""Serving benchmarks (the port's counterpart of the JAX package's
``serving/bench.py``: ``synth_trace``, ``run_serve_bench``,
``matched_budget_plan``, ``run_paged_bench`` and ``run_spec_bench``).

:func:`run_serve_bench` replays one synthetic arrival trace (Poisson gaps,
mixed prompt and output lengths) through the SAME
:class:`.engine.ServingProgram` under both admission policies and reports
the comparison as one row: ``continuous`` refills a slot the moment its
request retires, ``static`` admits a fresh batch only after every slot has
drained. The program, weights and trace are identical, so every difference
in tokens/s, ticks and TTFT is scheduling.

:func:`run_paged_bench` compares paged and contiguous KV at one matched
per-device byte budget (:func:`matched_budget_plan`): contiguous serving
reserves the worst case ``mlen_alloc`` rows a slot, the paged engine buys a
page pool with the same bytes and provisions slots for the trace's mean
demand. :func:`run_spec_bench` compares speculative and plain decoding on
one trace. Greedy decoding makes a request's tokens independent of the
engine, so both rows assert ``outputs_match`` before comparing anything.

With a ``report`` (a ``utils.telemetry.RunReport``) each bench attaches
its serving summary, the serving cost model
(``analysis.cost_model.serving_cost_model_section``) and the serving
memory model (``analysis.memory_model.serving_memory_section``, with the
card's allocator watermarks over the runs in the place of JAX's compiled
accounting). Differences from the JAX module:

- The paged bench also prices both engines with the cost model and the
  speculative bench both with the memory model (rows ``cost_model`` and
  ``memory``), so each report carries both sections; a row's
  ``predicted_s_per_tick`` and ``s_per_tick`` hold the timed engine's.
  As in JAX an accounting error does not fail a run: the section is then
  missing, and a caller that needs it checks for it.
- JAX asserts that each engine's serving block compiled once
  (``program.step._cache_size() == 1``). An eager engine compiles
  nothing; its counterpart on the card is that each engine's program
  captured its CUDA graphs once (``ServingProgram.n_captures == 1``),
  which the benches assert there. The CPU captures no graph and skips
  the check.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.transformer import Transformer, init_params
from ..utils.config import ModelConfig, resolve_device
from ..utils.telemetry import serving_summary
from .engine import Request, ServingEngine, make_serving_step_fn


def _small_cfg(max_len: int, prefill_chunk: int) -> ModelConfig:
    """The JAX benches' default model: a small gpt2-family config."""
    return ModelConfig(arch="gpt2", dim=64, n_layers=4, n_heads=4,
                       vocab_size=128, ffn_dim=128,
                       max_seq_len=max_len + prefill_chunk - 1)


def _check_captures(engines: Dict[str, ServingEngine]) -> None:
    """On the card, each engine's program captured its graphs once (the
    JAX one-compilation assert; see the module doc)."""
    for name, eng in engines.items():
        p = eng.program
        if p.cuda_graphs and p.n_captures != 1:
            raise AssertionError(
                f"{name} serving program captured its graphs "
                f"{p.n_captures}x")


def _serving_sections(cfg, program, summary, *, hardware=None,
                      draft_cfg=None, prefix_stats=None):
    """The serving cost and memory sections of one engine's run, the
    memory section with the allocator's watermarks since the bench reset
    them (None for a section whose accounting failed: that never fails
    the run)."""
    from ..analysis.cost_model import (detect_hardware,
                                       serving_cost_model_section)
    from ..analysis.memory_model import allocator_stats, serving_memory_section
    hw = hardware
    cm = mem = None
    try:
        hw = hw if hw is not None else detect_hardware(program.device)
        cm = serving_cost_model_section(cfg, program.n_stages,
                                        program.n_slots, summary,
                                        hardware=hw, draft_cfg=draft_cfg)
    except Exception:  # accounting never fails a run
        cm = None
    try:
        mem = serving_memory_section(
            cfg, program, hardware=hw,
            allocator=allocator_stats(program.device),
            prefix_stats=prefix_stats)
    except Exception:  # accounting never fails a run
        mem = None
    return cm, mem


def _reset_peaks(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def synth_trace(n_requests: int, *, prompt_lens=(2, 12), out_lens=(2, 16),
                prefill_chunk: int = 1, load: float = 0.8,
                vocab_size: int = 64, seed: int = 0) -> List[Request]:
    """A Poisson arrival trace with mixed prompt/output lengths, the same
    requests as the JAX ``synth_trace`` for the same arguments.

    Each slot visit is M ticks apart, and a request occupies its slot
    for ``ceil(plen/C) + budget`` visits, so the ring's service capacity
    is ``1 / mean_visits`` requests per tick regardless of M. Arrival
    gaps are exponential with rate ``load`` x capacity: ``load < 1``
    drains, ``load > 1`` builds an unbounded queue.
    """
    if not 0 < load:
        raise ValueError(f"load must be > 0, got {load}")
    for name, (lo, hi) in (("prompt_lens", tuple(prompt_lens)),
                           ("out_lens", tuple(out_lens))):
        if lo < 1 or hi < lo:
            raise ValueError(
                f"{name} bounds ({lo}, {hi}) invalid: need 1 <= lo <= hi")
    rng = np.random.RandomState(seed)
    plens = rng.randint(prompt_lens[0], prompt_lens[1] + 1, size=n_requests)
    budgets = rng.randint(out_lens[0], out_lens[1] + 1, size=n_requests)
    mean_visits = float(np.mean(np.ceil(plens / prefill_chunk) + budgets))
    rate = load / mean_visits  # requests per tick
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    gaps[0] = 0.0  # first request is waiting when the ring starts
    arrivals = np.cumsum(gaps)
    return [Request(rid=i,
                    prompt=rng.randint(0, vocab_size, size=int(plens[i]))
                    .tolist(),
                    max_new_tokens=int(budgets[i]),
                    arrival=float(arrivals[i]))
            for i in range(n_requests)]


def run_serve_bench(*, cfg: Optional[ModelConfig] = None,
                    model: Optional[Transformer] = None, n_stages: int = 2,
                    n_slots: int = 4, prefill_chunk: int = 2,
                    max_len: int = 48, prompt_max: int = 12,
                    out_max: int = 16, n_requests: int = 24,
                    load: float = 1.5, eos_id: Optional[int] = 1,
                    seed: int = 0, reps: int = 3, report=None,
                    device="cuda") -> Dict[str, Any]:
    """Run the continuous-vs-static comparison; returns the row.

    With no ``cfg``/``model`` given, builds the JAX bench's small
    gpt2-family model (random weights from ``seed``) over ``n_stages``
    stages. Each policy runs ``reps`` times after one warm-up run and
    keeps the run of median wall time (the replay is deterministic, so
    any run's tokens do). ``report``: both policies' serving summaries,
    and the continuous run's cost and memory sections.
    """
    device = resolve_device(device)
    if cfg is None:
        cfg = _small_cfg(max_len, prefill_chunk)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = init_params(cfg, gen, device)
    trace = synth_trace(n_requests, prompt_lens=(2, prompt_max),
                        out_lens=(2, out_max), prefill_chunk=prefill_chunk,
                        load=load, vocab_size=cfg.vocab_size, seed=seed)
    program = make_serving_step_fn(cfg, n_stages, n_slots=n_slots,
                                   max_len=max_len, prompt_max=prompt_max,
                                   out_max=out_max,
                                   prefill_chunk=prefill_chunk,
                                   eos_id=eos_id, device=device)
    engine = ServingEngine(program, model, report=report)
    engine.run(trace[:1])  # warm-up: first launches, allocator
    _reset_peaks(device)
    results = {}
    for policy in ("continuous", "static"):
        runs = [engine.run(trace, policy=policy) for _ in range(max(1, reps))]
        results[policy] = sorted(runs, key=lambda r: r.wall_s)[len(runs) // 2]
        if report is not None:
            report.attach_serving(serving_summary(results[policy]))
    cont, stat = results["continuous"], results["static"]
    if report is not None:
        cm, mem = _serving_sections(cfg, program, serving_summary(cont))
        if cm is not None:
            report.attach_cost_model(cm)
        if mem is not None:
            report.attach_memory(mem)
    # same program and greedy: both policies must emit identical tokens per
    # request; anything else is a scheduler fault, not a speed difference
    by_rid = {c.rid: c.tokens for c in stat.completions}
    outputs_match = all(by_rid.get(c.rid) == c.tokens
                        for c in cont.completions)
    sc, ss = serving_summary(cont), serving_summary(stat)
    for s in (sc, ss):  # keep the row compact: no per-boundary series
        s.pop("occupancy", None)
        s.pop("queue_depth", None)
    return {
        "bench": "serve",
        "n_slots": n_slots, "n_pipe": n_stages,
        "prefill_chunk": prefill_chunk, "n_requests": n_requests,
        "load": load, "eos_id": eos_id, "seed": seed,
        "outputs_match": bool(outputs_match),
        "continuous_tokens_per_sec": sc["tokens_per_sec"],
        "static_tokens_per_sec": ss["tokens_per_sec"],
        "throughput_gain": (sc["tokens_per_sec"] / ss["tokens_per_sec"]
                            if ss["tokens_per_sec"] else None),
        "ticks_continuous": sc["ticks"], "ticks_static": ss["ticks"],
        "tick_gain": (ss["ticks"] / sc["ticks"] if sc["ticks"] else None),
        "ttft_p50_ticks": sc["ttft_ticks"]["p50"],
        "ttft_p99_ticks": sc["ttft_ticks"]["p99"],
        "ttft_p50_ticks_static": ss["ttft_ticks"]["p50"],
        "ttft_p99_ticks_static": ss["ttft_ticks"]["p99"],
        "continuous": sc, "static": ss,
    }


def matched_budget_plan(cfg, trace, *, n_devices: int, n_slots: int,
                        max_len: int, prefill_chunk: int, page_size: int,
                        budget_bytes: Optional[float] = None
                        ) -> Dict[str, Any]:
    """Size both sides of the paged-vs-contiguous comparison from ONE
    per-device KV byte budget (the JAX function, value for value).

    Default budget: exactly ``n_slots`` worst-case contiguous slots. The
    contiguous side gets ``contiguous_slots_for_budget`` slots (each
    reserving ``mlen_alloc`` rows); the paged side buys
    ``size_page_pool`` pages with the same bytes and provisions slots for
    the trace's mean page demand (``ceil((plen + budget + C - 1) /
    page_size)`` a request). Overcommit past the mean is safe: an
    exhausted pool defers admission (backpressure) and fails no request.
    The page table is priced by ``serving_memory_section``, not here."""
    from ..analysis.memory_model import (contiguous_slots_for_budget,
                                         kv_page_bytes, kv_slot_bytes,
                                         size_page_pool)
    from .paging import pages_for

    mlen_alloc = max_len + prefill_chunk - 1
    slot_b = kv_slot_bytes(cfg, n_devices=n_devices, mlen_alloc=mlen_alloc)
    if budget_bytes is None:
        budget_bytes = n_slots * slot_b
    m_c = contiguous_slots_for_budget(cfg, n_devices=n_devices,
                                      mlen_alloc=mlen_alloc,
                                      budget_bytes=budget_bytes)
    n_pages = size_page_pool(cfg, n_devices=n_devices, page_size=page_size,
                             budget_bytes=budget_bytes)
    if m_c < 1 or n_pages < 2:
        raise ValueError(
            f"budget {budget_bytes:.0f} B/device buys {m_c} contiguous "
            f"slots and {n_pages} pages — the comparison needs >= 1 slot "
            "and >= 2 pages on each side")
    demand = [pages_for(len(r.prompt) + r.max_new_tokens
                        + prefill_chunk - 1, page_size) for r in trace]
    mean_pages = float(np.mean(demand)) if demand else 1.0
    m_p = max(1, int((n_pages - 1) // mean_pages))
    return {
        "budget_bytes": float(budget_bytes),
        "mlen_alloc": int(mlen_alloc),
        "page_size": int(page_size),
        "contiguous_slot_bytes": float(slot_b),
        "page_bytes": float(kv_page_bytes(cfg, n_devices=n_devices,
                                          page_size=page_size)),
        "contiguous_slots": int(m_c),
        "n_pages": int(n_pages),
        "mean_pages_per_request": round(mean_pages, 6),
        "max_pages_per_request": int(max(demand)) if demand else 0,
        "paged_slots": int(m_p),
    }


def _ok_tokens(result) -> Dict[int, Any]:
    return {c.rid: c.tokens for c in result.completions
            if getattr(c, "status", "ok") == "ok"}


def _outputs_match(ref, got) -> bool:
    want = _ok_tokens(ref)
    return all(want.get(rid) == toks for rid, toks in _ok_tokens(got).items())


def _load_sweeps(engines, loads, mix, mixes, n_requests, seed, hardware,
                 row, report, timed: str):
    """Both engines swept over the offered ``loads`` (``loadgen.
    sweep_offered_load``): the row's ``serving_load`` and each engine's
    knee; the timed engine's sweep goes into ``report``."""
    from .loadgen import sweep_offered_load
    sweeps = {name: sweep_offered_load(
        eng, loads, mix=mix, n_requests=n_requests, seed=seed,
        hardware=hardware, mixes=mixes) for name, eng in engines.items()}
    row["serving_load"] = sweeps
    for name in engines:
        row[f"max_sustainable_load_{name}"] = \
            sweeps[name]["knee"]["max_sustainable_load"]
    if report is not None:
        report.attach_serving_load(sweeps[timed])


def run_paged_bench(*, cfg: Optional[ModelConfig] = None,
                    model: Optional[Transformer] = None, n_stages: int = 2,
                    n_slots: int = 4, prefill_chunk: int = 2,
                    max_len: int = 32, prompt_max: int = 12,
                    out_max: int = 16, page_size: int = 4,
                    n_requests: int = 24, load: float = 1.2,
                    mix: str = "prefix", loads=None,
                    eos_id: Optional[int] = 1, seed: int = 0,
                    budget_bytes: Optional[float] = None, mixes=None,
                    report=None, device="cuda") -> Dict[str, Any]:
    """Paged against contiguous KV serving at a matched per-device byte
    budget; returns the row.

    ``n_slots`` names the budget (that many worst-case contiguous slots)
    unless ``budget_bytes`` overrides it; :func:`matched_budget_plan`
    splits it into the two engines' geometries. Both engines replay the
    SAME ``mix`` trace (default the shared-prefix mix) with the
    continuous policy; the row asserts their completions match before
    comparing anything. ``loads`` (strictly increasing) also sweeps both
    engines over offered loads (``loadgen.sweep_offered_load``) and
    compares ``max_sustainable_load`` at the knee. ``mixes`` replaces
    ``loadgen.WORKLOAD_MIXES`` (the port's addition, for traces at a
    full-size model's lengths)."""
    from .loadgen import make_workload

    device = resolve_device(device)
    if cfg is None:
        cfg = _small_cfg(max_len, prefill_chunk)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = init_params(cfg, gen, device)
    D = int(n_stages)

    trace = make_workload(n_requests, mix, prefill_chunk=prefill_chunk,
                          load=load, vocab_size=cfg.vocab_size, seed=seed,
                          mixes=mixes)
    plan = matched_budget_plan(cfg, trace, n_devices=D, n_slots=n_slots,
                               max_len=max_len,
                               prefill_chunk=prefill_chunk,
                               page_size=page_size,
                               budget_bytes=budget_bytes)
    common = dict(max_len=max_len, prompt_max=prompt_max, out_max=out_max,
                  prefill_chunk=prefill_chunk, eos_id=eos_id, device=device)
    prog_c = make_serving_step_fn(cfg, D, n_slots=plan["contiguous_slots"],
                                  **common)
    prog_p = make_serving_step_fn(cfg, D, n_slots=plan["paged_slots"],
                                  paged=True, page_size=page_size,
                                  n_pages=plan["n_pages"], **common)
    engines = {"contiguous": ServingEngine(prog_c, model, report=report),
               "paged": ServingEngine(prog_p, model, report=report)}

    results, sections = {}, {}
    plens = [len(r.prompt) for r in trace]
    budgets = [r.max_new_tokens for r in trace]
    for name, eng in engines.items():
        _reset_peaks(device)
        results[name] = res = eng.run(trace, policy="continuous")
        prefix = None
        if name == "paged":
            prefix = {"hit_rate": res.prefix_hit_rate or 0.0,
                      "mean_prompt_len": float(np.mean(plens)),
                      "mean_budget": float(np.mean(budgets))}
        sections[name] = _serving_sections(
            cfg, eng.program, serving_summary(res), prefix_stats=prefix)
    _check_captures(engines)

    rc, rp = results["contiguous"], results["paged"]
    outputs_match = _outputs_match(rc, rp)
    sc, sp = serving_summary(rc), serving_summary(rp)
    for s in (sc, sp):
        for key in ("occupancy", "queue_depth", "pages_used",
                    "page_fragmentation"):
            s.pop(key, None)
    cost = {n: c for n, (c, _) in sections.items() if c is not None}
    mem = {n: m for n, (_, m) in sections.items() if m is not None}

    row: Dict[str, Any] = {
        "bench": "paged_serve",
        "n_pipe": D, "prefill_chunk": prefill_chunk,
        "n_requests": n_requests, "load": load, "mix": mix,
        "eos_id": eos_id, "seed": seed,
        "budget": plan,
        "contiguous_slots": plan["contiguous_slots"],
        "paged_slots": plan["paged_slots"],
        "slot_gain": plan["paged_slots"] / plan["contiguous_slots"],
        "outputs_match": bool(outputs_match),
        "goodput_contiguous": sc["goodput"],
        "goodput_paged": sp["goodput"],
        "goodput_gain": (sp["goodput"] / sc["goodput"]
                         if sc["goodput"] else None),
        "ticks_contiguous": sc["ticks"], "ticks_paged": sp["ticks"],
        "ttft_p99_ticks_contiguous": sc["ttft_ticks"]["p99"],
        "ttft_p99_ticks_paged": sp["ttft_ticks"]["p99"],
        "prefix_hit_rate": sp.get("prefix_hit_rate"),
        "prefill_skipped_tokens": sp.get("prefill_skipped_tokens"),
        "n_cow": sp.get("n_cow"),
        "n_backpressure": sp.get("n_backpressure"),
        "s_per_tick": sp["s_per_tick"],
        "predicted_s_per_tick": (cost["paged"]["predicted"]["step_s"]
                                 if "paged" in cost else None),
        "contiguous": sc, "paged": sp,
    }
    if mem:
        row["memory"] = mem
    if cost:
        row["cost_model"] = cost
    if loads is not None:
        _load_sweeps(engines, loads, mix, mixes, n_requests, seed, None,
                     row, report, "paged")
    if report is not None:
        if "paged" in cost:
            report.attach_cost_model(cost["paged"])
        if "paged" in mem:
            report.attach_memory(mem["paged"])
        report.attach_serving(sp)
    return row


def run_spec_bench(*, cfg: Optional[ModelConfig] = None,
                   model: Optional[Transformer] = None,
                   draft_cfg: Optional[ModelConfig] = None,
                   draft_model: Optional[Transformer] = None,
                   n_stages: int = 2, n_slots: int = 4,
                   prefill_chunk: int = 3, gamma: int = 2, max_len: int = 32,
                   prompt_max: int = 12, out_max: int = 16,
                   paged: bool = False, page_size: int = 4,
                   n_requests: int = 24, load: float = 1.5,
                   mix: str = "mixed", loads=None,
                   eos_id: Optional[int] = 1, seed: int = 0, reps: int = 3,
                   hardware=None, mixes=None, report=None,
                   device="cuda") -> Dict[str, Any]:
    """Speculative against plain decoding on one trace; returns the row.

    Both engines share weights, geometry and the SAME trace, so every
    difference in tokens/s, ticks and the knee is the draft-verify
    schedule; greedy acceptance makes the completions identical, which
    the row asserts (``outputs_match``). ``draft_cfg``/``draft_model``
    default to self-draft (the target drafts for itself: acceptance near
    1, so the tick-domain gain is deterministic); a ``draft_cfg`` without
    a model gets random weights from ``seed + 1``. Each engine runs one
    warm-up and ``reps`` timed runs, keeping the median by wall time.
    ``loads`` sweeps both engines over offered loads and compares the
    knee that ``serving_cost_model_section``'s ``speculative`` part
    predicts from the measured acceptance rate. ``hardware``: the
    roofline preset of the cost sections (default: the device's);
    ``mixes`` as in :func:`run_paged_bench`."""
    from .loadgen import make_workload

    device = resolve_device(device)
    if cfg is None:
        cfg = _small_cfg(max_len, prefill_chunk)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = init_params(cfg, gen, device)
    if draft_cfg is None:
        draft_cfg, draft_model = cfg, model  # self-draft
    elif draft_model is None:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        draft_model = init_params(draft_cfg, gen, device)
    D = int(n_stages)

    trace = make_workload(n_requests, mix, prefill_chunk=prefill_chunk,
                          load=load, vocab_size=cfg.vocab_size, seed=seed,
                          mixes=mixes)
    common = dict(n_slots=n_slots, max_len=max_len, prompt_max=prompt_max,
                  out_max=out_max, prefill_chunk=prefill_chunk,
                  eos_id=eos_id, device=device)
    if paged:
        common.update(paged=True, page_size=page_size)
    prog_off = make_serving_step_fn(cfg, D, **common)
    prog_on = make_serving_step_fn(cfg, D, speculative=True, gamma=gamma,
                                   draft_cfg=draft_cfg, **common)
    engines = {
        "spec_off": ServingEngine(prog_off, model, report=report),
        "spec_on": ServingEngine(prog_on, model, draft_params=draft_model,
                                 report=report),
    }

    results, sections = {}, {}
    for name, eng in engines.items():
        eng.run(trace[:1])  # warm-up: first launches, allocator
        _reset_peaks(device)
        runs = [eng.run(trace, policy="continuous")
                for _ in range(max(1, reps))]
        results[name] = sorted(runs, key=lambda r: r.wall_s)[len(runs) // 2]
        if paged:
            eng.paging.check_invariants()
        sections[name] = _serving_sections(
            cfg, eng.program, serving_summary(results[name]),
            hardware=hardware,
            draft_cfg=draft_cfg if name == "spec_on" else None)
    _check_captures(engines)

    r0, r1 = results["spec_off"], results["spec_on"]
    outputs_match = _outputs_match(r0, r1)
    s0, s1 = serving_summary(r0), serving_summary(r1)
    for s in (s0, s1):
        for key in ("occupancy", "queue_depth", "pages_used",
                    "page_fragmentation", "acceptance_series"):
            s.pop(key, None)
    cost = {n: c for n, (c, _) in sections.items() if c is not None}
    mem = {n: m for n, (_, m) in sections.items() if m is not None}
    cm = cost.get("spec_on")

    row: Dict[str, Any] = {
        "bench": "spec_serve",
        "n_pipe": D, "n_slots": n_slots,
        "prefill_chunk": prefill_chunk, "gamma": gamma, "paged": paged,
        "self_draft": draft_model is model,
        "n_requests": n_requests, "load": load, "mix": mix,
        "eos_id": eos_id, "seed": seed,
        "outputs_match": bool(outputs_match),
        "acceptance_rate": s1.get("acceptance_rate"),
        "accepted_len_mean": s1.get("accepted_len_mean"),
        "spec_verify_visits": s1.get("spec_verify_visits"),
        "spec_off_tokens_per_sec": s0["tokens_per_sec"],
        "spec_on_tokens_per_sec": s1["tokens_per_sec"],
        "throughput_gain": (s1["tokens_per_sec"] / s0["tokens_per_sec"]
                            if s0["tokens_per_sec"] else None),
        "ticks_spec_off": s0["ticks"], "ticks_spec_on": s1["ticks"],
        # ticks do not depend on the host: the tick-domain gain is the
        # deterministic capacity figure
        "tick_gain": (s0["ticks"] / s1["ticks"] if s1["ticks"] else None),
        "ttft_p99_ticks_spec_off": s0["ttft_ticks"]["p99"],
        "ttft_p99_ticks_spec_on": s1["ttft_ticks"]["p99"],
        "s_per_tick": s1["s_per_tick"],
        "predicted_s_per_tick": (cm["predicted"]["step_s"]
                                 if cm is not None else None),
        "spec_off": s0, "spec_on": s1,
    }
    if cm is not None and "speculative" in cm:
        row["predicted"] = cm["speculative"]["predicted"]
        row["expected_tokens_per_tick"] = \
            cm["speculative"]["expected_tokens_per_tick"]
    if cost:
        row["cost_model"] = cost
    if mem:
        row["memory"] = mem
    if loads is not None:
        _load_sweeps(engines, loads, mix, mixes, n_requests, seed, hardware,
                     row, report, "spec_on")
    if report is not None:
        if cm is not None:
            report.attach_cost_model(cm)
        if "spec_on" in mem:
            report.attach_memory(mem["spec_on"])
        report.attach_serving(s1)
    return row
