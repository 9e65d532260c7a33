"""Serving benchmark: continuous vs static batching on a Poisson trace
(the port's counterpart of the JAX package's ``serving/bench.py``:
``synth_trace`` and ``run_serve_bench``).

Replays one synthetic arrival trace (Poisson gaps, mixed prompt and
output lengths) through the SAME :class:`.engine.ServingProgram` under
both admission policies and reports the comparison as one row:
``continuous`` refills a slot the moment its request retires, ``static``
admits a fresh batch only after every slot has drained. The program,
weights and trace are identical, so every difference in tokens/s, ticks
and TTFT is scheduling. The JAX row's ``report=`` (its RunReport with the
serving cost-model and memory sections) is not ported (``ROADMAP.md``
Queue 1, item 12, entry 6).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.transformer import Transformer, init_params
from ..utils.config import ModelConfig, resolve_device
from ..utils.telemetry import serving_summary
from .engine import Request, ServingEngine, make_serving_step_fn


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
                    seed: int = 0, reps: int = 3,
                    device="cuda") -> Dict[str, Any]:
    """Run the continuous-vs-static comparison; returns the row.

    With no ``cfg``/``model`` given, builds the JAX bench's small
    gpt2-family model (random weights from ``seed``) over ``n_stages``
    stages. Each policy runs ``reps`` times after one warm-up run and
    keeps the run of median wall time (the replay is deterministic, so
    any run's tokens do).
    """
    device = resolve_device(device)
    if cfg is None:
        cfg = ModelConfig(arch="gpt2", dim=64, n_layers=4, n_heads=4,
                          vocab_size=128, ffn_dim=128,
                          max_seq_len=max_len + prefill_chunk - 1)
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
    engine = ServingEngine(program, model)
    engine.run(trace[:1])  # warm-up: first launches, allocator
    results = {}
    for policy in ("continuous", "static"):
        runs = [engine.run(trace, policy=policy) for _ in range(max(1, reps))]
        results[policy] = sorted(runs, key=lambda r: r.wall_s)[len(runs) // 2]
    cont, stat = results["continuous"], results["static"]
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
