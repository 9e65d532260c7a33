"""Profiling (the counterpart of the JAX package's ``utils/profiling.py``:
``trace`` ``:41``, ``annotate`` ``:55`` and ``measure_bubble`` ``:79``).
:func:`trace` records a block with ``torch.profiler`` (host ops, and the
card's kernels where there is one) and writes it as a Chrome trace;
:func:`annotate` labels a host span in it; :func:`measure_bubble` times a
pipelined step against the same model's one-stage step."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block: ``with trace('/tmp/prof'): step(...)`` writes
    ``/tmp/prof/trace.json`` (open it in Perfetto or
    ``chrome://tracing``). Stopping the profiler waits for the card."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Label a host-side span of a traced block:
    ``with annotate("step3"): step(...)``. No cost worth naming when no
    profiler is running."""
    with torch.profiler.record_function(name):
        yield


def _time_fn(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Mean seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup``, each window closed by ``metrics.force_completion``."""
    from .metrics import force_completion
    out = None
    for _ in range(warmup):
        out = fn(*args)
    force_completion(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    force_completion(out)
    return (time.perf_counter() - t0) / iters


def measure_bubble(cfg, n_stages: int, sched, batch_size: int = 32,
                   seq_length: int = 128, iters: int = 5, seed: int = 0,
                   device="cuda") -> Dict[str, float]:
    """Measured against analytic against simulated bubble for one config
    (the JAX ``measure_bubble``): the pipelined step over ``n_stages`` (D)
    under ``sched`` and the same model's one-stage GPipe step with the
    same microbatches through the tick executor and the remat backward
    (so the recompute's cost cancels out of the ratio), each timed over
    ``iters`` calls after 2 warm-ups; ``bubble_measured = 1 - t_single /
    (D * t_pipe)``. Random weights and tokens from ``seed``.

    Under the lockstep transport the D stages run one after another on
    one card, so a pipelined step costs about D one-stage steps' work
    and ``bubble_measured`` tends to 1 - 1/D whatever the schedule: the
    figure means something only with a card per rank."""
    from ..models.transformer import init_params
    from ..parallel.pipeline import make_pipeline_grad_fn
    from ..parallel.schedules import (analytic_bubble_fraction,
                                      compile_schedule, simulated_bubble)
    from .config import ScheduleConfig, resolve_device

    device = resolve_device(device)
    D = n_stages
    model = init_params(cfg, torch.Generator().manual_seed(seed), device)
    gen = torch.Generator().manual_seed(seed + 1)
    tokens, targets = (torch.randint(0, cfg.vocab_size,
                                     (batch_size, seq_length),
                                     generator=gen).to(device)
                       for _ in range(2))

    def timed(grad_fn):
        def step(m, x, y):
            m.zero_grad(set_to_none=True)
            return grad_fn(m, x, y)
        return _time_fn(step, model, tokens, targets, iters=iters)

    t_pipe = timed(make_pipeline_grad_fn(cfg, sched, D, device=device))
    single = ScheduleConfig(name="GPipe",
                            n_microbatches=sched.n_microbatches)
    t_single = timed(make_pipeline_grad_fn(cfg, single, 1,
                                           remat_backward=True,
                                           device=device))
    cs = compile_schedule(sched.name, D, sched.n_virtual,
                          sched.n_microbatches)
    return {
        "t_pipeline": t_pipe,
        "t_single_device": t_single,
        "bubble_measured": 1.0 - t_single / (D * t_pipe),
        "bubble_analytic": analytic_bubble_fraction(
            sched.name, D, sched.n_virtual, sched.n_microbatches, cs=cs),
        "bubble_simulated": simulated_bubble(cs, w_f=1.0, w_b=3.0)[
            "bubble_fraction"],
    }
