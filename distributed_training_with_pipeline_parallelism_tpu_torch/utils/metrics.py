"""Timed training iterations and the reference's metrics dict (the
counterpart of the JAX package's ``utils/metrics.py:run_train_iterations``):
untimed warm-up steps, then ``num_iterations`` timed steps, throughput =
batch * seq * iters / elapsed, and ``{"elapsed_time", "throughput",
"tokens_processed"}``.

Completion: a CUDA step returns before the device finishes, so the clock
stops only after ``torch.cuda.synchronize()`` and one ``.item()`` of the
last loss (the JAX ``force_completion``). In a world (``mesh``) every
rank takes a barrier after its warm-ups and after its timed steps, so the
window spans the slowest rank; the global batch is counted.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch


def force_completion(loss) -> None:
    """Wait until every kernel enqueued so far has run: synchronise the
    loss's CUDA device and read the loss back to the host."""
    if isinstance(loss, torch.Tensor):
        if loss.device.type == "cuda":
            torch.cuda.synchronize(loss.device)
        loss.item()


def run_train_iterations(step: Callable, model, tokens, targets,
                         num_iterations: int = 10,
                         warmup_iterations: int = 2,
                         seed: Optional[int] = None,
                         mesh=None, report=None,
                         telemetry=None) -> Dict[str, float]:
    """Time ``num_iterations`` calls of ``step(model, tokens, targets)``
    (returning the loss) after ``warmup_iterations`` untimed ones. With a
    ``seed`` (a step that runs train-mode dropout) the i-th call, warm-ups
    included, also takes ``seed + i`` as its step seed, so each step
    draws new masks. With ``mesh`` (this rank's ``parallel.mesh.Mesh``;
    every rank calls it) ``tokens`` is the rank's slice (its data rows,
    and on a seq axis its chunk of each sequence) and the tokens count the
    global batch; global rank 0's numbers are the run's.

    ``report`` (a ``utils.telemetry.RunReport``) records the warm-up
    (first launches and kernel builds included) and the timed loop as
    the ``warmup_s`` and ``timed_loop_s`` timers, the ``timed_iterations``
    counter and the returned metrics as gauges. ``telemetry`` (a
    ``PipelineTelemetry`` already wired into ``step``) is reset after the
    warm-up, so its stamps cover exactly the timed steps, and is attached
    to ``report`` at the end."""
    shards = 1 if mesh is None else mesh.n_data * mesh.n_seq * mesh.n_expert
    total_toks = tokens.shape[0] * tokens.shape[1] * num_iterations * shards
    barrier = mesh.barrier if mesh is not None else (lambda: None)

    def call(i):
        if seed is None:
            return step(model, tokens, targets)
        return step(model, tokens, targets, seed + i)

    warm0 = time.perf_counter()
    out = None
    for i in range(warmup_iterations):
        out = call(i)
    force_completion(out)
    barrier()
    if report is not None:
        report.timers["warmup_s"] = time.perf_counter() - warm0
    if telemetry is not None:
        telemetry.reset()  # the timeline covers the timed loop only
    start = time.perf_counter()
    for i in range(warmup_iterations, warmup_iterations + num_iterations):
        out = call(i)
    force_completion(out)
    barrier()
    elapsed = time.perf_counter() - start
    metrics = {"elapsed_time": elapsed, "throughput": total_toks / elapsed,
               "tokens_processed": total_toks}
    if report is not None:
        report.timers["timed_loop_s"] = elapsed
        report.count("timed_iterations", num_iterations)
        for k, v in metrics.items():
            report.gauge(k, v)
        if telemetry is not None:
            report.attach_telemetry(telemetry)
    return metrics
