"""Timed training iterations and the reference's metrics dict (the
counterpart of the JAX package's ``utils/metrics.py:run_train_iterations``):
untimed warm-up steps, then ``num_iterations`` timed steps, throughput =
batch * seq * iters / elapsed, and ``{"elapsed_time", "throughput",
"tokens_processed"}``.

Completion: a CUDA step returns before the device finishes, so the clock
stops only after ``torch.cuda.synchronize()`` and one ``.item()`` of the
last loss (the JAX ``force_completion``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict

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
                         warmup_iterations: int = 2) -> Dict[str, float]:
    """Time ``num_iterations`` calls of ``step(model, tokens, targets)``
    (returning the loss) after ``warmup_iterations`` untimed ones."""
    total_toks = tokens.shape[0] * tokens.shape[1] * num_iterations
    out = None
    for _ in range(warmup_iterations):
        out = step(model, tokens, targets)
    force_completion(out)
    start = time.perf_counter()
    for _ in range(num_iterations):
        out = step(model, tokens, targets)
    force_completion(out)
    elapsed = time.perf_counter() - start
    return {"elapsed_time": elapsed, "throughput": total_toks / elapsed,
            "tokens_processed": total_toks}
