"""Profiling (the counterpart of the JAX package's ``utils/profiling.py``:
``trace`` ``:41`` and ``annotate`` ``:55``). :func:`trace` records a block
with ``torch.profiler`` (host ops, and the card's kernels where there is
one) and writes it as a Chrome trace; :func:`annotate` labels a host span
in it. ``measure_bubble`` is ``ROADMAP.md`` Queue 1, item 12."""

from __future__ import annotations

import contextlib
import os

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
