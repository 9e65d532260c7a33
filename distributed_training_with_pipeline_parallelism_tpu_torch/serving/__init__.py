"""Continuous-batching serving over the lockstep pipelined decoder (the
port's counterpart of the JAX package's ``serving``).

:mod:`.engine`: the slot-level program (a fixed-shape tick block over D
stages) and the host scheduler that admits, retires and refills slots
between blocks, with its paged-KV and speculative modes. :mod:`.paging`:
the host-side page allocator with its radix prefix cache. :mod:`.bench`:
the continuous-vs-static comparison on a Poisson trace, paged against
contiguous KV at a matched byte budget, and speculative against plain
decoding, each with the serving cost and memory sections.
:mod:`.loadgen`: seeded workload mixes and offered-load ramps with the
predicted per-tick roofline. :mod:`.slo`: SLO targets, attainment, and
the saturation knee.
"""

from .bench import (matched_budget_plan, run_paged_bench, run_serve_bench,
                    run_spec_bench, synth_trace)
from .engine import (Completion, Request, ServeResult, ServingEngine,
                     ServingProgram, make_serving_step_fn)
from .loadgen import WORKLOAD_MIXES, make_workload, sweep_offered_load
from .paging import (AdmissionPlan, PagedKVAllocator, PagePool,
                     RadixPrefixCache, pages_for)
from .slo import SLOSpec, find_knee, serving_load_section, slo_attainment

__all__ = ["Completion", "Request", "ServeResult", "ServingEngine",
           "ServingProgram", "make_serving_step_fn", "run_serve_bench",
           "run_paged_bench", "run_spec_bench", "matched_budget_plan",
           "synth_trace", "WORKLOAD_MIXES", "make_workload",
           "sweep_offered_load", "SLOSpec", "find_knee",
           "serving_load_section", "slo_attainment", "AdmissionPlan",
           "PagePool", "PagedKVAllocator", "RadixPrefixCache", "pages_for"]
