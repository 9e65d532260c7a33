"""Host-side analyses of the pipeline's tick tables (the port's own copies
of the numpy parts of the JAX package's ``analysis/``):

- :mod:`.table_check`: the static table verifier (hazards located to the
  cell, slot high-water marks, hop counts, the phase round trip, the
  ring's bank discipline) and the serving ring and page-table checks;
- :mod:`.cost_model` and :mod:`.memory_model`: a step's time and memory,
  priced from its table and the verifier's report, and a serving run's;
- :mod:`.calibration`: measured probes against those prices, the ledger,
  and fitted per-hardware corrections as a fingerprinted artifact (the
  measured leg is ``probe.py``);
- :mod:`.schedule_search`: the certifying schedule search, whose winner
  is a certified artifact (``parallel.schedules.schedule_artifact``);
- :mod:`.cli` (``python -m
  distributed_training_with_pipeline_parallelism_tpu_torch.analysis``):
  the host passes from the command line.

The code that builds a table calls the verifier on it, behind the
``DTPP_VERIFY_TABLES`` environment variable (off unless set, as in JAX;
the tests set it): the executor's compile
(``parallel.pipeline.make_pipeline_grad_fn``), the eval executor's
forward table, the serving program and each paged admission.
"""

import os
from typing import Optional

VERIFIER_VERSION = 1


def verify_tables_enabled() -> bool:
    """True when ``DTPP_VERIFY_TABLES`` asks for build-time verification."""
    return os.environ.get("DTPP_VERIFY_TABLES", "").lower() not in (
        "", "0", "false", "off", "no")


def maybe_verify_schedule(cs) -> None:
    """With ``DTPP_VERIFY_TABLES`` set, check a compiled schedule's table
    (``table_check.check_table_cached``) and raise ``ScheduleError``
    naming every hazard's location; otherwise do nothing."""
    if not verify_tables_enabled():
        return
    from ..parallel.schedules import ScheduleError
    from .table_check import check_table_cached
    report = check_table_cached(cs)
    if not report.ok:
        raise ScheduleError(
            f"static table verification failed for {cs.name} "
            f"(D={cs.n_devices}, V={cs.n_virtual}, M={cs.n_microbatches}, "
            f"{cs.placement}): "
            + "; ".join(str(h) for h in report.hazards[:8]))


def maybe_verify_forward_table(table, n_devices: int, n_virtual: int,
                               n_microbatches: int, n_slots: int) -> None:
    """The same for the eval executor's forward-only table
    (``parallel.pipeline._fwd_tick_table``)."""
    if not verify_tables_enabled():
        return
    from ..parallel.schedules import ScheduleError
    from .table_check import check_forward_table
    report = check_forward_table(table, n_devices, n_virtual,
                                 n_microbatches, n_slots)
    if not report.ok:
        raise ScheduleError(
            f"static forward-table verification failed "
            f"(D={n_devices}, V={n_virtual}, M={n_microbatches}): "
            + "; ".join(str(h) for h in report.hazards[:8]))


def maybe_verify_serving(n_devices: int, n_slots: int,
                         gamma: Optional[int] = None,
                         prefill_chunk: Optional[int] = None) -> None:
    """The serving program's round robin
    (``serving.engine.make_serving_step_fn``); a speculative program
    passes ``gamma`` and ``prefill_chunk`` for the draft-verify checks.
    Raises ``ValueError``."""
    if not verify_tables_enabled():
        return
    from .table_check import check_serving_ring
    spec = (dict(gamma=gamma, prefill_chunk=prefill_chunk)
            if gamma is not None else None)
    report = check_serving_ring(n_devices, n_slots, speculative=spec)
    if not report.ok:
        raise ValueError(
            f"serving ring verification failed (D={n_devices}, "
            f"n_slots={n_slots}): "
            + "; ".join(str(h) for h in report.hazards[:8]))


def maybe_verify_page_table(pages, *, refcount, n_pages: int,
                            page_size: int, write_lo: int, write_hi: int,
                            cow_dst: int = -1, slot: int = -1) -> None:
    """One paged admission's planned page-table row against the pool's
    refcounts (``serving.engine.ServingEngine._admit``): in bounds, live,
    no aliased page, no write into a shared page without its copy.
    Raises ``ValueError``."""
    if not verify_tables_enabled():
        return
    from .table_check import page_table_hazards
    hazards = page_table_hazards(
        pages, refcount=refcount, n_pages=n_pages, page_size=page_size,
        write_lo=write_lo, write_hi=write_hi, cow_dst=cow_dst, slot=slot)
    if hazards:
        raise ValueError(
            f"page-table discipline verification failed (slot={slot}): "
            + "; ".join(str(h) for h in hazards[:8]))


# the public names of the submodules, imported on first use (as in JAX;
# the JAX lint's, the jaxpr audit's and XLA's compiled-memory names have
# no port: ROADMAP.md Queue 1, item 9)
_LAZY = {
    "Hazard": ("table_check", "Hazard"),
    "TableReport": ("table_check", "TableReport"),
    "check_table": ("table_check", "check_table"),
    "check_table_cached": ("table_check", "check_table_cached"),
    "check_table_baseline": ("table_check", "check_table_baseline"),
    "recheck_after_swap": ("table_check", "recheck_after_swap"),
    "TableCheckBaseline": ("table_check", "TableCheckBaseline"),
    "check_forward_table": ("table_check", "check_forward_table"),
    "check_serving_ring": ("table_check", "check_serving_ring"),
    "check_page_table": ("table_check", "check_page_table"),
    "page_table_hazards": ("table_check", "page_table_hazards"),
    "speculative_hazards": ("table_check", "speculative_hazards"),
    "static_analysis_section": ("table_check", "static_analysis_section"),
    "main": ("cli", "main"),
    "run_checks": ("cli", "run_checks"),
    "default_grid": ("cli", "default_grid"),
    "HardwareSpec": ("cost_model", "HardwareSpec"),
    "hardware_spec_for": ("cost_model", "hardware_spec_for"),
    "detect_hardware": ("cost_model", "detect_hardware"),
    "cost_model_section": ("cost_model", "cost_model_section"),
    "serving_cost_model_section": ("cost_model", "serving_cost_model_section"),
    "expected_tokens_per_verify": ("cost_model", "expected_tokens_per_verify"),
    "train_flops_per_token": ("cost_model", "train_flops_per_token"),
    "fwd_flops_per_token": ("cost_model", "fwd_flops_per_token"),
    "resolve_backward_policy": ("cost_model", "resolve_backward_policy"),
    "backward_weights": ("cost_model", "backward_weights"),
    "predicted_step_time": ("cost_model", "predicted_step_time"),
    "memory_model_section": ("memory_model", "memory_model_section"),
    "serving_memory_section": ("memory_model", "serving_memory_section"),
    "activation_slot_bytes": ("memory_model", "activation_slot_bytes"),
    "params_bytes": ("memory_model", "params_bytes"),
    "oom_preflight": ("memory_model", "oom_preflight"),
    "size_page_pool": ("memory_model", "size_page_pool"),
    "kv_page_bytes": ("memory_model", "kv_page_bytes"),
    "kv_slot_bytes": ("memory_model", "kv_slot_bytes"),
    "contiguous_slots_for_budget":
        ("memory_model", "contiguous_slots_for_budget"),
    "comm_overlap_step_time": ("cost_model", "comm_overlap_step_time"),
    "predicted_tick_seconds": ("cost_model", "predicted_tick_seconds"),
    "memory_probe_axes": ("memory_model", "memory_probe_axes"),
    "CalibrationError": ("calibration", "CalibrationError"),
    "ProbeSpec": ("calibration", "ProbeSpec"),
    "probe_grid": ("calibration", "probe_grid"),
    "run_probe": ("calibration", "run_probe"),
    "reprice_row": ("calibration", "reprice_row"),
    "schedule_family": ("calibration", "schedule_family"),
    "load_ledger": ("calibration", "load_ledger"),
    "append_ledger_rows": ("calibration", "append_ledger_rows"),
    "group_errors": ("calibration", "group_errors"),
    "CorrectionFactors": ("calibration", "CorrectionFactors"),
    "fit_corrections": ("calibration", "fit_corrections"),
    "correction_artifact": ("calibration", "correction_artifact"),
    "load_correction_artifact": ("calibration", "load_correction_artifact"),
    "maybe_load_default_corrections":
        ("calibration", "maybe_load_default_corrections"),
    "calibration_section": ("calibration", "calibration_section"),
    "calibration_section_from_cost_model":
        ("calibration", "calibration_section_from_cost_model"),
    "SearchSpec": ("schedule_search", "SearchSpec"),
    "SearchResult": ("schedule_search", "SearchResult"),
    "search_schedule": ("schedule_search", "search_schedule"),
    "seed_orders": ("schedule_search", "seed_orders"),
    "run_search": ("cli", "run_search"),
    "allocator_stats": ("memory_model", "allocator_stats"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        value = getattr(importlib.import_module(f".{mod}", __name__), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = ["VERIFIER_VERSION", "verify_tables_enabled",
           "maybe_verify_schedule", "maybe_verify_forward_table",
           "maybe_verify_serving", "maybe_verify_page_table",
           *sorted(_LAZY)]
