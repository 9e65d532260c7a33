"""Host-side analyses of the pipeline's tick tables (the port's own copies
of the numpy parts of the JAX package's ``analysis/``):

- :mod:`.table_check`: the static table verifier (hazards located to the
  cell, slot high-water marks, hop counts, the phase round trip, the
  ring's bank discipline) and the serving ring and page-table checks;
- :mod:`.cost_model` and :mod:`.memory_model`: a step's time and memory,
  priced from its table and the verifier's report;
- :mod:`.schedule_search`: the certifying schedule search, whose winner
  is a certified artifact (``parallel.schedules.schedule_artifact``).

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
