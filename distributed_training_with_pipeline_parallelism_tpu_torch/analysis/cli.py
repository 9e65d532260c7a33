"""The static-analysis passes from the command line (the port's
counterpart of the JAX package's ``analysis/cli.py``).

    python -m distributed_training_with_pipeline_parallelism_tpu_torch.analysis
        [--tables] [--memory] [--overlap] [--search [--search-out PATH]]
        [--calibration] [--all] [--json PATH] [--quiet]

``--tables`` verifies every registered schedule over a config grid plus
the forward-only table and the serving ring; ``--memory`` prices
per-device memory over the same grid and pins the analytic-bytes identity;
``--overlap`` prices the grid in the cost model's ``comm_overlap`` mode and
pins the overlap sandwich and the two-buffer hop census; ``--search`` runs
the certifying schedule search on two small shapes; ``--calibration``
runs the calibration module's host checks. Every pass is host numpy and
its report equals the JAX pass's, case for case. ``--all`` runs the five.
Exit code 0 iff every requested pass is clean; ``--json PATH`` writes the
whole report.

The JAX ``--lint`` (``analysis/repo_lint.py``, the JAX package's own
lint) and ``--jaxpr`` (``analysis/jaxpr_audit.py``, audits of traced jax
programs) have no port yet (``ROADMAP.md`` Queue 1, item 9): asked for,
they raise ``NotImplementedError`` naming it; ``--all`` lists them under
the report's ``not_ported``. With no pass named, ``--tables`` runs (the
JAX default adds ``--lint``). The pricing passes use the CPU proxy's
preset on the CPU and the card's on a CUDA host, as the JAX passes
detect theirs.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from . import VERIFIER_VERSION

# the JAX passes with no port, and the item that records them
NOT_PORTED = {
    "lint": "the JAX package's repo lint (analysis/repo_lint.py) is not "
            "ported: ROADMAP.md Queue 1, item 9",
    "jaxpr": "the jaxpr audit (analysis/jaxpr_audit.py) audits traced jax "
             "programs and is not ported: ROADMAP.md Queue 1, item 9",
}


def _host_hardware():
    """The preset a host pass prices on: the card's on a CUDA host, else
    the CPU proxy (the JAX passes' ``detect_hardware()``)."""
    import torch

    from .cost_model import detect_hardware
    return detect_hardware("cuda" if torch.cuda.is_available() else "cpu")

GridEntry = Tuple[str, int, int, int]  # (schedule, D, V, M)


def default_grid() -> List[GridEntry]:
    """One grid entry per registered schedule x device count x virtual
    depth, with microbatch counts satisfying each schedule's constraints
    (1F1B/ZBH1: M >= D; ZBV: M >= 2D; Interleaved: divisibility)."""
    from ..parallel.schedules import schedule_names
    grid: List[GridEntry] = []
    for name in schedule_names():
        if name == "ZBV":
            v_options: Tuple[int, ...] = (2,)
        elif name in ("Interleaved1F1B", "BFS"):
            v_options = (1, 2)
        else:
            v_options = (1,)
        for D in (2, 4):
            for V in v_options:
                for M in sorted({D, 2 * D, 8}):
                    if name == "ZBV" and M < 2 * D:
                        continue
                    if name in ("1F1B", "ZBH1", "Interleaved1F1B") \
                            and M < D:
                        continue
                    if name == "Interleaved1F1B" and V > 1:
                        rounds = max(1, M // D)
                        if M % rounds != 0:
                            continue
                    grid.append((name, D, V, M))
    return grid


def run_table_checks(grid: Optional[List[GridEntry]] = None
                     ) -> Dict[str, Any]:
    from ..parallel.pipeline import _fwd_tick_table
    from ..parallel.schedules import ScheduleError, compile_schedule
    from .table_check import (check_forward_table, check_serving_ring,
                              check_table)
    reports: List[Dict[str, Any]] = []
    n_hazards = 0
    for name, D, V, M in (grid if grid is not None else default_grid()):
        try:
            cs = compile_schedule(name, D, V, M)
        except ScheduleError as e:
            reports.append({"name": name, "n_devices": D, "n_virtual": V,
                            "n_microbatches": M, "ok": False,
                            "n_hazards": 1,
                            "hazards": [f"compile failed: {e}"]})
            n_hazards += 1
            continue
        reports.append(check_table(cs).summary())
        n_hazards += reports[-1]["n_hazards"]
    for D, V, M in ((2, 1, 4), (4, 1, 8), (2, 2, 4)):
        table, n_slots = _fwd_tick_table(D, V, M)
        reports.append(check_forward_table(table, D, V, M,
                                           n_slots).summary())
        n_hazards += reports[-1]["n_hazards"]
    for D, M in ((2, 2), (4, 4), (4, 6)):
        reports.append(check_serving_ring(D, M).summary())
        n_hazards += reports[-1]["n_hazards"]
    # page-table discipline over a synthetic paged ring: a 4-slot pool
    # where slots 0/1 share a refcount-2 prefix page (read-only: their
    # write spans start past it) and slots 2/3 hold private rows; trailing
    # zeros are null-page filler. It must come back hazard-free.
    paging = {
        "page_size": 4, "n_pages": 16,
        "page_tbl": [[1, 2, 3, 0], [1, 4, 5, 0],
                     [6, 7, 8, 0], [9, 10, 11, 0]],
        "refcount": [1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
        "spans": [(4, 12), (4, 12), (0, 12), (0, 12)],
        "cow_dst": [-1, -1, -1, -1],
    }
    reports.append(check_serving_ring(2, 4, paging=paging).summary())
    n_hazards += reports[-1]["n_hazards"]
    # speculative widened-metadata discipline over a synthetic draft-verify
    # ring: gamma=2 inside a prefill_chunk=3 channel, two slots mid-verify
    # with in-range accepted lengths, committed frontiers at or behind the
    # accepted position, and page rows covering the verify chunk's junk
    # tail. Hazard-free by construction.
    speculative = {
        "gamma": 2, "prefill_chunk": 3,
        "slots": [
            {"slot": 0, "n_accepted": 3, "pos": 9, "committed": 8,
             "mapped_rows": 16},
            {"slot": 1, "n_accepted": 1, "pos": 5, "committed": 5,
             "mapped_rows": 12},
        ],
    }
    reports.append(check_serving_ring(2, 4,
                                      speculative=speculative).summary())
    n_hazards += reports[-1]["n_hazards"]
    return {"n_checked": len(reports), "n_hazards": n_hazards,
            "ok": n_hazards == 0, "reports": reports}


def run_memory_checks(grid: Optional[List[GridEntry]] = None
                      ) -> Dict[str, Any]:
    """The ``--memory`` pass: over the same schedule grid the table
    verifier walks, build :func:`.memory_model.memory_model_section` and
    assert the integer identity — per-device analytic activation/grad
    bytes equal the verifier's slot live peaks times one slot's slab
    bytes, exactly. Host-side only (shapes from the model on the ``meta``
    device)."""
    from ..parallel.schedules import ScheduleError, compile_schedule
    from ..utils.config import ModelConfig
    from .memory_model import memory_model_section
    from .table_check import check_table

    cfg = ModelConfig(dim=32, n_layers=4, n_heads=4, vocab_size=64,
                      ffn_dim=64, max_seq_len=16)
    hw = _host_hardware()
    batch, seq = 8, 16
    reports: List[Dict[str, Any]] = []
    n_bad = 0
    for name, D, V, M in (grid if grid is not None else default_grid()):
        row: Dict[str, Any] = {"name": name, "n_devices": D, "n_virtual": V,
                               "n_microbatches": M}
        try:
            cs = compile_schedule(name, D, V, M)
        except ScheduleError as e:
            row.update(ok=False, error=f"compile failed: {e}")
            reports.append(row)
            n_bad += 1
            continue
        tr = check_table(cs)
        sec = memory_model_section(cs, cfg, batch_size=batch,
                                   seq_length=seq, hardware=hw,
                                   table_report=tr)
        slot_b = sec["analytic"]["act_slot_bytes"]
        exact = all(
            pd["act_bytes"] == tr.act_live_peak[pd["device"]] * slot_b
            and pd["grad_bytes"] == tr.grad_live_peak[pd["device"]] * slot_b
            for pd in sec["analytic"]["per_device"])
        row.update(ok=bool(exact),
                   act_slot_bytes=slot_b,
                   backward_policy=sec["backward_policy"],
                   peak_bytes=sec["analytic"]["peak_bytes"],
                   per_device=sec["analytic"]["per_device"])
        if not exact:
            row["error"] = "analytic bytes != live_peak x slot_bytes"
            n_bad += 1
        reports.append(row)
    # the remaining rows of the table pass's 44-entry grid: forward-only
    # tables and the serving ring carry live peaks too — price them with
    # the same identity (one [mb, seq, dim] / [1, C, dim] slab per slot)
    from ..parallel.pipeline import _fwd_tick_table
    from .memory_model import activation_slot_bytes
    from .table_check import check_forward_table, check_serving_ring
    for D, V, M in ((2, 1, 4), (4, 1, 8), (2, 2, 4)):
        table, n_slots = _fwd_tick_table(D, V, M)
        tr = check_forward_table(table, D, V, M, n_slots)
        slot_b = activation_slot_bytes(cfg, batch, seq, M)
        per_device = [{"device": d, "act_live_peak": int(p),
                       "grad_live_peak": 0,
                       "act_bytes": int(p) * slot_b, "grad_bytes": 0}
                      for d, p in enumerate(tr.act_live_peak)]
        reports.append({"name": "forward", "n_devices": D,
                        "n_virtual": V, "n_microbatches": M, "ok": True,
                        "act_slot_bytes": slot_b,
                        "backward_policy": "none",
                        "peak_bytes": float(max(pd["act_bytes"]
                                                for pd in per_device)),
                        "per_device": per_device})
    from .cost_model import dtype_bytes
    for D, M in ((2, 2), (4, 4), (4, 6)):
        tr = check_serving_ring(D, M)
        slot_b = cfg.dim * dtype_bytes(cfg.dtype)  # one decode token/slot
        per_device = [{"device": d, "act_live_peak": int(p),
                       "grad_live_peak": 0,
                       "act_bytes": int(p) * slot_b, "grad_bytes": 0}
                      for d, p in enumerate(tr.act_live_peak)]
        reports.append({"name": "serving_ring", "n_devices": D,
                        "n_virtual": 1, "n_microbatches": M, "ok": True,
                        "act_slot_bytes": slot_b,
                        "backward_policy": "none",
                        "peak_bytes": float(max(pd["act_bytes"]
                                                for pd in per_device)),
                        "per_device": per_device})
    return {"n_checked": len(reports), "n_bad": n_bad, "ok": n_bad == 0,
            "batch_size": batch, "seq_length": seq, "reports": reports}


def run_overlap_checks(grid: Optional[List[GridEntry]] = None
                       ) -> Dict[str, Any]:
    """The ``--overlap`` pass: over the full schedule grid, price every
    table in the cost model's ``comm_overlap`` mode and pin the overlap
    contract (host numpy):

    - ``step_s_comm_overlap <= step_s`` for every entry (hiding hops can
      never slow the predicted step down);
    - ``step_s_overlapped <= step_s_comm_overlap`` summed over the grid's
      real tables (the optimistic launch-tick bound stays below the
      bank-tick priced mode — the two attributions can differ tick by
      tick, so this is pinned per entry here where it holds for every
      registered schedule);
    - the verifier's exposed + overlappable hop census equals
      ``predicted_ppermutes`` (every hop is classified exactly once);
    - the overlap discipline itself is hazard-free (``check_table``'s
      two-buffer extension).
    """
    from ..parallel.schedules import ScheduleError, compile_schedule
    from .cost_model import comm_overlap_step_time, predicted_step_time
    from .table_check import check_table

    unit_s, hop_s = (1.0, 2.0, 1.0), 0.25
    reports: List[Dict[str, Any]] = []
    n_bad = 0
    for name, D, V, M in (grid if grid is not None else default_grid()):
        row: Dict[str, Any] = {"name": name, "n_devices": D, "n_virtual": V,
                               "n_microbatches": M}
        try:
            cs = compile_schedule(name, D, V, M)
        except ScheduleError as e:
            row.update(ok=False, error=f"compile failed: {e}")
            reports.append(row)
            n_bad += 1
            continue
        tr = check_table(cs)
        base = predicted_step_time(cs.table, unit_s, hop_s,
                                   tr.predicted_ppermutes)
        ov = comm_overlap_step_time(cs.table, unit_s, hop_s)
        census = sum(v["exposed_hop_ticks"] + v["overlappable_hop_ticks"]
                     for k, v in tr.overlap.items()
                     if k in tr.comm and tr.comm[k]["hop_ticks"] > 0)
        problems: List[str] = []
        if ov["step_s_comm_overlap"] > base["step_s"] + 1e-9:
            problems.append(
                f"comm_overlap {ov['step_s_comm_overlap']:.3f} > lockstep "
                f"step_s {base['step_s']:.3f}")
        if base["step_s_overlapped"] > ov["step_s_comm_overlap"] + 1e-9:
            problems.append(
                f"optimistic bound {base['step_s_overlapped']:.3f} > "
                f"comm_overlap {ov['step_s_comm_overlap']:.3f}")
        if census != tr.predicted_ppermutes:
            problems.append(f"overlap census {census} != predicted "
                            f"ppermutes {tr.predicted_ppermutes}")
        stage_hazards = [str(h) for h in tr.hazards
                         if h.kind.startswith("overlap-")]
        if stage_hazards:
            problems.extend(stage_hazards)
        row.update(ok=not problems,
                   step_s=base["step_s"],
                   step_s_overlapped=base["step_s_overlapped"],
                   step_s_comm_overlap=ov["step_s_comm_overlap"],
                   exposed_hops=ov["exposed_hops"],
                   overlappable_hops=ov["overlappable_hops"],
                   problems=problems)
        if problems:
            n_bad += 1
        reports.append(row)
    return {"n_checked": len(reports), "n_bad": n_bad, "ok": n_bad == 0,
            "unit_s": list(unit_s), "hop_s": hop_s, "reports": reports}


def run_lint() -> Dict[str, Any]:
    raise NotImplementedError(NOT_PORTED["lint"])


def run_jaxpr_audits() -> Dict[str, Any]:
    raise NotImplementedError(NOT_PORTED["jaxpr"])


def run_search(out_path: Optional[str] = None, *, seed: int = 0,
               iterations: int = 300) -> Dict[str, Any]:
    """The ``--search`` pass: run the certifying schedule compiler on two
    small shapes (host numpy), assert every
    winner is certified and beats or ties 1F1B's table-exact bubble
    fraction, and optionally save the first winner's artifact JSON."""
    from ..parallel.schedules import save_schedule_artifact
    from .schedule_search import SearchSpec, search_schedule

    # Case 1: split-backward greedy seeds — must strictly beat 1F1B's
    # bubble at D=4 (the acceptance bar). Case 2: full-backward search
    # from the builtin seeds — 1F1B is in the pool, so the winner ties
    # it at worst (split cannot beat 1F1B's idle fraction at D=2: the
    # elided stage-0 dgrad leaves the first device structurally idle).
    specs = [
        SearchSpec(n_devices=4, n_microbatches=8, seed=seed,
                   iterations=iterations),
        SearchSpec(n_devices=2, n_microbatches=4, split_backward=False,
                   seed=seed, iterations=iterations),
    ]
    out: Dict[str, Any] = {"cases": [], "ok": True}
    for i, spec in enumerate(specs):
        res = search_schedule(spec)
        beats = res.beats_1f1b
        case = {
            "case": f"search[D={spec.n_devices},V={spec.n_virtual},"
                    f"M={spec.n_microbatches},seed={spec.seed}]",
            "certified": res.report.ok,
            "bubble_table_exact": res.predicted["bubble_table_exact"],
            "bubble_1f1b": res.baselines.get("1F1B", {}).get(
                "bubble_table_exact"),
            "beats_or_ties_1f1b": beats,
            "makespan": res.predicted["makespan"],
            "winning_seed": res.stats["winning_seed"],
            "evaluated": res.stats["evaluated"],
        }
        case_ok = bool(res.report.ok) and beats is not False
        out["cases"].append(case)
        out["ok"] = out["ok"] and case_ok
        if i == 0 and out_path:
            save_schedule_artifact(res.artifact, out_path)
            case["artifact"] = out_path
    return out


def run_calibration_checks() -> Dict[str, Any]:
    """The ``--calibration`` pass: host-side checks of the calibration
    module (numpy, no measured probe; the measured leg is ``probe.py``):

    - the probe grid is seeded-deterministic and spans the contract
      (>= 8 configs, >= 3 schedule families, all three backward
      policies, both comm_overlap modes);
    - the least-squares correction fit recovers known synthetic
      efficiencies to float64 accuracy;
    - the correction artifact byte-roundtrips and rejects tampering;
    - a corrected ``cost_model_section`` preserves the overlap sandwich
      (overlapped <= comm_overlap <= serial) — positive de-rating can
      reorder nothing;
    - malformed ledger rows are rejected with located errors.
    """
    from ..parallel.schedules import compile_schedule
    from ..utils.config import ModelConfig
    from . import calibration as cal
    from .cost_model import cost_model_section

    cases: List[Dict[str, Any]] = []

    def case(name: str, ok: bool, **extra: Any) -> None:
        cases.append({"case": name, "ok": bool(ok), **extra})

    g0, g1 = cal.probe_grid(seed=0), cal.probe_grid(seed=0)
    case("grid_deterministic", g0 == g1)
    families = {cal.schedule_family(s.schedule) for s in g0}
    policies = {cal._policy_of(s.schedule, s.remat_backward, s.n_devices)
                for s in g0}
    overlaps = {s.comm_overlap for s in g0}
    case("grid_coverage",
         len(g0) >= 8 and len(families) >= 3
         and policies == {"stored", "remat", "split"}
         and overlaps == {"none", "ring"},
         n_configs=len(g0), families=sorted(families),
         policies=sorted(policies), overlaps=sorted(overlaps))

    # synthetic fit: measured = compute/e_f + comm/e_b must be recovered
    e_f, e_b = 0.02, 0.5
    rows = []
    for i, (c, k) in enumerate(((1e-3, 1e-4), (2e-3, 5e-4), (3e-3, 2e-4),
                                (5e-3, 8e-4))):
        rows.append({
            "schema_version": cal.CALIBRATION_SCHEMA_VERSION,
            "kind": cal.LEDGER_KIND, "source": "synthetic", "t": 0.0,
            "name": f"syn{i}", "backend": "cpu", "hardware": "syn_hw",
            "cpu_proxy": True, "schedule": "GPipe",
            "schedule_family": "GPipe", "backward_policy": "remat",
            "comm_overlap": "none", "n_devices": 2, "n_virtual": 1,
            "n_microbatches": 4, "batch_size": 8, "seq_length": 16,
            "predicted": {"compute_s": c, "comm_s": k,
                          "step_s": c + k},
            "measured": {"step_s": c / e_f + k / e_b},
            "rel_err": None, "corrected": None,
        })
    fit = cal.fit_correction(rows, "syn_hw")
    case("fit_recovers_synthetic",
         fit is not None
         and abs(fit.flops_efficiency - e_f) < 1e-9
         and abs(fit.bandwidth_efficiency - e_b) < 1e-9,
         fitted=None if fit is None else fit.summary())

    art = cal.correction_artifact({"syn_hw": fit})
    loaded = cal.load_correction_artifact(art)
    rebuilt = cal.correction_artifact_bytes(cal.correction_artifact(loaded))
    roundtrip_ok = rebuilt == cal.correction_artifact_bytes(art)
    tampered = dict(art)
    tampered["corrections"] = dict(art["corrections"],
                                   syn_hw=dict(art["corrections"]["syn_hw"],
                                               flops_efficiency=1.0))
    try:
        cal.load_correction_artifact(tampered)
        tamper_ok = False
    except cal.CalibrationError:
        tamper_ok = True
    case("artifact_roundtrip_and_tamper", roundtrip_ok and tamper_ok)

    # corrected sandwich over a real table: de-rating by positive scalars
    # must preserve overlapped <= comm_overlap <= serial
    cfg = ModelConfig(dim=16, n_layers=4, n_heads=2, vocab_size=64,
                      ffn_dim=32, max_seq_len=16)
    hw = _host_hardware()
    sandwich_ok, checked = True, []
    for name, D, V, M in (("GPipe", 2, 1, 4), ("1F1B", 4, 1, 8),
                          ("ZBH1", 4, 1, 8)):
        cs = compile_schedule(name, D, V, M)
        sec = cost_model_section(cs, cfg, batch_size=8, seq_length=16,
                                 hardware=hw, correction=fit)
        corr = sec["predicted"]["corrected"]
        ok = (corr["step_s_overlapped"]
              <= corr["step_s_comm_overlap"] + 1e-12
              <= corr["step_s"] + 1e-12)
        sandwich_ok = sandwich_ok and ok
        checked.append({"schedule": name, "ok": ok,
                        "corrected_step_s": corr["step_s"]})
    case("corrected_sandwich", sandwich_ok, entries=checked)

    bad_rejected = 0
    for bad in ({}, {"schema_version": 99}, dict(rows[0], kind="wrong"),
                dict(rows[0], predicted={"no_step": 1.0})):
        try:
            cal.validate_ledger_row(bad)
        except cal.CalibrationError:
            bad_rejected += 1
    case("malformed_rows_rejected", bad_rejected == 4,
         n_rejected=bad_rejected)

    return {"cases": cases, "n_checked": len(cases),
            "n_bad": sum(1 for c in cases if not c["ok"]),
            "ok": all(c["ok"] for c in cases)}


def run_checks(tables: bool = True, lint: bool = False,
               jaxpr: bool = False, search: bool = False,
               search_out: Optional[str] = None,
               memory: bool = False, overlap: bool = False,
               calibration: bool = False,
               not_ported: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Run the requested passes into one report. ``lint`` or ``jaxpr``
    raises ``NotImplementedError`` (see the module doc);
    ``not_ported`` names passes left out, listed with their reasons under
    the report's ``not_ported``."""
    if lint:
        run_lint()
    if jaxpr:
        run_jaxpr_audits()
    report: Dict[str, Any] = {"verifier_version": VERIFIER_VERSION}
    ok = True
    if tables:
        report["tables"] = run_table_checks()
        ok = ok and report["tables"]["ok"]
    if memory:
        report["memory"] = run_memory_checks()
        ok = ok and report["memory"]["ok"]
    if overlap:
        report["overlap"] = run_overlap_checks()
        ok = ok and report["overlap"]["ok"]
    if calibration:
        report["calibration"] = run_calibration_checks()
        ok = ok and report["calibration"]["ok"]
    if search:
        report["search"] = run_search(search_out)
        ok = ok and report["search"]["ok"]
    if not_ported:
        report["not_ported"] = {k: NOT_PORTED[k] for k in not_ported}
    report["ok"] = ok
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_training_with_pipeline_parallelism_tpu"
             "_torch.analysis",
        description="Static analysis: table verifier, memory and overlap "
                    "pricing, schedule search, calibration checks")
    ap.add_argument("--tables", action="store_true",
                    help="verify every registered schedule's tick table "
                         "over the config grid")
    ap.add_argument("--lint", action="store_true",
                    help="the JAX repo lint: not ported (raises)")
    ap.add_argument("--jaxpr", action="store_true",
                    help="the JAX jaxpr audit: not ported (raises)")
    ap.add_argument("--search", action="store_true",
                    help="run the certifying schedule compiler on small "
                         "shapes and assert the winners are certified and "
                         "beat/tie 1F1B's table-exact bubble")
    ap.add_argument("--search-out", metavar="PATH",
                    help="with --search: save the first winner's schedule "
                         "artifact JSON to PATH")
    ap.add_argument("--memory", action="store_true",
                    help="price per-device HBM over the schedule grid and "
                         "pin analytic bytes == slot live peaks x slot "
                         "bytes (host-side, no backend)")
    ap.add_argument("--overlap", action="store_true",
                    help="price the schedule grid in comm_overlap mode and "
                         "pin step_s_overlapped <= step_s_comm_overlap <= "
                         "step_s plus the two-buffer hop census (host-side, "
                         "no backend)")
    ap.add_argument("--calibration", action="store_true",
                    help="structural checks over the calibration "
                         "observatory: probe-grid determinism/coverage, "
                         "synthetic least-squares recovery, correction-"
                         "artifact roundtrip + tamper rejection, corrected "
                         "sandwich, malformed-ledger-row rejection "
                         "(host-side, no backend)")
    ap.add_argument("--all", action="store_true",
                    help="the five ported passes (the report lists the "
                         "two left out)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the structured report to PATH")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-pass console summary")
    args = ap.parse_args(argv)

    tables = args.tables or args.all
    search = args.search or args.all
    memory = args.memory or args.all
    overlap = args.overlap or args.all
    calibration = args.calibration or args.all
    if not (tables or args.lint or args.jaxpr or search or memory
            or overlap or calibration):
        tables = True  # the default pass

    report = run_checks(tables=tables, lint=args.lint, jaxpr=args.jaxpr,
                        search=search, search_out=args.search_out,
                        memory=memory, overlap=overlap,
                        calibration=calibration,
                        not_ported=tuple(NOT_PORTED) if args.all else ())

    if not args.quiet:
        if "tables" in report:
            t = report["tables"]
            print(f"tables: {t['n_checked']} checked, "
                  f"{t['n_hazards']} hazards")
            for r in t["reports"]:
                for h in r.get("hazards", []):
                    print(f"  {r.get('name')}: {h}")
        if "memory" in report:
            m = report["memory"]
            print(f"memory: {m['n_checked']} priced, {m['n_bad']} identity "
                  f"violations (batch={m['batch_size']}, "
                  f"seq={m['seq_length']})")
            for r in m["reports"]:
                if "error" in r:
                    print(f"  {r['name']}[D={r['n_devices']},"
                          f"V={r['n_virtual']},M={r['n_microbatches']}]: "
                          f"{r['error']}")
                    continue
                cells = " ".join(
                    f"d{pd['device']}:{pd['act_live_peak']}x"
                    f"{r['act_slot_bytes']}B+{pd['grad_live_peak']}g"
                    for pd in r["per_device"])
                print(f"  {r['name']}[D={r['n_devices']},"
                      f"V={r['n_virtual']},M={r['n_microbatches']}] "
                      f"{r['backward_policy']}: "
                      f"peak {r['peak_bytes'] / 1e6:.3f} MB  {cells}")
        if "overlap" in report:
            ov = report["overlap"]
            print(f"overlap: {ov['n_checked']} priced, {ov['n_bad']} "
                  f"contract violations")
            for r in ov["reports"]:
                for p in r.get("problems", []) or (
                        [r["error"]] if "error" in r else []):
                    print(f"  {r['name']}[D={r['n_devices']},"
                          f"V={r['n_virtual']},M={r['n_microbatches']}]: "
                          f"{p}")
        if "calibration" in report:
            ca = report["calibration"]
            print(f"calibration: {ca['n_checked']} checks, "
                  f"{ca['n_bad']} failures")
            for c in ca["cases"]:
                if not c["ok"]:
                    print(f"  {c['case']}: FAIL "
                          f"{ {k: v for k, v in c.items() if k not in ('case', 'ok')} }")
        if "search" in report:
            for case in report["search"]["cases"]:
                status = ("ok" if case["certified"]
                          and case["beats_or_ties_1f1b"] is not False
                          else "FAIL")
                print(f"search: {case['case']}: {status} "
                      f"(bubble={case['bubble_table_exact']:.4f} vs "
                      f"1F1B={case['bubble_1f1b']}, "
                      f"seed={case['winning_seed']})")
        for name, why in report.get("not_ported", {}).items():
            print(f"{name}: left out ({why})")
        print(f"check: {'OK' if report['ok'] else 'FAILED'}")

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")

    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
