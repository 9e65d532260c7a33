"""Calibration probes: measured micro-probes -> ledger -> corrections (the
counterpart of the JAX package's ``scripts/probe.py``; the library is
``analysis.calibration``).

    python -m distributed_training_with_pipeline_parallelism_tpu_torch.probe OUTDIR
        [--grid smoke] [--seed 0] [--iterations 2] [--warmup 1]
        [--ledger PATH] [--corrections PATH] [--check] [--device cuda]
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.probe --backfill
        [--bench FILE ...] [--history FILE] [--ledger PATH]

Grid mode (the default): run the seeded probe grid on ``--device`` (the
card unless ``--device cpu``), one short measured run per (schedule family
x microbatch count x backward policy x comm_overlap) point; fit
per-hardware corrections from the fresh rows, re-price every row under the
fit, append the rows to the ledger, write the corrections as a versioned,
fingerprinted artifact, and write ``OUTDIR/report.json`` (a run report
with the ``calibration`` section, which ``utils.telemetry.validate_report``
accepts) and ``OUTDIR/trace.json`` (the Perfetto trace of a ring probe,
each tick carrying its corrected prediction beside its measurement).
``--check`` makes it a gate: the corrected median |relative error| below
the raw one, the trace annotated, the artifact and the appended rows
reading back byte for byte. It fails on the card and only warns on the
CPU, where the probes measure the host, not the model.

``--backfill`` appends rows from earlier measurements: bench wrappers
(``--bench``, JSON ``{"rc", "parsed": {"metric", "value", "unit"}}``) and a
perf history (``--history``, JSONL of headline scalars). A row with a
measurement and no prediction is kept with ``predicted: null``; one with
nothing to calibrate is skipped with its reason printed; a line already in
the ledger is skipped, so a second run appends nothing. It reads only the
files it is given.

The ledger and the artifact default to ``calibration_out/`` under the
current directory (``analysis.calibration.DEFAULT_LEDGER_PATH`` and
``DEFAULT_CORRECTIONS_PATH``); ``fit`` and the sweep read the artifact from
there, or from ``$DTPP_CALIBRATION_CORRECTIONS``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir", nargs="?", default="probe_out",
                   help="report and trace directory")
    p.add_argument("--grid", default="smoke",
                   help="probe grid name (analysis.calibration.probe_grid)")
    p.add_argument("--seed", type=int, default=0,
                   help="grid order and data seed (same seed: rows equal "
                        "but for the measured fields)")
    p.add_argument("--iterations", type=int, default=2,
                   help="timed steps a probe")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed steps a probe before them")
    p.add_argument("--ledger", default=None,
                   help="the calibration ledger (default "
                        "calibration_out/calibration.jsonl)")
    p.add_argument("--corrections", default=None,
                   help="the correction artifact written (default "
                        "calibration_out/calibration_corrections.json)")
    p.add_argument("--check", action="store_true",
                   help="gate: corrected error below raw, the artifact and "
                        "rows read back (warn-only on the cpu)")
    p.add_argument("--device", default="cuda",
                   help="where the probes run (cuda or cpu)")
    p.add_argument("--backfill", action="store_true",
                   help="append rows from --bench and --history instead of "
                        "probing")
    p.add_argument("--bench", nargs="*", default=[],
                   help="with --backfill: bench wrapper JSON files")
    p.add_argument("--history", default=None,
                   help="with --backfill: a perf history JSONL file")
    return p.parse_args(argv)


def run_backfill(args) -> int:
    from .analysis import calibration as cal

    ledger = args.ledger or cal.DEFAULT_LEDGER_PATH
    existing, bad = cal.load_ledger(ledger)
    for b in bad:
        print(f"probe --backfill: WARNING malformed ledger line: {b}")
    seen = {cal.canonical_row_line(r) for r in existing}
    rows, n_skipped = [], 0

    def keep(row, label, reason_none):
        nonlocal n_skipped
        if row is None:
            print(f"probe --backfill: skip {label}: {reason_none}")
            n_skipped += 1
        elif cal.canonical_row_line(row) in seen:
            print(f"probe --backfill: skip {label}: already in ledger")
            n_skipped += 1
        else:
            seen.add(cal.canonical_row_line(row))
            rows.append(row)

    for path in args.bench:
        label = os.path.splitext(os.path.basename(path))[0]
        if not os.path.exists(path):
            print(f"probe --backfill: skip {label}: no such file")
            n_skipped += 1
            continue
        with open(path) as fh:
            blob = json.load(fh)
        reason = ("bench run failed (rc != 0) or nothing parsed"
                  if blob.get("rc") or not blob.get("parsed")
                  else "no derivable step time (unit/batch/seq missing)")
        keep(cal.backfill_row_from_bench(blob, label=label), label, reason)

    if args.history is not None:
        name = os.path.basename(args.history)
        if not os.path.exists(args.history):
            print(f"probe --backfill: skip {args.history}: no such file")
        else:
            with open(args.history) as fh:
                for lineno, line in enumerate(fh, start=1):
                    line = line.strip()
                    if not line:
                        continue
                    label = f"{name}:{lineno}"
                    try:
                        hrow = json.loads(line)
                    except json.JSONDecodeError as e:
                        print(f"probe --backfill: skip {label}: bad JSON "
                              f"({e})")
                        n_skipped += 1
                        continue
                    keep(cal.backfill_row_from_history(hrow, path=label),
                         label, "no measured or predicted step time")

    n = cal.append_ledger_rows(ledger, rows)
    print(f"probe --backfill: OK — {n} rows appended to {ledger}, "
          f"{n_skipped} skipped (reasons above), "
          f"{len(existing)} rows were already present")
    return 0


def _trace_tick_predictions(detail, corrections):
    """The ring probe's per-tick predictions under its corrected roofline."""
    from .analysis.cost_model import predicted_tick_seconds
    cm, cs = detail["cost_model"], detail["compiled_schedule"]
    hwd = cm["hardware"]
    unit = cm["flops"]["unit"]
    unit_sec = (unit["F"] / hwd["peak_flops"], unit["B"] / hwd["peak_flops"],
                unit["W"] / hwd["peak_flops"])
    hop_s = cm["comm"]["bytes_per_hop"] / hwd["ici_bytes_per_s"]
    return predicted_tick_seconds(cs.table, unit_sec, hop_s,
                                  correction=corrections.get(hwd["name"]))


def run_grid(args) -> int:
    from .analysis import calibration as cal
    from .utils.config import resolve_device
    from .utils.telemetry import (RunReport, validate_report,
                                  write_perfetto_trace)

    device = resolve_device(args.device)
    backend = device.type
    specs = cal.probe_grid(args.grid, seed=args.seed)
    ledger = args.ledger or cal.DEFAULT_LEDGER_PATH
    corrections_path = args.corrections or cal.DEFAULT_CORRECTIONS_PATH

    print(f"probe: {len(specs)} probes ({args.grid} grid, seed "
          f"{args.seed}) on backend={backend}")
    measured, detail = [], {}
    for i, spec in enumerate(specs):
        t_start = time.time()
        sink = detail if spec.comm_overlap == "ring" else None
        row = cal.run_probe(spec, seed=args.seed,
                            num_iterations=args.iterations,
                            warmup_iterations=args.warmup,
                            t=t_start, detail=sink, device=device)
        measured.append((spec, row))
        err = (row.get("rel_err") or {}).get("step_s")
        print(f"probe [{i + 1}/{len(specs)}] {spec.label}: measured "
              f"{row['measured']['step_s']:.3e}s, raw rel_err "
              f"{'n/a' if err is None else format(err, '+.3f')} "
              f"({time.time() - t_start:.1f}s)")

    corrections = cal.fit_corrections([row for _, row in measured])
    for hw, cf in sorted(corrections.items()):
        print(f"probe: fitted {hw}: e_flops={cf.flops_efficiency:.4g}, "
              f"e_bw={cf.bandwidth_efficiency:.4g} over {cf.n_rows} rows "
              f"(residual rms {cf.residual_rms:.3e}s)")

    # the measurement is the costly part: re-price the same rows under
    # the fit instead of probing again
    rows = [cal.reprice_row(row, spec, corrections)
            for spec, row in measured]
    n_appended = cal.append_ledger_rows(ledger, rows)
    cal.save_correction_artifact(cal.correction_artifact(corrections),
                                 corrections_path)

    section = cal.calibration_section(rows, correction=corrections,
                                      ledger_path=ledger)
    report = RunReport(out_dir=args.out_dir, name="calibration_probe")
    report.set_meta(backend=backend, grid=args.grid, seed=args.seed,
                    ledger=ledger, corrections=corrections_path)
    report.count("probes", len(rows))
    report.attach_calibration(section)

    trace_ok = False
    if detail:
        report.attach_cost_model(detail["cost_model"])
        report.attach_memory(detail["memory"])
        trace_path = write_perfetto_trace(
            detail["telemetry"], os.path.join(args.out_dir, "trace.json"),
            predicted_tick_s=_trace_tick_predictions(detail, corrections))
        with open(trace_path) as fh:
            n_pred = json.load(fh).get("otherData", {}).get(
                "n_predicted_ticks", 0)
        trace_ok = n_pred > 0
        print(f"probe: trace with {n_pred} predicted-vs-measured ticks "
              f"at {trace_path}")

    validate_report(report.write())

    summary = section["summary"]
    raw_err = summary["median_abs_rel_err_raw"]
    cor_err = summary["median_abs_rel_err_corrected"]
    print(f"probe: OK — {n_appended} rows -> {ledger}, corrections -> "
          f"{corrections_path}, median |rel err| raw="
          f"{'n/a' if raw_err is None else format(raw_err, '.4f')} "
          f"corrected="
          f"{'n/a' if cor_err is None else format(cor_err, '.4f')}, "
          f"report at {os.path.join(args.out_dir, 'report.json')}")
    if not args.check:
        return 0
    failures = check_failures(rows, raw_err, cor_err, trace_ok, ledger,
                              corrections_path)
    if failures:
        for f in failures:
            print(f"probe --check: {f}", file=sys.stderr)
        if backend == "cpu":
            # the CPU measures the host, not the model: report, pass
            print("probe --check: WARN-ONLY on cpu backend "
                  f"({len(failures)} finding(s) above)", file=sys.stderr)
            return 0
        return 1
    print("probe --check: all gates passed")
    return 0


def check_failures(rows, raw_err, cor_err, trace_ok, ledger,
                   corrections_path):
    """The ``--check`` gate's findings (empty when it passes)."""
    from .analysis import calibration as cal
    failures = []
    if raw_err is None or cor_err is None:
        failures.append("probe rows produced no raw/corrected error "
                        "medians — the grid measured nothing")
    elif not cor_err < raw_err:
        failures.append(f"corrected median |rel err| {cor_err:.4f} is not "
                        f"below raw {raw_err:.4f}")
    if not trace_ok:
        failures.append("Perfetto trace carries no predicted-vs-measured "
                        "tick annotations")
    # the artifact reloads and rebuilds to its bytes on disk
    loaded = cal.load_correction_artifact(corrections_path)
    rebuilt = cal.correction_artifact_bytes(cal.correction_artifact(loaded))
    with open(corrections_path, "rb") as fh:
        if rebuilt != fh.read():
            failures.append("correction artifact does not byte-roundtrip")
    # the rows just appended read back verbatim
    reread, bad = cal.load_ledger(ledger)
    if bad:
        failures.append(f"ledger has {len(bad)} malformed lines: {bad[:2]}")
    if [cal.canonical_row_line(r) for r in reread[-len(rows):]] != \
            [cal.canonical_row_line(r) for r in rows]:
        failures.append("appended ledger rows did not read back verbatim")
    return failures


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.backfill:
        return run_backfill(args)
    return run_grid(args)


if __name__ == "__main__":
    sys.exit(main())
