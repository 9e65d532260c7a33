"""Search a certified pipeline schedule and check its artifact (the
counterpart of the JAX package's ``scripts/search_schedule.py``; host
numpy only, no device).

    python -m distributed_training_with_pipeline_parallelism_tpu_torch.search_schedule OUTDIR
        [--devices 4] [--virtual 1] [--microbatches 8] [--no-split]
        [--placement wrap] [--seed 0] [--iterations 300]
        [--act-budget N] [--grad-budget N] [--hop-s S] [--name NAME]
        [--require-beat] [--skip-determinism]

Runs ``analysis.schedule_search.search_schedule`` on one pipeline shape,
checks that the winner is certified (a clean ``check_table`` report
embedded in the artifact) and that its table-exact bubble ties or beats
1F1B's (``--require-beat``: beats), writes ``OUTDIR/searched_schedule.json``,
reloads it through the certifying loader
(``parallel.schedules.load_schedule_artifact``: the orders recompiled and
every cell compared), and runs the search again to show that the seed
gives the same bytes. Exits 0 when every check holds. The artifact
registers as a schedule (``ScheduleConfig.from_artifact``,
``parallel.schedules.register_schedule_artifact``) for ``fit`` and the
sweep (``run_sweep --schedule-artifact``).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", help="directory for searched_schedule.json")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--virtual", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--no-split", action="store_true",
                    help="search full-backward orders (default: split B/W)")
    ap.add_argument("--placement", default="wrap",
                    choices=("wrap", "vshape"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--act-budget", type=int, default=None,
                    help="max activation slots a device (a hard constraint)")
    ap.add_argument("--grad-budget", type=int, default=None)
    ap.add_argument("--hop-s", type=float, default=0.0,
                    help="seconds a ring hop costs in the objective")
    ap.add_argument("--name", default="Searched")
    ap.add_argument("--require-beat", action="store_true",
                    help="require a strictly smaller bubble than 1F1B's")
    ap.add_argument("--skip-determinism", action="store_true",
                    help="skip the second search (halves the run time)")
    args = ap.parse_args(argv)

    from .analysis import schedule_search as ss
    from .parallel import schedules as sch

    spec = ss.SearchSpec(
        n_devices=args.devices, n_virtual=args.virtual,
        n_microbatches=args.microbatches, placement=args.placement,
        split_backward=not args.no_split, seed=args.seed,
        iterations=args.iterations, hop_s=args.hop_s,
        act_slot_budget=args.act_budget, grad_slot_budget=args.grad_budget,
        name=args.name)
    res = ss.search_schedule(spec)

    failures = []
    if not res.report.ok:
        failures.append("winner is not certified (hazards in TableReport)")
    tr = res.artifact.get("table_report") or {}
    if not tr.get("ok") or tr.get("n_hazards") != 0:
        failures.append("artifact does not embed a clean TableReport summary")
    base = res.baselines.get("1F1B")
    if base is None:
        failures.append("no 1F1B baseline for this shape")
    else:
        ours, theirs = (res.predicted["bubble_table_exact"],
                        base["bubble_table_exact"])
        if args.require_beat:
            if not ours < theirs - 1e-12:
                failures.append(
                    f"bubble {ours:.6f} does not beat 1F1B's {theirs:.6f}")
        elif not ours <= theirs + 1e-12:
            failures.append(
                f"bubble {ours:.6f} worse than 1F1B's {theirs:.6f}")

    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, "searched_schedule.json")
    sch.save_schedule_artifact(res.artifact, path)
    try:  # the certifying loader: recompile, every cell, check_table
        cs2 = sch.load_schedule_artifact(path)
        if sch.table_digest(cs2.table) != res.artifact["table_digest"]:
            failures.append("roundtrip table digest mismatch")
    except sch.ScheduleError as e:
        failures.append(f"artifact failed its own certifying load: {e}")
    if not args.skip_determinism:
        res2 = ss.search_schedule(spec)
        if (sch.schedule_artifact_bytes(res2.artifact)
                != sch.schedule_artifact_bytes(res.artifact)):
            failures.append("search is not byte-deterministic for the seed")

    b1f1b = base["bubble_table_exact"] if base else float("nan")
    print(f"search_schedule: D={spec.n_devices} V={spec.n_virtual} "
          f"M={spec.n_microbatches} split={spec.split_backward} "
          f"seed={spec.seed}: makespan={res.predicted['makespan']} "
          f"bubble={res.predicted['bubble_table_exact']:.4f} "
          f"(1F1B {b1f1b:.4f}) evaluated={res.stats['evaluated']} "
          f"winning_seed={res.stats['winning_seed']}")
    print(f"search_schedule: artifact -> {path}")
    for f in failures:
        print(f"search_schedule: FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
