"""Run the reference's 54-config sweep through the port and write its
tables (the counterpart of ``scripts/run_sweep.py``).

    python -m distributed_training_with_pipeline_parallelism_tpu_torch.run_sweep
    python -m distributed_training_with_pipeline_parallelism_tpu_torch.run_sweep --quick --device cpu

On the card by default, at the reference's size: ref_decoder, dim 768,
vocab 10000, ffn 2048, batch 32, seq 128, 4 microbatches, 5 timed
iterations after 2 warm-ups, f32; layers {4, 8, 12} x heads {4, 8, 12} x
devices {2, 4} x {GPipe, 1F1B, Interleaved1F1B} (``--schedules`` picks
others, e.g. ``--schedules 1F1B ZBH1 ZBV`` for the zero-bubble rows; ZBV
lifts M to 2D). Writes ``sweep.csv``
(every row and column) and ``speedup.csv`` under ``--out`` with the
stdlib ``csv`` module (the H100 host has no pandas), and prints both
tables with the card's name. ``--backend gloo`` (or ``nccl``) runs each
config as the reference does, one process per stage, one world per
device count (``utils.sweep``'s world rows, with their ``transport``).
``--report-dir`` appends each row's validated run-report manifest to
``sweep_reports.jsonl`` there. ``--dynamics`` adds one instrumented
gradient pass a row, off the clock (the ``grad_norm_final``, ``gns`` and
``n_skipped_attributed`` columns; ``dynamics.csv`` holds their median by
schedule); ``--schedule-artifact`` runs every row on a certified
searched schedule (``search_schedule``'s artifact: its schedule, M and V
replace the row's, and its table digest is recorded).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

from .utils.sweep import (compute_speedup_and_efficiency,
                          summarize_dynamics, sweep_rows)


def write_csv(path: str, rows) -> None:
    """``rows`` (dicts) as CSV, columns in first-seen order."""
    cols = list(dict.fromkeys(k for r in rows for k in r))
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="sweep_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--dim", type=int, default=None,
                    help="model width (default: the reference's 768, 64 "
                         "under --quick)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--schedules", nargs="+", default=None,
                    help="schedules to sweep (default: the reference's "
                         "GPipe, 1F1B, Interleaved1F1B); any of "
                         "parallel.schedules.schedule_names()")
    ap.add_argument("--quick", action="store_true",
                    help="a 6-config smoke run at a small size")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="run each config as the reference does, one "
                         "process per stage over torch.distributed with "
                         "this backend, one world per device count "
                         "(default: every stage in this process)")
    ap.add_argument("--report-dir", default=None,
                    help="append one RunReport manifest per row to "
                         "sweep_reports.jsonl in this dir")
    ap.add_argument("--dynamics", action="store_true",
                    help="one instrumented gradient pass a row, off the "
                         "clock: the model-health columns")
    ap.add_argument("--schedule-artifact", default=None,
                    help="a certified schedule artifact (search_schedule's "
                         "JSON) every row runs")
    args = ap.parse_args(argv)

    import torch
    dim = args.dim or (64 if args.quick else 768)
    kwargs = dict(dim=dim, dtype=args.dtype, device=args.device,
                  backend=args.backend, report_dir=args.report_dir,
                  dynamics=args.dynamics,
                  schedule_artifact=args.schedule_artifact)
    if args.schedules:
        kwargs["schedules"] = tuple(args.schedules)
    if args.quick:
        kwargs.update(layers=(4,), heads=(4, 8), devices=(2,), batch_size=8,
                      seq_length=32, vocab_size=256)
    device = torch.device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"sweep on {where}: {kwargs}", flush=True)
    rows = sweep_rows(num_iterations=args.iterations, **kwargs)
    speedup = compute_speedup_and_efficiency(rows)
    os.makedirs(args.out, exist_ok=True)
    write_csv(os.path.join(args.out, "sweep.csv"), rows)
    write_csv(os.path.join(args.out, "speedup.csv"), speedup)

    print(f"\n== tokens/s on {where} ==")
    print("L   H   D  schedule          tokens/s   bubble_analytic  "
          "bubble_simulated  bubble_table_exact  mfu_card")
    for r in rows:
        if "throughput" not in r:
            print(f"{r['n_layers']:<3} {r['n_heads']:<3} "
                  f"{r['num_processes']:<2} {r['schedule']:<16} "
                  f"skipped: {r['skip_reason']}")
            continue
        print(f"{r['n_layers']:<3} {r['n_heads']:<3} {r['num_processes']:<2} "
              f"{r['schedule']:<16} {r['throughput']:>10.1f}   "
              f"{r['bubble_analytic']:<16.4f} {r['bubble_simulated']:<17.4f} "
              f"{r['bubble_table_exact']:<19.4f} {r['mfu_card']:.4f}")
    print("\n== speedup over GPipe, efficiency (%) ==")
    for r in speedup:
        print(f"L{r['n_layers']} H{r['n_heads']} D{r['num_processes']} "
              f"{r['schedule']:<16} {r['speedup']:.4f}  "
              f"{r['efficiency']:.2f}")
    if args.dynamics:
        health = summarize_dynamics(rows)
        write_csv(os.path.join(args.out, "dynamics.csv"), health)
        print("\n== model health by schedule (median) ==")
        for r in health:
            print(f"{r['schedule']:<16} n={r['n']:<3} grad_norm_final "
                  f"{r['grad_norm_final_median']:.6g}  gns {r['gns_median']}"
                  f"  skipped {r['n_skipped_attributed']}")
    print(f"\nwrote {args.out}/sweep.csv and {args.out}/speedup.csv "
          f"({len(rows)} rows)")
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
