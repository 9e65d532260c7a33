"""The reference's 54-config experiment: one row per (layers, heads,
devices, schedule), the speedup and scaling efficiency over GPipe, and the
throughput pivot (the port's own copy of the JAX package's
``utils/sweep.py``: ``run_one_experiment`` ``:36``, ``run_all_experiments``
``:289``, ``compute_speedup_and_efficiency`` ``:342``, ``pivot_throughput``
``:394``).

Rows are plain dicts with the JAX columns (``:176-216``) plus
:data:`PORT_COLUMNS`; pandas is imported only by the two functions that
return a DataFrame (:func:`run_all_experiments`, :func:`pivot_throughput`),
so :func:`sweep_rows`, which they wrap, runs where pandas is not
installed. The error and ``skip_reason`` contracts are JAX's: a config
that fails becomes ``{"error": ...}`` and is left out of the sweep, one
priced out by the OOM preflight becomes a ``skip_reason="predicted_oom"``
row.

What the columns mean in the port:

- ``host_serialized`` is always True: the lockstep transport runs all D
  stages on one card, one after another within each tick, so the
  throughput columns measure the total work plus each tick's overhead,
  not pipeline overlap (as the JAX docstring says of a CPU-simulated
  mesh). ``throughput_per_chip`` is still ``throughput / D``, as in JAX;
  schedule comparisons rest on the bubble and cost-model columns.
- ``tick_executor`` is ``"lockstep"``: the port's one tick-table
  executor (``parallel/pipeline.py``), a Python loop over the ticks.
- ``mfu`` and ``predicted_step_s`` price D chips of the run's
  ``HardwareSpec`` (the H100 preset on the card), as in JAX.
- ``rel_err_corrected`` is None: no calibration correction is fitted for
  the H100 yet (``ROADMAP.md`` Queue 1, item 12), and neither are the
  dynamics columns.
"""

from __future__ import annotations

import time
import traceback
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from .config import ModelConfig, ScheduleConfig, virtual_stages_for
from .metrics import run_train_iterations

SCHEDULES = ("GPipe", "1F1B", "Interleaved1F1B")
# beyond the JAX columns: the one card's model FLOP utilization (D * mfu:
# all stages share it), the analytic bytes of that card, and the card's
# measured torch.cuda.max_memory_allocated over the run (None on the CPU)
PORT_COLUMNS = ("mfu_card", "predicted_card_bytes",
                "max_memory_allocated_bytes")
_ITEM_12 = "ROADMAP.md Queue 1, item 12 (observability)"
_ITEM_12_ARTIFACTS = ("ROADMAP.md Queue 1, item 12 (schedule artifacts and "
                      "the search, behind analysis/table_check.py)")


def run_one_experiment(n_layers: int, n_heads: int, num_devices: int,
                       schedule_type: str, batch_size: int = 32,
                       seq_length: int = 128, num_iterations: int = 5,
                       dim: int = 768, vocab_size: int = 10000,
                       n_microbatches: int = 4, seed: int = 0,
                       arch: str = "ref_decoder", dtype: str = "float32",
                       remat_backward=None,
                       report_dir: Optional[str] = None,
                       schedule_artifact: Optional[str] = None,
                       oom_preflight: bool = True, dynamics: bool = False,
                       device="cuda") -> Dict[str, object]:
    """One experiment: ``num_iterations`` timed pipeline steps (loss and
    gradients, no optimizer) after 2 warm-ups, through the port's
    executor on ``device``, with random weights and tokens from ``seed``
    (dropout at the config default, 0, as in JAX); returns the
    reference's metrics dict plus the bubble, cost and memory columns, or
    ``{"error": ...}`` on failure (the message printed with its
    traceback). ``oom_preflight`` prices the config on the card (all
    stages on it) before building anything; an overflow returns a
    ``skip_reason="predicted_oom"`` row.

    ZBV's steady state needs M >= 2D, so its row lifts
    ``n_microbatches`` to 2D where it is smaller (recorded in the row's
    ``n_microbatches``), as in JAX. ``report_dir``, ``dynamics=True``
    and ``schedule_artifact`` raise ``NotImplementedError``
    (``ROADMAP.md`` item 12)."""
    from ..analysis.cost_model import (backward_weights, cost_model_section,
                                       detect_hardware,
                                       resolve_backward_policy)
    from ..analysis.memory_model import (memory_model_section,
                                         oom_preflight as _preflight)
    from ..models.transformer import init_params
    from ..parallel.pipeline import make_pipeline_grad_fn
    from ..parallel.schedules import (analytic_bubble_fraction,
                                      compile_schedule, simulated_bubble)
    from .config import resolve_device

    if report_dir is not None or dynamics:
        raise NotImplementedError(
            f"run reports and the dynamics pass are not ported yet: "
            f"{_ITEM_12}")
    if schedule_artifact is not None:
        raise NotImplementedError(f"schedule artifacts are not ported yet: "
                                  f"{_ITEM_12_ARTIFACTS}")
    device = resolve_device(device)
    try:
        n_virtual = virtual_stages_for(schedule_type, n_layers, num_devices)
        if schedule_type == "ZBV":
            n_microbatches = max(n_microbatches, 2 * num_devices)
        cfg = ModelConfig(dim=dim, n_layers=n_layers, n_heads=n_heads,
                          vocab_size=vocab_size, arch=arch, dtype=dtype)
        sched = ScheduleConfig(name=schedule_type,
                               n_microbatches=n_microbatches,
                               n_virtual=n_virtual)
        cs = compile_schedule(schedule_type, num_devices, n_virtual,
                              n_microbatches)
        hw = detect_hardware(device)
        mem = memory_model_section(cs, cfg, batch_size=batch_size,
                                   seq_length=seq_length, hardware=hw,
                                   remat_backward=remat_backward)
        if oom_preflight:
            pf = _preflight(mem, hw, per="card")
            if not pf["ok"]:
                return {
                    "skip_reason": "predicted_oom",
                    "predicted_peak_bytes": pf["predicted_peak_bytes"],
                    "hbm_bytes": pf["hbm_bytes"],
                    "n_virtual": n_virtual,
                    "n_microbatches": n_microbatches,
                }
        grad_fn = make_pipeline_grad_fn(cfg, sched, num_devices,
                                        remat_backward=remat_backward,
                                        device=device)
        gen = torch.Generator().manual_seed(seed)
        model = init_params(cfg, gen, device)
        gen = torch.Generator().manual_seed(seed + 1)
        tokens, targets = (torch.randint(0, vocab_size,
                                         (batch_size, seq_length),
                                         generator=gen).to(device)
                           for _ in range(2))

        def step(m, x, y):
            m.zero_grad(set_to_none=True)
            return grad_fn(m, x, y)

        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        metrics = run_train_iterations(step, model, tokens, targets,
                                       num_iterations=num_iterations)
        peak_alloc = (float(torch.cuda.max_memory_allocated(device))
                      if cuda else None)
        policy = resolve_backward_policy(cs, remat_backward, num_devices)
        w_b, w_w = backward_weights(policy)
        sim = simulated_bubble(cs, w_f=1.0, w_b=w_b, w_w=w_w)
        cost = cost_model_section(
            cs, cfg, batch_size=batch_size, seq_length=seq_length,
            hardware=hw, remat_backward=remat_backward,
            measured_step_s=metrics["elapsed_time"] / num_iterations)
        mfu = cost.get("measured", {}).get("mfu")
        metrics.update({
            "throughput_per_chip": metrics["throughput"] / num_devices,
            "n_virtual": n_virtual,
            "n_microbatches": n_microbatches,
            "predicted_step_s": cost["predicted"]["step_s"],
            "rel_err": cost.get("measured", {}).get("rel_err"),
            "rel_err_corrected": None,
            "bubble_analytic": analytic_bubble_fraction(
                schedule_type, num_devices, n_virtual, n_microbatches),
            "bubble_simulated": sim["bubble_fraction"],
            "bubble_sim_w_b": w_b,
            "bubble_table_exact": cost["predicted"]["bubble_table_exact"],
            "mfu": mfu,
            "backward_policy": policy,
            "tick_executor": "lockstep",
            "host_serialized": True,
            "grad_norm_final": None,
            "gns": None,
            "n_skipped_attributed": None,
            "mfu_card": None if mfu is None else mfu * num_devices,
            "predicted_card_bytes": mem["analytic"]["card_bytes"],
            "max_memory_allocated_bytes": peak_alloc,
        })
        return metrics
    except Exception as e:  # the reference worker's catch-all contract
        traceback.print_exc()
        return {"error": str(e)}


def sweep_rows(layers: Sequence[int] = (4, 8, 12),
               heads: Sequence[int] = (4, 8, 12),
               devices: Sequence[int] = (2, 4),
               schedules: Sequence[str] = SCHEDULES,
               batch_size: int = 32, seq_length: int = 128,
               num_iterations: int = 5, verbose: bool = True,
               **kwargs) -> List[Dict[str, object]]:
    """The cross product layers x heads x devices x schedules (54 configs
    by default) as a list of row dicts: each config's ``n_layers``,
    ``n_heads``, ``num_processes`` and ``schedule`` before its
    :func:`run_one_experiment` columns. A failed config is reported and
    left out; a priced-out one is a row with its ``skip_reason``."""
    configs = [(L, H, D, s) for L in layers for H in heads
               for D in devices for s in schedules]
    rows = []
    for k, (L, H, D, s) in enumerate(configs, 1):
        if verbose:
            print(f"[{k}/{len(configs)}] Running: layers={L} heads={H} "
                  f"devices={D} schedule={s}", flush=True)
        t0 = time.perf_counter()
        result = run_one_experiment(L, H, D, s, batch_size=batch_size,
                                    seq_length=seq_length,
                                    num_iterations=num_iterations, **kwargs)
        if "error" in result:
            if verbose:
                print(f"    ERROR: {result['error']}", flush=True)
            continue
        if verbose and "skip_reason" in result:
            print(f"    SKIPPED ({result['skip_reason']}): predicted "
                  f"{result.get('predicted_peak_bytes', 0) / 1e9:.2f} GB "
                  f"> {result.get('hbm_bytes', 0) / 1e9:.2f} GB HBM",
                  flush=True)
        elif verbose:
            print(f"    throughput: {result['throughput']:.2f} tokens/sec "
                  f"({time.perf_counter() - t0:.1f} s with set-up)",
                  flush=True)
        rows.append({"n_layers": L, "n_heads": H, "num_processes": D,
                     "schedule": s, **result})
    return rows


def run_all_experiments(layers: Sequence[int] = (4, 8, 12),
                        heads: Sequence[int] = (4, 8, 12),
                        devices: Sequence[int] = (2, 4),
                        schedules: Sequence[str] = SCHEDULES,
                        batch_size: int = 32, seq_length: int = 128,
                        num_iterations: int = 5, verbose: bool = True,
                        **kwargs):
    """:func:`sweep_rows` as a pandas DataFrame (the JAX return type)."""
    import pandas as pd
    return pd.DataFrame(sweep_rows(layers, heads, devices, schedules,
                                   batch_size, seq_length, num_iterations,
                                   verbose, **kwargs))


def _records(rows) -> List[Dict[str, object]]:
    """Row dicts from a list of them or from a DataFrame."""
    return rows.to_dict("records") if hasattr(rows, "to_dict") \
        else list(rows)


def compute_speedup_and_efficiency(rows: Iterable) -> List[Dict[str, object]]:
    """Per (layers, heads, devices) group, in sorted order: each
    non-GPipe schedule's speedup over GPipe's throughput and its scaling
    efficiency, speedup / devices * 100 (the reference's formula). Takes
    row dicts or a DataFrame; returns row dicts. A group without a GPipe
    row contributes nothing; a skipped row has no throughput (NaN), as in
    the JAX frame."""
    groups: Dict[tuple, List[Dict[str, object]]] = {}
    for r in _records(rows):
        key = (r["n_layers"], r["n_heads"], r["num_processes"])
        groups.setdefault(key, []).append(r)

    def throughput(r):
        return float(r.get("throughput", float("nan")))

    out = []
    for (L, H, D), g in sorted(groups.items()):
        gp = [r for r in g if r["schedule"] == "GPipe"]
        if not gp:
            continue
        base = throughput(gp[0])
        others = dict.fromkeys(r["schedule"] for r in g
                               if r["schedule"] != "GPipe")
        for schedule in others:
            first = next(r for r in g if r["schedule"] == schedule)
            speedup = throughput(first) / base
            out.append({"n_layers": L, "n_heads": H, "num_processes": D,
                        "schedule": schedule, "speedup": speedup,
                        "efficiency": speedup / D * 100.0})
    return out


def pivot_throughput(rows):
    """Throughput by (layers, heads) x (schedule, devices), a pandas pivot
    table (the reference notebook's cell 25)."""
    import pandas as pd
    df = rows if isinstance(rows, pd.DataFrame) else pd.DataFrame(
        _records(rows))
    return df.pivot_table(index=["n_layers", "n_heads"],
                          columns=["schedule", "num_processes"],
                          values="throughput")
