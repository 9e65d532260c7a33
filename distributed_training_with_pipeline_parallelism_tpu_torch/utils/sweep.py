"""The reference's 54-config experiment: one row per (layers, heads,
devices, schedule), the speedup and scaling efficiency over GPipe, and the
throughput pivot (the port's own copy of the JAX package's
``utils/sweep.py``: ``run_one_experiment`` ``:36``, ``run_all_experiments``
``:289``, ``compute_speedup_and_efficiency`` ``:342``,
``summarize_dynamics`` ``:365``, ``pivot_throughput`` ``:394``).

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
- ``predicted_step_s``, ``rel_err`` and ``rel_err_corrected`` come from
  the row's cost model, which carries the corrections
  ``analysis.calibration.maybe_load_default_corrections`` finds
  (``$DTPP_CALIBRATION_CORRECTIONS``, else the default artifact), as in
  JAX: ``rel_err_corrected`` is None when none matches the row's
  hardware.
- ``grad_norm_final``, ``gns`` and ``n_skipped_attributed`` are filled by
  ``dynamics=True``: one instrumented gradient pass after the timed steps
  (off the clock) through ``make_pipeline_grad_fn(..., dynamics=True)``
  with the rematerialising backward, as in JAX; None otherwise.
- ``schedule_artifact`` (a certified artifact, a path or a dict) is
  registered and certified (``parallel.schedules.
  register_schedule_artifact``) and overrides the row's schedule, M and
  V with its own; the row records the pinned ``schedule_artifact_digest``.

``report_dir`` adds one validated ``RunReport`` manifest per row to
``{report_dir}/sweep_reports.jsonl`` (JAX ``:246-282``): the timers and
counter of ``run_train_iterations``, the row's columns as gauges, the
``cost_model``, ``calibration`` (the row's own predicted-against-measured
point) and ``memory`` sections.
A world row's manifest carries rank 0's timing and is written once, by
the process that launched the world.

A world row (``backend="gloo"`` or ``"nccl"``) runs the config as the
reference does, one process per stage (``parallel.mesh.launch`` over a
world of D ranks; ``LLMsDistributedTrainingHelper.py:168-178``): each
rank builds only its view of the model and runs its row of the tick
table, and rank 0's ``run_train_iterations(..., mesh=)`` is the row's
timing; every other column is computed as for a lockstep row. It adds
``transport`` (``Mesh.transport``: ``"gloo-staged"`` where gloo stages
CUDA tensors through host memory, ``"gloo"``, ``"nccl"``) and
``world_ranks``; its ``tick_executor`` is ``"dist"`` and
``max_memory_allocated_bytes`` is the sum of the ranks' peaks. On one
card its ranks share the card and every hop is staged: the row measures
the transport, not the bubble. :func:`sweep_rows` runs the rows of one D
in one world.
"""

from __future__ import annotations

import math
import time
import traceback
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from .config import ModelConfig, ScheduleConfig, virtual_stages_for
from .metrics import run_train_iterations

SCHEDULES = ("GPipe", "1F1B", "Interleaved1F1B")
# a world row's columns beyond a lockstep row's
WORLD_COLUMNS = ("transport", "world_ranks")
# beyond the JAX columns: the one card's model FLOP utilization (D * mfu:
# all stages share it), the analytic bytes of that card, and the card's
# measured torch.cuda.max_memory_allocated over the run (None on the CPU)
PORT_COLUMNS = ("mfu_card", "predicted_card_bytes",
                "max_memory_allocated_bytes")


def run_one_experiment(n_layers: int, n_heads: int, num_devices: int,
                       schedule_type: str, batch_size: int = 32,
                       seq_length: int = 128, num_iterations: int = 5,
                       dim: int = 768, vocab_size: int = 10000,
                       n_microbatches: int = 4, seed: int = 0,
                       arch: str = "ref_decoder", dtype: str = "float32",
                       remat_backward=None,
                       report_dir: Optional[str] = None,
                       schedule_artifact=None,
                       oom_preflight: bool = True, dynamics: bool = False,
                       device="cuda", backend: Optional[str] = None
                       ) -> Dict[str, object]:
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
    ``n_microbatches``), as in JAX. ``report_dir`` appends the row's
    manifest to ``sweep_reports.jsonl`` there; ``schedule_artifact`` and
    ``dynamics`` are as in the module doc. ``backend`` (``"gloo"`` or
    ``"nccl"``) makes it a world row (see the module doc)."""
    from .config import resolve_device

    device = resolve_device(device)
    row = _Row(n_layers, n_heads, num_devices, schedule_type, batch_size,
               seq_length, num_iterations, dim, vocab_size, n_microbatches,
               seed, arch, dtype, remat_backward, oom_preflight, report_dir,
               schedule_artifact, dynamics)
    if backend is not None:
        return _world_rows([row], backend, device)[0]
    return row.run(device)


class _Row:
    """One config of the sweep: its set-up, its timing (lockstep, or a
    rank's share of a world's) and its columns."""

    def __init__(self, n_layers, n_heads, num_devices, schedule_type,
                 batch_size, seq_length, num_iterations, dim, vocab_size,
                 n_microbatches, seed, arch, dtype, remat_backward,
                 oom_preflight, report_dir=None, schedule_artifact=None,
                 dynamics=False):
        self.__dict__.update(locals())
        del self.__dict__["self"]

    def prepare(self, device):
        """The config's objects and the OOM preflight: None to go on,
        else the row to return (a skip)."""
        from ..analysis.cost_model import detect_hardware
        from ..analysis.memory_model import (memory_model_section,
                                             oom_preflight as _preflight)
        from ..parallel.schedules import compile_schedule
        self.artifact_info = None
        if self.schedule_artifact is not None:
            cs_art = self.register_artifact()
            self.schedule_type = cs_art.name
            self.n_microbatches = cs_art.n_microbatches
            n_virtual = cs_art.n_virtual
        else:
            n_virtual = virtual_stages_for(self.schedule_type,
                                           self.n_layers, self.num_devices)
        if self.schedule_type == "ZBV":
            self.n_microbatches = max(self.n_microbatches,
                                      2 * self.num_devices)
        self.n_virtual = n_virtual
        self.cfg = ModelConfig(dim=self.dim, n_layers=self.n_layers,
                               n_heads=self.n_heads,
                               vocab_size=self.vocab_size, arch=self.arch,
                               dtype=self.dtype)
        self.sched = ScheduleConfig(name=self.schedule_type,
                                    n_microbatches=self.n_microbatches,
                                    n_virtual=n_virtual)
        self.cs = compile_schedule(self.schedule_type, self.num_devices,
                                   n_virtual, self.n_microbatches)
        self.hw = detect_hardware(device)
        self.mem = memory_model_section(
            self.cs, self.cfg, batch_size=self.batch_size,
            seq_length=self.seq_length, hardware=self.hw,
            remat_backward=self.remat_backward)
        if self.oom_preflight:
            pf = _preflight(self.mem, self.hw, per="card")
            if not pf["ok"]:
                return {
                    "skip_reason": "predicted_oom",
                    "predicted_peak_bytes": pf["predicted_peak_bytes"],
                    "hbm_bytes": pf["hbm_bytes"],
                    "n_virtual": n_virtual,
                    "n_microbatches": self.n_microbatches,
                }
        return None

    def register_artifact(self):
        """Register and certify the row's artifact (in this process: a
        world's ranks register it again) and keep its pin."""
        from ..parallel.schedules import (register_schedule_artifact,
                                          registered_artifact_info)
        cs = register_schedule_artifact(self.schedule_artifact)
        self.artifact_info = registered_artifact_info(cs.name)
        return cs

    def timed(self, device, mesh=None):
        """The timed steps (with ``mesh``, this rank's share: its view,
        its row of the table) and the device's peak allocation; with a
        ``report_dir`` also the timing's ``RunReport`` timers and
        counters (``"report"``)."""
        from .telemetry import RunReport
        from ..models.transformer import init_params
        from ..parallel.pipeline import make_pipeline_grad_fn, owned_layers
        if mesh is not None and self.schedule_artifact is not None:
            self.register_artifact()
        grad_fn = make_pipeline_grad_fn(self.cfg, self.sched,
                                        self.num_devices,
                                        remat_backward=self.remat_backward,
                                        device=device, mesh=mesh)
        layers = None if mesh is None else owned_layers(
            self.n_layers, self.sched, self.num_devices, mesh.pipe)
        gen = torch.Generator().manual_seed(self.seed)
        model = init_params(self.cfg, gen, device, layers=layers)
        gen = torch.Generator().manual_seed(self.seed + 1)
        tokens, targets = (torch.randint(0, self.vocab_size,
                                         (self.batch_size, self.seq_length),
                                         generator=gen).to(device)
                           for _ in range(2))

        def step(m, x, y):
            m.zero_grad(set_to_none=True)
            return grad_fn(m, x, y)

        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        report = RunReport() if self.report_dir is not None else None
        metrics = run_train_iterations(step, model, tokens, targets,
                                       num_iterations=self.num_iterations,
                                       mesh=mesh, report=report)
        metrics["peak"] = (float(torch.cuda.max_memory_allocated(device))
                           if cuda else None)
        if report is not None:
            metrics["report"] = {"timers": report.timers,
                                 "counters": report.counters}
        if self.dynamics:
            metrics["dynamics"] = self.dynamics_pass(model, tokens, targets,
                                                     device, mesh)
        return metrics

    def dynamics_pass(self, model, tokens, targets, device, mesh):
        """One instrumented gradient pass, off the clock (the JAX row's):
        the stage statistics and ``sq_mb`` on the host."""
        from ..parallel.pipeline import make_pipeline_grad_fn
        from .dynamics import stage_stats
        S = self.num_devices * self.n_virtual
        grad_fn = make_pipeline_grad_fn(self.cfg, self.sched,
                                        self.num_devices, remat_backward=True,
                                        device=device, mesh=mesh,
                                        dynamics=True)
        model.zero_grad(set_to_none=True)
        _, sq_mb = grad_fn(model, tokens, targets)
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None
                 and (mesh is None or mesh.pipe == 0
                      or n.startswith("layers."))}
        st = stage_stats(self.n_layers, S, grads, mesh=mesh)
        st["sq_mb"] = sq_mb
        return {k: v.detach().cpu().numpy() for k, v in st.items()}

    def run(self, device):
        try:
            skip = self.prepare(device)
            if skip is not None:
                return skip
            metrics = self.timed(device)
            timing = metrics.pop("report", None)
            row = self.finish(metrics, metrics.pop("peak"))
            self.write_report(row, timing, device)
            return row
        except Exception as e:  # the reference worker's catch-all contract
            traceback.print_exc()
            return {"error": str(e)}

    def finish(self, metrics, peak_alloc, world=None):
        """The row: the timing's metrics and the analytic columns (a world
        row: ``world`` = (transport, ranks))."""
        from ..analysis.calibration import maybe_load_default_corrections
        from ..analysis.cost_model import (backward_weights,
                                           cost_model_section,
                                           resolve_backward_policy)
        from ..parallel.schedules import (analytic_bubble_fraction,
                                          simulated_bubble)
        cs, D = self.cs, self.num_devices
        self.corrections = maybe_load_default_corrections()
        policy = resolve_backward_policy(cs, self.remat_backward, D)
        w_b, w_w = backward_weights(policy)
        sim = simulated_bubble(cs, w_f=1.0, w_b=w_b, w_w=w_w)
        cost = cost_model_section(
            cs, self.cfg, batch_size=self.batch_size,
            seq_length=self.seq_length, hardware=self.hw,
            remat_backward=self.remat_backward,
            measured_step_s=metrics["elapsed_time"] / self.num_iterations,
            correction=self.corrections)
        mfu = cost.get("measured", {}).get("mfu")
        metrics.update({
            "throughput_per_chip": metrics["throughput"] / D,
            "n_virtual": self.n_virtual,
            "n_microbatches": self.n_microbatches,
            "predicted_step_s": cost["predicted"]["step_s"],
            "rel_err": cost.get("measured", {}).get("rel_err"),
            "rel_err_corrected": cost.get("measured", {}).get(
                "rel_err_corrected"),
            "bubble_analytic": analytic_bubble_fraction(
                self.schedule_type, D, self.n_virtual, self.n_microbatches,
                cs=cs),
            "bubble_simulated": sim["bubble_fraction"],
            "bubble_sim_w_b": w_b,
            "bubble_table_exact": cost["predicted"]["bubble_table_exact"],
            "mfu": mfu,
            "backward_policy": policy,
            "tick_executor": "lockstep" if world is None else "dist",
            "host_serialized": True,
            **self.dynamics_columns(metrics.pop("dynamics", None)),
            "mfu_card": None if mfu is None else mfu * D,
            "predicted_card_bytes": self.mem["analytic"]["card_bytes"],
            "max_memory_allocated_bytes": peak_alloc,
        })
        if world is not None:
            metrics.update(zip(WORLD_COLUMNS, world))
        if self.artifact_info is not None:
            metrics["schedule_artifact_digest"] = \
                self.artifact_info["table_digest"]
        self.cost = cost
        return metrics

    def dynamics_columns(self, st) -> Dict[str, object]:
        """The model-health columns: None without the dynamics pass."""
        from .dynamics import GNSEstimator
        cols: Dict[str, object] = {"grad_norm_final": None, "gns": None,
                                   "n_skipped_attributed": None}
        self.dyn_stats = st
        if st is None:
            return cols
        cols["grad_norm_final"] = float(st["grad_norm"])
        cols["n_skipped_attributed"] = 0  # no guard in a sweep row
        if self.n_microbatches > 1:
            toks = self.batch_size * self.seq_length
            est = GNSEstimator(batch_small=toks / self.n_microbatches,
                               batch_big=toks)
            est.update(float(st["sq_mb"].mean()),
                       float(st["grad_norm"]) ** 2)
            cols["gns"] = est.value()
        return cols

    def write_report(self, row, timing, device, world=None) -> None:
        """With a ``report_dir``: the row's manifest (``timing``: the
        timed steps' timers and counters), validated and appended to
        ``sweep_reports.jsonl``."""
        if self.report_dir is None:
            return
        import json
        import os

        from .telemetry import RunReport, validate_report
        D = self.num_devices
        report = RunReport(name=f"sweep_L{self.n_layers}_H{self.n_heads}_"
                                f"D{D}_{self.schedule_type}")
        report.set_meta(config=self.cfg, schedule=self.sched,
                        mesh_shape={"data": 1, "pipe": D},
                        batch_size=self.batch_size,
                        seq_length=self.seq_length, backend=device.type,
                        **({} if world is None else {"transport": world[0]}))
        report.timers.update(timing["timers"])
        report.counters.update(timing["counters"])
        for k, v in row.items():
            report.gauge(k, v)
        report.attach_cost_model(self.cost)
        from ..analysis.calibration import (
            calibration_section_from_cost_model)
        cal = calibration_section_from_cost_model(
            self.cost, backend=device.type,
            name=f"sweep_{self.schedule_type}", correction=self.corrections)
        if cal is not None:
            report.attach_calibration(cal)
        report.attach_memory(self.mem)
        if self.dyn_stats is not None:
            from .dynamics import dynamics_section
            report.attach_dynamics(dynamics_section(
                D * self.n_virtual, last_stats=self.dyn_stats,
                gns=row["gns"], gns_updates=0 if row["gns"] is None else 1))
        manifest = report.manifest()
        validate_report(manifest)
        os.makedirs(self.report_dir, exist_ok=True)
        with open(os.path.join(self.report_dir, "sweep_reports.jsonl"),
                  "a") as fh:
            fh.write(json.dumps(manifest) + "\n")


def _world_rank(mesh, rows: List[_Row]):
    """One rank of a sweep world: its transport and every row's timing
    (the prepared rows' skips and errors are the launcher's)."""
    out = []
    for row in rows:
        try:
            out.append(row.timed(mesh.device, mesh))
        except Exception as e:  # the row's error, on every rank alike
            traceback.print_exc()
            out.append({"error": str(e)})
        mesh.barrier()
    return mesh.transport, out


def _world_rows(rows: List[_Row], backend: str, device
                ) -> List[Dict[str, object]]:
    """Rows of one D as world rows: prepared here, timed in one world of D
    processes (``parallel.mesh.launch``), finished here with rank 0's
    timing."""
    from ..parallel.mesh import launch
    from .config import MeshConfig
    results: List[Optional[Dict[str, object]]] = [None] * len(rows)
    todo = []
    for i, row in enumerate(rows):
        try:
            skip = row.prepare(device)
        except Exception as e:  # the reference worker's catch-all contract
            traceback.print_exc()
            skip = {"error": str(e)}
        if skip is not None:
            results[i] = skip
        else:
            todo.append(i)
    if not todo:
        return results
    D = rows[todo[0]].num_devices
    try:
        ranks = launch(_world_rank, MeshConfig(D, 1),
                       [rows[i] for i in todo], backend=backend,
                       device=device)
    except Exception as e:  # the world failed: every row it held did
        traceback.print_exc()
        for i in todo:
            results[i] = {"error": str(e)}
        return results
    transport = ranks[0][0]
    for k, i in enumerate(todo):
        timing = ranks[0][1][k]
        if "error" in timing:
            results[i] = timing
            continue
        peaks = [r[1][k]["peak"] for r in ranks]
        timing.pop("peak")
        peak = None if peaks[0] is None else float(sum(peaks))
        try:
            report = timing.pop("report", None)
            results[i] = rows[i].finish(timing, peak, (transport, D))
            rows[i].write_report(results[i], report, device,
                                 (transport, D))
        except Exception as e:
            traceback.print_exc()
            results[i] = {"error": str(e)}
    return results


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
    left out; a priced-out one is a row with its ``skip_reason``. With a
    ``backend`` the rows of each D run in one world of D processes (world
    rows, see the module doc), the worlds in the order of ``devices``."""
    configs = [(L, H, D, s) for L in layers for H in heads
               for D in devices for s in schedules]
    backend = kwargs.pop("backend", None)
    done = {}
    if backend is not None:
        done = _world_sweep(configs, backend, batch_size, seq_length,
                            num_iterations, kwargs, verbose)
    rows = []
    for k, (L, H, D, s) in enumerate(configs, 1):
        if verbose:
            print(f"[{k}/{len(configs)}] {'Ran' if done else 'Running'}: "
                  f"layers={L} heads={H} devices={D} schedule={s}",
                  flush=True)
        t0 = time.perf_counter()
        result = done.get(k - 1) or run_one_experiment(
            L, H, D, s, batch_size=batch_size, seq_length=seq_length,
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
                  f"({time.perf_counter() - t0:.1f} s with set-up"
                  f"{', in a world' if done else ''})", flush=True)
        rows.append({"n_layers": L, "n_heads": H, "num_processes": D,
                     "schedule": s, **result})
    return rows


def _world_sweep(configs, backend, batch_size, seq_length, num_iterations,
                 kwargs, verbose) -> Dict[int, Dict[str, object]]:
    """Every config's world row, by index, one world per D."""
    from .config import resolve_device
    kw = dict(kwargs)
    device = resolve_device(kw.pop("device", "cuda"))
    defaults = dict(dim=768, vocab_size=10000, n_microbatches=4, seed=0,
                    arch="ref_decoder", dtype="float32", remat_backward=None,
                    oom_preflight=True, report_dir=None,
                    schedule_artifact=None, dynamics=False)
    defaults.update(kw)
    out = {}
    for D in dict.fromkeys(D for _, _, D, _ in configs):
        idx = [i for i, c in enumerate(configs) if c[2] == D]
        rows = [_Row(configs[i][0], configs[i][1], D, configs[i][3],
                     batch_size, seq_length, num_iterations,
                     defaults["dim"], defaults["vocab_size"],
                     defaults["n_microbatches"], defaults["seed"],
                     defaults["arch"], defaults["dtype"],
                     defaults["remat_backward"], defaults["oom_preflight"],
                     defaults["report_dir"], defaults["schedule_artifact"],
                     defaults["dynamics"])
                for i in idx]
        t0 = time.perf_counter()
        out.update(zip(idx, _world_rows(rows, backend, device)))
        if verbose:
            print(f"world of {D} ({backend}): {len(idx)} rows in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


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


def summarize_dynamics(rows: Iterable) -> List[Dict[str, object]]:
    """Per schedule, in sorted order, the model health of a
    ``dynamics=True`` sweep (the JAX ``summarize_dynamics``): the rows,
    the median ``grad_norm_final`` and ``gns`` (None without a finite
    one) and the attributed skips. Rows without the dynamics pass are
    left out. Takes row dicts or a DataFrame; returns row dicts."""
    import statistics

    def given(r, key):
        v = r.get(key)
        return v is not None and not (isinstance(v, float) and math.isnan(v))

    groups: Dict[str, List[Dict[str, object]]] = {}
    for r in _records(rows):
        if given(r, "grad_norm_final"):
            groups.setdefault(r["schedule"], []).append(r)
    out = []
    for schedule, g in sorted(groups.items()):
        gns = [r["gns"] for r in g if given(r, "gns")]
        out.append({
            "schedule": schedule,
            "n": len(g),
            "grad_norm_final_median": float(statistics.median(
                r["grad_norm_final"] for r in g)),
            "gns_median": float(statistics.median(gns)) if gns else None,
            "n_skipped_attributed": int(sum(
                r["n_skipped_attributed"] for r in g
                if given(r, "n_skipped_attributed"))),
        })
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
