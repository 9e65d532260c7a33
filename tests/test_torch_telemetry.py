"""The port's telemetry and run reports against the JAX package on the
CPU (``utils/telemetry.py``, the executor's stamps, ``fit``'s and the
sweep's manifests, ``measure_bubble``).

(a) The analysis: the same tick table and the same ``(kind, index, t)``
    rows (two stamps a tick, as a mesh gives, with seeded numpy times),
    the same memory samples, serving and dynamics rows handed to the JAX
    ``PipelineTelemetry`` and to the port's: ``timeline``,
    ``stage_breakdown``, ``critical_path``, ``report`` and the Perfetto
    traces are exactly equal, under GPipe, 1F1B, Interleaved1F1B and ZBH1
    at D = 4. No clock and no device query enters the comparison.
(b) The validator rejects JAX's mutations (and a manifest without the
    port's version keys) and accepts the port's manifests.
(c) The key sets of one tiny ``fit`` manifest and one sweep row's
    manifest equal JAX's, but for :data:`KEY_EXCEPTIONS`.
(d) A stamped step of the port gives one timeline record per tick and
    the unstamped step's loss and gradients bit for bit; an unstamped
    step records nothing.
(f) ``measure_bubble``: the keys of the JAX function's result, and its
    analytic and simulated bubbles exactly JAX's.

The serving engine's events are held to the JAX engine's in
``test_torch_serving.py`` (it shares that file's compiled JAX engine).
"""

import ast
import copy
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models.transformer import (
    transformer_init)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    schedules as jsched)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    data as jdata, sweep as jsweep, telemetry as jtm, train as jtrain)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    schedules as tsched)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    data as tdata, profiling as tprof, sweep as tsweep, telemetry as ttm,
    train as ttrain)

SIZE = dict(dim=32, n_layers=2, n_heads=2, vocab_size=64, ffn_dim=64,
            max_seq_len=16, arch="gpt2")
B, S, M = 8, 16, 2
TABLES = (("GPipe", 1, 4), ("1F1B", 1, 4), ("Interleaved1F1B", 2, 4),
          ("ZBH1", 1, 4))
# key paths of a manifest that only one package has, and why
KEY_EXCEPTIONS = {
    "meta.jax_version": "the JAX package's versions; the port records "
                        "meta.torch_version and meta.cuda_version",
    "meta.jaxlib_version": "as meta.jax_version",
    "meta.torch_version": "as meta.jax_version",
    "meta.cuda_version": "as meta.jax_version",
    "memory.compiled": "XLA's ahead-of-time memory analysis: the port runs "
                       "eagerly and has no compiled program",
    "memory.reconciliation": "the analytic bytes held to memory.compiled",
    "meta.config.remat_layers": "fields of the JAX ModelConfig that steer "
                                "XLA's scan and remat; the port's config "
                                "has no counterpart",
    "meta.config.unroll_layers": "as meta.config.remat_layers",
    "memory.analytic.card_bytes": "the port prices the one card all "
                                  "lockstep stages share",
    "gauges.mfu_card": "the sweep's port columns (utils/sweep.py "
                       "PORT_COLUMNS)",
    "gauges.predicted_card_bytes": "as gauges.mfu_card",
    "gauges.max_memory_allocated_bytes": "as gauges.mfu_card",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the analysis, on the same rows
# ---------------------------------------------------------------------------


def _rows(T, seed):
    """Two stamps a tick (a two-device mesh), seeded, in the order a run
    appends them: (kind, index, t) rows, memory samples at the step
    boundaries, serving events and dynamics rows."""
    rng = np.random.default_rng(seed)
    t = 100.0 + rng.random()
    events = [(jtm.STEP_START, 0, t), (jtm.STEP_START, 0, t + 1e-5)]
    for tick in range(T):
        t += 1e-3 * (0.5 + rng.random())
        events += [(jtm.TICK, tick, t), (jtm.TICK, tick, t + 2e-5 * rng.random())]
    events += [(jtm.STEP_END, 0, t + 1e-4)]
    memory = [{"kind": k, "device": d, "t": tt, "bytes_in_use": int(b),
               "peak_bytes_in_use": int(b + p)}
              for k, tt in (("step_start", events[0][2]),
                            ("step_end", t + 1e-4))
              for d, b, p in zip(range(2), rng.integers(1e6, 2e6, 2),
                                 rng.integers(0, 1e5, 2))]
    serving = []
    for rid in range(3):
        serving.append({"t": 50.0 + rid, "kind": "serve_admit", "rid": rid,
                        "slot": rid % 2, "tick": 2 * rid, "prompt_len": 4,
                        "budget": 3, "arrival": float(rid),
                        "wait_ticks": rid})
        serving.append({"t": 52.5 + rid, "kind": "serve_finish", "rid": rid,
                        "slot": rid % 2, "tick": 2 * rid + 5, "n_tokens": 3,
                        "ttft_ticks": 2, "spec_verify_visits": rid,
                        "spec_accepted": rid, "accepted_len_mean": 1.5})
    dynamics = [{"t": 10.0 + i, "kind": "dynamics", "grad_norm": 1.0 / (i + 1),
                 "gns": float(i), "grad_norm_per_stage": [0.5, 0.25]}
                for i in range(2)]
    return events, memory, serving, dynamics


def _recorders(name, V, D):
    jcs = jsched.compile_schedule(name, D, V, 4)
    tcs = tsched.compile_schedule(name, D, V, 4)
    np.testing.assert_array_equal(jcs.table, tcs.table)
    jt, tt = jtm.PipelineTelemetry(), ttm.PipelineTelemetry()
    jt.attach(jcs.table, None, "unrolled")
    tt.attach(tcs.table, None, "unrolled")
    return jt, tt, tcs.table.shape[0]


@pytest.mark.parametrize("name,V,D", TABLES)
def test_analysis_matches_jax(name, V, D):
    jt, tt, T = _recorders(name, V, D)
    events, memory, serving, dynamics = _rows(T, seed=T)
    for rec in (jt, tt):
        rec.events.extend(events)
    assert tt.timeline() == jt.timeline()
    assert len(tt.timeline()) == T
    assert tt.stage_breakdown() == jt.stage_breakdown()
    assert ttm.critical_path(tt) == jtm.critical_path(jt)
    assert tt.report() == jt.report()
    assert ttm.perfetto_trace(tt) == jtm.perfetto_trace(jt)
    for rec in (jt, tt):
        rec.memory_samples.extend(copy.deepcopy(memory))
    predicted = list(np.linspace(1e-4, 2e-4, T))
    assert tt.memory_summary() == jt.memory_summary()
    assert tt.report() == jt.report()
    kw = dict(serving_events=serving, dynamics_events=dynamics,
              predicted_tick_s=predicted)
    assert ttm.perfetto_trace(tt, **kw) == jtm.perfetto_trace(jt, **kw)
    load = dict(occupancy=[(0, 1), (4, 2)], queue_depth=[(0, 0), (4, 1)],
                s_per_tick=1e-3, pages_used=[(0, 3)],
                page_fragmentation=[(0, 0.25)],
                acceptance=[(0, None), (4, 0.5)])
    assert ttm.perfetto_serving_load_events(serving, **load) == \
        jtm.perfetto_serving_load_events(serving, **load)


def test_written_traces_match_jax(tmp_path):
    """``write_perfetto_trace`` writes the JAX file, with a timeline and
    serving-load tracks and for a serving-only run."""
    jt, tt, T = _recorders("1F1B", 1, 4)
    events, memory, serving, dynamics = _rows(T, seed=1)
    for rec in (jt, tt):
        rec.events.extend(events)
        rec.memory_samples.extend(copy.deepcopy(memory))
    load = {"occupancy": [(0, 1)], "queue_depth": [(0, 2)],
            "s_per_tick": 2e-3}
    for tel_j, tel_t in ((jt, tt), (None, None)):
        paths = [str(tmp_path / f"{p}.json") for p in ("j", "t")]
        jtm.write_perfetto_trace(tel_j, paths[0], serving_events=serving,
                                 dynamics_events=dynamics,
                                 serving_load_tracks=load)
        ttm.write_perfetto_trace(tel_t, paths[1], serving_events=serving,
                                 dynamics_events=dynamics,
                                 serving_load_tracks=load)
        assert Path(paths[1]).read_text() == Path(paths[0]).read_text()


# ---------------------------------------------------------------------------
# (b) the validator
# ---------------------------------------------------------------------------


def test_validate_report_rejects():
    """JAX's two mutations, a manifest with the JAX version keys in place
    of the port's, and the same rules as JAX on a bad section."""
    report = ttm.RunReport(name="unit")
    manifest = report.manifest()
    ttm.validate_report(manifest)
    bad = dict(manifest, schema_version=99)
    with pytest.raises(ValueError, match="schema_version"):
        ttm.validate_report(bad)
    bad = {k: v for k, v in manifest.items() if k != "events"}
    with pytest.raises(ValueError, match="events"):
        ttm.validate_report(bad)
    with pytest.raises(ValueError, match="torch_version"):
        ttm.validate_report(jtm.RunReport(name="unit").manifest())
    for section, value in (("cost_model", {"schedule": "1F1B"}),
                           ("memory", {"schedule": 3}),
                           ("telemetry", {"timeline": [{"n_ticks": 1}]})):
        bad = dict(manifest, **{section: value})
        with pytest.raises(ValueError, match=section) as got:
            ttm.validate_report(bad)
        with pytest.raises(ValueError) as want:
            jtm.validate_report(dict(
                jtm.RunReport(name="unit").manifest(), **{section: value}))
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# (c) the manifests' key sets
# ---------------------------------------------------------------------------


def _paths(x, pre=""):
    """The key paths of a manifest (lists of dicts as ``[]``), less the
    subtrees of :data:`KEY_EXCEPTIONS`."""
    out = set()
    if isinstance(x, dict):
        for k, v in x.items():
            p = pre + str(k)
            if p in KEY_EXCEPTIONS:
                continue
            out.add(p)
            out |= _paths(v, p + ".")
    elif isinstance(x, list) and x and isinstance(x[0], dict):
        for v in x:
            out |= _paths(v, pre + "[].")
    return out


def _fit_kw(tmp, telemetry):
    # the watchdog gives the resilience section (a checkpoint would too,
    # at seconds of the JAX side's Orbax save)
    return dict(log_every=1, verbose=False, report_dir=str(tmp),
                telemetry=telemetry, stall_timeout_s=600.0)


def _sweep_kw(tmp):
    return dict(batch_size=B, seq_length=S, num_iterations=1,
                dim=SIZE["dim"], vocab_size=SIZE["vocab_size"],
                report_dir=str(tmp))


@pytest.fixture(scope="module")
def corrections_env(tmp_path_factory):
    """Both packages' ``fit`` and sweep read one correction artifact for
    the CPU proxy, through ``$DTPP_CALIBRATION_CORRECTIONS``, for the whole
    module: their manifests then carry the corrected cost model and the
    calibration section alike."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
        calibration as tcal)
    path = tmp_path_factory.mktemp("corr") / "corrections.json"
    tcal.save_correction_artifact(tcal.correction_artifact({
        "cpu_proxy": tcal.CorrectionFactors("cpu_proxy", 0.02, 0.5, 4,
                                            1e-3)}), str(path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tcal.CORRECTIONS_ENV, str(path))
        yield str(path)


@pytest.fixture(scope="module")
def jax_manifests(tmp_path_factory, corrections_env):
    """One JAX ``fit`` (1F1B, D = 2, one step, stamped, watched) and
    one JAX sweep row (GPipe, D = 2; the scan executor compiles fastest
    and a sweep row carries no timeline), both under
    :func:`corrections_env`."""
    tmp = tmp_path_factory.mktemp("jax")
    jcfg = dtpp.ModelConfig(**SIZE)
    jtrain.fit(jcfg, make_mesh(n_pipe=2), dtpp.ScheduleConfig("1F1B", M),
               transformer_init(jax.random.key(0), jcfg),
               jdata.synthetic_batches(SIZE["vocab_size"], B, S, seed=1), 1,
               **_fit_kw(tmp, jtm.PipelineTelemetry()))
    row = jsweep.run_one_experiment(SIZE["n_layers"], SIZE["n_heads"], 2,
                                    "GPipe", unroll_ticks=False,
                                    **_sweep_kw(tmp))
    assert "error" not in row, row
    with open(tmp / "report.json") as fh:
        fit = json.load(fh)
    with open(tmp / "sweep_reports.jsonl") as fh:
        sweep = json.loads(fh.readline())
    return fit, sweep


def test_manifest_keys_match_jax(jax_manifests, tmp_path):
    """The same tiny ``fit`` and sweep row through the port: manifests the
    port's validator accepts, with JAX's key sets but for the listed
    exceptions (the corrected cost model and the calibration section
    included); the fit's has the measured attribution, a timeline of T
    ticks and the resilience section."""
    jfit, jrow = jax_manifests
    tcfg = port.ModelConfig(**SIZE)
    model = port.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tel = ttm.PipelineTelemetry()
    ttrain.fit(tcfg, port.ScheduleConfig("1F1B", M), 2, model,
               tdata.synthetic_batches(SIZE["vocab_size"], B, S, seed=1), 1,
               device="cpu", **_fit_kw(tmp_path, tel))
    with open(tmp_path / "report.json") as fh:
        fit = json.load(fh)
    ttm.validate_report(fit)
    assert os.path.exists(tmp_path / "events.jsonl")
    assert _paths(fit) == _paths(jfit)
    T = tsched.compile_schedule("1F1B", 2, 1, M).table.shape[0]
    assert len(fit["telemetry"]["timeline"]) == T
    assert fit["cost_model"]["attribution"]["n_ticks"] == T
    assert fit["cost_model"]["measured"]["step_s"] > 0
    assert fit["memory"]["live"]["available"] is False  # no CPU allocator
    assert fit["resilience"] == {"stalls": 0}
    _same_corrected(fit, jfit)

    row = tsweep.run_one_experiment(SIZE["n_layers"], SIZE["n_heads"], 2,
                                    "GPipe", device="cpu",
                                    **_sweep_kw(tmp_path))
    assert "error" not in row, row
    with open(tmp_path / "sweep_reports.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    assert len(rows) == 1
    ttm.validate_report(rows[0])
    assert _paths(rows[0]) == _paths(jrow)
    assert rows[0]["gauges"]["throughput"] == row["throughput"]
    _same_corrected(rows[0], jrow)
    assert row["rel_err_corrected"] == \
        rows[0]["cost_model"]["measured"]["rel_err_corrected"]


def _same_corrected(got, want):
    """The corrected cost model and the calibration section of a port
    manifest against a JAX one of the same run (one artifact, the CPU
    proxy on both sides): the correction and every predicted number
    equal; the measured error each side's own, from its own step."""
    cm, jcm = got["cost_model"], want["cost_model"]
    assert cm["predicted"] == jcm["predicted"]
    corrected = cm["predicted"]["corrected"]["step_s"]
    step = cm["measured"]["step_s"]
    assert cm["measured"]["rel_err_corrected"] == (corrected - step) / step
    cal, jcal = got["calibration"], want["calibration"]
    assert cal["correction"] == jcal["correction"] is not None
    for key in ("schedule", "schedule_family", "backward_policy",
                "comm_overlap", "n_devices", "n_microbatches",
                "predicted_step_s", "predicted_step_s_corrected"):
        assert cal["rows"][0][key] == jcal["rows"][0][key], key
    assert cal["rows"][0]["rel_err_corrected"] == \
        cm["measured"]["rel_err_corrected"]


def test_fit_uncorrected_when_the_artifact_is_missing(tmp_path, monkeypatch):
    """``$DTPP_CALIBRATION_CORRECTIONS`` naming a missing file: neither
    package loads a correction, and the port's ``fit`` report carries the
    calibration section without one and no corrected cost model."""
    from distributed_training_with_pipeline_parallelism_tpu.analysis import (
        calibration as jcal_mod)
    from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
        calibration as tcal_mod)
    monkeypatch.setenv(tcal_mod.CORRECTIONS_ENV, str(tmp_path / "none.json"))
    assert jcal_mod.maybe_load_default_corrections() is None
    assert tcal_mod.maybe_load_default_corrections() is None
    tcfg = port.ModelConfig(**SIZE)
    model = port.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ttrain.fit(tcfg, port.ScheduleConfig("1F1B", M), 2, model,
               tdata.synthetic_batches(SIZE["vocab_size"], B, S, seed=1), 1,
               device="cpu", **_fit_kw(tmp_path, ttm.PipelineTelemetry()))
    with open(tmp_path / "report.json") as fh:
        fit = json.load(fh)
    ttm.validate_report(fit)
    assert "corrected" not in fit["cost_model"]["predicted"]
    assert "rel_err_corrected" not in fit["cost_model"]["measured"]
    assert fit["calibration"]["correction"] is None
    assert fit["calibration"]["rows"][0]["predicted_step_s"] == \
        fit["cost_model"]["predicted"]["step_s"]


# ---------------------------------------------------------------------------
# (d) the executor's stamps
# ---------------------------------------------------------------------------


def _step(fn, model, tokens, targets):
    model.zero_grad(set_to_none=True)
    loss = fn(model, tokens, targets)
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name,V,D", [("1F1B", 1, 2), ("ZBH1", 1, 2),
                                      ("Interleaved1F1B", 2, 2),
                                      ("GPipe", 1, 1)])
def test_stamped_step_is_bitwise_the_unstamped(name, V, D):
    """T tick records (the plain D = 1 step: one whole-step record), the
    loss and every gradient bitwise equal, and nothing recorded by the
    unstamped step; the stamped train step as well."""
    cfg = port.ModelConfig(**dict(SIZE, n_layers=4))
    sched = port.ScheduleConfig(name, M, V)
    model = port.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tokens, targets = (torch.from_numpy(rng.integers(0, 64, (B, S)))
                       for _ in range(2))
    tel = ttm.PipelineTelemetry()
    stamped = port.make_pipeline_grad_fn(cfg, sched, D, device="cpu",
                                         telemetry=tel)
    plain = port.make_pipeline_grad_fn(cfg, sched, D, device="cpu")
    loss1, g1 = _step(stamped, model, tokens, targets)
    n = len(tel.events)
    loss0, g0 = _step(plain, model, tokens, targets)
    assert len(tel.events) == n
    assert torch.equal(loss1, loss0)
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
    T = tsched.compile_schedule(name, D, V, M).table.shape[0]
    timeline = tel.timeline()
    if D == 1:
        assert tel.executor == "scan" and len(timeline) == 1
        assert timeline[0]["n_ticks"] == T
    else:
        assert tel.executor == "unrolled"
        assert [r["tick"] for r in timeline] == list(range(T))
        assert n == T + 2
    assert all(r["duration_s"] >= 0 for r in timeline)
    assert tel.memory_summary()["available"] is False
    ttm.validate_report(dict(ttm.RunReport().manifest(),
                             telemetry=tel.report()))


# ---------------------------------------------------------------------------
# (f) measure_bubble
# ---------------------------------------------------------------------------


def _jax_measure_bubble_keys():
    """The keys of the dict the JAX ``measure_bubble`` returns, read from
    its source (running it compiles two JAX programs)."""
    src = Path(jax_profiling_file()).read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "measure_bubble")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.keys}


def jax_profiling_file():
    from distributed_training_with_pipeline_parallelism_tpu.utils import (
        profiling)
    return profiling.__file__


def test_measure_bubble_matches_jax():
    cfg = port.ModelConfig(**SIZE)
    sched = port.ScheduleConfig("1F1B", M)
    got = tprof.measure_bubble(cfg, 2, sched, batch_size=B, seq_length=S,
                               iters=1, device="cpu")
    assert set(got) == _jax_measure_bubble_keys()
    cs = jsched.compile_schedule("1F1B", 2, 1, M)
    assert got["bubble_analytic"] == jsched.analytic_bubble_fraction(
        "1F1B", 2, 1, M, cs=cs)
    assert got["bubble_simulated"] == jsched.simulated_bubble(
        cs, w_f=1.0, w_b=3.0)["bubble_fraction"]
    assert got["t_pipeline"] > 0 and got["t_single_device"] > 0
