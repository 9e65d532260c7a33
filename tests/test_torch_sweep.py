"""The PyTorch port's sweep and its analysis columns on the CPU: the bubble
columns against the JAX package's over all 54 (layers, heads, devices,
schedule) configs, the cost-model and memory-model sections and the OOM
preflight against JAX's under one ``HardwareSpec``, one mini sweep whose
columns are JAX's (plus the port's own, documented ones), speedup and
efficiency against JAX's on the same rows, the error and ``skip_reason``
contracts, the CSV writer, the plots, and a sweep module that imports
neither pandas nor matplotlib.

Bubble, cost and memory columns are pure numpy on both sides; the only
JAX pipeline compiled here is one GPipe row of the mini sweep, for its
column set."""

import csv
import dataclasses
import itertools
import json
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.analysis import (
    cost_model as jcm, memory_model as jmm)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    schedules as jsched)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    sweep as jsweep)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch import run_sweep
from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
    cost_model as tcm, memory_model as tmm)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    schedules as tsched)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    plotting, sweep as tsweep, telemetry as ttelemetry)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
    virtual_stages_for)

CONFIGS = list(itertools.product((4, 8, 12), (4, 8, 12), (2, 4),
                                 ("GPipe", "1F1B", "Interleaved1F1B")))
M = 4
HW = dict(name="h100", peak_flops=989e12, ici_bytes_per_s=3.35e12,
          hbm_bytes_per_s=3.35e12, hbm_bytes=80e9)
MINI = dict(batch_size=4, seq_length=16, num_iterations=1, dim=32,
            vocab_size=64, verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedules(name, L, D):
    V = virtual_stages_for(name, L, D)
    return (jsched.compile_schedule(name, D, V, M),
            tsched.compile_schedule(name, D, V, M), V)


@pytest.mark.parametrize("L,H,D,name", CONFIGS + [
    (8, 8, 2, "ZBH1"), (8, 8, 4, "ZBH1"), (8, 8, 2, "ZBV")])
def test_bubble_columns_match_jax(L, H, D, name):
    """``bubble_analytic``, ``bubble_simulated`` (under the weight of the
    backward the sweep resolves) and the paper-comparable bubble, equal to
    the JAX package's for each of the reference's 54 configs, and for
    the zero-bubble schedules (under the split backward's weights)."""
    jcs, tcs, V = _schedules(name, L, D)
    assert tsched.analytic_bubble_fraction(name, D, V, M) == \
        jsched.analytic_bubble_fraction(name, D, V, M)
    assert tsched.paper_bubble_fraction(name, D, V, M) == \
        jsched.paper_bubble_fraction(name, D, V, M)
    policy = tcm.resolve_backward_policy(tcs, None, D)
    assert policy == jcm.resolve_backward_policy(jcs, None, D)
    w_b, w_w = tcm.backward_weights(policy)
    assert (w_b, w_w) == jcm.backward_weights(policy)
    assert tsched.simulated_bubble(tcs, 1.0, w_b, w_w) == \
        jsched.simulated_bubble(jcs, 1.0, w_b, w_w)


@pytest.mark.parametrize("L,D,name", list(itertools.product(
    (4, 8, 12), (2, 4), ("GPipe", "1F1B", "Interleaved1F1B"))) + [
        (8, 2, "ZBH1"), (8, 4, "ZBH1"), (8, 2, "ZBV")])
def test_cost_and_memory_sections_match_jax(L, D, name):
    """Under one ``HardwareSpec``: the cost model's FLOPs, predicted step
    time, table-exact bubble and (from a given step time) MFU; the memory
    model's analytic section (live slot peaks, bytes, per-device peak);
    the OOM preflight, also when the capacity is too small. The
    zero-bubble cases price the split backward (B and W at 2 forward
    units each), the W column, and under ZBV the reverse channels and
    local hops."""
    H = {4: 4, 8: 8, 12: 12}[L]
    jcs, tcs, _ = _schedules(name, L, D)
    jcfg = dtpp.ModelConfig(n_layers=L, n_heads=H)
    tcfg = port.ModelConfig(n_layers=L, n_heads=H)
    jhw, thw = jcm.HardwareSpec(**HW), tcm.HardwareSpec(**HW)
    kw = dict(batch_size=32, seq_length=128)
    j = jcm.cost_model_section(jcs, jcfg, hardware=jhw, measured_step_s=0.05,
                               **kw)
    t = tcm.cost_model_section(tcs, tcfg, hardware=thw, measured_step_s=0.05,
                               **kw)
    assert t["flops"] == j["flops"]
    for key in ("compute_s", "comm_s", "step_s", "step_s_overlapped",
                "step_s_comm_overlap", "exposed_comm_s", "hidden_comm_s",
                "ideal_compute_s", "bubble_table_exact", "bubble_weighted",
                "bubble_closed_form"):
        assert t["predicted"][key] == j["predicted"][key], key
    for key in ("hops", "exposed_hops", "overlappable_hops"):
        assert t["comm"][key] == j["comm"][key], key
    assert t["measured"] == {k: j["measured"][k] for k in t["measured"]}
    jm = jmm.memory_model_section(jcs, jcfg, hardware=jhw, **kw)
    tm = tmm.memory_model_section(tcs, tcfg, hardware=thw, **kw)
    analytic = dict(tm["analytic"])
    card = analytic.pop("card_bytes")
    assert analytic == jm["analytic"]
    assert card >= analytic["params_total_bytes"] * 2
    assert tmm.oom_preflight(tm, thw) == jmm.oom_preflight(jm, jhw)
    small = dataclasses.replace(thw, hbm_bytes=1e8)
    assert tmm.oom_preflight(tm, small) == jmm.oom_preflight(
        jm, dataclasses.replace(jhw, hbm_bytes=1e8))
    assert not tmm.oom_preflight(tm, small, per="card")["ok"]


def test_hardware_presets():
    """The H100 preset takes the card's capacity; an unknown card raises
    rather than borrowing a TPU's figures; the CPU is the labelled
    proxy."""
    h100 = tcm.hardware_spec_for("NVIDIA H100 80GB HBM3", 85e9)
    assert (h100.peak_flops, h100.hbm_bytes_per_s, h100.hbm_bytes) == \
        (989e12, 3.35e12, 85e9)
    assert h100.ici_bytes_per_s == h100.hbm_bytes_per_s
    assert tcm.hardware_spec_for("cpu").cpu_proxy
    assert tcm.detect_hardware("cpu") == tcm.CPU_PROXY
    assert tcm.CPU_PROXY.summary() == jcm.CPU_PROXY.summary()
    with pytest.raises(ValueError, match="no roofline preset"):
        tcm.hardware_spec_for("TPU v5 lite")


@pytest.fixture(scope="module")
def mini_sweeps():
    """The port's mini sweep (all three schedules) and one JAX GPipe row,
    both on the CPU: L4, H4, D2, dim 32, B 4, S 16, 1 iteration."""
    grid = dict(layers=(4,), heads=(4,), devices=(2,))
    tdf = tsweep.run_all_experiments(**grid, device="cpu", **MINI)
    # the scan executor compiles in a fifth of the unrolled one's time;
    # the columns are the same
    jdf = jsweep.run_all_experiments(**grid, schedules=("GPipe",),
                                     unroll_ticks=False, **MINI)
    return tdf, jdf


def test_mini_sweep_columns_match_jax(mini_sweeps):
    tdf, jdf = mini_sweeps
    assert len(tdf) == 3 and len(jdf) == 1
    assert list(tdf.columns) == list(jdf.columns) + list(tsweep.PORT_COLUMNS)
    t, j = tdf.iloc[0], jdf.iloc[0]
    for col in ("n_virtual", "n_microbatches", "tokens_processed",
                "bubble_analytic", "bubble_simulated", "bubble_sim_w_b",
                "bubble_table_exact", "predicted_step_s", "backward_policy"):
        assert t[col] == j[col], col
    assert t["host_serialized"] and t["tick_executor"] == "lockstep"
    assert (tdf["throughput"] > 0).all()
    assert tdf["mfu_card"].tolist() == (tdf["mfu"] * 2).tolist()
    assert tdf["max_memory_allocated_bytes"].isna().all()  # the CPU
    assert tsweep.pivot_throughput(tdf).shape == (1, 3)


def test_speedup_matches_jax():
    """The same rows through both ``compute_speedup_and_efficiency``s: a
    skipped row, a group without GPipe and an extra schedule included."""
    rng = np.random.default_rng(0)
    rows = [{"n_layers": L, "n_heads": H, "num_processes": D,
             "schedule": s, "throughput": float(rng.uniform(1e3, 1e4))}
            for L, H, D, s in itertools.product(
                (8, 4), (4,), (4, 2), ("GPipe", "1F1B", "Interleaved1F1B"))]
    rows += [{"n_layers": 12, "n_heads": 4, "num_processes": 2,
              "schedule": "1F1B", "throughput": 5e3},
             {"n_layers": 4, "n_heads": 4, "num_processes": 2,
              "schedule": "BFS", "throughput": 7e3},
             {"n_layers": 12, "n_heads": 8, "num_processes": 2,
              "schedule": "GPipe", "skip_reason": "predicted_oom"},
             {"n_layers": 12, "n_heads": 8, "num_processes": 2,
              "schedule": "1F1B", "throughput": 5e3}]
    want = jsweep.compute_speedup_and_efficiency(pd.DataFrame(rows))
    got = tsweep.compute_speedup_and_efficiency(rows)
    pd.testing.assert_frame_equal(pd.DataFrame(got), want)
    pd.testing.assert_frame_equal(pd.DataFrame(
        tsweep.compute_speedup_and_efficiency(pd.DataFrame(rows))), want)


def test_error_and_skip_contracts():
    """A failing config returns ``{"error": ...}`` and the sweep leaves it
    out; a config priced over the capacity returns a
    ``skip_reason="predicted_oom"`` row with the JAX keys before anything
    is built."""
    bad = tsweep.run_one_experiment(3, 4, 2, "GPipe", device="cpu", **{
        k: v for k, v in MINI.items() if k != "verbose"})
    assert set(bad) == {"error"} and "divide" in bad["error"]
    rows = tsweep.sweep_rows(layers=(3,), heads=(4,), devices=(2,),
                             schedules=("GPipe",), device="cpu", **MINI)
    assert rows == []
    huge = dict(MINI, vocab_size=10 ** 9)
    huge.pop("verbose")
    skip = tsweep.run_one_experiment(4, 4, 2, "GPipe", device="cpu", **huge)
    jskip = jsweep.run_one_experiment(4, 4, 2, "GPipe", **huge)
    assert skip["skip_reason"] == jskip["skip_reason"] == "predicted_oom"
    assert set(skip) == set(jskip)
    assert skip["predicted_peak_bytes"] > skip["hbm_bytes"] == 16e9


def test_run_sweep_writes_csv(tmp_path, capsys):
    """``python -m ...run_sweep --quick --device cpu`` writes the rows and
    the speedup table as CSV (stdlib ``csv``)."""
    assert run_sweep.main(["--quick", "--device", "cpu", "--iterations", "1",
                           "--out", str(tmp_path)]) == 0
    with open(tmp_path / "sweep.csv") as fh:
        rows = list(csv.DictReader(fh))
    with open(tmp_path / "speedup.csv") as fh:
        speedup = list(csv.DictReader(fh))
    assert len(rows) == 6 and len(speedup) == 4
    assert set(tsweep.PORT_COLUMNS) <= set(rows[0])
    assert "tokens/s on cpu" in capsys.readouterr().out


def test_plots(tmp_path):
    rows = [{"n_layers": L, "n_heads": H, "num_processes": D,
             "schedule": s, "throughput": 1e3 * (L + H + D)}
            for L, H, D, s in itertools.product(
                (4, 8), (4, 8), (2, 4), ("GPipe", "1F1B", "Interleaved1F1B"))]
    sp = tsweep.compute_speedup_and_efficiency(rows)
    for fig, name in (
            (plotting.plot_speedup_and_efficiency(sp), "speedup.png"),
            (plotting.plot_throughput_grid(rows), "grid.png"),
            (plotting.plot_schedule_timeline("Interleaved1F1B", 2, 2, 4),
             "timeline.png")):
        fig.savefig(tmp_path / name)
        assert (tmp_path / name).stat().st_size > 0


def test_sweep_imports_neither_pandas_nor_matplotlib():
    """The H100 host has neither: importing the sweep, its CLI and the
    plotting module pulls in neither."""
    code = ("import sys\n"
            "import distributed_training_with_pipeline_parallelism_tpu_torch"
            ".run_sweep\n"
            "import distributed_training_with_pipeline_parallelism_tpu_torch"
            ".utils.plotting\n"
            "bad = {'pandas', 'matplotlib'} & set(sys.modules)\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_world_rows_add_the_transport(tmp_path):
    """``backend="gloo"`` runs a row of each D in one world of D processes
    (``sweep_rows`` and ``run_one_experiment``): the lockstep row's keys
    plus ``transport`` and ``world_ranks``, the same bubble, cost and
    memory columns, and the JAX key set for the lockstep rows. With a
    ``report_dir`` the world row's manifest is written once, valid, with
    rank 0's timing and the row as gauges."""
    kw = {k: v for k, v in MINI.items() if k != "verbose"}
    lock = tsweep.run_one_experiment(4, 4, 2, "1F1B", device="cpu", **kw)
    world = tsweep.run_one_experiment(4, 4, 2, "1F1B", device="cpu",
                                      backend="gloo", report_dir=tmp_path,
                                      **kw)
    with open(tmp_path / "sweep_reports.jsonl") as fh:
        manifests = [json.loads(line) for line in fh]
    assert len(manifests) == 1
    ttelemetry.validate_report(manifests[0])
    assert manifests[0]["gauges"]["transport"] == "gloo"
    assert manifests[0]["counters"] == {"timed_iterations":
                                        MINI["num_iterations"]}
    assert "error" not in world, world
    assert set(world) == set(lock) | set(tsweep.WORLD_COLUMNS)
    assert world["transport"] == "gloo" and world["world_ranks"] == 2
    assert world["tick_executor"] == "dist"
    assert lock["tick_executor"] == "lockstep"
    for k in ("bubble_analytic", "bubble_simulated", "bubble_table_exact",
              "bubble_sim_w_b", "predicted_step_s", "predicted_card_bytes",
              "n_virtual", "n_microbatches", "tokens_processed"):
        assert world[k] == lock[k], k
    assert world["throughput"] > 0
    rows = tsweep.sweep_rows(layers=(4,), heads=(4,), devices=(2,),
                             schedules=("GPipe", "Interleaved1F1B"),
                             device="cpu", backend="gloo", **MINI)
    assert [r["schedule"] for r in rows] == ["GPipe", "Interleaved1F1B"]
    assert all(r["transport"] == "gloo" for r in rows)
