"""The port's calibration module and the cost model's corrections against
the JAX package's on the CPU.

Host numpy on both sides, so everything is held exactly (``==``, bytes
for the artifact) unless a test states a tolerance:

- ``probe_grid`` for seeds 0-2, ``schedule_family``, ``signed_rel_err``;
- ``fit_correction`` on the JAX CLI's synthetic rows and on a seeded
  random ledger, the fingerprinted artifact's bytes, the loader's
  tamper rejection (same message), ``validate_ledger_row`` on the JAX
  CLI's four malformed rows (same messages), ``group_errors``,
  ``calibration_section``, the backfill row builders, ``reprice_row``;
- ``cost_model_section`` with a correction, the run's record of a
  ``comm_overlap="ring"`` run included, over GPipe, 1F1B,
  Interleaved1F1B, ZBH1 and ZBV (the JAX section computes in float64, so
  the sections are equal dicts), and ``predicted_tick_seconds``;
- ``maybe_load_default_corrections`` through
  ``$DTPP_CALIBRATION_CORRECTIONS``, a missing file and a tampered one;
- one measured ``run_probe`` per side at a "none" and a "ring" spec:
  equal ``deterministic_fields`` (no key differs).

``fit``'s and the sweep's corrected sections are held to JAX's in
``tests/test_torch_telemetry.py``, next to the JAX ``fit`` it compiles.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.analysis import (
    calibration as jcal, cost_model as jcm)
from distributed_training_with_pipeline_parallelism_tpu.analysis.cli import (
    run_calibration_checks)
from distributed_training_with_pipeline_parallelism_tpu.parallel import (
    schedules as jsched)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
    calibration as tcal, cost_model as tcm)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    schedules as tsched)

HW = dict(name="h100", peak_flops=989e12, ici_bytes_per_s=3.35e12,
          hbm_bytes_per_s=3.35e12, hbm_bytes=80e9)
# (schedule, D, V, M): the five families of the cost model's tables
TABLES = (("GPipe", 2, 1, 4), ("1F1B", 4, 1, 8), ("Interleaved1F1B", 2, 2, 4),
          ("ZBH1", 4, 1, 8), ("ZBV", 2, 2, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic_rows(mod, e_f=0.02, e_b=0.5):
    """The JAX CLI's synthetic ledger (``analysis/cli.py``): measured =
    compute / e_f + comm / e_b over four rows."""
    rows = []
    for i, (c, k) in enumerate(((1e-3, 1e-4), (2e-3, 5e-4), (3e-3, 2e-4),
                                (5e-3, 8e-4))):
        rows.append({
            "schema_version": mod.CALIBRATION_SCHEMA_VERSION,
            "kind": mod.LEDGER_KIND, "source": "synthetic", "t": 0.0,
            "name": f"syn{i}", "backend": "cpu", "hardware": "syn_hw",
            "cpu_proxy": True, "schedule": "GPipe",
            "schedule_family": "GPipe", "backward_policy": "remat",
            "comm_overlap": "none", "n_devices": 2, "n_virtual": 1,
            "n_microbatches": 4, "batch_size": 8, "seq_length": 16,
            "predicted": {"compute_s": c, "comm_s": k, "step_s": c + k},
            "measured": {"step_s": c / e_f + k / e_b},
            "rel_err": None, "corrected": None,
        })
    return rows


def _random_ledger(seed, n=24):
    """A seeded ledger over two hardware names, every family and policy,
    some rows without a prediction or a measurement, in shuffled order."""
    rng = np.random.default_rng(seed)
    base = _synthetic_rows(jcal)[0]
    rows = []
    for i in range(n):
        sched = ["GPipe", "1F1B", "Interleaved1F1B", "ZBH1", "BFS",
                 "Searched_x", "odd"][i % 7]
        c, k = rng.uniform(1e-4, 1e-2), rng.uniform(0.0, 2e-3)
        pred = ({"compute_s": c, "comm_s": k if i % 5 else None,
                 "step_s": c + k} if i % 6 else None)
        meas = ({"step_s": c / rng.uniform(0.01, 0.3)
                 + k / rng.uniform(0.1, 0.9)} if i % 7 != 3 else None)
        row = dict(base, name=f"r{i}", schedule=sched,
                   schedule_family=jcal.schedule_family(sched),
                   hardware=("hw_a", "hw_b")[i % 2],
                   backend=("cpu", "cuda")[i % 2],
                   backward_policy=("remat", "stored", "split")[i % 3],
                   predicted=pred, measured=meas,
                   rel_err=jcal._rel_err_block(pred, meas))
        rows.append(row)
    rng.shuffle(rows)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_grid_matches_jax(seed):
    """The seeded smoke grid: the same specs in the same order, with
    JAX's labels."""
    j, t = jcal.probe_grid("smoke", seed=seed), tcal.probe_grid("smoke",
                                                                 seed=seed)
    assert [s.to_dict() for s in t] == [s.to_dict() for s in j]
    assert [s.label for s in t] == [s.label for s in j]
    for name in ("GPipe", "1F1B", "Interleaved1F1B", "BFS", "ZBV",
                 "Searched_a", "", None, "other"):
        assert tcal.schedule_family(name) == jcal.schedule_family(name)
    with pytest.raises(tcal.CalibrationError, match="unknown probe grid"):
        tcal.probe_grid("nope")


def test_fit_correction_and_artifact_match_jax():
    """The synthetic rows recover their efficiencies to 1e-9 (the JAX
    CLI's check) with JAX's exact factors; the seeded random ledger fits
    to JAX's factors per hardware name; the artifacts' bytes and
    fingerprints are equal, each loads in the other package, and a
    tampered payload fails both with one message."""
    jrows, trows = _synthetic_rows(jcal), _synthetic_rows(tcal)
    jfit, tfit = (jcal.fit_correction(jrows, "syn_hw"),
                  tcal.fit_correction(trows, "syn_hw"))
    assert tfit.summary() == jfit.summary()
    assert abs(tfit.flops_efficiency - 0.02) < 1e-9
    assert abs(tfit.bandwidth_efficiency - 0.5) < 1e-9
    ledger = _random_ledger(0)
    jf, tf = jcal.fit_corrections(ledger), tcal.fit_corrections(ledger)
    assert {k: v.summary() for k, v in tf.items()} == \
        {k: v.summary() for k, v in jf.items()}
    assert tcal.fit_correction(ledger, "absent") is None
    # row order does not move the fit (sorted canonical rows)
    assert tcal.fit_corrections(ledger[::-1])["hw_a"] == tf["hw_a"]

    jart = jcal.correction_artifact(dict(jf, syn_hw=jfit))
    tart = tcal.correction_artifact(dict(tf, syn_hw=tfit))
    assert tcal.correction_artifact_bytes(tart) == \
        jcal.correction_artifact_bytes(jart)
    assert tart["fingerprint"] == jart["fingerprint"]
    assert tcal.load_correction_artifact(jart) == {
        k: tcal.CorrectionFactors(**v.summary()) for k, v in
        jcal.load_correction_artifact(tart).items()}
    tampered = json.loads(json.dumps(tart))
    tampered["corrections"]["syn_hw"]["flops_efficiency"] = 1.0
    msgs = []
    for mod in (jcal, tcal):
        with pytest.raises(mod.CalibrationError) as e:
            mod.load_correction_artifact(tampered)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "fingerprint mismatch" in msgs[1]


def test_ledger_rows_match_jax(tmp_path):
    """``validate_ledger_row`` rejects the JAX CLI's four malformed rows
    with JAX's messages; ``group_errors``, ``calibration_section`` (with
    a correction), the canonical lines and a ledger written and read back
    (a malformed line counted) are JAX's."""
    row = _synthetic_rows(tcal)[0]
    for bad in ({}, {"schema_version": 99}, dict(row, kind="wrong"),
                dict(row, predicted={"no_step": 1.0}), "not a dict"):
        msgs = []
        for mod in (jcal, tcal):
            with pytest.raises(mod.CalibrationError) as e:
                mod.validate_ledger_row(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    ledger = _random_ledger(1)
    assert tcal.group_errors(ledger) == jcal.group_errors(ledger)
    corr = tcal.fit_corrections(ledger)
    assert tcal.calibration_section(ledger, correction=corr,
                                    ledger_path="x.jsonl") == \
        jcal.calibration_section(ledger, correction=jcal.fit_corrections(
            ledger), ledger_path="x.jsonl")
    assert [tcal.canonical_row_line(r) for r in ledger] == \
        [jcal.canonical_row_line(r) for r in ledger]
    path = str(tmp_path / "l.jsonl")
    assert tcal.append_ledger_rows(path, ledger) == len(ledger)
    with open(path, "a") as fh:
        fh.write("{not json\n")
    got, bad = tcal.load_ledger(path)
    want, jbad = jcal.load_ledger(path)
    assert got == want == ledger and len(bad) == len(jbad) == 1
    with pytest.raises(tcal.CalibrationError):
        tcal.load_ledger(path, strict=True)


def test_backfill_rows_match_jax():
    """Both backfill row builders give JAX's rows (and JAX's None) on
    bench wrappers and history rows."""
    benches = [
        {"rc": 0, "parsed": {"metric": "train (GPipe, x, batch 32, seq 128, "
                                       "8 layers, 4-stage)",
                             "value": 1671.3, "unit": "tokens/sec"}},
        {"rc": 1, "parsed": None},
        {"rc": 0, "parsed": {"metric": "odd", "value": 5.0,
                             "unit": "tokens/sec"}},
        {"rc": 0, "parsed": {"metric": "x", "value": 5.0, "unit": "ms"}},
    ]
    for i, b in enumerate(benches):
        assert tcal.backfill_row_from_bench(b, label=f"b{i}") == \
            jcal.backfill_row_from_bench(b, label=f"b{i}")
    hist = [{"measured_step_s": 0.1, "predicted_step_s": 0.05,
             "schedule": "1F1B", "backend": "cpu", "t": 3.0,
             "peak_temp_bytes": 123, "tokens_per_sec": 9.0},
            {"measured_step_s": 0.2, "backend": "tpu"}, {"name": "x"}]
    for i, h in enumerate(hist):
        assert tcal.backfill_row_from_history(h, path=f"h:{i}") == \
            jcal.backfill_row_from_history(h, path=f"h:{i}")


def _sections(name, D, V, M, comm_overlap, correction, measured=0.05):
    jcs = jsched.compile_schedule(name, D, V, M)
    tcs = tsched.compile_schedule(name, D, V, M)
    jcfg = dtpp.ModelConfig(dim=64, n_layers=8, n_heads=4, vocab_size=128,
                            ffn_dim=128)
    tcfg = port.ModelConfig(dim=64, n_layers=8, n_heads=4, vocab_size=128,
                            ffn_dim=128)
    kw = dict(batch_size=16, seq_length=32, remat_backward=None,
              measured_step_s=measured, comm_overlap=comm_overlap)
    j = jcm.cost_model_section(jcs, jcfg, hardware=jcm.HardwareSpec(**HW),
                               correction=correction[0], **kw)
    t = tcm.cost_model_section(tcs, tcfg, hardware=tcm.HardwareSpec(**HW),
                               correction=correction[1], **kw)
    return j, t, jcs, tcs


@pytest.mark.parametrize("comm_overlap", ["none", "ring"])
@pytest.mark.parametrize("name,D,V,M", TABLES, ids=lambda v: str(v))
def test_corrected_cost_model_section_matches_jax(name, D, V, M,
                                                  comm_overlap):
    """With a per-hardware correction mapping (the artifact loader's
    shape): the whole section equal to JAX's, ``predicted.corrected`` and
    ``measured.rel_err_corrected`` included, a ring run's record too; the
    corrected sandwich holds (overlapped <= comm_overlap <= serial); a
    correction for another hardware name leaves no corrected block; the
    per-tick prediction sums to ``step_s_comm_overlap``."""
    corr = {"h100": tcal.CorrectionFactors("h100", 0.31, 0.07, 9, 1e-3)}
    jcorr = {"h100": jcal.CorrectionFactors("h100", 0.31, 0.07, 9, 1e-3)}
    j, t, jcs, tcs = _sections(name, D, V, M, comm_overlap, (jcorr, corr))
    assert t == j
    c = t["predicted"]["corrected"]
    assert c["step_s_overlapped"] <= c["step_s_comm_overlap"] + 1e-15 \
        <= c["step_s"] + 2e-15
    assert t["measured"]["rel_err_corrected"] == \
        (c["step_s"] - 0.05) / 0.05
    other = {"v5e": corr["h100"]}
    j2, t2, _, _ = _sections(name, D, V, M, comm_overlap, (
        {"v5e": jcorr["h100"]}, other))
    assert t2 == j2 and "corrected" not in t2["predicted"]
    unit = t["flops"]["unit"]
    unit_s = tuple(unit[k] / HW["peak_flops"] for k in "FBW")
    hop_s = t["comm"]["bytes_per_hop"] / HW["ici_bytes_per_s"]
    for cf in (None, corr["h100"]):
        got = tcm.predicted_tick_seconds(tcs.table, unit_s, hop_s,
                                         correction=cf)
        want = jcm.predicted_tick_seconds(
            jcs.table, unit_s, hop_s,
            correction=None if cf is None else jcorr["h100"])
        np.testing.assert_array_equal(got, want)
    # the per-tick vector sums to the step time, to the sum's rounding
    assert abs(got.sum() - c["step_s_comm_overlap"]) <= \
        1e-12 * c["step_s_comm_overlap"]


def test_reprice_and_row_builders_match_jax():
    """``row_from_cost_model`` on a corrected section and ``reprice_row``
    of a probe row under a fit give JAX's rows (the CPU proxy's preset on
    both sides)."""
    j, t, _, _ = _sections("1F1B", 4, 1, 8, "ring", (
        {"cpu_proxy": jcal.CorrectionFactors("cpu_proxy", 0.2, 0.4, 3, 0.)},
        {"cpu_proxy": tcal.CorrectionFactors("cpu_proxy", 0.2, 0.4, 3, 0.)}))
    kw = dict(source="probe", name="p", backend="cpu", t=1.5, seed=3,
              measured_comm_s=0.01, predicted_peak_bytes=1e6,
              measured_peak_bytes=2e6)
    assert tcal.row_from_cost_model(t, **kw) == \
        jcal.row_from_cost_model(j, **kw)
    assert tcal.calibration_section_from_cost_model(t, backend="cpu") == \
        jcal.calibration_section_from_cost_model(j, backend="cpu")
    spec = tcal.probe_grid()[0]
    jspec = jcal.ProbeSpec(**spec.to_dict())
    # a probe row as run_probe builds it, on the CPU proxy
    cfg = port.ModelConfig(**tcal._PROBE_MODEL)
    cs = tsched.compile_schedule(spec.schedule, spec.n_devices,
                                 spec.n_virtual, spec.n_microbatches)
    row = tcal.row_from_cost_model(
        tcm.cost_model_section(cs, cfg, batch_size=8, seq_length=16,
                               hardware=tcm.CPU_PROXY,
                               remat_backward=spec.remat_backward,
                               measured_step_s=0.02,
                               comm_overlap=spec.comm_overlap),
        source="probe", name="probe_x", backend="cpu", seed=0,
        predicted_peak_bytes=5e5, measured_peak_bytes=None)
    fit = {"cpu_proxy": tcal.CorrectionFactors("cpu_proxy", 0.01, 0.002, 9,
                                               0.0)}
    jfit = {"cpu_proxy": jcal.CorrectionFactors(**fit["cpu_proxy"].summary())}
    assert tcal.reprice_row(row, spec, fit) == \
        jcal.reprice_row(row, jspec, jfit)


def test_default_corrections_follow_the_env(tmp_path, monkeypatch):
    """``maybe_load_default_corrections``: the artifact the variable names
    (as JAX loads it); None for a missing file and for a tampered one (no
    raise); the port's default path lies outside ``results/``."""
    path = tmp_path / "c.json"
    tcal.save_correction_artifact(tcal.correction_artifact(
        {"cpu_proxy": tcal.CorrectionFactors("cpu_proxy", 0.1, 0.2, 2, 0.)}),
        str(path))
    monkeypatch.setenv(tcal.CORRECTIONS_ENV, str(path))
    got, want = (tcal.maybe_load_default_corrections(),
                 jcal.maybe_load_default_corrections())
    assert got["cpu_proxy"].summary() == want["cpu_proxy"].summary()
    monkeypatch.setenv(tcal.CORRECTIONS_ENV, str(tmp_path / "missing.json"))
    assert tcal.maybe_load_default_corrections() is None
    assert jcal.maybe_load_default_corrections() is None
    art = json.loads(path.read_text())
    art["corrections"]["cpu_proxy"]["n_rows"] = 5
    path.write_text(json.dumps(art))
    monkeypatch.setenv(tcal.CORRECTIONS_ENV, str(path))
    assert tcal.maybe_load_default_corrections() is None
    assert not tcal.DEFAULT_CORRECTIONS_PATH.startswith("results")
    assert not tcal.DEFAULT_LEDGER_PATH.startswith("results")


def test_jax_calibration_checks_hold_on_the_port():
    """The JAX ``--calibration`` pass's own cases are its report; the
    port's pass equals it (``tests/test_torch_analysis_cli.py``); here its
    synthetic fit and corrected sandwich on the port's objects alone."""
    rep = run_calibration_checks()
    assert rep["ok"]
    fit = tcal.fit_correction(_synthetic_rows(tcal), "syn_hw")
    cfg = port.ModelConfig(dim=16, n_layers=4, n_heads=2, vocab_size=64,
                           ffn_dim=32, max_seq_len=16)
    for name, D, V, M in (("GPipe", 2, 1, 4), ("1F1B", 4, 1, 8),
                          ("ZBH1", 4, 1, 8)):
        sec = tcm.cost_model_section(tsched.compile_schedule(name, D, V, M),
                                     cfg, batch_size=8, seq_length=16,
                                     hardware=tcm.CPU_PROXY, correction=fit)
        c = sec["predicted"]["corrected"]
        assert c["step_s_overlapped"] <= c["step_s_comm_overlap"] + 1e-12 \
            <= c["step_s"] + 1e-12


@pytest.mark.parametrize("index", [8, 2], ids=["none", "ring"])
def test_run_probe_matches_jax(index):
    """One measured probe per side (``GPipe[D=2,V=1,M=4]/remat/none`` and
    ``GPipe[D=2,V=1,M=2]/remat/ring``, the grid's cheapest of each
    kind): every deterministic field equal, the measured step positive,
    no measured peak on the CPU (no allocator), and the corrected row
    that ``reprice_row`` gives under a fit on JAX's probe row JAX's."""
    spec = tcal.probe_grid(seed=0)[index]
    jspec = jcal.ProbeSpec(**spec.to_dict())
    assert spec.remat_backward and spec.schedule == "GPipe"
    t = tcal.run_probe(spec, device="cpu")
    j = jcal.run_probe(jspec)
    assert tcal.deterministic_fields(t) == jcal.deterministic_fields(j)
    assert t["measured"]["step_s"] > 0 and "peak_bytes" not in t["measured"]
    assert t["backend"] == "cpu" and t["hardware"] == "cpu_proxy"
    fit = tcal.fit_correction([t], "cpu_proxy")
    jfit = jcal.CorrectionFactors(**fit.summary())
    assert jcal.deterministic_fields(tcal.reprice_row(j, spec, fit)) == \
        jcal.deterministic_fields(jcal.reprice_row(j, jspec, jfit))
    assert dataclasses.asdict(spec) == jspec.to_dict()
