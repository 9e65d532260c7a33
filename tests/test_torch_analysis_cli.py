"""The port's analysis CLI and its ``probe.py`` entry point on the CPU.

- Each of the five host passes (``--tables``, ``--memory``,
  ``--overlap``, ``--calibration``, ``--search``) gives the JAX pass's
  report, case for case (``==`` on the whole dict);
- ``--all`` exits 0, writes the JSON report with the five passes and
  lists the two it leaves out (``--lint``, ``--jaxpr``), which asked
  for raise ``NotImplementedError`` naming ``ROADMAP.md`` Queue 1, item 9;
  ``--search-out`` writes an artifact the certifying loader accepts;
- ``probe.py`` runs the smoke grid on the CPU with ``--check`` (warn-only
  there, as in JAX) into explicit paths: a ledger of 9 valid rows, an
  artifact that reloads to its bytes, a report ``validate_report``
  accepts with the calibration section, an annotated trace; and
  ``--backfill`` appends what it is given once.
"""

import json
import runpy
import sys

import pytest
import torch

from distributed_training_with_pipeline_parallelism_tpu.analysis import (
    cli as jcli)
from distributed_training_with_pipeline_parallelism_tpu_torch import probe
from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
    calibration as tcal, cli as tcli)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    schedules as tsched)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.telemetry import (
    validate_report)

PASSES = ("run_table_checks", "run_memory_checks", "run_overlap_checks",
          "run_calibration_checks", "run_search")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the built-in schedules: the default grid of a fresh process on both
# sides (other tests register schedules in one package's registry only)
BUILTIN = ("GPipe", "1F1B", "Interleaved1F1B", "BFS", "ZBH1", "ZBV")


@pytest.mark.parametrize("name", PASSES)
def test_pass_reports_equal_jax(name):
    """The port's pass report equals the JAX pass's (the pricing passes
    on the CPU proxy on both sides), the grid passes over the default
    grid's built-in schedules."""
    kw = {}
    if name != "run_calibration_checks" and name != "run_search":
        grid = [g for g in jcli.default_grid() if g[0] in BUILTIN]
        assert {g[0] for g in grid} == set(BUILTIN)
        assert set(grid) <= set(tcli.default_grid())
        kw["grid"] = grid
    got, want = getattr(tcli, name)(**kw), getattr(jcli, name)(**kw)
    assert got == want
    assert got["ok"]


def test_all_lists_what_it_leaves_out(tmp_path, capsys):
    """``--all`` (quiet) exits 0 with the five passes in its JSON report
    and ``not_ported`` naming lint and jaxpr; the default runs the
    tables alone; ``--search-out`` writes a certified artifact."""
    out = tmp_path / "all.json"
    art = tmp_path / "searched.json"
    assert tcli.main(["--all", "--quiet", "--json", str(out),
                      "--search-out", str(art)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and {"tables", "memory", "overlap", "calibration",
                          "search"} <= set(rep)
    assert sorted(rep["not_ported"]) == ["jaxpr", "lint"]
    assert all("Queue 1, item 9" in v for v in rep["not_ported"].values())
    cs = tsched.load_schedule_artifact(str(art))
    assert cs.n_devices == 4 and cs.n_microbatches == 8
    assert tcli.main([]) == 0
    printed = capsys.readouterr().out
    assert f"tables: {len(tcli.default_grid()) + 8} checked, 0 hazards" \
        in printed
    assert "check: OK" in printed


@pytest.mark.parametrize("flag", ["--lint", "--jaxpr"])
def test_jax_only_passes_raise(flag):
    with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
        tcli.main([flag])


def test_module_entry_point_runs(monkeypatch):
    """``python -m ...analysis --overlap --quiet`` exits 0."""
    monkeypatch.setattr(sys, "argv", ["analysis", "--overlap", "--quiet"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module(
            "distributed_training_with_pipeline_parallelism_tpu_torch"
            ".analysis", run_name="__main__")
    assert e.value.code == 0


def test_probe_grid_and_backfill_on_cpu(tmp_path):
    """The smoke grid on the CPU into explicit paths, ``--check``
    included; then ``--backfill`` of a bench wrapper, twice."""
    ledger, corr = tmp_path / "l.jsonl", tmp_path / "c.json"
    out = tmp_path / "out"
    assert probe.main([str(out), "--device", "cpu", "--check",
                       "--iterations", "1", "--ledger", str(ledger),
                       "--corrections", str(corr)]) == 0
    rows, bad = tcal.load_ledger(str(ledger))
    assert len(rows) == 9 and not bad
    assert {r["backend"] for r in rows} == {"cpu"}
    assert all(r["corrected"] is not None for r in rows)
    factors = tcal.load_correction_artifact(str(corr))
    assert tcal.correction_artifact_bytes(
        tcal.correction_artifact(factors)) == corr.read_bytes()
    manifest = json.loads((out / "report.json").read_text())
    validate_report(manifest)
    assert manifest["calibration"]["n_rows"] == 9
    assert manifest["calibration"]["correction"]["cpu_proxy"] == \
        factors["cpu_proxy"].summary()
    trace = json.loads((out / "trace.json").read_text())
    assert trace["otherData"]["n_predicted_ticks"] > 0

    bench = tmp_path / "BENCH_x.json"
    bench.write_text(json.dumps({"rc": 0, "parsed": {
        "metric": "train (GPipe, x, batch 32, seq 128, 2-stage)",
        "value": 1000.0, "unit": "tokens/sec"}}))
    hist = tmp_path / "h.jsonl"
    hist.write_text(json.dumps({"measured_step_s": 0.5}) + "\n\n{bad\n")
    args = ["--backfill", "--bench", str(bench), str(tmp_path / "no.json"),
            "--history", str(hist), "--ledger", str(ledger)]
    assert probe.main(args) == 0
    assert len(tcal.load_ledger(str(ledger))[0]) == 11
    assert probe.main(args) == 0
    assert len(tcal.load_ledger(str(ledger))[0]) == 11


def test_analysis_exports_match_jax():
    """The package's lazy exports: JAX's names but the lint's, the jaxpr
    audit's and XLA's compiled-memory ones (ROADMAP.md Queue 1, item 9),
    plus the allocator watermarks that stand in for the last; each
    resolves."""
    from distributed_training_with_pipeline_parallelism_tpu import (
        analysis as janalysis)
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        analysis as tanalysis)
    left_out = {"JaxprAudit", "audit_jaxpr", "audit_fn", "LintFinding",
                "lint_repo", "lint_source", "compiled_memory_section",
                "reconcile_memory"}
    assert set(tanalysis.__all__) == \
        (set(janalysis.__all__) - left_out) | {"allocator_stats"}
    for name in tanalysis.__all__:
        assert getattr(tanalysis, name) is not None
    assert tanalysis.fit_corrections is tcal.fit_corrections
