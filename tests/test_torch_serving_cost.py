"""The port's serving cost and memory instruments against the JAX
package's on the CPU.

- ``expected_tokens_per_verify``, ``serving_cost_model_section`` without
  and with its ``speculative`` part (and a correction), on GPT-2 and
  llama configs: equal to JAX's (float64 host math on both sides, so
  exactly);
- the KV sizing (``kv_page_bytes``, ``kv_slot_bytes``,
  ``size_page_pool``, ``contiguous_slots_for_budget``),
  ``matched_budget_plan`` and ``serving_memory_section`` (contiguous and
  paged, with the prefix discount) on the program geometry both engines
  allocate: exactly JAX's; the port's ``allocator`` part is its own;
- ``run_paged_bench`` and ``run_spec_bench`` at the JAX benches' default
  CPU sizes on the same weights: every engine's completions equal to its
  JAX twin's, ``outputs_match`` in both, the budget plan and the
  speculative prediction JAX's, and a run report that the port's
  validator accepts carrying the serving cost and memory sections.
"""

import types

import pytest
import torch

import jax

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.analysis import (
    calibration as jcal, cost_model as jcm, memory_model as jmm)
from distributed_training_with_pipeline_parallelism_tpu.models.llama import (
    llama_config as jllama_config)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.serving import (
    bench as jbench, engine as jengine, loadgen as jloadgen)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
    calibration as tcal, cost_model as tcm, memory_model as tmm)
from distributed_training_with_pipeline_parallelism_tpu_torch.serving import (
    bench as tbench, engine as tengine, loadgen as tloadgen)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.telemetry import (
    RunReport, validate_report)

from test_torch_serving import _tree

HW = dict(name="h100", peak_flops=989e12, ici_bytes_per_s=3.35e12,
          hbm_bytes_per_s=3.35e12, hbm_bytes=80e9)
# the JAX benches' default model, at the position table _tree builds
SMALL = dict(arch="gpt2", dim=64, n_layers=4, n_heads=4, vocab_size=128,
             ffn_dim=128, max_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(which):
    if which == "gpt2":
        return dtpp.ModelConfig(**SMALL), port.ModelConfig(**SMALL)
    return (jllama_config("llama-debug", n_layers=4),
            port.llama_config("llama-debug", n_layers=4))


def _summary(speculative):
    s = {"ticks": 180, "wall_s": 0.75, "tokens_out": 410}
    if speculative:
        s.update(speculative=True, gamma=3, acceptance_rate=0.62)
    return s


def test_expected_tokens_per_verify_matches_jax():
    for a in (0.0, 0.3, 0.999, 1.0, 1.5, -1.0):
        for g in (0, 1, 3, 7):
            assert tcm.expected_tokens_per_verify(a, g) == \
                jcm.expected_tokens_per_verify(a, g)
    with pytest.raises(ValueError, match="gamma"):
        tcm.expected_tokens_per_verify(0.5, -1)


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["plain", "speculative"])
@pytest.mark.parametrize("which", ["gpt2", "llama"])
def test_serving_cost_model_section_matches_jax(which, speculative):
    """The section on the same summary, with a 2-layer draft when
    speculative, uncorrected and under a correction mapping (its
    ``speculative.predicted.corrected``): equal dicts."""
    jcfg, tcfg = _cfgs(which)
    jd = tcd = None
    if speculative:
        jd = jllama_config("llama-debug", n_layers=2) if which == "llama" \
            else dtpp.ModelConfig(**dict(SMALL, n_layers=2))
        tcd = port.llama_config("llama-debug", n_layers=2) \
            if which == "llama" else port.ModelConfig(**dict(SMALL,
                                                             n_layers=2))
    jhw, thw = jcm.HardwareSpec(**HW), tcm.HardwareSpec(**HW)
    for corr in (None, (0.4, 0.05)):
        jc = None if corr is None else {
            "h100": jcal.CorrectionFactors("h100", *corr, 3, 0.0)}
        tc = None if corr is None else {
            "h100": tcal.CorrectionFactors("h100", *corr, 3, 0.0)}
        j = jcm.serving_cost_model_section(jcfg, 2, 4, _summary(speculative),
                                           hardware=jhw, draft_cfg=jd,
                                           correction=jc)
        t = tcm.serving_cost_model_section(tcfg, 2, 4, _summary(speculative),
                                           hardware=thw, draft_cfg=tcd,
                                           correction=tc)
        assert t == j
        assert ("speculative" in t) == speculative
        if speculative and corr is not None:
            assert "corrected" in t["speculative"]["predicted"]
    empty = tcm.serving_cost_model_section(tcfg, 2, 4, {}, hardware=thw)
    assert "measured" not in empty and empty == \
        jcm.serving_cost_model_section(jcfg, 2, 4, {}, hardware=jhw)


def _program(cfg, paged, **kw):
    """The fields the memory section reads, as both engines' programs
    hold them (``mlen_alloc`` and ``max_pages_per_slot`` derived as
    they derive them)."""
    p = types.SimpleNamespace(n_stages=2, n_slots=4, prefill_chunk=3,
                              max_len=24, paged=paged, page_size=4,
                              n_pages=17, **kw)
    p.mlen_alloc = p.max_len + p.prefill_chunk - 1
    p.max_pages_per_slot = -(-p.mlen_alloc // p.page_size) if paged else 0
    return p


@pytest.mark.parametrize("which", ["gpt2", "llama"])
def test_kv_sizing_and_memory_section_match_jax(which):
    """The four KV sizing functions over a grid, and the serving memory
    section contiguous, paged and paged with the prefix discount, equal
    to JAX's; the port's program derives the geometry as the stand-in
    does; ``allocator=`` adds its part and nothing else."""
    jcfg, tcfg = _cfgs(which)
    for D in (1, 2, 4):
        for ps in (1, 4, 16):
            kw = dict(n_devices=D, page_size=ps)
            assert tmm.kv_page_bytes(tcfg, **kw) == \
                jmm.kv_page_bytes(jcfg, **kw)
            for budget in (0.0, 1e3, 5e5, 3e7):
                assert tmm.size_page_pool(tcfg, budget_bytes=budget, **kw) \
                    == jmm.size_page_pool(jcfg, budget_bytes=budget, **kw)
        for mlen in (8, 27, 640):
            kw = dict(n_devices=D, mlen_alloc=mlen)
            assert tmm.kv_slot_bytes(tcfg, **kw) == \
                jmm.kv_slot_bytes(jcfg, **kw)
            for budget in (0.0, 1e3, 5e5, 3e7):
                assert tmm.contiguous_slots_for_budget(
                    tcfg, budget_bytes=budget, **kw) == \
                    jmm.contiguous_slots_for_budget(
                        jcfg, budget_bytes=budget, **kw)
    jhw, thw = jmm.HardwareSpec(**HW), tmm.HardwareSpec(**HW)
    stats = {"hit_rate": 0.4, "mean_prompt_len": 9.0, "mean_budget": 7.5}
    for paged, prefix in ((False, None), (True, None), (True, stats)):
        prog = _program(tcfg, paged)
        j = jmm.serving_memory_section(jcfg, prog, hardware=jhw,
                                       prefix_stats=prefix)
        t = tmm.serving_memory_section(tcfg, prog, hardware=thw,
                                       prefix_stats=prefix)
        assert t == j
        alloc = {"max_memory_allocated_bytes": 5.0,
                 "memory_allocated_bytes": 3.0}
        t2 = tmm.serving_memory_section(tcfg, prog, hardware=thw,
                                        allocator=alloc, prefix_stats=prefix)
        assert t2.pop("allocator") == alloc and t2 == j
    real = port.make_serving_step_fn(tcfg, 2, n_slots=4, max_len=24,
                                     prompt_max=12, out_max=10,
                                     prefill_chunk=3, paged=True,
                                     page_size=4, n_pages=17, device="cpu")
    stand_in = _program(tcfg, True)
    assert (real.mlen_alloc, real.max_pages_per_slot) == \
        (stand_in.mlen_alloc, stand_in.max_pages_per_slot)


def test_matched_budget_plan_matches_jax():
    """The plan over the JAX benches' mixes and a few budgets, and its
    refusal of a budget too small for one slot, with JAX's message."""
    jcfg, tcfg = _cfgs("gpt2")
    for mix in ("prefix", "mixed", "short_chat", "long_doc"):
        trace = tloadgen.make_workload(24, mix, prefill_chunk=2, load=1.2,
                                       vocab_size=128, seed=0)
        jtrace = jloadgen.make_workload(24, mix, prefill_chunk=2, load=1.2,
                                        vocab_size=128, seed=0)
        for budget in (None, 2.5e5, 1e6):
            kw = dict(n_devices=2, n_slots=4, max_len=32, prefill_chunk=2,
                      page_size=4, budget_bytes=budget)
            assert tbench.matched_budget_plan(tcfg, trace, **kw) == \
                jbench.matched_budget_plan(jcfg, jtrace, **kw)
    msgs = []
    for mod, cfg in ((jbench, jcfg), (tbench, tcfg)):
        with pytest.raises(ValueError) as e:
            mod.matched_budget_plan(cfg, trace, n_devices=2, n_slots=4,
                                    max_len=32, prefill_chunk=2,
                                    page_size=4, budget_bytes=10.0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.fixture(scope="module")
def weights():
    """The benches' default model on seeded weights, in both packages."""
    jcfg, tcfg = _cfgs("gpt2")
    tree = _tree(jcfg, 0)
    return (jcfg, jax.tree.map(jax.numpy.asarray, tree), tcfg,
            port.from_jax_params(tcfg, tree, device="cpu"))


def _recording(monkeypatch, engine_cls):
    """Record every result ``engine_cls.run`` returns, keyed by the
    engine's program (slots, paged, speculative), and the programs."""
    seen, programs = [], []
    run = engine_cls.run

    def wrapped(self, *a, **kw):
        res = run(self, *a, **kw)
        p = self.program
        seen.append(((p.n_slots, bool(p.paged), bool(p.speculative)), res))
        programs.append(p)
        return res

    monkeypatch.setattr(engine_cls, "run", wrapped)
    return seen, programs


def _completions(res):
    return sorted((c.rid, list(c.prompt), list(c.tokens))
                  for c in res.completions)


def _same_runs(jseen, tseen):
    """The last run of each engine on both sides: equal completions."""
    jlast, tlast = dict(jseen), dict(tseen)
    assert sorted(jlast) == sorted(tlast)
    for key in jlast:
        assert _completions(tlast[key]) == _completions(jlast[key]), key
        assert tlast[key].ticks == jlast[key].ticks, key


@pytest.mark.parametrize("which", ["paged", "spec"])
def test_benches_match_jax(which, weights, monkeypatch):
    """``run_paged_bench`` / ``run_spec_bench`` at the JAX defaults (one
    timed run each for the speculative bench) on the same weights: each
    engine's completions and ticks equal to its JAX twin's,
    ``outputs_match`` in both rows, the budget plan and the speculative
    prediction JAX's, and the port's report (valid) with the serving
    cost and memory sections; no graph captured on the CPU."""
    jcfg, jparams, tcfg, model = weights
    jseen, _ = _recording(monkeypatch, jengine.ServingEngine)
    tseen, programs = _recording(monkeypatch, tengine.ServingEngine)
    report = RunReport(name=f"{which}_bench")
    if which == "paged":
        j = jbench.run_paged_bench(cfg=jcfg, params=jparams,
                                   mesh=make_mesh(n_pipe=2))
        t = tbench.run_paged_bench(cfg=tcfg, model=model, report=report,
                                   device="cpu")
        assert t["budget"] == j["budget"]
        for key in ("slot_gain", "ticks_contiguous", "ticks_paged",
                    "prefix_hit_rate", "prefill_skipped_tokens", "n_cow",
                    "n_backpressure"):
            assert t[key] == j[key], key
        assert t["memory"]["paged"]["analytic"] == \
            j["memory"]["paged"]["analytic"]
    else:
        j = jbench.run_spec_bench(cfg=jcfg, params=jparams,
                                  mesh=make_mesh(n_pipe=2), reps=1)
        t = tbench.run_spec_bench(cfg=tcfg, model=model, report=report,
                                  reps=1, device="cpu")
        for key in ("acceptance_rate", "accepted_len_mean",
                    "spec_verify_visits", "ticks_spec_off", "ticks_spec_on",
                    "tick_gain", "predicted", "expected_tokens_per_tick",
                    "self_draft"):
            assert t[key] == j[key], key
    assert j["outputs_match"] and t["outputs_match"]
    _same_runs(jseen, tseen)
    manifest = report.manifest()
    validate_report(manifest)
    assert {"cost_model", "memory", "serving"} <= set(manifest)
    assert manifest["cost_model"]["schedule"] == "serving_ring"
    assert t["predicted_s_per_tick"] == \
        manifest["cost_model"]["predicted"]["step_s"] > 0
    assert len({id(p) for p in programs}) == 2
    assert all(not p.cuda_graphs and p.n_captures == 0 for p in programs)


def test_serve_bench_report_sections():
    """``run_serve_bench(report=)``: both policies' serving summaries and
    the continuous run's cost and memory sections (the CPU proxy's
    roofline, no allocator on the CPU), a report the validator accepts."""
    report = RunReport(name="serve_bench")
    row = tbench.run_serve_bench(n_requests=4, reps=1, report=report,
                                 device="cpu")
    manifest = report.manifest()
    validate_report(manifest)
    assert row["outputs_match"]
    assert manifest["cost_model"]["hardware"]["name"] == "cpu_proxy"
    assert manifest["cost_model"]["n_ticks"] == row["ticks_continuous"]
    assert manifest["memory"]["schedule"] == "serving_ring"
    assert "allocator" not in manifest["memory"]
