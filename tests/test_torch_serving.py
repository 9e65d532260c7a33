"""Parity of the PyTorch port's continuous-batching engine with the JAX
package on the CPU. Every admitted request's greedy tokens must equal the
JAX single-device ``generate`` of that request alone (chunked prefill and
recycled slots included), and on one trace the port's tick stamps,
tokens, occupancy and queue-depth series must equal the JAX
``ServingEngine``'s exactly, under both policies. Also: EOS retirement,
the failed-request path, the build and submit validation with the JAX
messages, the mesh refusals, and the host-side pieces (traces,
workload mixes, the latency summary, the SLO accounting) against the JAX
functions. Weights are seeded numpy trees in the JAX layout, loaded into
the port through ``from_jax_params``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models.generate import (
    make_generate_fn as jgenerate_fn)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.serving import (
    engine as jeng, loadgen as jload, slo as jslo)
from distributed_training_with_pipeline_parallelism_tpu.serving.bench import (
    synth_trace as jsynth_trace)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    resilience as jresilience)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    telemetry as jtelemetry)
from distributed_training_with_pipeline_parallelism_tpu.utils.telemetry import (
    serving_summary as jserving_summary)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch import serving
from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
    cost_model as tcm)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh)
from distributed_training_with_pipeline_parallelism_tpu_torch.serving import (
    loadgen as tload, slo as tslo)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    resilience as tresilience)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    telemetry as ttelemetry)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils.telemetry import (
    serving_summary)

SIZE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=64)
ARCHS = {"gpt2": dict(arch="gpt2"),
         "llama": dict(arch="llama", n_kv_heads=2, rope_theta=100.0,
                       rope_scaling=(4.0, 1.0, 4.0, 32))}
# prompt_max + out_max > max_len, so a request can overflow its slot
PROGRAM = dict(n_slots=3, max_len=16, prompt_max=8, out_max=10,
               prefill_chunk=2)
D = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(cfg, seed):
    """A JAX-layout parameter pytree (linear ``w`` [in, out], layer leaves
    stacked [L, ...]) with seeded numpy leaves."""
    rng = np.random.default_rng(seed)
    L, d, f, v = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size
    kv = (cfg.n_kv_heads or cfg.n_heads) * cfg.head_dim

    def r(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lin(i, o, bias):
        leaf = {"w": r(L, i, o, scale=i ** -0.5)}
        if bias:
            leaf["b"] = r(L, o, scale=0.1)
        return leaf

    def norm(*lead):
        leaf = {"scale": 1 + r(*lead, d, scale=0.1)}
        if cfg.arch == "gpt2":
            leaf["bias"] = r(*lead, d, scale=0.1)
        return leaf

    gpt2 = cfg.arch == "gpt2"
    attn = {"q": lin(d, d, gpt2), "k": lin(d, kv, gpt2),
            "v": lin(d, kv, gpt2), "o": lin(d, d, gpt2)}
    if gpt2:
        layers = {"ln1": norm(L), "ln2": norm(L), "attn": attn,
                  "lin1": lin(d, f, True), "lin2": lin(f, d, True)}
        embed = {"tok": r(v, d, scale=0.5), "pos": r(64, d, scale=0.1)}
    else:
        layers = {"rms1": norm(L), "rms2": norm(L), "attn": attn,
                  "w1": lin(d, f, False), "w2": lin(f, d, False),
                  "w3": lin(d, f, False)}
        embed = {"tok": r(v, d, scale=0.5)}
    return {"embed": embed, "layers": layers,
            "head": {"norm": norm(), "out": {"w": r(d, v, scale=d ** -0.5)}}}


@pytest.fixture(scope="module")
def models():
    """Per arch: the JAX config and parameters, and the port's config and
    model holding the same weights."""
    out = {}
    for arch, kw in ARCHS.items():
        jcfg = dtpp.ModelConfig(**SIZE, **kw)
        tree = _tree(jcfg, 0)
        tcfg = port.ModelConfig(**SIZE, **kw)
        model = port.from_jax_params(tcfg, tree, device="cpu")
        out[arch] = (jcfg, jax.tree.map(jax.numpy.asarray, tree), tcfg,
                     model)
    return out


def _requests(n, seed, prompt_lens, out_max=10, spacing=2.0):
    rng = np.random.RandomState(seed)
    return [port.Request(
        rid=i, prompt=rng.randint(0, SIZE["vocab_size"],
                                  size=int(rng.choice(prompt_lens))).tolist(),
        max_new_tokens=int(rng.randint(1, out_max + 1)),
        arrival=float(i) * spacing) for i in range(n)]


@pytest.mark.parametrize("arch,eos", [("gpt2", None), ("llama", 7)])
def test_engine_matches_jax_generate_per_request(models, arch, eos):
    """D = 2, M = 3, C = 2, seven requests with staggered arrivals, so
    retired slots are refilled mid-flight: every completion equals the
    jitted JAX ``generate`` of its request alone (greedy, cut at its
    budget, and at the EOS where there is one); the first token returns
    >= D ticks after admission and a decoding slot is revisited every M
    ticks."""
    jcfg, params, tcfg, model = models[arch]
    program = port.make_serving_step_fn(tcfg, D, eos_id=eos, device="cpu",
                                        **PROGRAM)
    requests = _requests(7, 3, prompt_lens=(3, 6))
    res = port.ServingEngine(program, model).run(requests)
    assert len(res.completions) == len(requests)
    slots = [c.slot for c in res.completions]
    assert len(set(slots)) < len(slots)  # recycled
    oracle = {}
    for plen in (3, 6):  # one JAX compile per prompt length
        batch = [r for r in requests if len(r.prompt) == plen]
        out = jgenerate_fn(
            jcfg, PROGRAM["out_max"], eos_id=eos,
            return_lengths=eos is not None, max_len=program.mlen_alloc)(
                params, np.asarray([r.prompt for r in batch], np.int32))
        toks, lens = out if eos is not None else \
            (out, [PROGRAM["out_max"]] * len(batch))
        for r, t, n in zip(batch, np.asarray(toks), lens):
            oracle[r.rid] = t[plen:plen + min(int(n), r.max_new_tokens)]
    for c in res.completions:
        assert c.status == "ok"
        assert c.tokens == oracle[c.rid].tolist(), (c.rid, c.slot)
        assert c.first_token_tick - c.admit_tick >= D
        if c.tpot_ticks is not None:
            assert c.tpot_ticks == PROGRAM["n_slots"]
    assert res.host_syncs == res.n_blocks > 0


@pytest.fixture(scope="module")
def engines(models):
    """One JAX ``ServingEngine`` (llama, D = 2, M = 3, C = 2, blocks of 7
    ticks so block ends fall at every phase of the ring) and the port's on
    the same weights and program, with an ``eos_id`` that the trace's
    greedy streams emit, so some requests retire before their budget."""
    jcfg, params, tcfg, model = models["llama"]
    trace = serving.synth_trace(10, prompt_lens=(1, 8), out_lens=(1, 10),
                                prefill_chunk=2, load=1.5,
                                vocab_size=SIZE["vocab_size"], seed=1)
    prog = dict(PROGRAM, block_ticks=7)
    free = port.ServingEngine(
        port.make_serving_step_fn(tcfg, D, device="cpu", **prog), model)
    outs = [t for c in free.run(trace).completions for t in c.tokens[1:]]
    eos = max(set(outs), key=outs.count)
    jengine = jeng.ServingEngine(
        jeng.make_serving_step_fn(jcfg, make_mesh(n_pipe=D), eos_id=eos,
                                  **prog), params)
    tengine = port.ServingEngine(
        port.make_serving_step_fn(tcfg, D, eos_id=eos, device="cpu", **prog),
        model)
    return jengine, tengine, trace, eos


def _stamps(res):
    return [(c.rid, c.slot, c.admit_tick, c.first_token_tick, c.finish_tick,
             c.tokens, c.status) for c in res.completions]


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_stamps_match_jax_engine(engines, policy):
    """The same trace through the JAX and the port engine: completions in
    the same order with the same slot, admission, first-token and finish
    ticks and tokens, and the same ticks, busy ticks, occupancy and
    queue-depth series; some requests end on the EOS before their
    budget."""
    jengine, tengine, trace, eos = engines
    jtrace = [jeng.Request(r.rid, r.prompt, r.max_new_tokens, r.arrival)
              for r in trace]
    want = jengine.run(jtrace, policy=policy)
    got = tengine.run(trace, policy=policy)
    assert _stamps(got) == _stamps(want)
    assert (got.ticks, got.busy_ticks) == (want.ticks, want.busy_ticks)
    assert got.occupancy == want.occupancy
    assert got.queue_depth == want.queue_depth
    budgets = {r.rid: r.max_new_tokens for r in trace}
    early = [c for c in got.completions
             if c.status == "ok" and len(c.tokens) < budgets[c.rid]]
    assert early and all(c.tokens[-1] == eos for c in early)


def test_static_policy_same_tokens_no_fewer_ticks(engines):
    """Same program, same trace: the fill-drain baseline emits the
    continuous run's tokens per request in at least as many ticks."""
    _, tengine, trace, _ = engines
    cont = tengine.run(trace, policy="continuous")
    stat = tengine.run(trace, policy="static")
    by_rid = {c.rid: c.tokens for c in stat.completions}
    assert all(by_rid[c.rid] == c.tokens for c in cont.completions)
    assert stat.ticks >= cont.ticks
    assert cont.tokens_out == stat.tokens_out > 0


def test_eos_retires_early_and_frees_the_slot(models):
    """With a token the request's greedy stream emits as ``eos_id``, the
    completion stops on it, before its budget, and the waiting request is
    admitted into the first slot to free."""
    _, _, tcfg, model = models["gpt2"]
    prompt = [5, 11, 2]
    plain = port.generate(tcfg, model, np.asarray([prompt]), 8,
                          device="cpu")[0, 3:].tolist()
    cand = [v for i, v in enumerate(plain) if i >= 1 and v not in plain[:i]]
    eos = cand[0] if cand else plain[0]
    k = plain.index(eos)
    program = port.make_serving_step_fn(
        tcfg, D, n_slots=2, max_len=20, prompt_max=6, out_max=8,
        prefill_chunk=1, eos_id=eos, device="cpu")
    res = port.ServingEngine(program, model).run(
        [port.Request(0, prompt, 8), port.Request(1, [3, 4], 2, 1.0),
         port.Request(2, [9], 2, 2.0)])
    c = next(c for c in res.completions if c.rid == 0)
    assert c.tokens == plain[:k + 1] and len(c.tokens) < 8
    first = min((x for x in res.completions if x.rid < 2),
                key=lambda x: x.finish_tick)
    later = next(x for x in res.completions if x.rid == 2)
    assert later.slot == first.slot and later.admit_tick >= first.finish_tick


def test_failed_requests_keep_the_ring_serving(engines):
    """A request over the slot's budget fails at submission with the JAX
    engine's reason; one whose prompt holds a token outside the
    vocabulary fails at admission; both come back ``status="failed"``
    with -1 stamps and the other requests are served as without them."""
    jengine, tengine, trace, _ = engines
    bad = [port.Request(100, [1] * 8, 10, 0.0),
           port.Request(101, [1, SIZE["vocab_size"]], 2, 0.0)]
    base = tengine.run(trace)
    got = tengine.run(list(trace) + bad)
    jbad = jengine.run([jeng.Request(100, [1] * 8, 10, 0.0)])
    failed = {c.rid: c for c in got.completions if c.status == "failed"}
    assert sorted(failed) == sorted(
        [c.rid for c in base.completions if c.status == "failed"]
        + [100, 101])
    assert got.n_failed == base.n_failed + 2
    assert failed[100].reason == jbad.completions[0].reason
    assert "overflows the slot max_len" in failed[100].reason
    assert failed[101].reason.startswith("admission failed")
    assert all(c.tokens == [] and c.finish_tick == -1
               for c in failed.values())
    assert {c.rid: c.tokens for c in got.completions if c.status == "ok"} \
        == {c.rid: c.tokens for c in base.completions if c.status == "ok"}


BUILD_ERRORS = [
    dict(arch="ref_decoder"),
    dict(n_layers=3),
    dict(n_slots=1),
    dict(prefill_chunk=0),
    dict(prompt_max=0),
    dict(prompt_max=24),
    dict(max_len=60, prefill_chunk=8),
    dict(block_ticks=-1),
]


@pytest.mark.parametrize("kw", BUILD_ERRORS)
def test_build_errors_match_jax(kw):
    """Each ``ValueError`` of the JAX ``make_serving_step_fn``, raised by
    the port with the same message."""
    kw = dict(kw)
    size = dict(SIZE, arch=kw.pop("arch", "gpt2"),
                n_layers=kw.pop("n_layers", 4))
    args = dict(PROGRAM, **kw)
    with pytest.raises(ValueError) as want:
        jeng.make_serving_step_fn(dtpp.ModelConfig(**size),
                                  make_mesh(n_pipe=D), **args)
    with pytest.raises(ValueError) as got:
        port.make_serving_step_fn(port.ModelConfig(**size), D,
                                  device="cpu", **args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("prompt,budget", [([], 2), ([1] * 9, 2),
                                           ([1], 0), ([1], 11),
                                           ([1] * 8, 17)])
def test_submit_errors_match_jax(engines, prompt, budget):
    """Each ``ValueError`` of the JAX ``ServingEngine.submit``, with the
    same message."""
    jengine, tengine, _, _ = engines
    with pytest.raises(ValueError) as want:
        jengine.submit(jeng.Request(3, prompt, budget))
    with pytest.raises(ValueError) as got:
        tengine.submit(port.Request(3, prompt, budget))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown policy"):
        tengine.run([], policy="greedy")


def test_mesh_refusals_raise(models):
    """The engine serves a (pipe 1, data 1, model T) world
    (``test_torch_tp_serving.py``): a seq axis raises the JAX executor's
    message, word for word, and a pipe axis above 1 the port's, naming
    its ROADMAP item."""
    jcfg, _, tcfg, _ = models["gpt2"]
    with pytest.raises(NotImplementedError) as want:
        jeng.make_serving_step_fn(jcfg, make_mesh(n_pipe=2, n_model=2,
                                                  n_seq=2), **PROGRAM)
    seq_world = tmesh.Mesh(1, 1, 0, "gloo", torch.device("cpu"), n_model=2,
                           n_seq=2)
    with pytest.raises(NotImplementedError) as got:
        port.make_serving_step_fn(tcfg, D, device="cpu", mesh=seq_world,
                                  **PROGRAM)
    assert str(got.value) == str(want.value)
    pipe_world = tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"), n_model=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port.make_serving_step_fn(tcfg, D, device="cpu", mesh=pipe_world,
                                  **PROGRAM)


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_fault_plan_matches_jax_engine(engines, policy):
    """One ``FaultPlan`` on both engines: poisoned admissions retire as
    ``failed`` with the JAX reason and free their slot, stragglers are
    retimed before the sort, and every completion's stamps and tokens,
    the ticks and the occupancy series equal the JAX engine's."""
    jengine, tengine, trace, _ = engines
    kw = dict(serve_poison_rids=(2, 5), serve_delay={1: 4.0, 3: 2.5})
    jtrace = [jeng.Request(r.rid, r.prompt, r.max_new_tokens, r.arrival)
              for r in trace]
    jengine.fault_plan = jresilience.FaultPlan(**kw)
    try:
        want = jengine.run(jtrace, policy=policy)
    finally:
        jengine.fault_plan = None
    tengine.fault_plan = tresilience.FaultPlan(**kw)
    try:
        got = tengine.run(trace, policy=policy)
    finally:
        tengine.fault_plan = None
    assert _stamps(got) == _stamps(want)
    assert [c.reason for c in got.completions] == \
        [c.reason for c in want.completions]
    assert (got.ticks, got.occupancy) == (want.ticks, want.occupancy)
    failed = {c.rid for c in got.completions if c.status == "failed"}
    assert failed >= {2, 5}
    assert all(c.status == "ok" for c in got.completions
               if c.rid not in failed)


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_report_events_match_jax_engine(engines, policy):
    """A ``RunReport`` on both engines over one trace with two poisoned
    admissions (and a request that overflows its slot): the same event
    stream (``serve_admit``, ``serve_failed``,
    ``serve_finish``, ``serve_run``) with the same fields, but for the
    wall clock (``t``, ``wall_s``, ``s_per_tick``), the same
    ``serve_failed`` counter, and a manifest with the serving summary
    that the port's validator accepts."""
    jengine, tengine, trace, _ = engines
    kw = dict(serve_poison_rids=(2, 5))
    jtrace = [jeng.Request(r.rid, r.prompt, r.max_new_tokens, r.arrival)
              for r in trace]
    jreport, treport = jtelemetry.RunReport(), ttelemetry.RunReport()
    jengine.report, jengine.fault_plan = jreport, jresilience.FaultPlan(**kw)
    try:
        jengine.run(jtrace, policy=policy)
    finally:
        jengine.report, jengine.fault_plan = None, None
    tengine.report, tengine.fault_plan = treport, tresilience.FaultPlan(**kw)
    try:
        got = tengine.run(trace, policy=policy)
    finally:
        tengine.report, tengine.fault_plan = None, None

    def stream(report):
        return [{k: v for k, v in row.items()
                 if k not in ("t", "wall_s", "s_per_tick")}
                for row in report.events]

    assert stream(treport) == stream(jreport)
    kinds = {row["kind"] for row in treport.events}
    assert kinds == {"serve_admit", "serve_failed", "serve_finish",
                     "serve_run"}
    assert treport.counters == jreport.counters
    assert treport.counters["serve_failed"] >= 2
    treport.attach_serving(serving_summary(got))
    ttelemetry.validate_report(treport.manifest())


def _as_tuples(trace):
    return [(r.rid, list(r.prompt), r.max_new_tokens, r.arrival)
            for r in trace]


def test_synth_trace_matches_jax():
    """``synth_trace`` gives the JAX function's requests, arrivals equal
    to the last bit, and rejects a bad length band."""
    kw = dict(prompt_lens=(1, 9), out_lens=(2, 7), prefill_chunk=3,
              load=1.2, vocab_size=50, seed=4)
    assert _as_tuples(serving.synth_trace(11, **kw)) == \
        _as_tuples(jsynth_trace(11, **kw))
    with pytest.raises(ValueError, match="invalid"):
        serving.synth_trace(3, prompt_lens=(0, 2))


@pytest.mark.parametrize("mix", sorted(jload.WORKLOAD_MIXES))
def test_workload_mix_matches_jax(mix):
    """``make_workload`` for each of the JAX package's mixes gives its
    requests, arrivals equal to the last bit."""
    assert sorted(tload.WORKLOAD_MIXES) == sorted(jload.WORKLOAD_MIXES)
    kw = dict(prefill_chunk=2, load=0.9, vocab_size=40, seed=2)
    assert _as_tuples(tload.make_workload(9, mix, **kw)) == \
        _as_tuples(jload.make_workload(9, mix, **kw))


def _synthetic_results(mod):
    comps = [mod.Completion(rid=i, prompt=[1] * (i + 1),
                            tokens=list(range(i % 4)), slot=i % 3,
                            admit_tick=2 * i + 1,
                            first_token_tick=2 * i + 4 + i % 3,
                            finish_tick=2 * i + 9 + 3 * (i % 4),
                            arrival=1.5 * i)
             for i in range(9)]
    comps.append(mod.Completion(rid=9, prompt=[1], tokens=[], slot=-1,
                                admit_tick=-1, first_token_tick=-1,
                                finish_tick=-1, arrival=3.0,
                                status="failed", reason="x"))
    return mod.ServeResult(completions=comps,
                           occupancy=[(3, 2), (6, 3), (9, 1)], ticks=40,
                           wall_s=0.25, n_slots=3, policy="continuous",
                           queue_depth=[(3, 1), (6, 4), (9, 0)],
                           busy_ticks=30)


def test_serving_summary_matches_jax():
    """``serving_summary`` equal to the JAX one on the same synthetic
    results (failed completions kept out of the percentiles)."""
    tres, jres = _synthetic_results(serving.engine), _synthetic_results(jeng)
    assert serving_summary(tres) == jserving_summary(jres)


SPECS = [dict(ttft_p99_ticks=5.0, tpot_p99_ticks=3.0, queue_depth_limit=3.0),
         dict(ttft_p99_ticks=1.0), dict(ttft_p99_ticks=100.0)]


@pytest.mark.parametrize("spec_kw", SPECS)
def test_slo_accounting_matches_jax(spec_kw):
    """``slo_attainment``, ``find_knee`` and ``serving_load_section``
    equal to the JAX functions' for one SLOSpec."""
    tspec, jspec = tslo.SLOSpec(**spec_kw), jslo.SLOSpec(**spec_kw)
    tres, jres = _synthetic_results(serving.engine), _synthetic_results(jeng)
    assert tslo.slo_attainment(tres, tspec) == \
        jslo.slo_attainment(jres, jspec)
    rows = [dict(offered_load=x, ttft_ticks={"p99": 2.0 + 2 * x},
                 tpot_ticks={"p99": 2.0}, queue_depth_max=x * 3,
                 goodput=0.5) for x in (0.25, 0.5, 1.0, 2.0)]
    knee = tslo.find_knee(rows, tspec)
    assert knee == jslo.find_knee(rows, jspec)
    assert tslo.serving_load_section(
        rows, knee, tspec, mix="mixed", n_requests=4, seed=0,
        reference_load=0.9) == jslo.serving_load_section(
            rows, knee, jspec, mix="mixed", n_requests=4, seed=0,
            reference_load=0.9)


def test_slo_spec_default_and_validation_match_jax():
    """``SLOSpec.default_for`` scales to the program's geometry as the JAX
    one does; a non-positive target raises."""
    program = port.make_serving_step_fn(
        port.ModelConfig(**SIZE, arch="gpt2"), D, device="cpu", **PROGRAM)

    class JProgram:  # the fields default_for reads
        n_slots, n_stages = program.n_slots, program.n_stages
        prefill_chunk, prompt_max = program.prefill_chunk, program.prompt_max

    assert tslo.SLOSpec.default_for(program) == \
        tslo.SLOSpec(**dataclasses.asdict(jslo.SLOSpec.default_for(JProgram)))
    with pytest.raises(ValueError, match="ttft_p99_ticks"):
        tslo.SLOSpec(ttft_p99_ticks=0)


def test_bench_row_and_load_sweep(models):
    """``run_serve_bench`` on the port's default small model: both
    policies emit the same tokens and static takes no fewer ticks;
    ``sweep_offered_load`` over two loads returns the section with its
    knee and each point's predicted tick time, the serving cost model's
    on the CPU proxy."""
    row = serving.run_serve_bench(n_requests=6, reps=1, device="cpu")
    assert row["outputs_match"] and row["tick_gain"] >= 1.0
    assert row["continuous"]["n_requests"] == 6
    _, _, tcfg, model = models["gpt2"]
    engine = port.ServingEngine(port.make_serving_step_fn(
        tcfg, D, device="cpu", **dict(PROGRAM, prompt_max=12, out_max=11)),
        model)
    sec = tload.sweep_offered_load(engine, [0.5, 1.5], n_requests=6)
    assert sec["offered_loads"] == [0.5, 1.5] and "knee" in sec
    assert [r["n_requests"] + r["n_failed"] for r in sec["curve"]] == [6, 6]
    want = tcm.serving_cost_model_section(
        tcfg, D, engine.program.n_slots, sec["curve"][0]["summary"],
        hardware=tcm.CPU_PROXY)["predicted"]["step_s"]
    assert want > 0
    assert all(r["predicted_s_per_tick"] == want for r in sec["curve"])
    with pytest.raises(ValueError, match="strictly increasing"):
        tload.sweep_offered_load(engine, [1.0, 0.5])
