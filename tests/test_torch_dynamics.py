"""The port's training dynamics against the JAX package on the CPU.

A tiny untied GPT-2 (2 layers, dim 32) at D = 2, M = 2, seeded numpy
weights in the JAX layout loaded through ``from_jax_params``, one numpy
batch:

- under GPipe, 1F1B and ZBH1 the port's ``make_pipeline_grad_fn(...,
  dynamics=True)`` gives the dynamics-off step's loss and gradients bit
  for bit, and its ``sq_mb`` and ``stage_stats`` (with parameters and an
  update) are within 1e-5 relative of the JAX executor's and
  ``stage_stats`` (its scan executor, on the simulated mesh);
- the refusals (tied embeddings, a model axis, the 1-stage path, the
  stored GPipe backward) raise ``ValueError`` as JAX's do;
- ``gns_estimates``, ``GNSEstimator``, ``batch_digest``,
  ``ForensicRecorder`` (its z-scores and its bundle files),
  ``validate_forensic_bundle`` and ``dynamics_section`` equal JAX's
  exactly;
- four ``fit(dynamics=...)`` steps with NaN gradients in stage 1 at step
  2 under the guard and a loss spike at step 3: the ``dynamics`` events
  and the manifest's ``dynamics`` section within 1e-5 of JAX ``fit``'s,
  the same ``anomaly_attributed`` and ``loss_spike`` events and the same
  bundle triggers;
- ``fit``, ``make_train_step``, ``train.main --dynamics`` and the sweep's
  ``dynamics=True`` run on the CPU.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipeline import (
    make_pipeline_grad_fn as jgrad_fn)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    dynamics as jdyn, resilience as jres, sweep as jsweep, train as jtrain)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch import (
    train as tmain)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    pipeline as tpipe)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    dynamics as tdyn, resilience as tres, sweep as tsweep, telemetry as ttm,
    train as ttrain)

SIZE = dict(dim=32, n_layers=2, n_heads=2, vocab_size=97, ffn_dim=64,
            max_seq_len=16, arch="gpt2")
B, S, M, D = 8, 16, 2, 2
RTOL = 1e-5
OPT = dict(learning_rate=1e-3, weight_decay=0.1, warmup_steps=1,
           total_steps=8)
SCHEDULES = ("GPipe", "1F1B", "ZBH1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed):
    """A JAX-layout untied GPT-2 pytree with seeded numpy leaves."""
    rng = np.random.default_rng(seed)
    L, d, f, v = SIZE["n_layers"], SIZE["dim"], SIZE["ffn_dim"], \
        SIZE["vocab_size"]

    def r(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lin(i, o):
        return {"w": r(L, i, o, scale=i ** -0.5), "b": r(L, o, scale=0.1)}

    def ln(*lead):
        return {"scale": 1 + r(*lead, d, scale=0.1),
                "bias": r(*lead, d, scale=0.1)}

    return {"embed": {"tok": r(v, d, scale=0.5),
                      "pos": r(SIZE["max_seq_len"], d, scale=0.1)},
            "layers": {"ln1": ln(L), "ln2": ln(L),
                       "attn": {n: lin(d, d) for n in "qkvo"},
                       "lin1": lin(d, f), "lin2": lin(f, d)},
            "head": {"norm": ln(), "out": {"w": r(d, v, scale=d ** -0.5)}}}


def _cfgs(**kw):
    size = dict(SIZE, **kw)
    return (dtpp.ModelConfig(**size, use_flash_attention=False),
            port.ModelConfig(**size, use_flash_attention=True,
                             use_fused_xent=True))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, SIZE["vocab_size"], (B, S)).astype(np.int32),
            rng.integers(0, SIZE["vocab_size"], (B, S)).astype(np.int32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_dyn():
    """Per schedule: the JAX executor's (loss, stage_stats with params and
    an update of 1e-3 * grads, sq_mb), as numpy."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(jnp.asarray, _tree(0))
    tokens, targets = _batch(1)
    # one compile for the three schedules (op by op, each op compiles)
    stats = jax.jit(lambda grads, params: jdyn.stage_stats(
        jcfg.n_layers, D, grads, params=params,
        updates=jax.tree.map(lambda g: 1e-3 * g, grads)))
    out = {}
    for name in SCHEDULES:
        fn = jax.jit(jgrad_fn(jcfg, make_mesh(n_pipe=D),
                              dtpp.ScheduleConfig(name, M), dynamics=True,
                              unroll_ticks=False))
        loss, grads, sq_mb = fn(params, tokens, targets)
        out[name] = (float(loss), _np(stats(grads, params)),
                     np.asarray(sq_mb))
    return out


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12,
                               err_msg=what)


@pytest.mark.parametrize("name", SCHEDULES)
def test_sq_mb_and_stage_stats_match_jax(jax_dyn, name):
    """The dynamics step is the plain step bit for bit; its ``sq_mb`` and
    the port's ``stage_stats`` are the JAX executor's within 1e-5."""
    jloss, jst, jsq = jax_dyn[name]
    _, tcfg = _cfgs()
    model = port.from_jax_params(tcfg, _tree(0), device="cpu")
    tokens, targets = _batch(1)
    sched = port.ScheduleConfig(name, M)
    plain = port.make_pipeline_grad_fn(tcfg, sched, D, device="cpu")
    loss0 = plain(model, tokens, targets)
    grads0 = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    dyn = port.make_pipeline_grad_fn(tcfg, sched, D, device="cpu",
                                     dynamics=True)
    loss, sq_mb = dyn(model, tokens, targets)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(p.grad, g)
               for p, g in zip(model.parameters(), grads0))
    assert abs(float(loss) - jloss) <= RTOL * abs(jloss)
    assert sq_mb.dtype == torch.float32 and sq_mb.shape == (M,)
    _close(sq_mb.numpy(), jsq, what="sq_mb")
    named = dict(model.named_parameters())
    st = tdyn.stage_stats(
        tcfg.n_layers, D, {n: p.grad for n, p in named.items()},
        params={n: p.detach() for n, p in named.items()},
        updates={n: 1e-3 * p.grad for n, p in named.items()})
    assert set(st) == set(jst)
    for k, v in jst.items():
        if k == "nonfinite_per_stage":
            assert st[k].tolist() == v.tolist()
        else:
            _close(st[k].numpy(), v, what=k)


def test_refusals_match_jax():
    """Tied embeddings, a model axis, the 1-stage path and the stored
    GPipe backward raise as the JAX executor does."""
    jcfg, tcfg = _cfgs()
    jtied, ttied = _cfgs(tie_embeddings=True)
    sched = port.ScheduleConfig("1F1B", M)
    jsched = dtpp.ScheduleConfig("1F1B", M)
    cases = [
        (lambda: jgrad_fn(jtied, make_mesh(n_pipe=D), jsched, dynamics=True),
         lambda: port.make_pipeline_grad_fn(ttied, sched, D, device="cpu",
                                            dynamics=True)),
        (lambda: jgrad_fn(jcfg, make_mesh(n_pipe=D),
                          dtpp.ScheduleConfig("GPipe", M), dynamics=True,
                          remat_backward=False),
         lambda: port.make_pipeline_grad_fn(
             tcfg, port.ScheduleConfig("GPipe", M), D, device="cpu",
             dynamics=True, remat_backward=False)),
    ]
    for jfn, tfn in cases:
        with pytest.raises(ValueError) as je:
            jfn()
        with pytest.raises(ValueError) as te:
            tfn()
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as je:
        jgrad_fn(jcfg, make_mesh(n_pipe=D, n_model=2), jsched, dynamics=True)
    with pytest.raises(ValueError) as te:
        tpipe._check_dynamics(tcfg, object(), False, None, False, "wrap",
                              "1F1B", D)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="1-stage fast path"):
        jgrad_fn(jcfg, make_mesh(n_pipe=1), jsched, dynamics=True)
    with pytest.raises(ValueError, match="1-stage fast path"):
        port.make_pipeline_grad_fn(tcfg, sched, 1, device="cpu",
                                   dynamics=True)
    # with remat_backward=True the 1-stage step runs the tick executor
    model = port.from_jax_params(tcfg, _tree(0), device="cpu")
    fn = port.make_pipeline_grad_fn(tcfg, sched, 1, remat_backward=True,
                                    device="cpu", dynamics=True)
    assert fn(model, *_batch(1))[1].shape == (M,)


def test_gns_and_digest_equal_jax():
    """``gns_estimates`` and a ``GNSEstimator`` fed the same pairs (a
    non-finite one among them) are JAX's to the bit; ``batch_digest``
    too, a CPU tensor hashing as its numpy array."""
    pairs = [(4.0, 1.5), (3.5, 1.2), (float("nan"), 1.0), (2.0, 1.9),
             (1.0, 1.2)]
    for p in pairs[:2]:
        assert tdyn.gns_estimates(*p, 32.0, 128.0) == \
            jdyn.gns_estimates(*p, 32.0, 128.0)
    with pytest.raises(ValueError) as je:
        jdyn.gns_estimates(1.0, 1.0, 8, 8)
    with pytest.raises(ValueError) as te:
        tdyn.gns_estimates(1.0, 1.0, 8, 8)
    assert str(te.value) == str(je.value)
    j, t = jdyn.GNSEstimator(32, 128, ema=0.8), tdyn.GNSEstimator(32, 128,
                                                                  ema=0.8)
    for p in pairs:
        assert t.update(*p) == j.update(*p)
        assert (t.g2_ema, t.s_ema, t.n_updates) == \
            (j.g2_ema, j.s_ema, j.n_updates)
    with pytest.raises(ValueError) as je:
        jdyn.GNSEstimator(8, 8)
    with pytest.raises(ValueError) as te:
        tdyn.GNSEstimator(8, 8)
    assert str(te.value) == str(je.value)
    tokens, targets = _batch(3)
    assert tdyn.batch_digest(tokens, targets) == \
        jdyn.batch_digest(tokens, targets) == \
        tdyn.batch_digest(torch.from_numpy(tokens), torch.from_numpy(targets))
    assert tdyn.as_dynamics_config(True) == tdyn.DynamicsConfig()
    assert tdyn.as_dynamics_config(None) is None
    with pytest.raises(TypeError):
        tdyn.as_dynamics_config("yes")


def _bundles():
    ok = {"schema_version": 1, "kind": "forensic_bundle", "trigger": "anomaly",
          "step": 3, "ring": [{"step": 1, "loss": 2.0}],
          "batch_digests": [{"step": 1, "digest": "ab"}],
          "attribution": {"stage": 1, "statistic": "nonfinite_grad"}}
    bad = [None, dict(ok, kind="x"), dict(ok, schema_version=2),
           dict(ok, trigger="boom"), dict(ok, step="3"), dict(ok, ring={}),
           dict(ok, ring=[{"loss": 1.0}]), dict(ok, batch_digests=[{}]),
           dict(ok, attribution=[]), dict(ok, attribution={"stage": "1"}),
           dict(ok, attribution={"stage": 1, "statistic": 2})]
    return ok, bad


def test_recorder_validator_and_section_equal_jax(tmp_path, jax_dyn):
    """The spike detector's z-scores, the bundle files, the validator's
    verdicts and messages, and ``dynamics_section`` equal JAX's."""
    ok, bad = _bundles()
    jdyn.validate_forensic_bundle(ok)
    tdyn.validate_forensic_bundle(ok)
    for b in bad:
        with pytest.raises(ValueError) as je:
            jdyn.validate_forensic_bundle(b)
        with pytest.raises(ValueError) as te:
            tdyn.validate_forensic_bundle(b)
        assert str(te.value) == str(je.value)
    _, jst, _ = jax_dyn["1F1B"]
    stats = {k: v for k, v in jst.items()}
    recs = (jdyn.ForensicRecorder(str(tmp_path / "j"), ring=4, spike_z=2.0,
                                  warmup=3),
            tdyn.ForensicRecorder(str(tmp_path / "t"), ring=4, spike_z=2.0,
                                  warmup=3))
    losses = [4.0, 4.1, 3.9, 4.0, 9.0, float("nan"), 4.05]
    for i, loss in enumerate(losses):
        for r in recs:
            r.note_batch(i, f"d{i}")
        zs = [r.observe(i, loss, stats=stats, gns=0.5) for r in recs]
        assert zs[0] == zs[1]
    paths = [r.dump(4, "loss_spike", loss=9.0, z=3.0, stats=stats,
                    checkpoint={"last_committed_step": 2}) for r in recs]
    with open(paths[0]) as fj, open(paths[1]) as ft:
        assert ft.read() == fj.read()
    for r in recs:
        with pytest.raises(ValueError):
            r.dump(1, "other")
    tsec = tdyn.dynamics_section(D, last_stats=stats, gns=1.5,
                                 gns_updates=3, n_skipped_attributed=1,
                                 forensic_bundles=paths[1:])
    jsec = jdyn.dynamics_section(D, last_stats=stats, gns=1.5,
                                 gns_updates=3, n_skipped_attributed=1,
                                 forensic_bundles=paths[1:])
    assert tsec == jsec
    assert tdyn.dynamics_section(D) == jdyn.dynamics_section(D)


def _spike_data():
    """Three steps on one batch, then a batch whose targets are the tokens
    the initial model rates least likely: the loss jumps at step 3."""
    a = _batch(5)
    tokens = _batch(6)[0]
    _, tcfg = _cfgs()
    model = port.from_jax_params(tcfg, _tree(0), device="cpu")
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    return [a, a, a, (tokens, logits.argmin(-1).numpy().astype(np.int32))]


def _fit_kw(mod, report_dir):
    return dict(log_every=1, guard=mod.AnomalyGuard(),
                fault_plan=mod.FaultPlan(nan_grad_steps=(2,),
                                         nan_grad_stage=1),
                report_dir=report_dir, verbose=False)


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """JAX ``fit``'s manifest, events and bundle files (D = 2, scan
    executor)."""
    jcfg, _ = _cfgs()
    out = str(tmp_path_factory.mktemp("jdyn"))
    jtrain.fit(jcfg, make_mesh(n_pipe=D), dtpp.ScheduleConfig("1F1B", M),
               jax.tree.map(jnp.asarray, _tree(0)), iter(_spike_data()), 4,
               optimizer=jtrain.adamw(**OPT), unroll_ticks=False,
               dynamics=jdyn.DynamicsConfig(spike_z=3.0, spike_warmup=2),
               **_fit_kw(jres, out))
    return _run_record(out)


def _run_record(out):
    with open(os.path.join(out, "report.json")) as fh:
        manifest = json.load(fh)
    with open(os.path.join(out, "events.jsonl")) as fh:
        events = [json.loads(x) for x in fh]
    bundles = sorted(f for f in os.listdir(out) if f.startswith("forensics"))
    return manifest, events, bundles


def _num_close(got, want, what):
    """Nested JSON values equal, numbers within 1e-5 relative (NaN with
    NaN)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _num_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _num_close(g, w, f"{what}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        if math.isnan(want):
            assert math.isnan(got), what
        else:
            assert abs(got - want) <= RTOL * abs(want) + 1e-12, \
                (what, got, want)
    else:
        assert got == want, (what, got, want)


def test_fit_dynamics_matches_jax(jax_fit, tmp_path):
    """The port's ``fit`` on the same weights, batches and faults: the
    same dynamics, attribution, spike and bundle events (numbers within
    1e-5), the manifest's section within 1e-5 (the update ratio: the
    parameters' move, within 1e-4 of optax's update), the same bundles,
    each valid."""
    jman, jev, jbundles = jax_fit
    _, tcfg = _cfgs()
    model = port.from_jax_params(tcfg, _tree(0), device="cpu")
    out = str(tmp_path)
    ttrain.fit(tcfg, port.ScheduleConfig("1F1B", M), D, model,
               iter(_spike_data()), 4, optimizer=ttrain.adamw(**OPT),
               device="cpu",
               dynamics=tdyn.DynamicsConfig(spike_z=3.0, spike_warmup=2),
               **_fit_kw(tres, out))
    man, ev, bundles = _run_record(out)
    ttm.validate_report(man)
    kinds = ("dynamics", "anomaly_attributed", "loss_spike",
             "forensic_bundle", "anomaly")

    def pick(events):
        return [{k: v for k, v in e.items() if k not in ("t", "bundle")}
                for e in events if e["kind"] in kinds]

    _num_close(pick(ev), pick(jev), "events")
    assert [e["kind"] for e in ev if e["kind"] in kinds].count(
        "loss_spike") == 1
    assert bundles == jbundles == ["forensics_step000002_anomaly.json",
                                   "forensics_step000003_loss_spike.json"]
    for f in bundles:
        with open(os.path.join(out, f)) as fh:
            tdyn.validate_forensic_bundle(json.load(fh))
    sec, jsec = dict(man["dynamics"]), dict(jman["dynamics"])
    for row, jrow in zip(sec["per_stage"], jsec["per_stage"]):
        r = row.pop("update_ratio")
        jr = jrow.pop("update_ratio")
        assert abs(r - jr) <= 1e-4 * jr
    _num_close(sec, jsec, "dynamics")
    # the skipped step's non-finite pair is not fed to the estimator
    assert sec["gns"] is not None and sec["gns_updates"] == 3
    assert sec["n_skipped_attributed"] == 1


def test_train_step_and_entry_point_dynamics(tmp_path):
    """``make_train_step(dynamics=True)`` returns the stats beside the
    loss and takes the dynamics-off step's update bit for bit;
    ``train.main --dynamics`` writes a report whose section validates
    (the prefetched batches carry their host digests)."""
    _, tcfg = _cfgs()
    sched = port.ScheduleConfig("1F1B", M)
    tokens, targets = _batch(1)
    models, losses = [], []
    for dyn in (None, True):
        model = port.from_jax_params(tcfg, _tree(0), device="cpu")
        opt = port.adamw(**OPT)
        step = port.make_train_step(tcfg, sched, D, opt, device="cpu",
                                    dynamics=dyn)
        state = opt.init(model)
        for _ in range(2):
            out = step(model, state, tokens, targets)
        losses.append(out if dyn is None else out[0])
        models.append(model)
    st = out[1]
    assert {"grad_norm", "sq_mb", "update_ratio_per_stage",
            "param_rms_per_stage"} <= set(st)
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(a, b) for a, b in zip(models[0].parameters(),
                                                 models[1].parameters()))
    assert float(st["update_ratio_per_stage"].min()) > 0
    rep = tmp_path / "run"
    assert tmain.main(["--model", "gpt2-small", "--layers", "2", "--dim",
                       "32", "--heads", "2", "--vocab", "97", "--seq", "16",
                       "--batch", "4", "--steps", "3", "--pipe", "2",
                       "--microbatches", "2", "--device", "cpu",
                       "--dynamics", "--report-dir", str(rep)]) == 0
    with open(rep / "report.json") as fh:
        man = json.load(fh)
    ttm.validate_report(man)
    assert man["dynamics"]["n_stages"] == 2
    assert man["dynamics"]["gns_updates"] >= 1


def test_sweep_dynamics_columns(tmp_path):
    """A ``dynamics=True`` sweep row fills the model-health columns (one
    instrumented pass; the grad norm that of the row's step), its
    manifest's section validates, and ``summarize_dynamics`` equals
    JAX's over rows with and without the pass."""
    kw = dict(batch_size=4, seq_length=8, num_iterations=1, dim=16,
              vocab_size=64, n_microbatches=2, dynamics=True)
    trow = tsweep.run_one_experiment(2, 2, 2, "1F1B", device="cpu",
                                     report_dir=str(tmp_path), **kw)
    assert "error" not in trow, trow
    assert trow["grad_norm_final"] > 0 and trow["gns"] is not None
    assert trow["n_skipped_attributed"] == 0
    with open(tmp_path / "sweep_reports.jsonl") as fh:
        man = json.loads(fh.readline())
    ttm.validate_report(man)
    assert man["dynamics"]["gns_updates"] == 1
    rows = [dict(trow, schedule="1F1B", n_layers=2, n_heads=2,
                 num_processes=2),
            dict(trow, schedule="GPipe", grad_norm_final=None)]
    import pandas as pd
    want = jsweep.summarize_dynamics(pd.DataFrame(rows))
    assert tsweep.summarize_dynamics(rows) == want.to_dict("records")
    assert tsweep.summarize_dynamics([]) == []
