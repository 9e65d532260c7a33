"""The PyTorch port's ``fit`` and what it stands on, against the JAX
package on the CPU.

Against JAX (f32; seeded numpy weights in the JAX layout, loaded through
``from_jax_params``; the same numpy batches): the forward-only pipelined
eval loss at D = 2 and 4, V = 1 and 2 (within 1e-5); four steps of
``fit`` with ``grad_accum=2`` and with an ``AnomalyGuard`` plus
``FaultPlan(nan_grad_steps=(1,), nan_grad_stage=0)`` — loss history within
1e-5 relative, parameters within the AdamW bounds of
``test_torch_train.py``, the guard's report lines equal. The JAX side runs
at D = 1 on the simulated mesh (its D > 1 compile costs ~10 s more and is
held to D = 1 by its own tests); the port at D = 2.

Port-internal: a resume after a kill between write and commit and after a
preemption is bitwise equal to the unbroken run (f32, dropout 0.1:
parameters, both Adam moments, the loss history); the guarded step's skip
keeps every tensor bitwise; the anomaly budget commits the last good
state; ``grad_accum=2`` equals one step on the concatenated batch; the
metrics lines carry the JAX keys; the entry point ``train.main`` runs on
the CPU, and every unported flag and ``fit`` argument raises naming its
item."""

import contextlib
import dataclasses
import io
import json
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
    make_pipeline_loss_fn as jloss_fn)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    data as jdata, resilience as jresilience, train as jtrain)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch import (
    train as tmain)
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
    transformer_loss)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.pipeline import (
    make_pipeline_loss_fn)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    checkpoint as tcheckpoint, data as tdata, resilience as tresilience,
    train as ttrain)

SIZE = dict(dim=32, n_layers=4, n_heads=2, vocab_size=97, ffn_dim=64,
            max_seq_len=16, arch="gpt2")
B, S, M = 8, 16, 2
OPT = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=1,
           total_steps=4)
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, n_layers=SIZE["n_layers"]):
    """A JAX-layout GPT-2 pytree with seeded numpy leaves."""
    rng = np.random.default_rng(seed)
    L, d, f, v = n_layers, SIZE["dim"], SIZE["ffn_dim"], SIZE["vocab_size"]

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


def _assert_params_match(tcfg, model, jparams, n_steps):
    """AdamW's bounds (``test_torch_train.py``): 1e-4 absolute on each
    element, the k bias (an analytically zero gradient, moved by rounding
    noise on both sides) at most the learning rate a step."""
    ref = port.from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    for name, p in model.named_parameters():
        atol = (2 * OPT["learning_rate"] * n_steps
                if name.endswith("attn.k.bias") else 1e-4)
        np.testing.assert_allclose(
            p.detach().numpy(), ref.get_parameter(name).detach().numpy(),
            rtol=1e-5, atol=atol, err_msg=name)


def _guard_lines(text):
    return [ln for ln in text.splitlines() if "anomaly guard" in ln]


FIT_CASES = {
    "grad_accum": dict(grad_accum=2),
    "guard": dict(guard="guard", nan_grad_steps=(1,), nan_grad_stage=0),
}


def _fit_kw(case, mod):
    kw = dict(FIT_CASES[case])
    if kw.pop("guard", None):
        kw["guard"] = mod.AnomalyGuard()
        kw["fault_plan"] = mod.FaultPlan(
            nan_grad_steps=kw.pop("nan_grad_steps"),
            nan_grad_stage=kw.pop("nan_grad_stage"))
    return kw


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """The JAX ``fit`` of one case (4 steps, log every step, metrics on),
    run once per case and worker: (params, history, guard lines, metrics
    lines)."""
    cache = {}

    def get(case):
        if case not in cache:
            jcfg, _ = _cfgs()
            metrics = str(tmp_path_factory.mktemp("jfit") / "m.jsonl")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                params, hist = jtrain.fit(
                    jcfg, make_mesh(n_pipe=1), dtpp.ScheduleConfig("1F1B", M),
                    jax.tree.map(jnp.asarray, _tree(0)),
                    jdata.synthetic_batches(SIZE["vocab_size"], B, S, seed=1),
                    4, optimizer=jtrain.adamw(**OPT), log_every=1,
                    metrics_path=metrics, **_fit_kw(case, jresilience))
            with open(metrics) as f:
                lines = [json.loads(x) for x in f]
            cache[case] = (params, hist, _guard_lines(out.getvalue()), lines)
        return cache[case]

    return get


def _port_fit(tcfg, model, n_steps, D=2, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, hist = ttrain.fit(
            tcfg, port.ScheduleConfig("1F1B", M), D, model,
            tdata.synthetic_batches(SIZE["vocab_size"], B, S, seed=1),
            n_steps, optimizer=ttrain.adamw(**OPT), log_every=1,
            device="cpu", **kw)
    return hist, out.getvalue()


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_jax(jax_fit, tmp_path, case):
    """Four steps: the loss at every step within 1e-5 relative, the
    parameters after the last within AdamW's bounds, the guard's lines
    (total, last anomalous step, stage) equal, and the metrics lines with
    the JAX keys."""
    jparams, jhist, jlines, jmetrics = jax_fit(case)
    _, tcfg = _cfgs()
    model = port.from_jax_params(tcfg, _tree(0), device="cpu")
    metrics = str(tmp_path / "m.jsonl")
    hist, text = _port_fit(tcfg, model, 4, metrics_path=metrics,
                           **_fit_kw(case, tresilience))
    assert [s for s, _ in hist] == [s for s, _ in jhist] == [0, 1, 2, 3]
    for (_, got), (_, want) in zip(hist, jhist):
        assert abs(got - want) <= LOSS_RTOL * abs(want)
    _assert_params_match(tcfg, model, jparams, 4)
    assert _guard_lines(text) == jlines
    if case == "guard":
        assert jlines == ["step 1: anomaly guard skipped 1 step(s) (total 1, "
                          "last at step 1 in stage 0)"]
    with open(metrics) as f:
        lines = [json.loads(x) for x in f]
    assert [sorted(x) for x in lines] == [sorted(x) for x in jmetrics]


@pytest.mark.parametrize("D,V", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_pipeline_loss_fn_matches_jax(D, V):
    """The forward-only pipelined loss, 8 layers over D * V stages,
    M = 4: within 1e-5 of the JAX ``make_pipeline_loss_fn`` and of the
    port's single-device ``transformer_loss``; no autograd graph."""
    jcfg, tcfg = _cfgs(n_layers=8)
    tree = _tree(2, n_layers=8)
    rng = np.random.default_rng(3)
    tokens, targets = (rng.integers(0, SIZE["vocab_size"], (B, S))
                       for _ in range(2))
    name = "1F1B" if V == 1 else "Interleaved1F1B"
    want = float(jloss_fn(jcfg, make_mesh(n_pipe=D),
                          dtpp.ScheduleConfig(name, 4, V))(
        jax.tree.map(jnp.asarray, tree), tokens, targets))
    model = port.from_jax_params(tcfg, tree, device="cpu")
    got = make_pipeline_loss_fn(tcfg, port.ScheduleConfig(name, 4, V), D,
                                device="cpu")(model, tokens, targets)
    assert got.grad_fn is None and not got.requires_grad
    assert abs(got.item() - want) <= LOSS_RTOL * abs(want)
    single = transformer_loss(tcfg, model, torch.from_numpy(tokens),
                              torch.from_numpy(targets)).item()
    assert abs(got.item() - single) <= LOSS_RTOL * abs(single)


def test_eval_fn_runs_in_eval_mode():
    """``make_eval_fn`` drops dropout: the eval loss of a dropout config is
    its eval-mode loss; ``evaluate`` reports the mean and perplexity."""
    _, tcfg = _cfgs()
    model = port.from_jax_params(tcfg, _tree(0), device="cpu")
    sched = port.ScheduleConfig("1F1B", M)
    plain = ttrain.make_eval_fn(tcfg, sched, 2, device="cpu")
    drop = ttrain.make_eval_fn(dataclasses.replace(
        tcfg, dropout=0.1, use_flash_attention=False), sched, 2,
        device="cpu")
    data = tdata.synthetic_batches(SIZE["vocab_size"], B, S, seed=4)
    x, y = next(data)
    assert abs(plain(model, x, y).item() - drop(model, x, y).item()) <= 1e-6
    m = ttrain.evaluate(plain, model, iter([(x, y), (x, y)]), 5)
    assert m["num_batches"] == 2
    assert abs(m["perplexity"] - np.exp(m["eval_loss"])) <= 1e-6 * \
        m["perplexity"]
    with pytest.raises(ValueError, match="no batches"):
        ttrain.evaluate(plain, model, iter([]), 1)


# --- port-internal: bitwise resume, the guard, grad_accum ------------------


def _drop_cfg():
    return port.ModelConfig(**SIZE, dropout=0.1, use_flash_attention=False,
                            use_fused_xent=True)


def _resume_run(ckpt, metrics, n_steps=6, resume=False, **kw):
    model = port.from_jax_params(_drop_cfg(), _tree(0), device="cpu")
    _port_fit(_drop_cfg(), model, n_steps, checkpoint_dir=ckpt,
              checkpoint_every=2, resume=resume, metrics_path=metrics,
              dropout_seed=11, **kw)
    return model


def _losses(metrics):
    with open(metrics) as f:
        return [(x["step"], x["loss"]) for x in map(json.loads, f)]


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """Six f32 steps with dropout 0.1, checkpoints every 2 steps: the
    final committed checkpoint and the loss of every step."""
    d = tmp_path_factory.mktemp("unbroken")
    _resume_run(str(d / "ck"), str(d / "m.jsonl"))
    return (tcheckpoint.restore_checkpoint(str(d / "ck" / "step_5")),
            dict(_losses(str(d / "m.jsonl"))))


@pytest.mark.parametrize("fault", ["kill_in_save_step", "preempt_at_step"])
def test_resume_is_bitwise_equal(unbroken, tmp_path, fault):
    """A run killed between the write and the commit of step 3's save (an
    uncommitted shell; resume falls back to step 1) or preempted at step 3
    (a synchronous save), then resumed: the final parameters, both Adam
    moments, the step count and every step's loss are the unbroken run's,
    bit for bit."""
    want_state, want_losses = unbroken
    ckpt, metrics = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    plan = tresilience.FaultPlan(**{fault: 3})
    if fault == "kill_in_save_step":
        with pytest.raises(tresilience.SimulatedKill):
            _resume_run(ckpt, metrics, fault_plan=plan)
        assert not tcheckpoint.is_committed(os.path.join(ckpt, "step_3"))
    else:
        _resume_run(ckpt, metrics, fault_plan=plan)
        assert tcheckpoint.is_committed(os.path.join(ckpt, "step_3"))
    _resume_run(ckpt, metrics, resume=True)
    got = tcheckpoint.restore_checkpoint(os.path.join(ckpt, "step_5"))
    for name, t in want_state["model"].items():
        assert torch.equal(got["model"][name], t), name
    for k, st in want_state["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got["optimizer"]["state"][k][key], st[key])
    losses = _losses(metrics)
    assert sorted({s for s, _ in losses}) == list(range(6))
    assert all(loss == want_losses[s] for s, loss in losses)


def test_resume_mid_accumulation_is_bitwise_equal(tmp_path):
    """``grad_accum=2``: a run preempted at step 2, half-way through an
    accumulation (the running mean and the mini-step are in the
    checkpoint), then resumed, ends bitwise where the unbroken run
    ends."""
    def run(name, n=5, **kw):
        model = port.from_jax_params(_drop_cfg(), _tree(0), device="cpu")
        _port_fit(_drop_cfg(), model, n, checkpoint_dir=str(tmp_path / name),
                  checkpoint_every=3, grad_accum=2, dropout_seed=5, **kw)
        return model

    want = run("unbroken")
    run("broken", fault_plan=tresilience.FaultPlan(preempt_at_step=2))
    saved = tcheckpoint.restore_checkpoint(str(tmp_path / "broken" / "step_2"))
    assert int(saved["optimizer"]["mini_step"]) == 1
    assert any(a.abs().sum() > 0 for a in saved["optimizer"]["acc"])
    got = run("broken", resume=True)
    for name, t in want.state_dict().items():
        assert torch.equal(got.state_dict()[name], t), name


def _tiny_step(guard=True, **plan):
    _, tcfg = _cfgs()
    model = port.from_jax_params(tcfg, _tree(0), device="cpu")
    opt = ttrain.adamw(**dict(OPT, warmup_steps=0))
    step = ttrain.make_train_step(
        tcfg, port.ScheduleConfig("1F1B", M), 2, opt, device="cpu",
        guard=tresilience.AnomalyGuard() if guard else None,
        fault_plan=tresilience.FaultPlan(**plan) if plan else None)
    return model, opt.init(model), step


@pytest.mark.parametrize("stage", [None, 1])
def test_guard_skip_keeps_state_bitwise(stage):
    """A poisoned step leaves the parameters, both moments and the step
    count (so the learning rate) bitwise as the step before left them,
    and the counters name the step and the stage (the first stage when
    every gradient is poisoned)."""
    model, opt_state, step = _tiny_step(nan_grad_steps=(1,),
                                        nan_grad_stage=stage)
    gs = tresilience.init_guard_state(0, device="cpu")
    data = tdata.synthetic_batches(SIZE["vocab_size"], B, S, seed=1)
    loss, gs = step(model, opt_state, *next(data), gs)
    assert torch.isfinite(loss)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {k: {kk: v.clone() for kk, v in st.items()}
               for k, st in opt_state.optimizer.state.items()}
    loss, gs = step(model, opt_state, *next(data), gs)
    assert torch.isfinite(loss) == (stage is not None)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    for k, st in opt_state.optimizer.state.items():
        for kk, v in st.items():
            assert torch.equal(v, moments[k][kk]), kk
    assert opt_state.count.item() == 1
    assert {k: int(v) for k, v in gs.items()} == {
        "step": 2, "consec": 1, "total": 1, "last_anomaly_step": 1,
        "last_bad_stage": 0 if stage is None else stage}
    lr = opt_state.lr.clone()  # the rate the skipped update was given
    step(model, opt_state, *next(data), gs)
    assert opt_state.count.item() == 2 and torch.equal(opt_state.lr, lr)


def test_nan_grads_need_the_guard():
    with pytest.raises(ValueError, match="AnomalyGuard"):
        _tiny_step(guard=False, nan_grad_steps=(1,))
    with pytest.raises(ValueError, match="out of range"):
        _tiny_step(nan_grad_steps=(1,), nan_grad_stage=2)


def test_anomaly_budget_commits_last_good_state(tmp_path):
    """Three poisoned steps in a row under ``max_consecutive=3`` raise
    ``AnomalyBudgetExceeded`` after committing the state step 0 left."""
    _, tcfg = _cfgs()
    model = port.from_jax_params(tcfg, _tree(0), device="cpu")
    ref = port.from_jax_params(tcfg, _tree(0), device="cpu")
    _port_fit(tcfg, ref, 1)
    ckpt = str(tmp_path / "ck")
    with pytest.raises(tresilience.AnomalyBudgetExceeded, match="checkpoint"):
        _port_fit(tcfg, model, 6, checkpoint_dir=ckpt,
                  guard=tresilience.AnomalyGuard(max_consecutive=3),
                  fault_plan=tresilience.FaultPlan(nan_grad_steps=(1, 2, 3)))
    assert tcheckpoint.is_committed(os.path.join(ckpt, "step_3"))
    saved = tcheckpoint.restore_checkpoint(os.path.join(ckpt, "step_3"))
    assert int(saved["guard"]["consec"]) == 3
    for name, t in ref.state_dict().items():
        assert torch.equal(saved["model"][name], t), name
        assert torch.equal(model.state_dict()[name], t), name


def test_grad_accum_equals_the_concatenated_batch():
    """``MultiSteps(k=2)`` over two batches of 4 against one AdamW step on
    the two concatenated (8): the mean loss within 1e-5 relative and every
    parameter within phase 4's leaf bound after the update."""
    _, tcfg = _cfgs()
    sched = port.ScheduleConfig("1F1B", M)
    opt = ttrain.adamw(**dict(OPT, warmup_steps=0))
    x, y = next(tdata.synthetic_batches(SIZE["vocab_size"], B, S, seed=9))
    big = port.from_jax_params(tcfg, _tree(0), device="cpu")
    big_state = opt.init(big)
    want = ttrain.make_train_step(tcfg, sched, 2, opt, device="cpu")(
        big, big_state, x, y).item()
    acc = port.from_jax_params(tcfg, _tree(0), device="cpu")
    multi = ttrain.MultiSteps(opt, 2)
    acc_state = multi.init(acc)
    step = ttrain.make_train_step(tcfg, sched, 2, multi, device="cpu")
    before = {n: p.detach().clone() for n, p in acc.named_parameters()}
    l0 = step(acc, acc_state, x[:4], y[:4]).item()
    for n, p in acc.named_parameters():  # the first mini-step: no update
        assert torch.equal(p, before[n]), n
    l1 = step(acc, acc_state, x[4:], y[4:]).item()
    assert abs((l0 + l1) / 2 - want) <= LOSS_RTOL * abs(want)
    assert int(acc_state.mini_step) == 0 and acc_state.inner.count.item() == 1
    g_norm = sum((p.detach() - before[n]).double().norm() ** 2
                 for n, p in big.named_parameters()) ** 0.5
    for n, p in acc.named_parameters():
        ref = big.get_parameter(n).detach().double()
        err = (p.detach().double() - ref).norm()
        move = (ref - before[n].double()).norm()
        assert err <= 1e-4 * move + 1e-6 * g_norm, n


# --- the entry point -------------------------------------------------------

TINY = ["--model", "ref", "--layers", "2", "--dim", "32", "--heads", "2",
        "--vocab", "64", "--ffn", "64", "--seq", "16", "--batch", "4",
        "--steps", "2", "--pipe", "2", "--microbatches", "2",
        "--device", "cpu"]


@pytest.mark.parametrize("data", ["synthetic", "file", "native"])
def test_train_main_runs_on_cpu(tmp_path, data):
    """Two steps of ``--model ref`` through ``main``: metrics and eval
    lines, a committed final checkpoint that ``--resume`` reads back."""
    extra = []
    if data != "synthetic":
        path = str(tmp_path / "tok.bin")
        tdata.write_token_file(path, np.random.default_rng(0).integers(
            0, 64, 4000))
        extra = ["--data-file", path]
        if data == "native":
            extra.append("--native-loader")
    metrics, ckpt = str(tmp_path / "m.jsonl"), str(tmp_path / "ck")
    assert tmain.main(TINY + extra + [
        "--metrics", metrics, "--ckpt", ckpt, "--eval-every", "1",
        "--eval-batches", "1", "--anomaly-guard"]) == 0
    with open(metrics) as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines if "loss" in x] == [0, 1]
    assert [x["step"] for x in lines if "eval_loss" in x] == [0, 1]
    assert all(np.isfinite(x.get("loss", x.get("eval_loss"))) for x in lines)
    assert tcheckpoint.is_committed(os.path.join(ckpt, "step_1"))
    assert tmain.main(TINY + ["--steps", "1", "--resume", ckpt]) == 0


@pytest.mark.parametrize("argv,error,match", [
    (["--ep", "2"], ValueError,
     "mesh has an 'expert' axis but no MoEConfig given"),
    (["--fsdp"], ValueError, "needs a 'data' mesh axis"),
    (["--fsdp", "--zero1"], ValueError, "subsumes ZeRO-1"),
])
def test_unported_flags_raise(argv, error, match):
    """``--ep`` without ``--moe-experts`` raises JAX's ``ValueError``
    (before a world starts; MoE runs, composed with every axis, in
    ``tests/test_torch_moe.py`` and ``tests/test_torch_moe_par.py``);
    ``--fsdp`` runs (``tests/test_torch_fsdp.py``) but needs a data axis
    and refuses ZeRO-1, as the JAX script does."""
    with pytest.raises(error, match=match):
        tmain.main(TINY + argv)


@pytest.mark.parametrize("argv,message", [
    (["--tp", "2"], "pass --backend"),
    (["--sp", "2"], "pass --backend"),
    (["--vocab-parallel"], "requires --tp > 1"),
])
def test_tp_flags_need_a_world(argv, message, capsys):
    """``--tp`` runs one process per model coordinate, so it needs a
    backend; ``--vocab-parallel`` needs ``--tp`` above 1 (the JAX
    script's rule)."""
    with pytest.raises(SystemExit):
        tmain.main(TINY + argv)
    assert message in capsys.readouterr().err


def test_fit_vocab_parallel_needs_a_model_axis():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="'model' mesh axis"):
        ttrain.fit(tcfg, port.ScheduleConfig("1F1B", M), 2, None, iter([]),
                   1, device="cpu", tp_vocab_parallel=True)


@pytest.mark.parametrize("kw,error,match", [
    (dict(fsdp=True), ValueError, "needs a 'data' mesh axis"),
    (dict(sp_attn_impl="ulysses_v2"), ValueError, "sp_attn_impl"),
    (dict(fsdp=True, zero1=True), ValueError, "subsumes ZeRO-1"),
])
def test_fit_unported_arguments_raise(kw, error, match):
    """``fsdp`` and ``sp_attn_impl`` run in a world
    (``tests/test_torch_fsdp.py``, ``tests/test_torch_seq_parallel.py``,
    with MoE ``tests/test_torch_moe_par.py``) and keep JAX's refusals."""
    _, tcfg = _cfgs()
    with pytest.raises(error, match=match):
        ttrain.fit(tcfg, port.ScheduleConfig("1F1B", M), 2, None, iter([]),
                   1, device="cpu", **kw)


WORLD = ["--model", "gpt2-small", "--layers", "4", "--dim", "32", "--heads",
         "2", "--vocab", "97", "--seq", "16", "--batch", "8", "--steps", "4",
         "--pipe", "2", "--data", "2", "--microbatches", "2", "--device",
         "cpu", "--backend", "gloo", "--eval-every", "2", "--eval-batches",
         "1", "--ckpt-every", "1", "--anomaly-guard", "--prefetch", "0"]


def test_train_world_resumes_bitwise_after_a_kill(tmp_path):
    """``train.py --pipe 2 --data 2 --backend gloo`` on the CPU: a world of
    4 processes with an eval every 2 steps and a checkpoint a step, killed
    (the launcher's whole process group) once step 1 is committed, then
    resumed with ``--auto-resume``: its last checkpoint (every rank's
    file: model, optimizer, guard, step) equals the unbroken run's
    bitwise. The unbroken and the killed run go side by side."""
    import signal
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m",
           "distributed_training_with_pipeline_parallelism_tpu_torch.train",
           *WORLD]
    full, killed = str(tmp_path / "full"), str(tmp_path / "killed")
    runs = [subprocess.Popen(cmd + ["--ckpt", ck], cwd=root, env=env,
                             start_new_session=True, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for ck in (full, killed)]
    try:
        marker = os.path.join(killed, "step_1", "_COMMITTED.json")
        deadline = time.monotonic() + 120
        while not os.path.exists(marker) and runs[1].poll() is None:
            assert time.monotonic() < deadline, "step 1 never committed"
            time.sleep(0.05)
        os.killpg(runs[1].pid, signal.SIGKILL)
        runs[1].wait(timeout=30)
        out, _ = runs[0].communicate(timeout=120)
        assert runs[0].returncode == 0, out
    finally:
        for r in runs:
            if r.poll() is None:
                os.killpg(r.pid, signal.SIGKILL)
                r.wait()
    assert runs[1].returncode == -signal.SIGKILL
    assert "step 1: eval_loss" in out and "final loss" in out
    assert not tcheckpoint.is_committed(os.path.join(killed, "step_3"))
    res = subprocess.run(cmd + ["--ckpt", killed, "--auto-resume"], cwd=root,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "resumed from" in res.stdout
    for name in ("state_pipe0.pt", "state_pipe1.pt"):
        a, b = (torch.load(os.path.join(ck, "step_3", name),
                           weights_only=True) for ck in (full, killed))
        assert a["step"] == b["step"] == 3
        flat_a = dict(tresilience._leaves(a))
        flat_b = dict(tresilience._leaves(b))
        assert flat_a.keys() == flat_b.keys()
        for k, v in flat_a.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, flat_b[k]), (name, k)
            else:
                assert v == flat_b[k], (name, k)


def test_resume_flag_rejects_a_foreign_dir(tmp_path):
    with pytest.raises(SystemExit, match="not a checkpoint"):
        tmain.main(TINY + ["--resume", str(tmp_path)])
