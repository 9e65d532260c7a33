"""Mixture-of-Experts in the port on the CPU (no world), held to the JAX
package's ``models/moe.py`` and its MoE pipeline on the simulated mesh.

- (b) ``route`` (dispatch exact; combine and aux within 1e-6),
  ``moe_ffn_apply`` and ``moe_lm_loss`` (loss within 1e-5, gradients 2e-5)
  with tight capacity and drops, ``embed_scale``, ``pad_token_id`` and
  tied embeddings (JAX ``test_moe.py``, ``test_padding.py:141,228``).
- (c) The lockstep MoE pipeline (``make_pipeline_grad_fn(moe=)``) under
  GPipe, 1F1B, Interleaved1F1B (V = 2), ZBH1 and the stored backward,
  tied and untied, against the JAX oracle the JAX executor is held to at
  2e-5, the mean over microbatches of ``moe_lm_loss`` (capacity and
  routing statistics are a microbatch's; ``test_moe_pipeline.py:56,186,
  259``): loss 1e-5, gradients 2e-5 (``tests/test_torch_moe_ep.py`` holds
  the port to JAX's ``make_pipeline_step(moe=)`` itself on the pp x ep
  mesh). The padded step against ``test_padding.py:141``'s oracle.
  Dropout: the port's masks do not depend on (D, V) (D = 1, D = 2 and
  V = 2 within 2e-5) and train mode differs from eval mode
  (``test_moe_pipeline.py:219``).
- (d) The MoE eval (``make_pipeline_loss_fn(moe=)``, ``make_eval_fn``):
  the cross entropy only, within 2e-5 of the JAX CE oracle that JAX's MoE
  eval is held to (``test_eval.py:196-240``).
- (e) ``fit(moe=)``: SGD for 4 steps equals the port's own step loop
  bitwise, and a run killed in a save and resumed ends bitwise where the
  unbroken one does.
- (g) The refusals and their messages (JAX's; MoE's compositions with
  TP, FSDP, seq and ZeRO-1 run in ``tests/test_torch_moe_par.py``).

Sizes are the JAX tests': gpt2, dim 32, 4 layers, 4 heads, vocab 64, ffn
64, batch 8, seq 8; weights in the JAX ``moe_lm_init`` layout with
seeded numpy leaves (through ``from_jax_params``), batches from numpy
with a seed.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    moe as jmoe)
from distributed_training_with_pipeline_parallelism_tpu.ops.layers import (
    masked_xent_sum as jmasked_xent_sum, select_xent as jselect_xent)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models import (
    moe as tmoe)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh)
from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
    data as tdata, resilience as tres, train as ttrain)
from test_torch_train import _one_torch_thread  # noqa: F401

BASE = dict(dim=32, n_layers=4, n_heads=4, vocab_size=64, ffn_dim=64,
            max_seq_len=16, arch="gpt2")
B, S, M = 8, 8, 4
PAD = 0
MOE = dict(n_experts=4, top_k=2, capacity_factor=4.0, aux_loss_weight=0.05)
# (schedule, V, remat_backward): every schedule JAX runs MoE under, and the
# stored backward
SCHEDULES = (("GPipe", 1, None), ("1F1B", 1, None),
             ("Interleaved1F1B", 2, None), ("ZBH1", 1, None),
             ("1F1B", 1, False))


def _cfgs(**kw):
    return (dtpp.ModelConfig(**BASE, **kw),
            port.ModelConfig(**BASE, use_fused_xent=True, **kw))


def _moes(**kw):
    fields = dict(MOE, **kw)
    return jmoe.MoEConfig(**fields), tmoe.MoEConfig(**fields)


def _tree(jcfg, jm, seed=0):
    """A JAX ``moe_lm_init`` pytree (its structure and shapes, traced
    only) with seeded numpy leaves: matrices scaled by their fan-in, norm
    scales near 1, small biases (continuous values: no routing ties)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmoe.moe_lm_init(jax.random.key(0),
                                                     jcfg, jm))

    def leaf(path, sd):
        key = jax.tree_util.keystr(path)
        x = rng.standard_normal(sd.shape)
        if key.endswith("['scale']"):
            x = 1 + 0.1 * x
        elif key.endswith(("['w']", "['w1']", "['w2']")):
            x = x * sd.shape[-2] ** -0.5
        elif "tok" in key:
            x = 0.5 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(pad=False):
    rng = np.random.default_rng(1)
    low = 1 if pad else 0
    tokens, targets = (rng.integers(low, BASE["vocab_size"], (B, S))
                       for _ in range(2))
    if pad:
        for i, keep in enumerate([2, 6, 3, 5, 4, 6, 2, 5]):
            targets[i, keep:] = PAD
    return tokens, targets


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _check(loss, grads, jloss, jgrads, tcfg, tm, loss_tol=1e-5, tol=2e-5):
    assert abs(float(loss) - float(jloss)) < loss_tol, (float(loss),
                                                         float(jloss))
    ref = port.from_jax_params(tcfg, jax.tree.map(np.asarray, jgrads),
                               device="cpu", moe=tm)
    assert set(grads) == {n for n, _ in ref.named_parameters()}
    worst = max(float((grads[n] - p.detach()).abs().max())
                for n, p in ref.named_parameters())
    assert worst < tol, worst


def _oracle(jcfg, jm, tree, tokens, targets, n_micro=M):
    """The JAX microbatched oracle: value_and_grad of the mean over
    microbatches of ``moe_lm_loss`` (a ``vmap`` over them: each keeps its
    own capacity and routing statistics)."""
    params = jax.tree.map(jnp.asarray, tree)
    toks = jnp.asarray(tokens).reshape(n_micro, -1, S)
    tgts = jnp.asarray(targets).reshape(n_micro, -1, S)

    def loss(p):
        return jax.vmap(lambda a, b: jmoe.moe_lm_loss(jcfg, jm, p, a, b))(
            toks, tgts).mean()

    return jax.jit(jax.value_and_grad(loss))(params)


@pytest.fixture(scope="module")
def oracles():
    out = {}
    tokens, targets = _batch()
    for tied in (False, True):
        jcfg, _ = _cfgs(tie_embeddings=tied)
        jm, _ = _moes()
        tree = _tree(jcfg, jm)
        out[tied] = (tree, _oracle(jcfg, jm, tree, tokens, targets))
    return out


# ---------------------------------------------------------------------------
# (b) routing, the MoE FFN and the MoE LM loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,E,k,C", [(16, 4, 2, 16), (24, 4, 2, 5),
                                     (12, 8, 1, 1), (20, 4, 3, 7)])
def test_route_matches_jax(T, E, k, C):
    """Continuous random probabilities (no ties): the dispatch tensor is
    JAX's exactly, queue positions and capacity drops included."""
    logits = np.random.default_rng(T * E + k).standard_normal((T, E))
    probs = np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    jd, jc, ja = jax.jit(jmoe.route, static_argnums=(1, 2))(
        jnp.asarray(probs), k, C)
    td, tc, ta = tmoe.route(torch.as_tensor(probs), k, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-6
    assert abs(float(ta) - float(ja)) < 1e-6


def test_route_uniform_aux_and_capacity():
    """JAX ``test_moe.py:25-43``: a uniform router's aux is 1; tokens that
    all prefer one expert fill its capacity in token order."""
    _, _, aux = tmoe.route(torch.full((16, 4), 0.25), 2, 16)
    assert abs(float(aux) - 1.0) < 1e-6
    probs = torch.tensor([[0.7, 0.1, 0.1, 0.1]]).repeat(6, 1)
    dispatch, combine, _ = tmoe.route(probs, 1, 2)
    assert dispatch[:, 0, :].sum(-1).tolist() == [1, 1, 0, 0, 0, 0]
    assert torch.allclose(combine.sum((1, 2))[:2], torch.ones(2))


@pytest.mark.parametrize("cap", [4.0, 0.25])
def test_moe_ffn_matches_jax(cap):
    """``moe_ffn_apply`` on random activations, without and with drops."""
    E, d, f = 4, 16, 32
    jm, tm = _moes(capacity_factor=cap, ffn_dim=f)
    rng = np.random.default_rng(3)
    params = {"router": {"w": rng.standard_normal((d, E)) * d ** -0.5},
              "w1": rng.standard_normal((E, d, f)) * d ** -0.5,
              "b1": 0.1 * rng.standard_normal((E, f)),
              "w2": rng.standard_normal((E, f, d)) * f ** -0.5,
              "b2": 0.1 * rng.standard_normal((E, d))}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    jy, ja = jax.jit(lambda p, v: jmoe.moe_ffn_apply(p, v, jm))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    ffn = tmoe.MoEFFN(d, f, E)
    with torch.no_grad():
        ffn.router.copy_(torch.as_tensor(params["router"]["w"]))
        for leaf in tmoe.EXPERT_LEAVES:
            getattr(ffn, leaf).copy_(torch.as_tensor(params[leaf]))
    with torch.no_grad():
        ty, ta = tmoe.moe_ffn_apply(ffn, torch.as_tensor(x), tm)
    assert np.abs(ty.numpy() - np.asarray(jy)).max() < 1e-5
    assert abs(float(ta) - float(ja)) < 1e-6


@pytest.mark.parametrize("kw,moe_kw", [
    ({}, dict(capacity_factor=0.5)),           # drops
    (dict(embed_scale=True), {}),
    (dict(tie_embeddings=True), {}),
    (dict(pad_token_id=PAD), {}),
])
def test_moe_lm_loss_matches_jax(kw, moe_kw):
    jcfg, tcfg = _cfgs(**kw)
    jm, tm = _moes(**moe_kw)
    tree = _tree(jcfg, jm)
    tokens, targets = _batch(pad="pad_token_id" in kw)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmoe.moe_lm_loss(jcfg, jm, p, jnp.asarray(tokens),
                                   jnp.asarray(targets))))(
        jax.tree.map(jnp.asarray, tree))
    model = port.from_jax_params(tcfg, tree, device="cpu", moe=tm)
    loss = port.moe_lm_loss(tcfg, tm, model, torch.as_tensor(tokens),
                            torch.as_tensor(targets))
    loss.backward()
    _check(loss, _grads(model), jloss, jgrads, tcfg, tm)


# ---------------------------------------------------------------------------
# (c) the lockstep MoE pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("name,V,remat", SCHEDULES)
def test_moe_pipeline_matches_jax(oracles, name, V, remat, tied):
    _, tcfg = _cfgs(tie_embeddings=tied)
    _, tm = _moes()
    tree, (jloss, jgrads) = oracles[tied]
    model = port.from_jax_params(tcfg, tree, device="cpu", moe=tm)
    fn = port.make_pipeline_grad_fn(tcfg, port.ScheduleConfig(name, M, V), 2,
                                    device="cpu", moe=tm,
                                    remat_backward=remat)
    loss = fn(model, *_batch())
    _check(loss, _grads(model), jloss, jgrads, tcfg, tm)


def test_moe_pipeline_padded_matches_jax():
    """JAX ``test_padding.py:141``: the CE over the global valid count, the
    aux token-uniform."""
    jcfg, tcfg = _cfgs(pad_token_id=PAD)
    jm, tm = _moes()
    tree = _tree(jcfg, jm)
    tokens, targets = _batch(pad=True)
    toks = jnp.asarray(tokens).reshape(M, -1, S)
    tgts = jnp.asarray(targets).reshape(M, -1, S)

    def oracle(p):
        def one(a, b):
            logits, aux = jmoe.moe_lm_logits_aux(jcfg, jm, p, a)
            return (*jmasked_xent_sum(logits, b, PAD), aux)

        s, n, aux = jax.vmap(one)(toks, tgts)
        return (s.sum() / n.sum()
                + jm.aux_loss_weight * aux.sum() / jcfg.n_layers / M)

    jloss, jgrads = jax.jit(jax.value_and_grad(oracle))(
        jax.tree.map(jnp.asarray, tree))
    model = port.from_jax_params(tcfg, tree, device="cpu", moe=tm)
    loss = port.make_pipeline_grad_fn(tcfg, port.ScheduleConfig("GPipe", M),
                                      2, device="cpu", moe=tm)(
        model, tokens, targets)
    _check(loss, _grads(model), jloss, jgrads, tcfg, tm)


def test_moe_dropout_partition_invariant():
    """The masks depend on (step seed, microbatch, global layer, site)
    only: D = 1, D = 2 and V = 2 give one step within 2e-5; eval mode
    differs."""
    jcfg, tcfg = _cfgs(dropout=0.25)
    jm, tm = _moes()
    tree = _tree(jcfg, jm)
    runs = []
    for name, D, V in (("GPipe", 1, 1), ("GPipe", 2, 1),
                       ("Interleaved1F1B", 2, 2)):
        model = port.from_jax_params(tcfg, tree, device="cpu", moe=tm)
        loss = port.make_pipeline_grad_fn(
            tcfg, port.ScheduleConfig(name, 2, V), D, device="cpu",
            moe=tm)(model, *_batch(), 7)
        runs.append((float(loss), _grads(model)))
    for loss, grads in runs[1:]:
        assert abs(loss - runs[0][0]) < 1e-5
        assert max(float((grads[n] - g).abs().max())
                   for n, g in runs[0][1].items()) < 2e-5
    model = port.from_jax_params(dataclasses.replace(tcfg, dropout=0.0),
                                 tree, device="cpu", moe=tm)
    eval_loss = port.make_pipeline_grad_fn(
        dataclasses.replace(tcfg, dropout=0.0), port.ScheduleConfig("GPipe", 2),
        2, device="cpu", moe=tm)(model, *_batch())
    assert abs(float(eval_loss) - runs[0][0]) > 1e-6


# ---------------------------------------------------------------------------
# (d) the MoE eval
# ---------------------------------------------------------------------------


def test_moe_eval_is_cross_entropy_only():
    """JAX ``test_eval.py:196-240``: the forward-only loss is the CE term
    of the microbatched oracle (aux on in the config, dropped in eval; the
    oracle JAX's MoE eval is held to at 2e-5); the training loss exceeds
    it by the aux term."""
    jcfg, tcfg = _cfgs()
    jm, tm = _moes(n_experts=2, top_k=1, capacity_factor=2.0,
                   aux_loss_weight=0.01)
    tree = _tree(jcfg, jm)
    tokens, targets = _batch()
    toks = jnp.asarray(tokens).reshape(2, -1, S)
    tgts = jnp.asarray(targets).reshape(2, -1, S)
    params = jax.tree.map(jnp.asarray, tree)
    ref = float(sum(jselect_xent(False)(
        jmoe.moe_lm_logits_aux(jcfg, jm, params, toks[m])[0], tgts[m])
        for m in range(2)) / 2)
    model = port.from_jax_params(tcfg, tree, device="cpu", moe=tm)
    tsched = port.ScheduleConfig("Interleaved1F1B", 2, 2)
    got = float(port.make_pipeline_loss_fn(tcfg, tsched, 2, device="cpu",
                                           moe=tm)(model, tokens, targets))
    assert abs(got - ref) < 2e-5
    got_fn = float(ttrain.make_eval_fn(tcfg, port.ScheduleConfig("1F1B", 2),
                                       2, device="cpu", moe=tm)(
        model, tokens, targets))
    assert abs(got_fn - ref) < 2e-5
    train = float(port.make_pipeline_grad_fn(
        tcfg, port.ScheduleConfig("1F1B", 2), 2, device="cpu", moe=tm)(
        model, tokens, targets))
    assert train > got_fn


# ---------------------------------------------------------------------------
# (e) fit(moe=)
# ---------------------------------------------------------------------------


def _fit(tcfg, tm, model, steps, **kw):
    data = tdata.synthetic_batches(tcfg.vocab_size, B, S, seed=1)
    trained, _ = ttrain.fit(tcfg, port.ScheduleConfig("1F1B", 2), 2,
                            copy.deepcopy(model), data, steps,
                            optimizer=ttrain.sgd(0.1), log_every=1,
                            verbose=False, device="cpu", moe=tm, **kw)
    return trained


def test_fit_moe_matches_step_loop_and_resumes(tmp_path):
    jcfg, tcfg = _cfgs()
    jm, tm = _moes()
    model = port.from_jax_params(tcfg, _tree(jcfg, jm), device="cpu", moe=tm)
    steps = 4
    ref = copy.deepcopy(model)
    step = ttrain.make_train_step(tcfg, port.ScheduleConfig("1F1B", 2), 2,
                                  ttrain.sgd(0.1), device="cpu", moe=tm)
    opt = ttrain.sgd(0.1).init(ref)
    data = tdata.synthetic_batches(tcfg.vocab_size, B, S, seed=1)
    for _ in range(steps):
        step(ref, opt, *next(data))
    fitted = _fit(tcfg, tm, model, steps)
    for (n, a), (_, b) in zip(ref.named_parameters(),
                              fitted.named_parameters()):
        assert torch.equal(a, b), n
    ck = str(tmp_path / "ck")
    with pytest.raises(tres.SimulatedKill):
        _fit(tcfg, tm, model, steps, checkpoint_dir=ck, checkpoint_every=1,
             fault_plan=tres.FaultPlan(kill_in_save_step=2))
    resumed = _fit(tcfg, tm, model, steps, checkpoint_dir=ck,
                   checkpoint_every=1, resume=True)
    for (n, a), (_, b) in zip(fitted.named_parameters(),
                              resumed.named_parameters()):
        assert torch.equal(a, b), n


def test_adamw_decays_router_and_expert_matrices():
    """The JAX ``adamw`` mask: "w", "w1", "w2" (the router and the expert
    matrices) decay, the expert biases do not."""
    _, tcfg = _cfgs()
    _, tm = _moes()
    model = tmoe.moe_init_params(tcfg, tm, torch.Generator().manual_seed(0),
                                 device="cpu")
    state = port.adamw(weight_decay=0.1).init(model)
    decayed = {id(p) for g in state.optimizer.param_groups
               if g["weight_decay"] for p in g["params"]}
    names = {n for n, p in model.named_parameters() if id(p) in decayed}
    for leaf, want in (("router", True), ("w1", True), ("w2", True),
                       ("b1", False), ("b2", False)):
        assert (f"layers.0.moe.{leaf}" in names) == want, leaf
    assert "layers.0.attn.q.weight" in names
    assert "layers.0.ln1.weight" not in names


# ---------------------------------------------------------------------------
# (g) refusals
# ---------------------------------------------------------------------------


def _fake_mesh(**kw):
    return tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"), **kw)


def _grad_fn(cfg, moe, **kw):
    return port.make_pipeline_grad_fn(cfg, port.ScheduleConfig("GPipe", 2), 2,
                                      device="cpu", moe=moe, **kw)


@pytest.mark.parametrize("build,error,match", [
    (lambda c, m: _grad_fn(c, tmoe.MoEConfig(n_experts=3),
                           mesh=_fake_mesh(n_expert=2)),
     ValueError, "n_experts=3 must divide over 2 expert shards"),
    (lambda c, m: _grad_fn(c, None, mesh=_fake_mesh(n_expert=2)),
     ValueError, "mesh has an 'expert' axis but no MoEConfig given"),
    (lambda c, m: _grad_fn(dataclasses.replace(c, arch="llama"), m),
     ValueError, "MoE pipeline blocks are gpt2-style; set arch='gpt2'"),
    (lambda c, m: port.make_pipeline_loss_fn(
        c, port.ScheduleConfig("GPipe", 2), 2, device="cpu",
        mesh=_fake_mesh(n_expert=2)),
     ValueError, "no MoEConfig given"),
    (lambda c, m: _grad_fn(c, m, dynamics=True), ValueError,
     "unsupported here: moe"),
    (lambda c, m: _grad_fn(c, m, axes={"expert": 2}), NotImplementedError,
     "an 'expert' axis"),
    (lambda c, m: tmoe.MoEConfig(n_experts=2, top_k=3), ValueError,
     r"top_k=3 must be in \[1, 2\]"),
])
def test_moe_refusals(build, error, match):
    _, tcfg = _cfgs()
    _, tm = _moes()
    with pytest.raises(error, match=match):
        build(tcfg, tm)


def test_expert_shard_without_its_axis_refused():
    """JAX ``moe_ffn_apply``'s check: an expert-sharded model run without
    its expert axis."""
    _, tcfg = _cfgs()
    _, tm = _moes()
    model = tmoe.moe_init_params(tcfg, tm, torch.Generator().manual_seed(0),
                                 device="cpu", expert=(2, 0))
    with pytest.raises(ValueError, match="holds expert block"):
        _grad_fn(tcfg, tm)(model, *_batch())
    with pytest.raises(ValueError, match="params hold 2 experts, config "
                                         "says 4"):
        tmoe.moe_lm_loss(tcfg, tm, model, *map(torch.as_tensor, _batch()))
