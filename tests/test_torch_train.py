"""Parity of the PyTorch port's GPT-2 training slice with the JAX package on
the CPU: the pipelined loss and every gradient leaf of
``make_pipeline_grad_fn`` against ``jax.value_and_grad`` of the JAX
``transformer_loss`` (which the JAX package's own tests hold its pipeline
to) and against the JAX ``make_pipeline_step`` itself, and three AdamW
steps against the JAX ``make_train_step`` with optax ``adamw``.

Weights and batches come from numpy with a seed; the JAX pytree loads into
the port through ``from_jax_params``, which also carries each JAX gradient
pytree into the port's layout. The port runs with both kernel routes on
(``use_flash_attention=True``, ``use_fused_xent=True``), which on the CPU
take the plain versions through the kernels' autograd functions; the JAX
side runs its dense attention and XLA cross entropy."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    transformer as jtfm)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipeline import (
    make_pipeline_step)
from distributed_training_with_pipeline_parallelism_tpu.utils import (
    train as jtrain)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
    transformer_loss)

SIZE = dict(dim=32, n_layers=4, n_heads=2, vocab_size=97, ffn_dim=128,
            max_seq_len=16, arch="gpt2")
B, S, M = 8, 16, 4
# f32 on both sides; the pipeline sums microbatches and scales by 1/M in
# another order than one full-batch autodiff. atol covers leaves whose true
# gradient is 0 (the k bias: softmax is shift-invariant), where both sides
# hold rounding noise of ~1e-8.
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(seed, tied):
    """A JAX-layout GPT-2 pytree (linear ``w`` [in, out], layer leaves
    stacked [L, ...]) with seeded numpy leaves."""
    rng = np.random.default_rng(seed)
    L, d, f, v = (SIZE[k] for k in ("n_layers", "dim", "ffn_dim",
                                    "vocab_size"))

    def r(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lin(i, o):
        return {"w": r(L, i, o, scale=i ** -0.5), "b": r(L, o, scale=0.1)}

    def ln(*lead):
        return {"scale": 1 + r(*lead, d, scale=0.1),
                "bias": r(*lead, d, scale=0.1)}

    head = {"norm": ln()}
    if not tied:
        head["out"] = {"w": r(d, v, scale=d ** -0.5)}
    return {"embed": {"tok": r(v, d, scale=0.5),
                      "pos": r(SIZE["max_seq_len"], d, scale=0.1)},
            "layers": {"ln1": ln(L), "ln2": ln(L),
                       "attn": {n: lin(d, d) for n in "qkvo"},
                       "lin1": lin(d, f), "lin2": lin(f, d)},
            "head": head}


def _cfgs(tied):
    jcfg = dtpp.ModelConfig(**SIZE, use_flash_attention=False,
                            tie_embeddings=tied)
    tcfg = port.ModelConfig(**SIZE, use_flash_attention=True,
                            use_fused_xent=True, tie_embeddings=tied)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def reference():
    """One jitted JAX ``value_and_grad(transformer_loss)`` per tied/untied
    configuration, computed once and shared by the parametrised cases."""
    cache = {}

    def get(tied):
        if tied not in cache:
            jcfg, _ = _cfgs(tied)
            tree = _numpy_params(0, tied)
            rng = np.random.default_rng(1)
            tokens, targets = (rng.integers(0, SIZE["vocab_size"], (B, S))
                               for _ in range(2))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jtfm.transformer_loss(jcfg, p, tokens, targets)))(
                    jax.tree.map(jnp.asarray, tree))
            cache[tied] = (tree, tokens, targets, float(loss),
                           jax.tree.map(np.asarray, grads))
        return cache[tied]

    return get


def _assert_grads_match(tcfg, model, jax_grads):
    ref = port.from_jax_params(tcfg, jax_grads, device="cpu")
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), ref.get_parameter(name).detach().numpy(),
            rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("name,D,V,remat,tied", [
    ("GPipe", 2, 1, None, False),
    ("GPipe", 2, 1, False, False),
    ("GPipe", 4, 1, True, False),
    ("GPipe", 4, 1, False, False),
    ("1F1B", 2, 1, True, False),
    ("1F1B", 2, 1, False, False),
    ("1F1B", 4, 1, None, False),
    ("1F1B", 4, 1, False, False),
    ("Interleaved1F1B", 2, 2, None, False),
    ("Interleaved1F1B", 2, 2, False, False),
    ("BFS", 2, 2, None, False),
    ("1F1B", 2, 1, None, True),   # tied: tok takes grads from both ends
    ("GPipe", 1, 1, None, False),  # D == 1: plain autograd over microbatches
    ("1F1B", 1, 1, True, False),   # D == 1 through the tick table
])
def test_pipeline_grads_match_single_device(reference, name, D, V, remat,
                                            tied):
    """Loss within 1e-5 and every gradient leaf within rtol 1e-4 / atol
    1e-6 of the single-device JAX objective, f32."""
    tree, tokens, targets, loss_ref, grads_ref = reference(tied)
    _, tcfg = _cfgs(tied)
    model = port.from_jax_params(tcfg, tree, device="cpu")
    fn = port.make_pipeline_grad_fn(tcfg, port.ScheduleConfig(name, M, V), D,
                                    remat_backward=remat, device="cpu")
    loss = fn(model, torch.from_numpy(tokens), torch.from_numpy(targets))
    assert abs(loss.item() - loss_ref) <= LOSS_TOL
    _assert_grads_match(tcfg, model, grads_ref)


def test_pipeline_matches_jax_make_pipeline_step(reference):
    """The JAX executor itself (1F1B, D = 2, ``unroll_ticks=False``) on the
    simulated mesh: the same 1/M-scaled gradients and microbatch-mean
    loss."""
    tree, tokens, targets, _, _ = reference(False)
    jcfg, tcfg = _cfgs(False)
    sched = dtpp.ScheduleConfig(name="1F1B", n_microbatches=M)
    step = make_pipeline_step(jcfg, make_mesh(n_pipe=2), sched,
                              unroll_ticks=False)
    jloss, jgrads = step(jax.tree.map(jnp.asarray, tree), tokens, targets)
    model = port.from_jax_params(tcfg, tree, device="cpu")
    fn = port.make_pipeline_grad_fn(tcfg, port.ScheduleConfig("1F1B", M), 2,
                                    device="cpu")
    loss = fn(model, torch.from_numpy(tokens), torch.from_numpy(targets))
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    _assert_grads_match(tcfg, model, jax.tree.map(np.asarray, jgrads))


def test_train_steps_match_optax(reference):
    """Three AdamW steps (global-norm clip 1.0, decay on the matrices,
    warmup-cosine from LR 0) against the JAX ``make_train_step`` with
    optax ``adamw`` at D = 1; the port runs 1F1B at D = 2. The first step
    (LR 0) leaves the parameters exactly as they were; after every step
    they agree within 1e-4 absolute. Adam's update is scale-free: an
    element whose gradient is near 0 moves by up to the learning rate
    (3e-2 here) on the sign of rounding noise, so the bound is 0.3% of the
    largest move of one step, not an f32 epsilon. The k bias's gradient is
    analytically 0 (softmax is shift-invariant), so Adam moves it by
    rounding noise alone on both sides: it is held to the bound every Adam
    step keeps, at most the learning rate per step."""
    tree, tokens, targets, _, _ = reference(True)
    jcfg, tcfg = _cfgs(True)
    opt_kw = dict(learning_rate=3e-2, weight_decay=0.1, warmup_steps=2,
                  total_steps=6)
    jstep = jtrain.make_train_step(jcfg, make_mesh(n_pipe=1),
                                   dtpp.ScheduleConfig("1F1B", M),
                                   jtrain.adamw(**opt_kw))
    params = jax.tree.map(jnp.asarray, tree)
    jopt = jtrain.adamw(**opt_kw).init(params)
    model = port.from_jax_params(tcfg, tree, device="cpu")
    opt = port.adamw(**opt_kw)
    opt_state = opt.init(model)
    tstep = port.make_train_step(tcfg, port.ScheduleConfig("1F1B", M), 2,
                                 opt, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(3):
        params, jopt, jloss = jstep(params, jopt, tokens, targets)
        loss = tstep(model, opt_state, torch.from_numpy(tokens),
                     torch.from_numpy(targets))
        assert abs(loss.item() - float(jloss)) <= LOSS_TOL
        ref = port.from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
        for name, p in model.named_parameters():
            atol = (2 * opt_kw["learning_rate"] * i
                    if name.endswith("attn.k.bias") else 1e-4)
            np.testing.assert_allclose(
                p.detach().numpy(), ref.get_parameter(name).detach().numpy(),
                rtol=1e-5, atol=atol, err_msg=f"step {i}: {name}")
            if i == 0:
                assert torch.equal(p, before[name]), name


def test_transformer_loss_matches_jax(reference):
    """The port's single-device objective with both kernel routes, f32."""
    tree, tokens, targets, loss_ref, grads_ref = reference(True)
    _, tcfg = _cfgs(True)
    model = port.from_jax_params(tcfg, tree, device="cpu")
    loss = transformer_loss(tcfg, model, torch.from_numpy(tokens),
                            torch.from_numpy(targets))
    loss.backward()
    assert abs(loss.item() - loss_ref) <= LOSS_TOL
    _assert_grads_match(tcfg, model, grads_ref)


@pytest.mark.parametrize("kw,match", [
    (dict(axes={"data": 2}), "item 8"),
    (dict(axes={"model": 2}), "torch.distributed world"),
])
def test_pipeline_not_ported_raises(kw, match):
    _, tcfg = _cfgs(False)
    tcfg = dataclasses.replace(tcfg, **kw.get("cfg", {}))
    with pytest.raises(NotImplementedError, match=match):
        port.make_pipeline_grad_fn(tcfg, port.ScheduleConfig("1F1B", M), 2,
                                   device="cpu", axes=kw.get("axes"))


def test_run_train_iterations_counts_tokens():
    calls = []

    def step(model, tokens, targets):
        calls.append(1)
        return torch.zeros(())

    out = port.run_train_iterations(step, None, torch.zeros(3, 5),
                                    torch.zeros(3, 5), num_iterations=4)
    assert len(calls) == 6 and out["tokens_processed"] == 60
    assert out["throughput"] == 60 / out["elapsed_time"]
