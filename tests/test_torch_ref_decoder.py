"""The PyTorch port's reference model (``arch="ref_decoder"``) on the CPU:
its loss and gradients against the JAX package's ``transformer_loss`` on
shared weights, its logits against the ``nn.TransformerDecoderLayer`` twin
the JAX package's own parity test builds, its pipelined gradients under
GPipe, 1F1B and Interleaved1F1B at D = 2 and 4 against the port's own
single-device autograd, the flash kernels' plain versions at the
reference's head dims, and train-mode dropout: the rate's law, and one step
seed giving the same loss and gradients under every stage split and both
backwards (the JAX contract of ``tests/test_dropout.py``).

Weights and batches come from numpy with a seed. JAX runs once, jitted;
every pipeline case is held to the port's unpipelined autograd, which is
held to JAX."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    transformer as jtfm)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
    transformer_apply, transformer_loss)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops import (
    flash_attention as tflash)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops.attention import (
    scaled_dot_attention)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops.layers import (
    dropout_apply, fold_seed, seeded_generator)

# the sizes of tests/test_model_torch_parity.py
SIZE = dict(dim=64, n_layers=2, n_heads=4, vocab_size=101, ffn_dim=128)
B, S = 4, 16
# a deeper, narrower model for the pipeline cases (8 layers split over
# D * V = 2, 4 or 8 stages)
PIPE = dict(dim=32, n_layers=8, n_heads=4, vocab_size=50, ffn_dim=64)
PB, PS, M = 8, 6, 4
# f32 on both sides; sums run in other orders. A leaf's error is bounded
# by RTOL of its own norm plus ATOL of the global norm: the k biases'
# true gradient is 0 (softmax is shift-invariant), so both sides hold
# only rounding noise there.
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree(size, seed):
    """A JAX-layout ref_decoder pytree (linear ``w`` [in, out], layer
    leaves stacked [L, ...]) with seeded numpy leaves."""
    rng = np.random.default_rng(seed)
    L, d, f, v = (size[k] for k in ("n_layers", "dim", "ffn_dim",
                                    "vocab_size"))

    def r(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lin(i, o, lead=(L,)):
        return {"w": r(*lead, i, o, scale=i ** -0.5),
                "b": r(*lead, o, scale=0.1)}

    def ln(*lead):
        return {"scale": 1 + r(*lead, d, scale=0.1),
                "bias": r(*lead, d, scale=0.1)}

    return {"embed": {"tok": r(v, d, scale=1.0)},
            "layers": {"self_attn": {n: lin(d, d) for n in "qkvo"},
                       "cross_attn": {n: lin(d, d) for n in "qkvo"},
                       "ln1": ln(L), "ln2": ln(L), "ln3": ln(L),
                       "lin1": lin(d, f), "lin2": lin(f, d)},
            "head": {"norm": ln(), "out": lin(d, v, lead=())}}


def _batch(size, b, s, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, size["vocab_size"], (b, s))
                 for _ in range(2))


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _assert_grads_close(got, want, rtol=RTOL, atol=ATOL):
    g_norm = torch.sqrt(sum((w.double() ** 2).sum() for w in want.values()))
    for name, w in want.items():
        err = (got[name].double() - w.double()).norm()
        assert err <= rtol * w.double().norm() + atol * g_norm, (
            name, float(err), float(w.norm()))


@pytest.fixture(scope="module")
def jax_reference():
    """The jitted JAX ``value_and_grad(transformer_loss)`` and the logits
    on the shared weights and batch, computed once."""
    jcfg = dtpp.ModelConfig(**SIZE)
    tree = _numpy_tree(SIZE, 0)
    tokens, targets = _batch(SIZE, B, S, 1)
    params = jax.tree.map(jnp.asarray, tree)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.transformer_loss(jcfg, p, tokens, targets)))(params)
    logits = jax.jit(lambda p: jtfm.transformer_apply(jcfg, p, tokens))(
        params)
    return (tree, tokens, targets, float(loss), np.asarray(logits),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("routes", ["dense", "kernels"])
def test_loss_and_grads_match_jax(jax_reference, routes):
    """Logits, loss and every gradient leaf of the port's single-device
    objective against JAX's (f32, 1e-5 relative). ``kernels`` routes the
    port's attention through the non-causal flash kernel and its loss
    through the fused xent (their plain versions here, through the
    kernels' autograd functions)."""
    tree, tokens, targets, loss_ref, logits_ref, grads_ref = jax_reference
    kernels = routes == "kernels"
    cfg = port.ModelConfig(**SIZE, use_flash_attention=kernels,
                           use_fused_xent=kernels)
    model = port.from_jax_params(cfg, tree, device="cpu")
    with torch.no_grad():
        logits = transformer_apply(cfg, model, torch.from_numpy(tokens))
    err = np.abs(logits.numpy() - logits_ref).max()
    assert err <= RTOL * np.abs(logits_ref).max(), err
    loss = transformer_loss(cfg, model, torch.from_numpy(tokens),
                            torch.from_numpy(targets))
    loss.backward()
    assert abs(loss.item() - loss_ref) <= RTOL * abs(loss_ref)
    want = port.from_jax_params(cfg, grads_ref, device="cpu")
    _assert_grads_close(_grads(model), dict(want.named_parameters()))


class _TorchRefModel(nn.Module):
    """The reference model's behavioural twin
    (``tests/test_model_torch_parity.py``, dropout off)."""

    def __init__(self, size):
        super().__init__()
        self.tok_embeddings = nn.Embedding(size["vocab_size"], size["dim"])
        self.layers = nn.ModuleList([
            nn.TransformerDecoderLayer(size["dim"], size["n_heads"],
                                       dim_feedforward=size["ffn_dim"],
                                       dropout=0.0, batch_first=True)
            for _ in range(size["n_layers"])])
        self.norm = nn.LayerNorm(size["dim"])
        self.output = nn.Linear(size["dim"], size["vocab_size"])

    def forward(self, tokens):
        h = self.tok_embeddings(tokens)
        for layer in self.layers:
            h = layer(h, h)
        return self.output(self.norm(h))


def _twin_tree(twin):
    """The twin's weights as a JAX-layout pytree of numpy leaves."""
    def a(t):
        return t.detach().numpy()

    def mha(m):
        ws = m.in_proj_weight.chunk(3, dim=0)
        bs = m.in_proj_bias.chunk(3, dim=0)
        out = {n: {"w": a(w).T, "b": a(b)} for n, w, b in zip("qkv", ws, bs)}
        out["o"] = {"w": a(m.out_proj.weight).T, "b": a(m.out_proj.bias)}
        return out

    def ln(m):
        return {"scale": a(m.weight), "bias": a(m.bias)}

    def lin(m):
        return {"w": a(m.weight).T, "b": a(m.bias)}

    layers = [{"self_attn": mha(ly.self_attn),
               "cross_attn": mha(ly.multihead_attn), "ln1": ln(ly.norm1),
               "ln2": ln(ly.norm2), "ln3": ln(ly.norm3),
               "lin1": lin(ly.linear1), "lin2": lin(ly.linear2)}
              for ly in twin.layers]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *layers)
    return {"embed": {"tok": a(twin.tok_embeddings.weight)},
            "layers": stacked,
            "head": {"norm": ln(twin.norm), "out": lin(twin.output)}}


def test_logits_match_torch_decoder_layer():
    """The port's ref_decoder is ``nn.TransformerDecoderLayer`` called as
    ``layer(h, h)``: equal logits on the twin's weights."""
    torch.manual_seed(0)
    twin = _TorchRefModel(SIZE).eval()
    cfg = port.ModelConfig(**SIZE)
    model = port.from_jax_params(cfg, _twin_tree(twin), device="cpu")
    tokens = torch.from_numpy(_batch(SIZE, B, S, 2)[0])
    with torch.no_grad():
        want, got = twin(tokens), transformer_apply(cfg, model, tokens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_init_params_conventions():
    """N(0, 1) token table (``nn.Embedding``'s), a biased head, unit
    LayerNorm scales, three of them a block."""
    cfg = port.ModelConfig(**SIZE)
    model = port.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert 0.9 < model.tok.std().item() < 1.1
    assert model.out.bias is not None
    assert all(torch.equal(b.ln3.weight, torch.ones(SIZE["dim"]))
               for b in model.layers)


@pytest.fixture(scope="module")
def pipe_reference():
    """The port's single-device loss and gradients on the pipeline size
    (the objective every schedule is held to)."""
    cfg = port.ModelConfig(**PIPE)
    tree = _numpy_tree(PIPE, 3)
    tokens, targets = (torch.from_numpy(x) for x in _batch(PIPE, PB, PS, 4))
    model = port.from_jax_params(cfg, tree, device="cpu")
    loss = transformer_loss(cfg, model, tokens, targets)
    loss.backward()
    return tree, tokens, targets, loss.item(), _grads(model)


@pytest.mark.parametrize("name,D,V", [
    ("GPipe", 2, 1), ("GPipe", 4, 1), ("1F1B", 2, 1), ("1F1B", 4, 1),
    ("Interleaved1F1B", 2, 2), ("Interleaved1F1B", 4, 2)])
def test_pipeline_grads_match_autograd(pipe_reference, name, D, V):
    tree, tokens, targets, loss_ref, grads_ref = pipe_reference
    cfg = port.ModelConfig(**PIPE)
    model = port.from_jax_params(cfg, tree, device="cpu")
    fn = port.make_pipeline_grad_fn(cfg, port.ScheduleConfig(name, M, V), D,
                                    device="cpu")
    loss = fn(model, tokens, targets)
    assert abs(loss.item() - loss_ref) <= RTOL * abs(loss_ref)
    _assert_grads_close(_grads(model), grads_ref)


def test_head_dims_have_kernels():
    """Both flash kernels are built for the reference's head dims (dim 768
    over 12, 8 and 4 heads: 64, 96, 192); the CUDA wrappers' check takes
    them and still refuses a head dim without a kernel."""
    assert {64, 96, 192} <= set(tflash.HEAD_DIMS)
    for dh in (64, 96, 192):
        q = torch.zeros(1, 2, 1, dh)
        tflash._check_cuda(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        q = torch.zeros(1, 2, 1, 80)
        tflash._check_cuda(q, q, q)


@pytest.mark.parametrize("dh", [96, 192])
def test_flash_plain_noncausal_matches_dense(dh):
    """The flash route's plain versions, non-causal, at the new head dims:
    output and q/k/v gradients equal to dense attention's (f32)."""
    rng = np.random.default_rng(dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, dh))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((2, 16, 2, dh))
                          .astype(np.float32))
    out = tflash.flash_attention(q, k, v, causal=False)
    got = torch.autograd.grad(out, (q, k, v), do)
    ref = scaled_dot_attention(q, k, v)
    want = torch.autograd.grad(ref, (q, k, v), do)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_decoding_rejects_ref_decoder():
    """The reference block is non-causal with no positions: generation is
    undefined for it, and both decoders raise the JAX error."""
    cfg = port.ModelConfig(**SIZE)
    model = port.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="generation is undefined"):
        port.generate(cfg, model, np.zeros((1, 3), np.int64), 2,
                      device="cpu")
    with pytest.raises(ValueError, match="generation is undefined"):
        port.make_pipeline_generate_fn(cfg, 2, 2, device="cpu")


def test_dropout_identity_at_zero_and_in_eval():
    x = torch.randn(8, 8)
    gen = seeded_generator(1, "cpu")
    assert dropout_apply(x, 0.0, gen) is x
    assert dropout_apply(x, 0.3, None) is x
    cfg = port.ModelConfig(**SIZE, dropout=0.1)
    model = port.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.from_numpy(_batch(SIZE, B, S, 5)[0])
    eval_cfg = dataclasses.replace(cfg, dropout=0.0)
    with torch.no_grad():
        assert torch.equal(transformer_apply(cfg, model, tokens),
                           transformer_apply(eval_cfg, model, tokens, rng=7))


def test_dropout_keep_rate_and_scale():
    """At p = 0.1 the kept share is within 4 sigma of 0.9, kept values are
    scaled by 1/0.9, and a seed draws the same mask again."""
    p, n = 0.1, 200_000
    x = torch.ones(n)
    y = dropout_apply(x, p, seeded_generator(fold_seed(3, 0), "cpu"))
    kept = y != 0
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(kept.float().mean().item() - (1 - p)) <= 4 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    again = dropout_apply(x, p, seeded_generator(fold_seed(3, 0), "cpu"))
    other = dropout_apply(x, p, seeded_generator(fold_seed(3, 1), "cpu"))
    assert torch.equal(y, again) and not torch.equal(y, other)


DROP = dict(PIPE, dropout=0.1)
STEP_SEED = 11


@pytest.fixture(scope="module")
def dropout_reference():
    """The manual microbatched reference under dropout: the mean over
    microbatches of ``transformer_loss(rng=fold_seed(step_seed, m))`` and
    its gradients (the JAX ``test_pipeline_matches_manual_microbatched_
    reference``)."""
    cfg = port.ModelConfig(**DROP)
    tree = _numpy_tree(DROP, 6)
    tokens, targets = (torch.from_numpy(x) for x in _batch(DROP, PB, PS, 7))
    model = port.from_jax_params(cfg, tree, device="cpu")
    toks, tgts = tokens.view(M, -1, PS), targets.view(M, -1, PS)
    loss = sum(transformer_loss(cfg, model, toks[m], tgts[m],
                                rng=fold_seed(STEP_SEED, m))
               for m in range(M)) / M
    loss.backward()
    eval_loss = transformer_loss(dataclasses.replace(cfg, dropout=0.0),
                                 model, tokens, targets).item()
    return tree, tokens, targets, loss.item(), _grads(model), eval_loss


@pytest.mark.parametrize("name,D,V", [
    ("GPipe", 2, 1), ("1F1B", 4, 1), ("Interleaved1F1B", 2, 2)])
def test_pipeline_dropout_partition_invariance(dropout_reference, name, D, V):
    """One step seed, any stage split: the masks key off (step seed,
    microbatch, global layer, site), so every schedule computes the
    manual reference's loss and gradients, which differ from eval mode."""
    tree, tokens, targets, loss_ref, grads_ref, eval_loss = dropout_reference
    cfg = port.ModelConfig(**DROP)
    model = port.from_jax_params(cfg, tree, device="cpu")
    fn = port.make_pipeline_grad_fn(cfg, port.ScheduleConfig(name, M, V), D,
                                    device="cpu")
    loss = fn(model, tokens, targets, STEP_SEED)
    assert abs(loss.item() - loss_ref) <= RTOL * abs(loss_ref)
    assert abs(loss.item() - eval_loss) > 1e-3
    _assert_grads_close(_grads(model), grads_ref)


def test_remat_and_stored_backward_equal_under_dropout(dropout_reference):
    """The rematerialising backward re-seeds its forward's streams, so it
    redraws the very masks the stored backward kept: equal loss and
    gradients. A step without its seed raises."""
    tree, tokens, targets, _, _, _ = dropout_reference
    cfg = port.ModelConfig(**DROP)
    sched = port.ScheduleConfig("1F1B", M)
    out = []
    for remat in (True, False):
        model = port.from_jax_params(cfg, tree, device="cpu")
        fn = port.make_pipeline_grad_fn(cfg, sched, 2, remat_backward=remat,
                                        device="cpu")
        out.append((fn(model, tokens, targets, STEP_SEED).item(),
                    _grads(model)))
    assert out[0][0] == out[1][0]
    _assert_grads_close(out[0][1], out[1][1], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="seed"):
        fn(model, tokens, targets)


def test_train_step_takes_a_step_seed(dropout_reference):
    """``make_train_step`` passes the step seed through and
    ``run_train_iterations`` hands each step ``seed + i``: two runs from
    one seed take the same steps."""
    tree, tokens, targets, _, _, _ = dropout_reference
    cfg = port.ModelConfig(**DROP)
    sched = port.ScheduleConfig("GPipe", M)
    finals = []
    for _ in range(2):
        model = port.from_jax_params(cfg, tree, device="cpu")
        opt = port.adamw(learning_rate=1e-2, warmup_steps=1)
        state = opt.init(model)
        step = port.make_train_step(cfg, sched, 2, opt, device="cpu")
        losses = []

        def counted(m, x, y, seed):
            losses.append(step(m, state, x, y, seed).item())
            return torch.tensor(losses[-1])

        port.run_train_iterations(counted, model, tokens, targets,
                                  num_iterations=2, warmup_iterations=1,
                                  seed=100)
        finals.append((losses, model.tok.detach().clone()))
    assert finals[0][0] == finals[1][0] and len(finals[0][0]) == 3
    assert torch.equal(finals[0][1], finals[1][1])


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_pipeline_dropout_other_archs(arch):
    """The GPT-2 and llama sites (attention probabilities, both residual
    branches, GPT-2's embedding) through a 1F1B D = 2 step equal the
    manual microbatched reference on one step seed."""
    cfg = port.ModelConfig(**dict(PIPE, n_layers=4), arch=arch,
                           max_seq_len=PS, dropout=0.1)
    tokens, targets = (torch.from_numpy(x) for x in _batch(PIPE, PB, PS, 8))
    model = port.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks, tgts = tokens.view(M, -1, PS), targets.view(M, -1, PS)
    loss_ref = sum(transformer_loss(cfg, model, toks[m], tgts[m],
                                    rng=fold_seed(STEP_SEED, m))
                   for m in range(M)) / M
    loss_ref.backward()
    grads_ref = _grads(model)
    model.zero_grad(set_to_none=True)
    fn = port.make_pipeline_grad_fn(cfg, port.ScheduleConfig("1F1B", M), 2,
                                    device="cpu")
    loss = fn(model, tokens, targets, STEP_SEED)
    assert abs(loss.item() - loss_ref.item()) <= RTOL * abs(loss_ref.item())
    _assert_grads_close(_grads(model), grads_ref)
