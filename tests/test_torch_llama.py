"""Parity of the PyTorch port's llama arch with the JAX package on the CPU:
RMSNorm, RoPE (with the Llama-3.1 frequency scaling), grouped-query
attention, the sliding window, q/k/v biases and the Gemma knobs, through the
full-sequence forward and loss, a pipelined training step, the
single-device ``generate`` and the pipelined decoder. Weights are numpy
trees in the JAX layout, loaded into the port through ``from_jax_params``;
inputs come from numpy seeds. f32 throughout, except the bf16 flash case."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    transformer as jtfm)
from distributed_training_with_pipeline_parallelism_tpu.models.generate import (
    make_generate_fn as jgenerate_fn)
from distributed_training_with_pipeline_parallelism_tpu.models.llama import (
    llama_config as jllama_config)
from distributed_training_with_pipeline_parallelism_tpu.ops import (
    attention as jatt, layers as jlay)
from distributed_training_with_pipeline_parallelism_tpu.ops.pallas_attention import (
    flash_attention as jflash)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models.llama import (
    llama_config)
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
    transformer_apply, transformer_loss)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops import (
    attention as tatt, flash_attention as fa, layers as tlay)

F32_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BASE = dict(arch="llama", dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            vocab_size=61, ffn_dim=48, max_seq_len=64,
            use_flash_attention=False)
# theta 100 and an original length of 32 put the second of the four
# frequencies of head_dim 8 inside the interpolated band (wavelength 19.9
# between 32/4 and 32/1), the first above it and the last two below
SCALED = dict(rope_theta=100.0, rope_scaling=(4.0, 1.0, 4.0, 32))
VARIANTS = {
    "gqa": {},
    "rope_scaling": SCALED,
    "sliding_window": dict(sliding_window=3),
    "qkv_bias_tied": dict(attention_qkv_bias=True, tie_embeddings=True),
    "gemma": dict(n_kv_heads=1, head_dim_override=16, mlp_act="gelu",
                  embed_scale=True, tie_embeddings=True, rms_eps=1e-6),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    size = dict(BASE, **kw)
    return dtpp.ModelConfig(**size), port.ModelConfig(**size)


def llama_tree(cfg, seed):
    """A JAX-layout llama pytree (linear ``w`` [in, out], layer leaves
    stacked [L, ...]) with seeded numpy leaves; norm scales near 1."""
    rng = np.random.default_rng(seed)
    L, d, f, v = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size
    hd, kv = cfg.head_dim, cfg.n_kv_heads or cfg.n_heads

    def r(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lin(i, o, bias=False):
        leaf = {"w": r(L, i, o, scale=i ** -0.5)}
        if bias:
            leaf["b"] = r(L, o, scale=0.1)
        return leaf

    def rms(*lead):
        return {"scale": 1 + r(*lead, d, scale=0.1)}

    qkv_b = cfg.attention_qkv_bias
    tree = {"embed": {"tok": r(v, d, scale=0.5)},
            "layers": {"rms1": rms(L), "rms2": rms(L),
                       "attn": {"q": lin(d, cfg.n_heads * hd, qkv_b),
                                "k": lin(d, kv * hd, qkv_b),
                                "v": lin(d, kv * hd, qkv_b),
                                "o": lin(cfg.n_heads * hd, d)},
                       "w1": lin(d, f), "w2": lin(f, d), "w3": lin(d, f)},
            "head": {"norm": rms()}}
    if not cfg.tie_embeddings:
        tree["head"]["out"] = {"w": r(d, v, scale=d ** -0.5)}
    return tree


@pytest.mark.parametrize("name", [
    "llama2-7b", "llama2-13b", "llama3-8b", "llama3.1-8b", "mistral-7b-v0.1",
    "mistral-7b-v0.3", "llama3.2-1b", "llama3.2-3b", "qwen2-0.5b",
    "qwen2-7b", "gemma-2b", "gemma-7b", "llama-debug"])
def test_llama_registry_matches_jax(name):
    """The port's own copy of ``llama_config``: the entry equal, field by
    field, to the JAX registry's."""
    want, got = jllama_config(name), llama_config(name)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_llama_registry_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown Llama size"):
        llama_config("llama-1t")


@pytest.mark.parametrize("kw,match", [
    (dict(n_kv_heads=3), "divisible by n_kv_heads"),
    (dict(arch="gpt2", sliding_window=4), "sliding_window requires"),
    (dict(sliding_window=0), "must be >= 1"),
    (dict(arch="gpt2", attention_qkv_bias=True), "attention_qkv_bias"),
    (dict(mlp_act="relu"), "must be 'silu' or 'gelu'"),
    (dict(arch="gpt2", head_dim_override=16), "Gemma-family"),
    (dict(arch="ref_decoder", embed_scale=True), "embed_scale applies"),
])
def test_llama_config_validation_matches_jax(kw, match):
    """The llama fields' validation raises as the JAX ``ModelConfig``
    does, with its message."""
    size = dict(BASE, **kw)
    with pytest.raises(ValueError, match=match) as want:
        dtpp.ModelConfig(**size)
    with pytest.raises(ValueError) as got:
        port.ModelConfig(**size)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("hd,theta,scaling", [
    (8, 100.0, (4.0, 1.0, 4.0, 32)),
    (64, 5e5, (32.0, 1.0, 4.0, 8192)),
    (64, 1e4, None)])
def test_rope_frequencies_match_jax(hd, theta, scaling):
    """``rope_frequencies`` with and without the Llama-3.1 scaling against
    the JAX one, f32 within 1e-6 relative."""
    want = np.asarray(jatt.rope_frequencies(hd, 300, theta, scaling))
    got = tatt.rope_frequencies(hd, 300, theta, scaling).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_apply_rope_matches_jax():
    """``apply_rope`` against the JAX one on the same angles, f32 within
    1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    ang = np.asarray(jatt.rope_frequencies(8, 7, 100.0, SCALED["rope_scaling"]))
    want = np.asarray(jatt.apply_rope(x, ang))
    got = tatt.apply_rope(torch.from_numpy(x),
                          tatt.Rope.of(torch.from_numpy(ang.copy()))).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL)


def test_rms_norm_matches_jax():
    """``rms_norm`` against the JAX ``rms_norm_apply``, f32 within 1e-5."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    want = np.asarray(jlay.rms_norm_apply({"scale": scale}, h, 1e-6))
    got = tlay.rms_norm(torch.from_numpy(h), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)


@pytest.mark.parametrize("variant", ["gqa", "qkv_bias_tied", "gemma"])
def test_llama_init_params_layout(variant):
    """``init_params`` builds the parameters ``from_jax_params`` fills
    (same names and shapes), with norm scales 1 and q/k/v biases only
    under ``attention_qkv_bias``."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    model = port.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    loaded = port.from_jax_params(tcfg, llama_tree(jcfg, 0), device="cpu")
    want = {k: v.shape for k, v in loaded.state_dict().items()}
    assert {k: v.shape for k, v in model.state_dict().items()} == want
    for name, p in model.named_parameters():
        if ".rms" in name or name.startswith("norm"):
            assert torch.equal(p, torch.ones_like(p)), name
    assert ("layers.0.attn.q.bias" in want) == tcfg.attention_qkv_bias


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_llama_logits_and_loss_match_jax(variant):
    """Logits of ``transformer_apply`` and ``transformer_loss`` against the
    JAX ones on the loaded weights, f32 within 1e-5, on the dense path and
    through the flash wrapper (its plain version on the CPU, heads
    expanded, the window as its band)."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    tree = llama_tree(jcfg, 0)
    rng = np.random.default_rng(1)
    tokens, targets = (rng.integers(0, jcfg.vocab_size, (2, 9))
                       for _ in range(2))
    logits, loss = jax.jit(lambda p, t, y: (
        jtfm.transformer_apply(jcfg, p, t),
        jtfm.transformer_loss(jcfg, p, t, y)))(
            jax.tree.map(jnp.asarray, tree), tokens, targets)
    model = port.from_jax_params(tcfg, tree, device="cpu")
    for flash in (False, True):
        cfg = dataclasses.replace(tcfg, use_flash_attention=flash)
        with torch.no_grad():
            got = transformer_apply(cfg, model, torch.from_numpy(tokens))
            got_loss = transformer_loss(cfg, model, torch.from_numpy(tokens),
                                        torch.from_numpy(targets))
        np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                                   atol=F32_TOL)
        assert abs(got_loss.item() - float(loss)) <= F32_TOL


def test_llama_pipeline_grad_step_matches_jax():
    """One 1F1B step at D = 2 (the rematerialising backward) on a GQA,
    rope-scaled, windowed llama: the loss and every gradient leaf against
    ``jax.value_and_grad`` of the JAX ``transformer_loss`` (rtol 1e-4,
    atol 1e-6); ``make_train_step`` then moves the weights and returns the
    same loss."""
    jcfg, tcfg = _cfgs(sliding_window=4, **SCALED)
    tree = llama_tree(jcfg, 2)
    rng = np.random.default_rng(4)
    tokens, targets = (rng.integers(0, jcfg.vocab_size, (4, 8))
                       for _ in range(2))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.transformer_loss(jcfg, p, tokens, targets)))(
            jax.tree.map(jnp.asarray, tree))
    model = port.from_jax_params(tcfg, tree, device="cpu")
    sched = port.ScheduleConfig("1F1B", 2)
    got = port.make_pipeline_grad_fn(tcfg, sched, 2, device="cpu")(
        model, torch.from_numpy(tokens), torch.from_numpy(targets))
    assert abs(got.item() - float(loss)) <= F32_TOL
    ref = port.from_jax_params(tcfg, jax.tree.map(np.asarray, grads),
                               device="cpu")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), ref.get_parameter(name).detach().numpy(),
            rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    opt = port.adamw(warmup_steps=0, total_steps=10)
    before = model.layers[0].w1.weight.detach().clone()
    step = port.make_train_step(tcfg, sched, 2, opt, device="cpu")
    first = step(model, opt.init(model), torch.from_numpy(tokens),
                 torch.from_numpy(targets))
    assert abs(first.item() - float(loss)) <= F32_TOL
    assert not torch.equal(model.layers[0].w1.weight, before)


@pytest.fixture(scope="module")
def decode_setup():
    """A rope-scaled GQA llama with a window of 4 (shorter than the
    prompt, so decode steps drop keys), its weights on both sides, and the
    JAX greedy tokens and log-probs of 6 prompts of 5 tokens."""
    jcfg, tcfg = _cfgs(sliding_window=4, **SCALED)
    tree = llama_tree(jcfg, 5)
    prompt = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (6, 5)).astype(np.int32)
    toks, lps = jgenerate_fn(jcfg, 6, return_logprobs=True)(
        jax.tree.map(jnp.asarray, tree), prompt)
    model = port.from_jax_params(tcfg, tree, device="cpu")
    return tcfg, model, prompt, np.asarray(toks), np.asarray(lps)


def test_llama_generate_matches_jax(decode_setup):
    """Greedy ``generate``: tokens equal to the jitted JAX
    ``make_generate_fn``'s and log-probs within 1e-5, with the prefill
    dense and through the flash wrapper (window as its band)."""
    tcfg, model, prompt, want, want_lp = decode_setup
    for flash in (False, True):
        cfg = dataclasses.replace(tcfg, use_flash_attention=flash)
        toks, lps = port.generate(cfg, model, prompt, 6,
                                  return_logprobs=True, device="cpu")
        np.testing.assert_array_equal(toks.numpy(), want)
        np.testing.assert_allclose(lps.numpy(), want_lp, atol=F32_TOL)


def test_llama_pipelined_decode_matches_generate(decode_setup):
    """The lockstep pipelined decoder at D = 2 (3 streams; stage caches of
    n_kv heads) emits the port's single-device tokens and log-probs, also
    with an EOS that freezes rows mid-run."""
    tcfg, model, prompt, want, want_lp = decode_setup
    fn = port.make_pipeline_generate_fn(tcfg, 2, 6, n_streams=3,
                                        return_logprobs=True, device="cpu")
    toks, lps = fn(model, prompt)
    np.testing.assert_array_equal(toks.numpy(), want)
    np.testing.assert_allclose(lps.numpy(), want_lp, atol=F32_TOL)
    eos = int(want[0, 6])
    ref = port.generate(tcfg, model, prompt, 6, eos_id=eos,
                        return_lengths=True, device="cpu")
    got = port.make_pipeline_generate_fn(
        tcfg, 2, 6, n_streams=3, eos_id=eos, return_lengths=True,
        device="cpu")(model, prompt)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert (ref[1].numpy() < 6).any()


def test_flash_plain_bf16_at_llama_prefill_layout():
    """The bf16 plain forward at the layout of a llama prefill (q of 4
    heads after RoPE, k/v of 2 kv heads expanded by ``gqa_expand``, head
    dim 64, causal): o within 0.25 bf16 ulp of the largest |o| of the JAX
    ``flash_attention`` in bf16 (Pallas in interpret mode) on the same
    values."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 32, 4, 64))
    kv = [rng.standard_normal((2, 32, 2, 64)) for _ in range(2)]
    jq = jnp.asarray(q, jnp.bfloat16)
    jk, jv = (jnp.repeat(jnp.asarray(x, jnp.bfloat16), 2, axis=2)
              for x in kv)
    want = np.asarray(jax.jit(lambda q, k, v: jflash(q, k, v, causal=True))(
        jq, jk, jv).astype(jnp.float32))

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)

    tk, tv = tatt.gqa_expand(*(t(jnp.asarray(x, jnp.bfloat16)
                                 .astype(jnp.float32)) for x in kv), 4)
    fa.check_tc_alignment("flash_fwd", {"q": t(jq.astype(jnp.float32)),
                                        "k": tk, "v": tv})
    o, _ = fa.flash_fwd(t(jq.astype(jnp.float32)), tk, tv, True)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(o.float().numpy() - want).max() <= 0.25 * ulp
