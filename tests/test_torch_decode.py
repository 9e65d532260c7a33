"""Parity of the PyTorch port's GPT-2 decode slice with the JAX package on
the CPU: the full-sequence forward, the single-device ``generate`` and the
round-robin pipelined decoder, on the same weights (the JAX pytree loaded
through ``from_jax_params``) and the same numpy prompts. The JAX side runs
the flash and fused-xent Pallas kernels in interpret mode; the port's
wrappers take their plain versions on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import distributed_training_with_pipeline_parallelism_tpu as dtpp
from distributed_training_with_pipeline_parallelism_tpu.models import (
    transformer as jtfm)
from distributed_training_with_pipeline_parallelism_tpu.models.generate import (
    make_generate_fn as jgenerate_fn)
from distributed_training_with_pipeline_parallelism_tpu.parallel.mesh import (
    make_mesh)
from distributed_training_with_pipeline_parallelism_tpu.parallel.pipelined_decode import (
    make_pipeline_generate_fn as jpipe)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
    transformer_apply)
from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
    mesh as tmesh)

SIZE = dict(dim=64, n_layers=4, n_heads=4, vocab_size=97, ffn_dim=256,
            max_seq_len=32, arch="gpt2", use_flash_attention=True,
            use_fused_xent=True)
JCFG = dtpp.ModelConfig(**SIZE)
TCFG = port.ModelConfig(**SIZE)
B, P, N = 60, 6, 5  # B divides over every stream count below
LP_TOL = 1e-5  # f32 log-probs: both sides log-softmax in f32



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _numpy_params(seed):
    """A JAX-layout GPT-2 pytree (linear ``w`` [in, out], layer leaves
    stacked [L, ...]) with seeded numpy leaves at the init scales."""
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

    return {"embed": {"tok": r(v, d, scale=0.02),
                      "pos": r(SIZE["max_seq_len"], d, scale=0.02)},
            "layers": {"ln1": ln(L), "ln2": ln(L),
                       "attn": {n: lin(d, d) for n in "qkvo"},
                       "lin1": lin(d, f), "lin2": lin(f, d)},
            "head": {"norm": ln(), "out": {"w": r(d, v, scale=d ** -0.5)}}}


@pytest.fixture(scope="module")
def weights():
    tree = _numpy_params(0)
    params = jax.tree.map(jax.numpy.asarray, tree)
    return params, port.from_jax_params(TCFG, tree, device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(
        0, SIZE["vocab_size"], (B, P)).astype(np.int32)


@pytest.fixture(scope="module")
def greedy(weights, prompt):
    """The port's greedy tokens and log-probs (held to the JAX ones by
    test_generate_matches_jax)."""
    toks, lps = port.generate(TCFG, weights[1], prompt, N,
                              return_logprobs=True, device="cpu")
    return toks.numpy(), lps.numpy()


def _eos(greedy):
    """A token the free run emits mid-sequence, so rows do freeze."""
    return int(greedy[0][0, P + 1])


def test_full_sequence_logits_match_jax(weights, prompt):
    """transformer_apply on the loaded weights: f32 logits within 1e-5."""
    dense = dataclasses.replace(JCFG, use_flash_attention=False)
    want = np.asarray(jax.jit(lambda p, t: jtfm.transformer_apply(
        dense, p, t))(weights[0], prompt))
    for flash in (False, True):
        with torch.no_grad():
            got = transformer_apply(
                dataclasses.replace(TCFG, use_flash_attention=flash),
                weights[1], torch.from_numpy(prompt)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("use_eos", [False, True])
def test_generate_matches_jax(weights, prompt, greedy, use_eos):
    """Greedy tokens bit-equal and log-probs within 1e-5; with an EOS the
    freeze (lengths, forced EOS, log-prob 0.0) matches too."""
    kw = dict(eos_id=_eos(greedy), return_lengths=True) if use_eos else {}
    want = [np.asarray(x) for x in jgenerate_fn(
        JCFG, N, return_logprobs=True, **kw)(weights[0], prompt)]
    got = [x.numpy() for x in port.generate(
        TCFG, weights[1], prompt, N, return_logprobs=True, device="cpu",
        **kw)] if use_eos else list(greedy)
    np.testing.assert_array_equal(got[0], want[0])
    if use_eos:
        np.testing.assert_array_equal(got[1], want[1])
        assert (want[1] < N).any()  # the freeze engaged
    np.testing.assert_allclose(got[-1], want[-1], atol=LP_TOL)


@pytest.mark.parametrize("D,M", [(2, 2), (2, 3), (4, 4), (4, 5)])
def test_pipelined_decode_matches_jax(weights, prompt, greedy, D, M):
    """The lockstep pipelined decoder emits the JAX pipelined decoder's
    tokens (on a D-stage pipe mesh, dense path: the JAX suite pins its
    flash prefill to the same tokens) and the port's own ``generate``
    tokens, with log-probs within 1e-5 of the latter's."""
    dense = dataclasses.replace(JCFG, use_flash_attention=False,
                                use_fused_xent=False)
    want = np.asarray(jpipe(dense, make_mesh(n_pipe=D), N,
                            n_streams=M)(weights[0], prompt))
    toks, lps = port.make_pipeline_generate_fn(
        TCFG, D, N, n_streams=M, return_logprobs=True,
        device="cpu")(weights[1], prompt)
    np.testing.assert_array_equal(toks.numpy(), want)
    np.testing.assert_array_equal(toks.numpy(), greedy[0])
    np.testing.assert_allclose(lps.numpy(), greedy[1], atol=LP_TOL)


def test_pipelined_decode_eos_matches_generate(weights, prompt, greedy):
    """EOS freeze through the ring: lengths, forced EOS and log-prob 0.0
    as the single-device decoder, with fully finished streams skipped."""
    kw = dict(eos_id=_eos(greedy), return_lengths=True,
              return_logprobs=True)
    want = port.generate(TCFG, weights[1], prompt, N, device="cpu", **kw)
    got = port.make_pipeline_generate_fn(TCFG, 2, N, n_streams=4,
                                         device="cpu", **kw)(weights[1],
                                                             prompt)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("pipelined", [False, True])
def test_sampling_in_vocab_and_seeded(weights, prompt, pipelined):
    """Temperature / top-k / top-p sampling stays in vocab and repeats
    under the same generator seed."""
    def run(seed):
        g = torch.Generator().manual_seed(seed)
        kw = dict(temperature=0.8, top_k=8, top_p=0.9)
        if pipelined:
            return port.make_pipeline_generate_fn(
                TCFG, 2, N, device="cpu", **kw)(weights[1], prompt, g)
        return port.generate(TCFG, weights[1], prompt, N, generator=g,
                             device="cpu", **kw)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (B, P + N)
    assert ((a >= 0) & (a < SIZE["vocab_size"])).all()


def test_pipelined_decode_errors(weights, prompt):
    with pytest.raises(ValueError, match="n_streams"):
        port.make_pipeline_generate_fn(TCFG, 4, N, n_streams=3, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        port.make_pipeline_generate_fn(TCFG, 3, N, device="cpu")
    # a world with pipe > 1 would put the stages on ranks (ROADMAP.md)
    pipe_world = tmesh.Mesh(2, 1, 0, "gloo", torch.device("cpu"), n_model=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port.make_pipeline_generate_fn(TCFG, 2, N, mesh=pipe_world,
                                       device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        port.make_pipeline_generate_fn(TCFG, 2, N, n_streams=3,
                                       device="cpu")(weights[1], prompt[:4])
