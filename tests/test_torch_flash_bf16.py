"""The bf16 arithmetic of the flash kernels' plain versions, and the
alignment rule of the bf16 tensor-core kernels, on the CPU.

The bf16 kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) round where
the TPU kernels of ``pallas_attention.py`` round: q times scale*log2(e) to
bf16, p to bf16 before p.v and p^T.do, ds to bf16 before ds.k and ds^T.q,
every product accumulated in f32. Their plain versions do the same, and are
held here against the JAX ``flash_attention`` and its VJP in bf16 (the
Pallas kernels in interpret mode) on the same inputs, made from a seed with
numpy. Tolerances are in bf16 ulps of the largest reference value (one ulp
is 2^(e - 7) for a largest magnitude in [2^e, 2^(e+1))).

Run on the CPU: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_flash_bf16.py -q``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_training_with_pipeline_parallelism_tpu.ops.pallas_attention import (
    flash_attention as jflash)
import distributed_training_with_pipeline_parallelism_tpu_torch as port
from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
    transformer_loss)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops import (
    flash_attention as fa)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops.attention import (
    gqa_expand)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(x: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) of the largest |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


def _bf16_inputs(shape, n, seed):
    """n bf16 arrays from a seed, as JAX arrays and as torch tensors holding
    the same values."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
          for _ in range(n)]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
          for x in jx]
    return jx, tx


# (route, shape, window, block, forward and backward tolerances in ulps).
# One rounding left out (p before p.v or p^T.do, ds, or q after scaling)
# moves some output by half an ulp or more on these inputs.
CASES = [
    # the packed route (K4 / K5): causal, full length, one 32-key block, so
    # the JAX kernel's arithmetic is the plain version's; only the order of
    # the f32 sums differs
    ("packed", (2, 32, 4, 64), None, None, 0.25, 0.25),
    # the [b*h, s, dh] route (K2 / K3): a ragged length over 16-key blocks
    # and a window of 8. The JAX forward rounds p against a running max over
    # its blocks, the plain version against the row's max, which may move a
    # rounding of o by one ulp; the backward's p comes from the saved lse on
    # both sides, and only the two forwards' lse differ in their last bits
    ("k2", (2, 37, 2, 16), 8, 16, 1.0, 0.5),
]


@pytest.mark.parametrize("route,shape,window,block,ulps,_", CASES)
def test_flash_fwd_plain_bf16_matches_jax(route, shape, window, block, ulps,
                                          _):
    """o of the bf16 plain forward against the JAX ``flash_attention`` in
    bf16, within ``ulps`` of the largest |o|; lse against the f32 plain
    forward of the same (bf16-valued) inputs within 1e-2 (the scores of
    the bf16 arithmetic come from a q rounded after scaling)."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(shape, 3, 5)
    want = np.asarray(jax.jit(lambda q, k, v: jflash(
        q, k, v, causal=True, block_q=block, block_k=block,
        window=window))(jq, jk, jv).astype(jnp.float32))
    before = fa.FLASH_FWD.launches
    o, lse = fa.flash_fwd(tq, tk, tv, True, window)
    assert fa.FLASH_FWD.launches == before
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    err = np.abs(o.float().numpy() - want).max()
    assert err <= ulps * _ulp(want), (err, _ulp(want))
    _, lse32 = fa.flash_fwd_plain(tq.float(), tk.float(), tv.float(), True,
                                  window)
    np.testing.assert_allclose(lse.numpy(), lse32.numpy(), atol=1e-2)


@pytest.mark.parametrize("route,shape,window,block,_,ulps", CASES)
def test_flash_bwd_plain_bf16_matches_jax(route, shape, window, block, _,
                                          ulps):
    """dq, dk, dv of the bf16 plain backward (from the bf16 plain forward's
    o and lse) against the VJP of the JAX ``flash_attention`` in bf16 under
    one cotangent, each within ``ulps`` of its largest reference value; the
    autograd function through the wrapper gives the same gradients."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bf16_inputs(shape, 4, 6)
    want = jax.jit(lambda q, k, v, g: jax.vjp(
        lambda q, k, v: jflash(q, k, v, causal=True, block_q=block,
                               block_k=block, window=window),
        q, k, v)[1](g))(jq, jk, jv, jg)
    o, lse = fa.flash_fwd_plain(tq, tk, tv, True, window)
    got = fa.flash_bwd_plain(tq, tk, tv, o, lse, tg, True, window)
    for name, x, w in zip("qkv", got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert x.dtype == torch.bfloat16
        err = np.abs(x.float().numpy() - w).max()
        assert err <= ulps * _ulp(w), (f"d{name}", err, _ulp(w))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    fa.flash_attention(*leaves, causal=True, window=window).backward(tg)
    for leaf, x in zip(leaves, got):
        assert torch.equal(leaf.grad, x)


def _strided(shape, strides, offset=0):
    buf = torch.zeros(offset + 4096, dtype=torch.bfloat16)
    return buf[offset:].as_strided(shape, strides)


@pytest.mark.parametrize("shape,strides,offset,match", [
    ((2, 8, 2, 64), (8 * 132, 132, 64, 1), 0, "q's seq stride 132 "),
    ((2, 8, 2, 64), (8 * 2 * 68, 2 * 68, 68, 1), 0, "q's head stride 68 "),
    ((2, 8, 2, 64), (1028, 128, 64, 1), 0, "q's batch stride 1028 "),
    ((2, 8, 2, 64), (1024, 128, 64, 1), 4, "q starts at byte address"),
])
def test_tc_alignment_rejects_misaligned(shape, strides, offset, match):
    """A bf16 tensor whose rows the 16-byte copies cannot take raises, and
    the message names the tensor and the stride (or its address)."""
    x = _strided(shape, strides, offset)
    ok = _strided((2, 8, 2, 64), (1024, 128, 64, 1))
    with pytest.raises(ValueError, match=match):
        fa.check_tc_alignment("flash_fwd", {"q": x, "k": ok, "v": ok})


def test_tc_alignment_ignores_strides_of_length_one_dims():
    """A dimension of size 1 is never stepped over, so its stride does not
    matter (a batch of one from a view keeps any batch stride)."""
    x = _strided((1, 8, 2, 64), (3, 128, 64, 1))
    fa.check_tc_alignment("flash_fwd", {"q": x})


def test_port_layouts_meet_tc_alignment(monkeypatch):
    """Every tensor the port hands the flash kernels meets the rule: the
    training step's q, k, v (separate [b, s, h*dh] projections), o and the
    cotangent autograd delivers, the decode prefill's q, k, v, the
    transposed [b, h, s, dh] storage of the K2 route, and GQA-expanded
    heads."""
    seen = []
    orig_fwd, orig_bwd = fa.flash_fwd, fa.flash_bwd

    def fwd(q, k, v, *args):
        fa.check_tc_alignment("flash_fwd", {"q": q, "k": k, "v": v})
        seen.append("fwd")
        return orig_fwd(q, k, v, *args)

    def bwd(q, k, v, o, lse, do, *args):
        fa.check_tc_alignment("flash_bwd", {"q": q, "k": k, "v": v, "o": o,
                                            "do": do})
        seen.append("bwd")
        return orig_bwd(q, k, v, o, lse, do, *args)

    monkeypatch.setattr(fa, "flash_fwd", fwd)
    monkeypatch.setattr(fa, "flash_bwd", bwd)
    cfg = dataclasses.replace(
        port.gpt2_config("small", tie_embeddings=True,
                         use_flash_attention=True),
        dim=128, n_layers=2, n_heads=2, ffn_dim=256, vocab_size=97,
        max_seq_len=64, dtype="bfloat16", param_dtype="float32")
    g = torch.Generator().manual_seed(0)
    model = port.init_params(cfg, g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    transformer_loss(cfg, model, tokens, tokens).backward()
    assert seen.count("fwd") == cfg.n_layers
    assert seen.count("bwd") == cfg.n_layers
    port.generate(cfg, model, tokens[:, :16], 2, device="cpu")
    assert seen.count("fwd") == 2 * cfg.n_layers  # the prefill

    x = torch.zeros(2, 4, 24, 64, dtype=torch.bfloat16).transpose(1, 2)
    k, v = gqa_expand(torch.zeros(2, 24, 2, 64, dtype=torch.bfloat16),
                      torch.zeros(2, 24, 2, 64, dtype=torch.bfloat16), 4)
    fa.check_tc_alignment("flash_fwd", {"q": x, "k": k, "v": v})
