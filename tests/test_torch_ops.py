"""Parity of the PyTorch port's ops and kernel plain versions (forward and
backward) with the JAX package on the CPU. Inputs come from numpy with a
seed; the JAX Pallas kernels run in interpret mode. Tolerances are stated
per test."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_training_with_pipeline_parallelism_tpu.models import (
    generate as jgen)
from distributed_training_with_pipeline_parallelism_tpu.ops import (
    attention as jatt, layers as jlay)
from distributed_training_with_pipeline_parallelism_tpu.ops.pallas_attention import (
    flash_attention as jflash)
from distributed_training_with_pipeline_parallelism_tpu.ops import (
    pallas_xent as jpx)
from distributed_training_with_pipeline_parallelism_tpu.ops.pallas_xent import (
    fused_softmax_xent as jxent)
from distributed_training_with_pipeline_parallelism_tpu_torch.models import (
    generate as tgen)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops import (
    attention as tatt, layers as tlay)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
    FLASH_BWD, FLASH_FWD, flash_attention as tflash, flash_bwd_plain,
    flash_fwd, flash_fwd_plain)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
    XENT_FWD, fused_masked_xent_sum, fused_softmax_xent as txent,
    xent_bwd_plain, xent_fwd_plain)

F32_TOL = 1e-5  # f32 on both sides; only the summation order differs



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op threads,
    and next to the suite's other worker processes those threads only
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(0)
    x, scale, bias = _rand(rng, 3, 5, 16), _rand(rng, 16), _rand(rng, 16)
    want = jlay.layer_norm_apply({"scale": scale, "bias": bias}, x)
    got = tlay.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    np.testing.assert_allclose(tlay.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), atol=F32_TOL)


@pytest.mark.parametrize("n_q,n_k,window,offset",
                         [(5, 5, None, 0), (3, 9, None, 4), (4, 12, 3, 6),
                          (1, 10, 2, 8)])
def test_band_mask_matches_jax(n_q, n_k, window, offset):
    want = np.asarray(jatt.band_mask(n_q, n_k, window, q_offset=offset))
    got = tatt.band_mask(n_q, n_k, window, q_offset=offset).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s,n_kv,window", [(1, 4, None), (3, 2, None),
                                           (3, 4, 3)])
def test_attend_cached_matches_jax(s, n_kv, window):
    """S new queries at offset 5 against a 10-slot cache (GQA when
    n_kv < 4 heads), f32 within 1e-5."""
    rng = np.random.default_rng(1)
    q = _rand(rng, 2, s, 4, 8)
    kc, vc = _rand(rng, 2, 10, n_kv, 8), _rand(rng, 2, 10, n_kv, 8)
    want = jgen._attend_cached(q, kc, vc, 5, 4, window)
    got = tgen._attend_cached(*map(torch.from_numpy, (q, kc, vc)), 5, 4,
                              window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


@pytest.mark.parametrize("route,shape,window,block", [
    # the packed route (K4): causal, full length, head_dim 64, auto blocks
    ("packed", (2, 32, 4, 64), None, None),
    # the [b*h, s, dh] route (K2): ragged length, window, explicit blocks
    ("k2", (2, 37, 2, 16), 8, 16),
])
def test_flash_plain_matches_jax_flash(route, shape, window, block):
    """The flash kernel's plain version against the JAX ``flash_attention``
    (Pallas in interpret mode), f32 within 1e-5; on the CPU the wrapper
    takes the plain version and launches nothing."""
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    want = jax.jit(lambda q, k, v: jflash(
        q, k, v, causal=True, block_q=block, block_k=block,
        window=window))(q, k, v)
    before = FLASH_FWD.launches
    got = tflash(*map(torch.from_numpy, (q, k, v)), causal=True,
                 block_q=block, block_k=block, window=window)
    assert FLASH_FWD.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)
    o, lse = flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), True, window)
    assert torch.equal(o, got) and lse.shape == (shape[0], shape[2], shape[1])


@pytest.mark.parametrize("kw,match", [
    (dict(causal=False, window=4), "window requires causal"),
    (dict(causal=True, block_q=16), "exceeds the sequence length"),
    (dict(causal=True, block_k=16), "exceeds the sequence length"),
])
def test_flash_attention_errors_match_jax(kw, match):
    q = np.zeros((1, 8, 2, 16), np.float32)
    with pytest.raises(ValueError, match=match):
        jflash(q, q, q, **kw)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError, match=match):
        tflash(t, t, t, **kw)


@pytest.mark.parametrize("causal,window", [(False, 4), (True, 0)])
def test_flash_fwd_rejects_window_outside_causal(causal, window):
    # the kernel's wrapper holds the contract of flash_attention, so the
    # kernel and its plain version never see a window they read apart
    t = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="window requires causal"):
        flash_fwd(t, t, t, causal, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [6, 7])
def test_xent_plain_matches_jax_fused(n, dtype):
    """The fused-xent kernel's plain version against the JAX
    ``fused_softmax_xent`` (the Pallas kernel at N = 6; the XLA fallback at
    odd N = 7) on the same logits, V = 1001. Both sides compute in f32
    from the same stored values, so bf16 holds the f32 tolerance: 1e-5
    relative."""
    rng = np.random.default_rng(3)
    x = 3 * _rand(rng, n, 1001)
    tg = rng.integers(0, 1001, n).astype(np.int32)
    jx = jnp.asarray(x, dtype=dtype)
    want = np.asarray(jax.jit(jxent)(jx, jnp.asarray(tg)))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    before = XENT_FWD.launches
    got = txent(tx, torch.from_numpy(tg)).numpy()
    assert XENT_FWD.launches == before
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("route,shape,causal,window,block", [
    # the packed route (K5): causal, full length, head_dim 64, auto blocks
    ("packed", (2, 32, 4, 64), True, None, None),
    # the [b*h, s, dh] route (K3): ragged length, window, explicit blocks
    ("k3", (2, 37, 2, 16), True, 8, 16),
    ("k3", (1, 24, 2, 16), False, None, 8),
])
def test_flash_bwd_plain_matches_jax_grad(route, shape, causal, window,
                                          block):
    """The backward kernel's plain version, from the forward's saved
    (o, lse), against the VJP of the JAX ``flash_attention`` (the Pallas
    backward in interpret mode) under one cotangent, f32 within 1e-5; the
    autograd function through the wrapper gives the same gradients and
    launches nothing on the CPU."""
    rng = np.random.default_rng(4)
    q, k, v, g = (_rand(rng, *shape) for _ in range(4))
    want = jax.jit(lambda q, k, v, g: jax.vjp(
        lambda q, k, v: jflash(q, k, v, causal=causal, block_q=block,
                               block_k=block, window=window),
        q, k, v)[1](g))(q, k, v, g)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = flash_fwd_plain(tq, tk, tv, causal, window)
    got = flash_bwd_plain(tq, tk, tv, o, lse, tg, causal, window)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=F32_TOL)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    before = (FLASH_FWD.launches, FLASH_BWD.launches)
    tflash(*leaves, causal=causal, window=window).backward(tg)
    assert (FLASH_FWD.launches, FLASH_BWD.launches) == before
    for leaf, x in zip(leaves, got):
        assert torch.equal(leaf.grad, x)


@pytest.mark.parametrize("n", [6, 7])
def test_xent_bwd_plain_matches_jax_grad(n):
    """The fused-xent backward's plain version against the VJP of the JAX
    ``fused_softmax_xent`` (its custom-vjp backward at N = 6, autodiff of
    the XLA fallback at odd N = 7), V = 1001, f32 within 1e-6; rows whose
    cotangent is 0 (pad rows) get exactly 0."""
    rng = np.random.default_rng(6)
    x = 3 * _rand(rng, n, 1001)
    tg = rng.integers(0, 1001, n).astype(np.int32)
    g = _rand(rng, n)
    g[[1, n - 1]] = 0.0  # pad rows
    want = np.asarray(jax.jit(lambda x, g: jax.vjp(
        lambda x: jxent(x, tg), x)[1](g)[0])(x, g))
    tx = torch.from_numpy(x)
    _, lse = xent_fwd_plain(tx, torch.from_numpy(tg))
    got = xent_bwd_plain(tx, torch.from_numpy(tg), lse, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (got[[1, n - 1]] == 0).all() and not torch.signbit(got[1]).any()


def test_masked_xent_pad_rows_get_zero_grad():
    """``fused_masked_xent_sum`` through the autograd function: the value
    of the JAX twin (f32, 1e-5), and pad rows' logit gradients exactly
    0."""
    rng = np.random.default_rng(7)
    x = 3 * _rand(rng, 2, 5, 33)
    tg = rng.integers(1, 33, (2, 5))
    tg[0, 3:] = 0
    tg[1, 4:] = 0
    s_want, n_want = jpx.fused_masked_xent_sum(x, tg, 0)
    tx = torch.from_numpy(x).requires_grad_()
    s, n = fused_masked_xent_sum(tx, torch.from_numpy(tg), 0)
    s.backward()
    assert int(n) == int(n_want)
    np.testing.assert_allclose(s.item(), float(s_want), rtol=1e-5)
    assert (tx.grad[torch.from_numpy(tg == 0)] == 0).all()
    assert (tx.grad[torch.from_numpy(tg != 0)].abs().sum(-1) > 0).all()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None)])
def test_flash_attention_gradcheck_f64(causal, window):
    """The autograd function's backward (the plain versions in f64 on the
    CPU) against finite differences."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 2, 4)))
               .requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tflash(q, k, v, causal=causal, window=window),
        (q, k, v))


def test_fused_xent_gradcheck_f64():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((5, 7))).requires_grad_()
    tg = torch.from_numpy(rng.integers(0, 7, 5))
    assert torch.autograd.gradcheck(lambda x: txent(x, tg), (x,))


@pytest.mark.parametrize("block", [1, 5, 8, 16])
def test_flash_attention_any_block_up_to_s(block):
    """A block is a tiling choice: any explicit block up to s gives the
    result of the kernel's own tiling (as the JAX ``flash_attention``
    does); a block above s raises (test_flash_attention_errors_match_jax)."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 16, 2, 64)) for _ in range(3))
    want = tflash(q, k, v, causal=True)
    got = tflash(q, k, v, causal=True, block_q=block, block_k=block)
    assert torch.equal(got, want)


@pytest.mark.parametrize("head_dim", [80, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_scale_matches_jax(head_dim, dtype):
    """``1/sqrt(head_dim)`` rounded as JAX rounds it, in the activation
    dtype (the f32 value at 96 and the bf16 products at 80 and 96 differ
    from a once-rounded f32 scale); the attention output agrees with the
    JAX ``scaled_dot_attention`` within 1e-5 (f32) / one bf16 ulp of 1."""
    jdt = getattr(jnp, dtype)
    want = 1.0 / jnp.sqrt(jnp.asarray(head_dim, dtype=jdt))
    assert tatt.attention_scale(head_dim, getattr(torch, dtype)) == \
        float(want)
    rng = np.random.default_rng(11)
    q, k, v = (_rand(rng, 1, 5, 2, head_dim) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x, dtype=jdt) for x in (q, k, v))
    mask = np.tril(np.ones((5, 5), bool))
    out_want = np.asarray(jatt.scaled_dot_attention(
        jq, jk, jv, mask[None, None]).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for x in (jq, jk, jv))
    out = tatt.scaled_dot_attention(tq, tk, tv,
                                    torch.from_numpy(mask)[None, None])
    np.testing.assert_allclose(out.float().numpy(), out_want,
                               atol=F32_TOL if dtype == "float32" else 2 ** -7)
