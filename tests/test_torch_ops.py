"""Parity of the PyTorch port's ops and kernel plain versions with the JAX
package on the CPU. Inputs come from numpy with a seed; the JAX Pallas
kernels run in interpret mode. Tolerances are stated per test."""

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
from distributed_training_with_pipeline_parallelism_tpu.ops.pallas_xent import (
    fused_softmax_xent as jxent)
from distributed_training_with_pipeline_parallelism_tpu_torch.models import (
    generate as tgen)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops import (
    attention as tatt, layers as tlay)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
    FLASH_FWD, flash_attention as tflash, flash_fwd, flash_fwd_plain)
from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
    XENT_FWD, fused_softmax_xent as txent)

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
