"""Elementary ops as plain tensor functions (counterparts of the JAX
package's ``ops/layers.py``).

Layout note: a torch weight is ``[out, in]`` (``F.linear``'s convention);
the JAX ``linear.w`` leaf is ``[in, out]``. :mod:`..utils.weights`
transposes at load time.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with ``weight`` [out, in]."""
    return F.linear(x, weight, bias)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with the population variance."""
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim, ``x * rsqrt(mean(x^2) + eps) * scale``,
    computed in x's dtype as the JAX ``rms_norm_apply`` computes it (no
    f32 upcast of its own)."""
    ms = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * scale


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, word: int) -> int:
    """A new 64-bit seed from ``seed`` and one more word (the port's
    ``jax.random.fold_in``): splitmix64's finaliser over ``seed +
    (word + 1) * golden``, a bijection of the sum, so distinct words give
    distinct seeds. A dropout stream is a chain of folds (step seed,
    microbatch, global layer, site), so its masks depend only on those
    words, never on which stage or device draws them."""
    z = (seed + (word + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def seeded_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``: the same
    seed draws the same numbers on that device every time, which is how
    the rematerialising backward redraws its forward's masks."""
    return torch.Generator(device=device).manual_seed(seed)


def dropout_apply(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (the JAX ``dropout_apply``): zero each element with
    probability ``rate`` and scale the kept ones by 1/(1 - rate), the mask
    drawn from ``generator`` (on x's device). ``generator=None`` (eval
    mode) or ``rate=0`` is the identity. The masks differ from the JAX
    package's (another generator); their law is the same."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def sharded_dropout_apply(x: torch.Tensor, rate: float,
                          generator: Optional[torch.Generator],
                          n_shards: int = 1, index: int = 0,
                          shard_dim: int = -1) -> torch.Tensor:
    """Dropout on block ``index`` of ``n_shards`` of a tensor split along
    ``shard_dim`` (tensor-parallel heads or FFN columns; the JAX
    ``sharded_dropout_apply``): the mask is drawn at the full shape from
    the replicated ``generator`` and this block sliced out, so each
    shard's mask is the unsharded mask restricted to its slice, and every
    shard advances the generator alike. At one shard it is
    :func:`dropout_apply`."""
    if n_shards == 1:
        return dropout_apply(x, rate, generator)
    return block_dropout(x, rate, generator,
                         ((shard_dim % x.ndim, n_shards, index),))


def block_dropout(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator], shards
                  ) -> torch.Tensor:
    """Inverted dropout on a block of a larger tensor: ``shards`` lists
    ``(dim, n, index)``, x being block ``index`` of ``n`` along each
    ``dim`` (a sequence chunk, and a tensor-parallel block of columns
    too). The mask is drawn at the whole tensor's shape and this block
    kept, so it is the unsharded mask's block."""
    if generator is None or rate == 0.0:
        return x
    full = list(x.shape)
    for dim, n, _ in shards:
        full[dim] *= n
    keep = torch.rand(full, generator=generator, device=x.device) >= rate
    for dim, n, index in shards:
        keep = keep.narrow(dim, index * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position NLL through an f32 log-softmax: [..., V] x [...] ->
    [...] f32 (the JAX ``_token_nll`` formulation)."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logz, -1, targets.long()[..., None])[..., 0]


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean token-wise cross entropy over all positions (f32)."""
    return token_nll(logits, targets).mean()


def masked_xent_sum(logits: torch.Tensor, targets: torch.Tensor,
                    pad_id: int):
    """Cross-entropy SUM over non-pad positions and the valid-token count:
    the caller divides by a (global) count for the ignore-index mean."""
    nll = token_nll(logits, targets)
    valid = targets != pad_id
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def global_pad_scale(targets: torch.Tensor, pad_id: int,
                     n_micro: int) -> torch.Tensor:
    """``n_micro / n_valid`` over the whole batch: multiplied into each
    microbatch's masked NLL sum, it turns the executor's later ``1/n_micro``
    into the global ignore-index mean ``total_nll / n_valid``."""
    n_valid = (targets != pad_id).sum().float()
    return n_micro / n_valid.clamp_min(1.0)


def select_masked_xent_sum(use_fused: bool):
    """The ignore-index loss core: :func:`masked_xent_sum` or its
    fused-kernel twin, same (sum, count) contract."""
    if use_fused:
        from .fused_xent import fused_masked_xent_sum
        return fused_masked_xent_sum
    return masked_xent_sum


def select_xent(use_fused: bool):
    """The mean loss: :func:`cross_entropy_loss` or the fused-kernel
    version, which never writes the [N, V] log-softmax."""
    if use_fused:
        from .fused_xent import fused_cross_entropy_loss
        return fused_cross_entropy_loss
    return cross_entropy_loss
