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
