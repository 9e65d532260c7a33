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


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, table)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position NLL through an f32 log-softmax: [..., V] x [...] ->
    [...] f32 (the JAX ``_token_nll`` formulation)."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logz, -1, targets.long()[..., None])[..., 0]
