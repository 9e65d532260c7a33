"""Training dynamics: the per-stage non-finite count the anomaly guard
reads (the JAX package's ``utils/dynamics.py:nonfinite_per_stage``). The
rest of that module — per-stage statistics, the gradient-noise scale,
forensics — is ``ROADMAP.md`` Queue 1, item 12."""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn


def _n_bad(params: Iterable[nn.Parameter], device) -> torch.Tensor:
    """How many of ``params`` hold a non-finite gradient element (0-d
    int32 on ``device``; a parameter without a gradient counts 0)."""
    bad = [~torch.isfinite(p.grad).all() for p in params if p.grad is not None]
    if not bad:
        return torch.zeros((), dtype=torch.int32, device=device)
    return torch.stack(bad).sum(dtype=torch.int32)


def nonfinite_per_stage(n_layers: int, n_stages: int,
                        model: nn.Module) -> torch.Tensor:
    """[S] int32 on the model's device: the (parameter, layer) units with a
    non-finite gradient, per pipeline stage (S = ``n_stages``, stage s
    holding layers ``s * L/S`` .. ``(s+1) * L/S - 1``). The embedding's
    parameters (``tok``, GPT-2's ``pos``) are charged to stage 0 and the
    head's (the final norm, ``out``) to stage S - 1, as the JAX function
    charges its ``embed`` and ``head`` leaves. Computed on the device;
    zero everywhere means the step's gradients are clean."""
    S, lps = n_stages, n_layers // n_stages
    device = model.tok.device
    per_layer = torch.stack([_n_bad(layer.parameters(), device)
                             for layer in model.layers])
    nf = per_layer.view(S, lps).sum(dim=1, dtype=torch.int32)
    head = [p for n, p in model.named_parameters()
            if n.split(".")[0] in ("norm", "out")]
    embed = [p for n, p in model.named_parameters() if n in ("tok", "pos")]
    extra = torch.zeros((S,), dtype=torch.int32, device=device)
    extra[0] = _n_bad(embed, device)
    extra[S - 1] += _n_bad(head, device)
    return nf + extra
