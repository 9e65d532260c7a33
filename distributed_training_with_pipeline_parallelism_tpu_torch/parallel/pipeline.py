"""The contiguous stage split of the JAX package's
``parallel/pipeline.py:stack_stage_layers`` (wrap placement, one chunk
per stage): stage d holds layers ``d*L/D .. (d+1)*L/D - 1``. Nothing else
of that module belongs to the decode slice."""

from __future__ import annotations

from typing import List

import torch.nn as nn


def stack_stage_layers(layers: nn.ModuleList, n_stages: int
                       ) -> List[nn.ModuleList]:
    """Split ``layers`` into ``n_stages`` contiguous slices (the blocks
    are shared, not copied)."""
    n = len(layers)
    if n % n_stages != 0:
        raise ValueError(f"n_layers={n} must divide evenly into "
                         f"{n_stages} stages")
    lps = n // n_stages
    return [nn.ModuleList(layers[d * lps:(d + 1) * lps])
            for d in range(n_stages)]
