"""Load a JAX-package parameter pytree into the port's model.

The caller turns the JAX pytree's leaves into numpy arrays
(``jax.tree.map(np.asarray, params)``); the port never imports jax.
Layouts: a JAX ``linear.w`` is ``[in, out]`` and becomes torch's
``[out, in]``; the ``layers`` leaves are stacked ``[L, ...]`` (the JAX
``vmap`` over layers) and are split per block. Under
``cfg.tie_embeddings`` the pytree's head has no ``out`` leaf (the head is
the token table). The loader takes any pytree of that layout, so a JAX
gradient pytree loads the same way, into a model whose parameters are
the gradients (what the parity tests compare leaf by leaf).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.transformer import Transformer
from ..utils.config import ModelConfig, resolve_device, torch_dtype


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch can't read it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def from_jax_params(cfg: ModelConfig, tree: Dict, device="cuda") -> Transformer:
    """The port's GPT-2 model holding the weights of the JAX pytree
    ``{"embed": {"tok", "pos"}, "layers": {...stacked [L, ...]},
    "head": {"norm", "out"}}`` (no ``out`` when tied) with numpy leaves,
    in ``cfg.storage_dtype`` on ``device``."""
    device = resolve_device(device)
    state = {"tok": tree["embed"]["tok"], "pos": tree["embed"]["pos"],
             "norm.weight": tree["head"]["norm"]["scale"],
             "norm.bias": tree["head"]["norm"]["bias"]}
    if not cfg.tie_embeddings:
        state["out.weight"] = np.asarray(tree["head"]["out"]["w"]).T
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        for ln in ("ln1", "ln2"):
            state[f"layers.{i}.{ln}.weight"] = layers[ln]["scale"][i]
            state[f"layers.{i}.{ln}.bias"] = layers[ln]["bias"][i]
        lins = {f"attn.{n}": layers["attn"][n] for n in ("q", "k", "v", "o")}
        lins.update(lin1=layers["lin1"], lin2=layers["lin2"])
        for name, leaf in lins.items():
            state[f"layers.{i}.{name}.weight"] = np.asarray(leaf["w"][i]).T
            state[f"layers.{i}.{name}.bias"] = leaf["b"][i]
    dtype = torch_dtype(cfg.storage_dtype)
    model = Transformer(cfg, device=device, dtype=dtype)
    model.load_state_dict({k: _tensor(v).to(device=device, dtype=dtype)
                           for k, v in state.items()})
    return model
