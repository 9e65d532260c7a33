"""Load a JAX-package parameter pytree (reference, GPT-2 or llama) into
the port's model.

The caller turns the JAX pytree's leaves into numpy arrays
(``jax.tree.map(np.asarray, params)``); the port never imports jax.
Layouts: a JAX ``linear.w`` is ``[in, out]`` and becomes torch's
``[out, in]``; the ``layers`` leaves are stacked ``[L, ...]`` (the JAX
``vmap`` over layers) and are split per block. Under
``cfg.tie_embeddings`` the pytree's head has no ``out`` leaf (the head is
the token table). The loader takes any pytree of that layout, so a JAX
gradient pytree loads the same way, into a model whose parameters are
the gradients (what the parity tests compare leaf by leaf), and a
speculative draft's pytree loads with the draft's config as the target's
does with its own.

A JAX ``moe_lm_init`` pytree (``moe=`` its ``MoEConfig``) loads into a
``models.moe.MoELM``: its blocks' ``ln1``, ``attn``, ``ln2`` as a GPT-2
block's, and ``moe``'s ``router.w`` and expert stacks as they are (the
port keeps their layout); ``expert=`` takes a rank's block of experts,
and ``shard=`` its Megatron shard of that block (each expert's ffn
split: JAX's addressable shard); ``parallel.fsdp.fsdp_shard_params``
cuts its FSDP shards from either.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import Transformer
from ..utils.config import ModelConfig, resolve_device, torch_dtype


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: torch can't read it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _linears(cfg: ModelConfig, layers: Dict, moe=None) -> Dict:
    """The block's linear leaves by port name (a MoE block's attention
    only: its FFN is not made of linears)."""
    attns = ("self_attn", "cross_attn") if cfg.arch == "ref_decoder" \
        else ("attn",)
    lins = {f"{a}.{n}": layers[a][n] for a in attns
            for n in ("q", "k", "v", "o")}
    if moe is None:
        names = ("w1", "w2", "w3") if cfg.arch == "llama" \
            else ("lin1", "lin2")
        lins.update({n: layers[n] for n in names})
    return lins


_BLOCK_NORMS = {"ref_decoder": ("ln1", "ln2", "ln3"), "gpt2": ("ln1", "ln2"),
                "llama": ("rms1", "rms2")}


def from_jax_params(cfg: ModelConfig, tree: Dict, device="cuda",
                    layers: Optional[Iterable[int]] = None,
                    shard=None, moe=None,
                    expert: Tuple[int, int] = (1, 0)) -> Transformer:
    """The port's model holding the weights of the JAX pytree with numpy
    leaves, in ``cfg.storage_dtype`` on ``device``. Reference:
    ``{"embed": {"tok"}, "layers": {"self_attn", "cross_attn", "ln1",
    "ln2", "ln3", "lin1", "lin2"}, "head": {"norm", "out"}}`` with q, k, v,
    o and the head's ``out`` biased; GPT-2:
    ``{"embed": {"tok", "pos"}, "layers": {"ln1", "attn", "ln2", "lin1",
    "lin2"}, "head": {"norm", "out"}}``; llama: ``{"embed": {"tok"},
    "layers": {"rms1", "attn", "rms2", "w1", "w2", "w3"}, "head": {"norm",
    "out"}}`` with q/k/v biases under ``cfg.attention_qkv_bias``; layer
    leaves stacked [L, ...]; no ``out`` when tied. ``layers`` (global
    indices): a pipe rank's view, holding only those blocks besides the
    embedding and the head (``models.transformer.Transformer``), so a
    world of ranks can be held to the JAX mesh on the same weights.
    ``shard`` (a ``parallel.tensor_parallel.TPShard``): the rank's
    Megatron shard of that view, the blocks of the JAX ``shard_params``
    layout at its model coordinate (``parallel.tensor_parallel.shard_model``).

    ``moe`` (a ``models.moe.MoEConfig``): ``tree`` is a JAX
    ``moe_lm_init`` pytree (``layers``: ``ln1``, ``attn``, ``ln2``,
    ``moe``: ``{"router": {"w"}, "w1", "b1", "w2", "b2"}``) and the result
    a ``models.moe.MoELM``; ``expert`` = ``(n_ep, index)`` keeps block
    ``index`` of ``n_ep`` of every expert stack (a rank's expert shard),
    which ``shard`` then splits as a MoE block's Megatron shard."""
    device = resolve_device(device)
    state = {"tok": tree["embed"]["tok"],
             "norm.weight": tree["head"]["norm"]["scale"]}
    if cfg.arch == "gpt2":
        state["pos"] = tree["embed"]["pos"]
    if cfg.arch != "llama":
        state["norm.bias"] = tree["head"]["norm"]["bias"]
    if not cfg.tie_embeddings:
        out = tree["head"]["out"]
        state["out.weight"] = np.asarray(out["w"]).T
        if "b" in out:
            state["out.bias"] = out["b"]
    own = range(cfg.n_layers) if layers is None else sorted(set(layers))
    leaves = tree["layers"]
    for i in own:
        for norm in _BLOCK_NORMS[cfg.arch]:
            state[f"layers.{i}.{norm}.weight"] = leaves[norm]["scale"][i]
            if "bias" in leaves[norm]:
                state[f"layers.{i}.{norm}.bias"] = leaves[norm]["bias"][i]
        for name, leaf in _linears(cfg, leaves, moe).items():
            state[f"layers.{i}.{name}.weight"] = np.asarray(leaf["w"][i]).T
            if "b" in leaf:
                state[f"layers.{i}.{name}.bias"] = leaf["b"][i]
        if moe is not None:
            from ..models.moe import EXPERT_LEAVES, expert_block
            ffn = leaves["moe"]
            state[f"layers.{i}.moe.router"] = ffn["router"]["w"][i]
            for leaf in EXPERT_LEAVES:
                name = f"layers.{i}.moe.{leaf}"
                state[name] = expert_block(name, np.asarray(ffn[leaf][i]),
                                           expert)
    dtype = torch_dtype(cfg.storage_dtype)
    if moe is not None:
        from ..models.moe import MoELM
        model = MoELM(cfg, moe, device=device, dtype=dtype, layers=own,
                      expert=expert)
    else:
        model = Transformer(cfg, device=device, dtype=dtype, layers=own)
    model.load_state_dict({k: _tensor(v).to(device=device, dtype=dtype)
                           for k, v in state.items()})
    if shard is not None:
        from ..parallel.tensor_parallel import shard_model
        model = shard_model(model, cfg, n=shard.n, index=shard.index,
                            vocab_parallel=shard.vocab_parallel)
    return model
