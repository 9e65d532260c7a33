"""Hugging Face GPT-2 / Llama / Mistral / Qwen2 / Gemma checkpoints in and
out of the port (the port's own copy of the JAX package's
``models/hf.py``).

:func:`from_hf` turns a ``transformers`` causal LM, or any object with
``.config.model_type`` and ``.state_dict()``, into ``(ModelConfig,
Transformer)``; the ``*_params_from_hf`` readers also take a raw state
dict. :func:`to_hf` turns the port's model back into a ``transformers``
model, and :func:`gpt2_state_dict` / :func:`llama_state_dict` give its
HF-named float32 tensors.

Conventions (why the conversion is exact):

- HF GPT-2's ``Conv1D`` stores ``[in, out]``; the port's ``nn.Linear``
  wants ``[out, in]``, so GPT-2's matrices are transposed. Llama's
  ``nn.Linear`` already is the port's layout and is not transposed (the
  JAX package transposes it: its layout is ``[in, out]``).
- HF GPT-2's ``gelu_new`` is the tanh approximation the port's ``gelu``
  computes; LayerNorm eps 1e-5 is the port's.
- HF Llama RoPE is the half-split ("rotate_half") convention of
  ``ops.attention.apply_rope``; the rms eps rides in the config.
- ``tie_word_embeddings`` carries through as ``cfg.tie_embeddings``: a
  tied source gives no ``out.weight``; an untied config of a tied source
  materialises it from the token table.
- Gemma's ``(1 + w)`` RMSNorm scales are folded in float32 before any
  cast, and unfolded on export.

The readers work on the source's tensors where they lie (a checkpoint on
the card is never copied through the host) and write the port's model in
``cfg.storage_dtype`` on ``device``. ``transformers`` is imported only by
:func:`to_hf`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.config import ModelConfig, resolve_device, torch_dtype
from .transformer import Transformer

StateDict = Dict[str, torch.Tensor]


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))  # a numpy leaf: a writable copy


def _state_dict(model_or_sd) -> StateDict:
    sd = model_or_sd if isinstance(model_or_sd, dict) \
        else model_or_sd.state_dict()
    return {k: _tensor(v) for k, v in sd.items()}


def _load(cfg: ModelConfig, state: StateDict, device) -> Transformer:
    """The port's model holding ``state`` (port names, any dtype and
    device), in ``cfg.storage_dtype`` on ``device``: ``load_state_dict``
    copies and casts each tensor once."""
    model = Transformer(cfg, device=resolve_device(device),
                        dtype=torch_dtype(cfg.storage_dtype))
    with torch.no_grad():
        model.load_state_dict(state)
    return model


# ---------------------------------------------------------------------------
# GPT-2
# ---------------------------------------------------------------------------


def gpt2_config_from_hf(hf_config) -> ModelConfig:
    return ModelConfig(
        dim=hf_config.n_embd, n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head, vocab_size=hf_config.vocab_size,
        ffn_dim=hf_config.n_inner or 4 * hf_config.n_embd,
        max_seq_len=hf_config.n_positions, arch="gpt2",
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", True)))


def gpt2_params_from_hf(model_or_sd, cfg: ModelConfig,
                        device="cuda") -> Transformer:
    sd = _state_dict(model_or_sd)
    pre = "transformer." if any(k.startswith("transformer.") for k in sd) \
        else ""
    d = cfg.dim
    wte = sd[pre + "wte.weight"]
    state = {"tok": wte, "pos": sd[pre + "wpe.weight"][:cfg.max_seq_len],
             "norm.weight": sd[pre + "ln_f.weight"],
             "norm.bias": sd[pre + "ln_f.bias"]}
    if not cfg.tie_embeddings:
        # untied config: materialise the head matrix ([vocab, dim] both)
        state["out.weight"] = sd.get("lm_head.weight", wte)
    for i in range(cfg.n_layers):
        p, q = f"{pre}h.{i}.", f"layers.{i}."
        ca_w, ca_b = sd[p + "attn.c_attn.weight"], sd[p + "attn.c_attn.bias"]
        for j, n in enumerate("qkv"):  # Conv1D [in, out] -> [out, in]
            state[f"{q}attn.{n}.weight"] = ca_w[:, j * d:(j + 1) * d].T
            state[f"{q}attn.{n}.bias"] = ca_b[j * d:(j + 1) * d]
        for port_name, hf_name in (("attn.o", "attn.c_proj"),
                                   ("lin1", "mlp.c_fc"),
                                   ("lin2", "mlp.c_proj")):
            state[f"{q}{port_name}.weight"] = sd[f"{p}{hf_name}.weight"].T
            state[f"{q}{port_name}.bias"] = sd[f"{p}{hf_name}.bias"]
        for port_name, hf_name in (("ln1", "ln_1"), ("ln2", "ln_2")):
            state[f"{q}{port_name}.weight"] = sd[f"{p}{hf_name}.weight"]
            state[f"{q}{port_name}.bias"] = sd[f"{p}{hf_name}.bias"]
    return _load(cfg, state, device)


# ---------------------------------------------------------------------------
# Llama
# ---------------------------------------------------------------------------


def llama_config_from_hf(hf_config) -> ModelConfig:
    # Refuse configs whose semantics this conversion does not carry — a
    # silent pass-through here would produce plausible-looking wrong logits.
    scaling = getattr(hf_config, "rope_scaling", None)
    rope_scaling = None
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type"))
        if rope_type == "llama3":
            rope_scaling = (float(scaling["factor"]),
                            float(scaling["low_freq_factor"]),
                            float(scaling["high_freq_factor"]),
                            int(scaling["original_max_position_embeddings"]))
        elif rope_type != "default":
            # 'default' is transformers' spelling of plain RoPE; anything
            # else (yarn, dynamic NTK, ...) is not carried by this converter
            raise NotImplementedError(
                f"rope_scaling={scaling!r} is not supported by this "
                f"converter; plain RoPE and rope_type='llama3' are")
    if getattr(hf_config, "mlp_bias", False):
        raise NotImplementedError(
            "mlp_bias=True checkpoints are not supported (gate/up/down "
            "projection biases would be dropped)")
    # decoupled head_dim (Gemma, Mistral-Nemo-class): carried natively via
    # head_dim_override
    hd = getattr(hf_config, "head_dim", None)
    override = (int(hd) if hd and
                hd != hf_config.hidden_size // hf_config.num_attention_heads
                else None)
    # Qwen2 always carries q/k/v biases (its config has no attention_bias
    # field) and no o bias. Llama's attention_bias=True puts a bias on
    # o_proj TOO — the port's blocks have no o bias, so importing would
    # silently drop it; refuse instead.
    qkv_bias = hf_config.model_type == "qwen2"
    if getattr(hf_config, "attention_bias", False):
        raise NotImplementedError(
            "Llama attention_bias=True checkpoints are not supported (the "
            "o_proj bias would be dropped; Qwen2's qkv-only biases are)")
    window = getattr(hf_config, "sliding_window", None)
    if hf_config.model_type == "qwen2":
        if not getattr(hf_config, "use_sliding_window", False):
            window = None  # qwen2 configs carry the field but default it off
        elif getattr(hf_config, "max_window_layers", 0) > 0:
            # HF windows only layers >= max_window_layers; the port's
            # sliding_window is uniform — a silent import would window
            # layers HF attends fully
            raise NotImplementedError(
                "qwen2 use_sliding_window with max_window_layers > 0 mixes "
                "full and windowed layers; only uniform windowing "
                "(max_window_layers=0) is supported")
    return ModelConfig(
        dim=hf_config.hidden_size, n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        vocab_size=hf_config.vocab_size, ffn_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings, arch="llama",
        rope_theta=float(hf_config.rope_theta),
        rope_scaling=rope_scaling,
        sliding_window=window,
        attention_qkv_bias=qkv_bias,
        head_dim_override=override,
        rms_eps=float(hf_config.rms_norm_eps),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)))


_LLAMA_LINEARS = (("attn.q", "self_attn.q_proj"), ("attn.k", "self_attn.k_proj"),
                  ("attn.v", "self_attn.v_proj"), ("attn.o", "self_attn.o_proj"),
                  ("w1", "mlp.gate_proj"), ("w2", "mlp.down_proj"),
                  ("w3", "mlp.up_proj"))
_LLAMA_NORMS = (("rms1", "input_layernorm"),
                ("rms2", "post_attention_layernorm"))


def llama_params_from_hf(model_or_sd, cfg: ModelConfig,
                         norm_offset: float = 0.0,
                         device="cuda") -> Transformer:
    """``norm_offset`` is added to every RMSNorm scale IN FLOAT32, before
    any dtype cast — Gemma's (1 + w) parametrization folds in exactly."""
    sd = _state_dict(model_or_sd)
    pre = "model." if any(k.startswith("model.") for k in sd) else ""

    def norm(name):
        return sd[name].float() + norm_offset

    embed = sd[pre + "embed_tokens.weight"]
    state = {"tok": embed, "norm.weight": norm(pre + "norm.weight")}
    if not cfg.tie_embeddings:  # materialise a tied source untied
        state["out.weight"] = sd.get("lm_head.weight", embed)
    for i in range(cfg.n_layers):
        p, q = f"{pre}layers.{i}.", f"layers.{i}."
        for port_name, hf_name in _LLAMA_NORMS:
            state[f"{q}{port_name}.weight"] = norm(f"{p}{hf_name}.weight")
        for port_name, hf_name in _LLAMA_LINEARS:  # both [out, in]
            state[f"{q}{port_name}.weight"] = sd[f"{p}{hf_name}.weight"]
        if cfg.attention_qkv_bias:
            for n in "qkv":
                state[f"{q}attn.{n}.bias"] = sd[f"{p}self_attn.{n}_proj.bias"]
    return _load(cfg, state, device)


# ---------------------------------------------------------------------------
# Gemma
# ---------------------------------------------------------------------------


def gemma_config_from_hf(hf_config) -> ModelConfig:
    act = getattr(hf_config, "hidden_activation", None) or getattr(
        hf_config, "hidden_act", None)
    # 'gelu' is accepted only for model_type='gemma', where the historical
    # Gemma-1 checkpoints said 'gelu' but were trained with the tanh
    # approximation (the documented HF reading). Anywhere else 'gelu' means
    # exact erf GELU, which the port's tanh gelu would silently change.
    gemma1_tanh_reading = (
        act == "gelu" and getattr(hf_config, "model_type", None) == "gemma")
    if act != "gelu_pytorch_tanh" and not gemma1_tanh_reading:
        raise NotImplementedError(
            f"gemma hidden activation {act!r} is not supported (tanh-approx "
            f"gelu == jax.nn.gelu's default is; exact-erf 'gelu' outside "
            f"model_type='gemma' would need approximate=False plumbing)")
    base = llama_config_from_hf(hf_config)
    return dataclasses.replace(
        base,
        head_dim_override=int(hf_config.head_dim),
        mlp_act="gelu", embed_scale=True,
        # Gemma ties unconditionally
        tie_embeddings=True)


def gemma_params_from_hf(model_or_sd, cfg: ModelConfig,
                         device="cuda") -> Transformer:
    """Gemma stores RMSNorm weights in the ``(1 + w)`` parametrization; the
    port's norm multiplies by the stored scale directly, so the +1 is
    folded in (exactly, in float32, before any dtype cast) and unfolded on
    export — zero runtime cost."""
    return llama_params_from_hf(model_or_sd, cfg, norm_offset=1.0,
                                device=device)


_CONVERTERS = {
    "gpt2": (gpt2_config_from_hf, gpt2_params_from_hf),
    "llama": (llama_config_from_hf, llama_params_from_hf),
    # Mistral = llama blocks + sliding-window attention; identical state
    # dict layout, window carried via config.sliding_window
    "mistral": (llama_config_from_hf, llama_params_from_hf),
    # Qwen2 = llama blocks + q/k/v biases (attention_qkv_bias)
    "qwen2": (llama_config_from_hf, llama_params_from_hf),
    # Gemma = llama blocks + decoupled head_dim + GeGLU + scaled embeddings
    # + (1+w) norms folded at conversion
    "gemma": (gemma_config_from_hf, gemma_params_from_hf),
}


def from_hf(model, dtype: str = "float32",
            device="cuda") -> Tuple[ModelConfig, Transformer]:
    """Convert a ``transformers`` causal-LM model (or any object with
    ``.config.model_type`` and ``.state_dict()``) to ``(ModelConfig,
    Transformer)``, the model in ``cfg.storage_dtype`` on ``device``.

    Dispatches on the HF config's ``model_type``: "gpt2", "llama",
    "mistral" (llama converter + sliding window), "qwen2" (llama
    converter + q/k/v biases) or "gemma".
    """
    mt = model.config.model_type
    if mt not in _CONVERTERS:
        raise ValueError(
            f"unsupported HF model_type {mt!r}; expected {sorted(_CONVERTERS)}")
    config_fn, params_fn = _CONVERTERS[mt]
    cfg = dataclasses.replace(config_fn(model.config), dtype=dtype)
    return cfg, params_fn(model, cfg, device=device)


# ---------------------------------------------------------------------------
# Export (the inverse direction): the port -> transformers
# ---------------------------------------------------------------------------


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A contiguous float32 copy of ``t`` on its device (never a view of
    the model's parameter)."""
    return t.detach().to(torch.float32, memory_format=torch.contiguous_format,
                         copy=True)


def gpt2_state_dict(cfg: ModelConfig, model: Transformer) -> StateDict:
    """Inverse of :func:`gpt2_params_from_hf`: the port's model ->
    ``GPT2LMHeadModel`` state-dict tensors, float32 on the model's device
    (Conv1D [in, out] layout; q/k/v packed back into ``c_attn``)."""
    sd: StateDict = {
        "transformer.wte.weight": _f32(model.tok),
        "transformer.wpe.weight": _f32(model.pos),
        "transformer.ln_f.weight": _f32(model.norm.weight),
        "transformer.ln_f.bias": _f32(model.norm.bias),
    }
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _f32(model.out.weight)
    for i in range(cfg.n_layers):
        p, blk = f"transformer.h.{i}.", model.layers[i]
        a = blk.attn
        sd[p + "ln_1.weight"] = _f32(blk.ln1.weight)
        sd[p + "ln_1.bias"] = _f32(blk.ln1.bias)
        sd[p + "attn.c_attn.weight"] = _f32(torch.cat(
            [a["q"].weight, a["k"].weight, a["v"].weight]).T)
        sd[p + "attn.c_attn.bias"] = _f32(torch.cat(
            [a["q"].bias, a["k"].bias, a["v"].bias]))
        sd[p + "attn.c_proj.weight"] = _f32(a["o"].weight.T)
        sd[p + "attn.c_proj.bias"] = _f32(a["o"].bias)
        sd[p + "ln_2.weight"] = _f32(blk.ln2.weight)
        sd[p + "ln_2.bias"] = _f32(blk.ln2.bias)
        sd[p + "mlp.c_fc.weight"] = _f32(blk.lin1.weight.T)
        sd[p + "mlp.c_fc.bias"] = _f32(blk.lin1.bias)
        sd[p + "mlp.c_proj.weight"] = _f32(blk.lin2.weight.T)
        sd[p + "mlp.c_proj.bias"] = _f32(blk.lin2.bias)
    return sd


def llama_state_dict(cfg: ModelConfig, model: Transformer,
                     norm_offset: float = 0.0) -> StateDict:
    """Inverse of :func:`llama_params_from_hf` (both layouts [out, in]),
    float32 on the model's device; ``norm_offset`` is SUBTRACTED from
    RMSNorm scales (Gemma's (1+w))."""
    sd: StateDict = {
        "model.embed_tokens.weight": _f32(model.tok),
        "model.norm.weight": _f32(model.norm.weight) - norm_offset,
    }
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _f32(model.out.weight)
    for i in range(cfg.n_layers):
        p, blk = f"model.layers.{i}.", model.layers[i]
        for port_name, hf_name in _LLAMA_NORMS:
            sd[f"{p}{hf_name}.weight"] = (
                _f32(blk.get_parameter(f"{port_name}.weight")) - norm_offset)
        for port_name, hf_name in _LLAMA_LINEARS:
            sd[f"{p}{hf_name}.weight"] = _f32(
                blk.get_parameter(f"{port_name}.weight"))
        if cfg.attention_qkv_bias:
            for n in "qkv":
                sd[f"{p}self_attn.{n}_proj.bias"] = _f32(blk.attn[n].bias)
    return sd


def to_hf(cfg: ModelConfig, model: Transformer):
    """Convert (ModelConfig, the port's model) to a ``transformers`` model
    on the CPU — ``GPT2LMHeadModel``, ``GemmaForCausalLM`` (under
    ``cfg.embed_scale``), ``Qwen2ForCausalLM`` (under
    ``cfg.attention_qkv_bias``), ``MistralForCausalLM`` (when
    ``cfg.sliding_window`` is set) or ``LlamaForCausalLM``. The round trip
    ``from_hf(to_hf(cfg, model))`` is exact. Save with
    ``to_hf(...).save_pretrained(path)``.

    ``tie_word_embeddings`` follows ``cfg.tie_embeddings``: untied configs
    export an explicit ``lm_head``; tied configs export no head matrix and
    let transformers tie it to ``wte``/``embed_tokens``.
    """
    import transformers

    if cfg.arch == "gpt2":
        if cfg.embed_scale:
            raise NotImplementedError(
                "embed_scale on gpt2 blocks (the MoE LM convention) has no "
                "HF model_type — GPT2LMHeadModel never scales embeddings "
                "and exporting without the scale would silently change the "
                "logits")
        hf_cfg = transformers.GPT2Config(
            vocab_size=cfg.vocab_size, n_positions=cfg.max_seq_len,
            n_embd=cfg.dim, n_layer=cfg.n_layers, n_head=cfg.n_heads,
            n_inner=cfg.ffn_dim,
            tie_word_embeddings=cfg.tie_embeddings)
        hf = transformers.GPT2LMHeadModel(hf_cfg)
        sd = gpt2_state_dict(cfg, model)
    elif cfg.arch == "llama":
        common = dict(
            vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
            intermediate_size=cfg.ffn_dim, num_hidden_layers=cfg.n_layers,
            num_attention_heads=cfg.n_heads,
            num_key_value_heads=cfg.n_kv_heads or cfg.n_heads,
            max_position_embeddings=cfg.max_seq_len,
            head_dim=cfg.head_dim,
            rms_norm_eps=cfg.rms_eps, rope_theta=cfg.rope_theta,
            tie_word_embeddings=cfg.tie_embeddings)
        norm_offset = 0.0
        if cfg.embed_scale:
            # Gemma: GeGLU + scaled embeddings + (1+w) norms (unfolded
            # by the exporter)
            if (cfg.mlp_act != "gelu" or not cfg.tie_embeddings
                    or cfg.rope_scaling is not None
                    or cfg.sliding_window is not None
                    or cfg.attention_qkv_bias):
                raise NotImplementedError(
                    "embed_scale exports as Gemma, which requires "
                    "mlp_act='gelu', tied embeddings, plain RoPE, no "
                    "window, no qkv bias")
            hf_cfg = transformers.GemmaConfig(
                hidden_activation="gelu_pytorch_tanh", **common)
            hf = transformers.GemmaForCausalLM(hf_cfg)
            norm_offset = 1.0
        elif cfg.mlp_act != "silu":
            raise NotImplementedError(
                "mlp_act='gelu' without embed_scale has no HF model_type "
                "(Llama/Mistral/Qwen2 are SwiGLU); exporting as SwiGLU "
                "would silently change the MLP")
        elif cfg.attention_qkv_bias:
            # Qwen2: llama blocks + always-on q/k/v biases
            if cfg.rope_scaling is not None:
                raise NotImplementedError(
                    "attention_qkv_bias + rope_scaling: Qwen2Config carries "
                    "no llama3 rope_scaling field")
            hf_cfg = transformers.Qwen2Config(
                use_sliding_window=cfg.sliding_window is not None,
                sliding_window=cfg.sliding_window or cfg.max_seq_len,
                # 0: window EVERY exported layer — the port's window is
                # uniform, and HF's default (28) would silently disable
                # the window on models up to 28 layers
                max_window_layers=0,
                **common)
            hf = transformers.Qwen2ForCausalLM(hf_cfg)
        elif cfg.sliding_window is not None:
            if cfg.rope_scaling is not None:
                raise NotImplementedError(
                    "sliding_window + rope_scaling: MistralConfig carries no "
                    "llama3 rope_scaling field")
            hf_cfg = transformers.MistralConfig(
                sliding_window=cfg.sliding_window, **common)
            hf = transformers.MistralForCausalLM(hf_cfg)
        else:
            if cfg.rope_scaling is not None:
                factor, low, high, orig = cfg.rope_scaling
                common["rope_scaling"] = {
                    "rope_type": "llama3", "factor": factor,
                    "low_freq_factor": low, "high_freq_factor": high,
                    "original_max_position_embeddings": orig}
            hf_cfg = transformers.LlamaConfig(
                attention_bias=False, mlp_bias=False, **common)
            hf = transformers.LlamaForCausalLM(hf_cfg)
        sd = llama_state_dict(cfg, model, norm_offset)
    else:
        raise ValueError(
            f"arch {cfg.arch!r} has no HF equivalent (the ref_decoder block "
            f"is the reference-parity architecture, not a public one)")

    with torch.no_grad():
        missing, unexpected = hf.load_state_dict(sd, strict=False)
    # rotary inv_freq buffers etc. may be "missing" (they are derived), and
    # a tied config intentionally ships no lm_head (transformers ties it to
    # the embedding); any other missing weight or unknown key is a
    # conversion bug
    real_missing = [k for k in missing
                    if "inv_freq" not in k
                    and not (cfg.tie_embeddings and k == "lm_head.weight")]
    if real_missing or unexpected:
        raise RuntimeError(f"export mismatch: missing={real_missing}, "
                           f"unexpected={unexpected}")
    if cfg.tie_embeddings:
        hf.tie_weights()  # re-point lm_head at the loaded embedding
    return hf.eval()
