"""Autoregressive decoding with a static-shape KV cache (counterpart of
the JAX package's ``models/generate.py``).

The cache is ``[n_layers, B, max_len, H, hd]`` per k and v, allocated
once and written in place at each step's offset (the JAX package's
``dynamic_update_slice`` returns a new buffer; in place saves a cache copy
per step). Prefill and decode share :func:`_forward_with_cache`; only the
whole-prompt prefill (offset 0, fresh cache: ``prefill=True``) may route
attention through the flash kernel, exactly as at the JAX
``generate.py:128-135``. Decode steps attend the cache through the plain
:func:`_attend_cached`, which is XLA code in the JAX package, not a
kernel. ``cfg.use_fused_xent`` routes the emitted tokens'
log-probabilities through the fused-xent kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.attention import band_mask, gqa_expand, scaled_dot_attention
from ..ops.flash_attention import flash_attention
from ..ops.fused_xent import fused_softmax_xent
from ..ops.layers import layer_norm, linear, token_nll
from ..utils.config import ModelConfig, resolve_device, torch_dtype
from .transformer import (Block, Transformer, _check_arch, compute_cast,
                          embed_apply, head_apply)

Cache = Dict[str, torch.Tensor]


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda") -> Cache:
    """All-zeros KV cache in the compute dtype: {"k", "v"} of
    [n_layers, B, max_len, H, hd] (GPT-2 has as many kv heads as query
    heads)."""
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_heads, cfg.head_dim)
    dtype = torch_dtype(cfg.dtype)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attend_cached(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, offset: int, n_heads: int,
                   window: Optional[int] = None) -> torch.Tensor:
    """Attention of S new queries q [B, S, H, hd] at global positions
    offset..offset+S-1 against the whole cache [B, T, Hkv, hd]: key j is
    visible to the query at position i iff j <= i (and i - j < window),
    which is causality inside the new block and masks the unwritten
    tail. -> [B, S, H*hd]."""
    k_cache, v_cache = gqa_expand(k_cache, v_cache, n_heads)
    s, t = q.shape[1], k_cache.shape[1]
    mask = band_mask(s, t, window, q_offset=offset, device=q.device)
    out = scaled_dot_attention(q, k_cache, v_cache, mask[None, None])
    return out.reshape(q.shape[0], s, -1)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, offset: int,
                 live_rows: Optional[torch.Tensor]) -> None:
    """cache[:, offset:offset+S] = new, in place; rows where ``live_rows``
    is False keep their previous values bit for bit."""
    region = cache[:, offset:offset + new.shape[1]]
    new = new.to(cache.dtype)
    if live_rows is not None:
        new = torch.where(live_rows[:, None, None, None], new, region)
    region.copy_(new)


def _layer_step(cfg: ModelConfig, block: Block, h: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, offset: int,
                prefill: bool = False,
                live_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block over S new positions h [B, S, dim]: writes their k/v into
    the layer's cache [B, T, H, hd] at ``offset`` and returns h_out.

    ``prefill=True`` is the caller's promise that ``offset`` is 0 and the
    cache held nothing before: the new block is then the whole visible
    sequence, so q attends the new k/v (not the cache) through the flash
    kernel where ``cfg.flash_for`` picks it. ``live_rows`` [B] bool masks
    the cache write of frozen rows (their outputs are discarded)."""
    b, s, _ = h.shape
    a = layer_norm(h, block.ln1.weight, block.ln1.bias)
    q, k, v = block.qkv(cfg, a)
    _write_cache(k_cache, k, offset, live_rows)
    _write_cache(v_cache, v, offset, live_rows)
    if prefill and cfg.flash_for(True, h.device):
        att = flash_attention(q, k, v, causal=True).reshape(b, s, -1)
    else:
        att = _attend_cached(q, k_cache, v_cache, offset, cfg.n_heads)
    o = block.attn["o"]
    return block.mlp(h + linear(att, o.weight, o.bias))


def layers_with_cache(cfg: ModelConfig, layers, h: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      offset: int, prefill: bool = False,
                      live_rows: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Run a stack of blocks over S new positions with per-layer caches
    [L, B, T, H, hd] (updated in place). Shared by the single-device
    decode and the pipelined decoder's stages."""
    for i, block in enumerate(layers):
        h = _layer_step(cfg, block, h, k_cache[i], v_cache[i], offset,
                        prefill=prefill, live_rows=live_rows)
    return h


def _forward_with_cache(cfg: ModelConfig, model: Transformer, cache: Cache,
                        tokens: torch.Tensor, offset: int,
                        prefill: bool = False,
                        live_rows: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Run tokens [B, S] at global positions offset..offset+S-1 through
    ``model`` (already in the compute dtype) and return the last
    position's logits [B, V]; ``cache`` is updated in place."""
    h = embed_apply(cfg, model, tokens, offset)
    h = layers_with_cache(cfg, model.layers, h, cache["k"], cache["v"],
                          offset, prefill=prefill, live_rows=live_rows)
    return head_apply(cfg, model, h[:, -1])


def token_logprob(cfg: ModelConfig, logits: torch.Tensor,
                  tok: torch.Tensor) -> torch.Tensor:
    """Log-probability [B] f32 of token ``tok`` [B] under logits [B, V]:
    through the fused-xent kernel under ``cfg.use_fused_xent``, else
    through the f32 log-softmax formulation."""
    if cfg.use_fused_xent:
        return -fused_softmax_xent(logits, tok)
    return -token_nll(logits, tok)


def sample_logits(logits: torch.Tensor, temperature: float = 0.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Next-token ids [B] (int64) from logits [B, V].

    temperature 0 is greedy: the first index of the maximum. Otherwise a
    categorical draw from ``generator`` (on the logits' device) after
    temperature scaling and optional top-k and top-p (nucleus)
    truncation, with the JAX ``sample_logits`` cut rules."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling (temperature != 0) requires a generator")
    logits = logits.float() / temperature
    if top_k is not None:
        top_k = min(top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # the smallest prefix with mass >= top_p: cut at the last logit
        # whose exclusive cumulative mass is < top_p
        exclusive_cdf = torch.cumsum(probs, dim=-1) - probs
        cutoff_idx = (exclusive_cdf < top_p).sum(dim=-1) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def check_decode_args(cfg: ModelConfig, prompt_len: int, max_new_tokens: int,
                      max_len: Optional[int], eos_id: Optional[int],
                      return_lengths: bool, temperature: float,
                      generator: Optional[torch.Generator]) -> int:
    """The JAX decoders' precondition checks; returns the cache length."""
    _check_arch(cfg)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if return_lengths and eos_id is None:
        raise ValueError("return_lengths=True requires an eos_id (without "
                         "one every row emits exactly max_new_tokens)")
    total = prompt_len + max_new_tokens
    max_len = max_len or total
    if total > max_len:
        raise ValueError(f"prompt ({prompt_len}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds max_len ({max_len})")
    if total > cfg.max_seq_len:
        raise ValueError(f"prompt ({prompt_len}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds the gpt2 position "
                         f"table (max_seq_len={cfg.max_seq_len})")
    if temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature != 0) requires a generator")
    return max_len


def model_on(model: Transformer, device: torch.device) -> None:
    """Raise unless the model's parameters live on ``device``."""
    have = next(model.parameters()).device
    if have != device and not (have.type == device.type == "cuda"
                               and device.index is None):
        raise ValueError(f"the model lives on {have}, the run on {device}; "
                         f"move it or pass device={str(have)!r}")


def lengths_of(new: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Emitted tokens per row including the first EOS (N without one)."""
    hit = new == eos_id
    first = torch.argmax(hit.int(), dim=1) + 1
    return torch.where(hit.any(dim=1), first,
                       torch.full_like(first, new.shape[1])).to(torch.int32)


@torch.no_grad()
def generate(cfg: ModelConfig, model: Transformer, prompt,
             max_new_tokens: int, *,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, max_len: Optional[int] = None,
             eos_id: Optional[int] = None, return_lengths: bool = False,
             return_logprobs: bool = False, device="cuda"):
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, P].

    Returns tokens [B, P + N]; with ``return_lengths`` (needs ``eos_id``)
    also lengths [B] int32; with ``return_logprobs`` also the emitted
    tokens' log-probabilities [B, N] f32, last. EOS freeze semantics of
    the JAX ``generate``: a row that emitted ``eos_id`` stops writing its
    cache, every later token it emits is ``eos_id`` and its log-prob is
    0.0 (forced, not sampled).
    """
    device = resolve_device(device)
    model_on(model, device)
    prompt = torch.as_tensor(prompt, device=device)
    b, p = prompt.shape
    n = max_new_tokens
    mlen = check_decode_args(cfg, p, n, max_len, eos_id, return_lengths,
                             temperature, generator)
    model = compute_cast(cfg, model)
    cache = init_cache(cfg, b, mlen, device=device)

    def sample(logits):
        return sample_logits(logits, temperature, top_k, top_p, generator)

    logits = _forward_with_cache(cfg, model, cache, prompt.long(), 0,
                                 prefill=True)
    tok = sample(logits)
    toks = [tok]
    lps = [token_logprob(cfg, logits, tok)] if return_logprobs else None
    done = tok == eos_id if eos_id is not None else None
    for step in range(1, n):
        # a row is done once the token it is about to consume is EOS: that
        # token's k/v never enter the cache
        live = None if done is None else ~done
        logits = _forward_with_cache(cfg, model, cache, tok[:, None],
                                     p + step - 1, live_rows=live)
        nxt = sample(logits)
        if return_logprobs:
            lp = token_logprob(cfg, logits, nxt)
            lps.append(lp if done is None else torch.where(done, 0.0, lp))
        if done is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        toks.append(tok)
    new = torch.stack(toks, dim=1)
    res = (torch.cat([prompt, new.to(prompt.dtype)], dim=1),)
    if return_lengths:
        res += (lengths_of(new, eos_id),)
    if return_logprobs:
        res += (torch.stack(lps, dim=1),)
    return res if len(res) > 1 else res[0]
