"""Round-robin pipelined decode (counterpart of the JAX package's
``parallel/pipelined_decode.py:make_pipeline_generate_fn``), run as D
stages in lockstep in one process on one card.

The model is split depth-wise into D contiguous stages
(:func:`.pipeline.stack_stage_layers`); each stage object owns its layer
slice and its ``[lps, B, max_len, Hkv, hd]`` KV cache (llama keeps its
``n_kv_heads`` there and expands them at attention time). ``M >= D``
independent batch streams of ``B/M`` rows round-robin through the stages,
the decode-time analogue of training microbatches: at tick u, stage d
works on stream ``(u - d) mod M``. The JAX package's +1 ring (one
``ppermute`` carrying hidden states d -> d+1 and the sampled token
D-1 -> 0) is a channel hand-off between the stage objects at the end of
each tick. The schedule is the JAX one: a prefill of M + D ticks over
whole prompts (the first token of every stream is sampled on the last
stage and banked on stage 0), then M*(N-1) + D decode ticks, the last of
which only banks the final token.

EOS: stage 0 keeps the ``done`` table; a live-row mask rides the channel
with the hidden state, every stage masks the cache writes of frozen rows,
and a stream whose rows have all finished skips its stage compute.
``return_logprobs`` rides home with the token.

Tensor parallelism (the JAX pipe x model mesh): ``mesh`` is a rank's
``parallel.mesh.Mesh`` of a world of shape (pipe 1, data 1, model T).
The JAX mesh's pipe axis stays this process's lockstep stages and its
model axis becomes the ranks: each rank holds its Megatron shard of
every stage (``tensor_parallel.shard_model(model, cfg, mesh,
vocab_parallel=False)``: the blocks split, the embedding and the head
whole), caches its ``Hkv/T`` kv heads and runs the same ticks, its
blocks' row-parallel projections all-reduced over the model group. The
greedy head goes vocab-parallel where T divides the vocabulary (the JAX
``_head_token``): rank t reads rows ``t*V/T .. (t+1)*V/T`` of the head
(or of the tied token table), and one all-gather of the ranks' (max,
argmax) pairs picks the first maximum, the global argmax's lowest-index
tie-break. Sampling and ``return_logprobs`` keep the replicated head;
every rank's logits are the same numbers, so ranks handed generators
seeded alike draw the same tokens. A data, seq or expert axis raises
the JAX refusal; a pipe axis above 1 (stages on ranks, the ring hop as
P2P) is ``ROADMAP.md`` Queue 1, item 15.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.generate import (check_decodable, check_decode_args,
                               layers_with_cache, lengths_of, model_on,
                               sample_logits, token_logprob)
from ..models.transformer import (Transformer, _c, compute_cast,
                                  embed_apply, head_apply, head_norm_apply,
                                  rope_table)
from ..ops import collectives as col
from ..ops.layers import linear
from ..utils.config import ModelConfig, resolve_device, torch_dtype
from .pipeline import stack_stage_layers
from .tensor_parallel import (check_block_shard, check_decode_mesh, check_tp,
                              kv_shard_heads)


def _slot_cache_apply(cfg: ModelConfig, layers, h: torch.Tensor,
                      kc: torch.Tensor, vc: torch.Tensor, g: int,
                      n_rows: int, offset: int, rope, *,
                      live_rows: Optional[torch.Tensor] = None,
                      prefill: bool = False, tp=None) -> torch.Tensor:
    """One stage's layer slice on h [n_rows, s, dim] for stream ``g``:
    its cache rows ``g*n_rows .. (g+1)*n_rows`` are updated in place
    (frozen rows, where ``live_rows`` is False, keep theirs). ``rope`` is
    the RoPE table (None for GPT-2). ``prefill`` marks the offset-0
    whole-prompt pass, the one site that may take the flash kernel.
    ``tp``: the rank's mesh, its blocks a model shard."""
    rows = slice(g * n_rows, (g + 1) * n_rows)
    return layers_with_cache(cfg, layers, h, kc[:, rows], vc[:, rows],
                             offset, rope, prefill=prefill,
                             live_rows=live_rows, tp=tp)


class _Stage:
    """One pipeline stage: its layer slice and its KV cache
    [lps, B, max_len, Hkv, hd] (Hkv/T under ``tp``)."""

    def __init__(self, cfg: ModelConfig, layers, batch: int, max_len: int,
                 device: torch.device, tp=None):
        shape = (len(layers), batch, max_len, kv_shard_heads(cfg, tp),
                 cfg.head_dim)
        dtype = torch_dtype(cfg.dtype)
        self.layers = layers
        self.tp = tp
        self.kc = torch.zeros(shape, dtype=dtype, device=device)
        self.vc = torch.zeros(shape, dtype=dtype, device=device)
        self.rope = rope_table(cfg, max_len, device)

    def apply(self, cfg, h, g, n_rows, offset, live_rows=None,
              prefill=False):
        return _slot_cache_apply(cfg, self.layers, h, self.kc, self.vc, g,
                                 n_rows, offset, self.rope,
                                 live_rows=live_rows, prefill=prefill,
                                 tp=self.tp)


def vocab_parallel_greedy(cfg: ModelConfig, model: Transformer,
                          y: torch.Tensor, mesh) -> torch.Tensor:
    """Greedy tokens [N] of hidden rows y [N, dim] with the head split
    over the vocab (the JAX ``_head_token``'s vocab-parallel branch):
    model rank t multiplies by rows ``t*V/T .. (t+1)*V/T`` of the head
    (or of the tied token table), and one all-gather of every rank's
    (max, argmax) pairs, in f64 (exact for both), picks the first
    maximum: ``torch.argmax`` takes the first on both levels, so the
    result is the global argmax with its lowest-index tie-break."""
    T, t = mesh.n_model, mesh.model
    vl = cfg.vocab_size // T
    hn = head_norm_apply(cfg, model, y)
    # the decodable archs' heads carry no bias
    w = model.tok if cfg.tie_embeddings else model.out.weight
    val, idx = linear(hn, _c(w[t * vl:(t + 1) * vl], hn)).max(dim=-1)
    pairs = col.tp_all_gather(torch.stack([val.double(),
                                           (idx + t * vl).double()]), mesh)
    win = pairs[:, 0].argmax(dim=0)  # [N]: the first rank holding the max
    return pairs[:, 1].gather(0, win[None])[0].long()


def _head_token(cfg: ModelConfig, model: Transformer, y_last: torch.Tensor,
                sample, return_logprobs: bool, tp=None,
                vocab_parallel: bool = False):
    """The last stage's head: next-token ids [B] from the last-position
    hidden y_last [B, dim], and their log-probs [B] f32 (or None).
    ``vocab_parallel`` (greedy under ``tp``) splits the head over the
    vocab (:func:`vocab_parallel_greedy`); log-probs need the replicated
    head's whole logits."""
    if vocab_parallel:
        if return_logprobs:
            raise ValueError("return_logprobs needs the replicated head "
                             "(full logits); vocab_parallel must be off")
        return vocab_parallel_greedy(cfg, model, y_last, tp), None
    logits = head_apply(cfg, model, y_last)
    tok = sample(logits)
    lp = token_logprob(cfg, logits, tok) if return_logprobs else None
    return tok, lp


def spec_accept_len(drafts, targets):
    """Longest-matching-prefix acceptance of greedy speculative decoding
    (the JAX ``spec_accept_len``; Leviathan et al., arXiv:2211.17192).

    ``drafts`` [gamma]: the draft model's proposals; ``targets`` [>= gamma]:
    the target's per-row argmaxes over the verify chunk, row ``i``
    conditioned on the context through draft ``i``. Draft ``i`` is
    accepted while ``drafts[i] == targets[i-1]`` (row 0's argmax is the
    free token), so the result is ``1 +`` the length of the matching
    prefix, in ``[1, gamma+1]``; ``targets[n - 1]`` is the token greedy
    decoding emits at the first mismatch. Takes torch tensors (a 0-d
    tensor back, on their device) or numpy arrays (a numpy integer)."""
    if isinstance(drafts, torch.Tensor) or isinstance(targets, torch.Tensor):
        drafts = torch.as_tensor(drafts)
        targets = torch.as_tensor(targets, device=drafts.device)
        hit = drafts == targets[:drafts.shape[0]]
        return 1 + torch.cumprod(hit.long(), 0).sum()
    drafts = np.asarray(drafts)
    hit = drafts == np.asarray(targets)[:drafts.shape[0]]
    return 1 + np.cumprod(hit.astype(np.int64)).sum()


def make_pipeline_generate_fn(cfg: ModelConfig, n_stages: int,
                              max_new_tokens: int, *,
                              n_streams: Optional[int] = None,
                              temperature: float = 0.0,
                              top_k: Optional[int] = None,
                              top_p: Optional[float] = None,
                              max_len: Optional[int] = None,
                              eos_id: Optional[int] = None,
                              return_lengths: bool = False,
                              return_logprobs: bool = False,
                              mesh=None, device="cuda"):
    """Build ``gen(model, prompt[, generator]) -> tokens [B, P+N]`` over
    ``n_stages`` lockstep stages (see the module doc).

    ``prompt`` is [B, P] with B divisible by ``n_streams`` (default: the
    stage count); stream g carries rows ``g*B/M .. (g+1)*B/M - 1``. With
    ``eos_id`` and ``return_lengths`` the result is ``(tokens, lengths)``;
    ``return_logprobs`` appends the emitted tokens' log-probs [B, N] f32.
    Greedy at temperature 0; sampling draws from ``generator`` (on the
    run's device) in tick order, so its numbers differ from the
    single-device ``generate``'s for the same generator state.

    ``mesh``: the rank's mesh of a (pipe 1, data 1, model T) world, whose
    ``model`` is its model shard (see the module doc); every rank calls
    ``gen`` with the same prompt (and a generator seeded alike).
    """
    check_decodable(cfg)
    T = check_decode_mesh(mesh, "decode")
    check_tp(cfg, T)
    D = n_stages
    if D < 1 or cfg.n_layers % D:
        raise ValueError(f"n_layers={cfg.n_layers} must divide over {D} "
                         "stages")
    M = n_streams or D
    if M < D:
        raise ValueError(f"n_streams={M} must be >= the stage count {D} "
                         "(fewer streams than stages stalls the ring)")
    N = max_new_tokens
    if N < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {N}")
    if return_lengths and eos_id is None:
        raise ValueError("return_lengths=True requires an eos_id (without "
                         "one every stream emits exactly max_new_tokens)")
    device = resolve_device(device)
    use_eos = eos_id is not None
    # the JAX rule: greedy without log-probs, the vocab dividing over T
    vocab_parallel = (T > 1 and temperature == 0.0
                      and cfg.vocab_size % T == 0 and not return_logprobs)

    @torch.no_grad()
    def gen(model: Transformer, prompt, generator=None):
        prompt = torch.as_tensor(prompt, device=device)
        B, P = prompt.shape
        if B % M:
            raise ValueError(
                f"batch {B} is not divisible by n_streams={M}; each "
                "round-robin stream carries B/M requests, so pad the batch "
                "or pick n_streams dividing it")
        mlen = check_decode_args(cfg, P, N, max_len, eos_id, return_lengths,
                                 temperature, generator)
        model_on(model, device)
        check_block_shard(model, mesh)
        model_c = compute_cast(cfg, model)
        Bg = B // M
        stages = [_Stage(cfg, chunks[0], B, mlen, device, mesh)
                  for chunks in stack_stage_layers(model_c.layers, D)]
        prompt_g = prompt.long().view(M, Bg, P)
        token_buf = torch.zeros((M, Bg), dtype=torch.long, device=device)
        out_buf = torch.zeros((N, M, Bg), dtype=torch.long, device=device)
        lp_buf = (torch.zeros((N, M, Bg), dtype=torch.float32, device=device)
                  if return_logprobs else None)
        done = (torch.zeros((M, Bg), dtype=torch.bool, device=device)
                if use_eos else None)

        def head(y):
            return _head_token(
                cfg, model_c, y[:, -1],
                lambda lg: sample_logits(lg, temperature, top_k, top_p,
                                         generator),
                return_logprobs, mesh, vocab_parallel)

        # the channels of the ring: h_chan[d] (and lives_chan[d]) feed stage
        # d > 0 from stage d-1; tok_chan/lp_chan feed stage 0 from stage D-1
        h_chan: List[Optional[torch.Tensor]] = [None] * D
        lives_chan: List[Optional[torch.Tensor]] = [None] * D
        tok_chan = lp_chan = None

        # prefill: M + D ticks over whole prompts; the last tick only
        # banks the last stream's first token
        for t in range(M + D):
            wp = t - D  # the stream whose first token arrives now
            if 0 <= wp < M:
                token_buf[wp] = tok_chan
                out_buf[0, wp] = tok_chan
                if return_logprobs:  # the first token is always sampled
                    lp_buf[0, wp] = lp_chan
                if use_eos:  # a prompt may yield EOS as its first token
                    done[wp] = tok_chan == eos_id
            outs: List[Optional[torch.Tensor]] = [None] * D
            tok_out = lp_out = None
            for d in range(D):
                w = t - d
                if not 0 <= w < M:
                    continue
                x = embed_apply(cfg, model_c, prompt_g[w]) if d == 0 \
                    else h_chan[d]
                outs[d] = stages[d].apply(cfg, x, w, Bg, 0, prefill=True)
                if d == D - 1:
                    tok_out, lp_out = head(outs[d])
            h_chan = [None] + outs[:-1]
            tok_chan, lp_chan = tok_out, lp_out

        # decode: M*(N-1) + D ticks; stream g consumes its round-e token at
        # global position P + e
        h_chan = [None] * D
        for u in range(M * (N - 1) + D if N > 1 else 0):
            wa = u - D  # the stage-(D-1) unit of tick u-1, banked now
            if wa >= 0:
                ga, ia = wa % M, wa // M + 1
                if tok_chan is None:  # skipped: every row of ga is done
                    tok_eff = torch.full((Bg,), eos_id, device=device)
                    lp_eff = torch.zeros(Bg, device=device)
                elif use_eos:  # frozen rows emit forced EOS, log-prob 0.0
                    tok_eff = torch.where(done[ga], eos_id, tok_chan)
                    lp_eff = (None if lp_chan is None
                              else torch.where(done[ga], 0.0, lp_chan))
                else:
                    tok_eff, lp_eff = tok_chan, lp_chan
                token_buf[ga] = tok_eff
                out_buf[ia, ga] = tok_eff
                if return_logprobs:
                    lp_buf[ia, ga] = lp_eff
                if use_eos:
                    done[ga] |= tok_eff == eos_id
            outs = [None] * D
            lives_out: List[Optional[torch.Tensor]] = [None] * D
            tok_out = lp_out = None
            for d in range(D):
                w = u - d
                if not 0 <= w < M * (N - 1):
                    continue
                g, e = w % M, w // M
                lives = None
                if use_eos:
                    # banking ran first, so when M == D and a token arrives
                    # and is consumed in one tick, done already has it
                    lives = ~done[g] if d == 0 else lives_chan[d]
                    if lives is None or not bool(lives.any()):
                        continue  # every row of the stream is done
                x = (embed_apply(cfg, model_c, token_buf[g][:, None], P + e)
                     if d == 0 else h_chan[d])
                outs[d] = stages[d].apply(cfg, x, g, Bg, P + e,
                                          live_rows=lives)
                lives_out[d] = lives
                if d == D - 1:
                    tok_out, lp_out = head(outs[d])
            h_chan = [None] + outs[:-1]
            lives_chan = [None] + lives_out[:-1]
            tok_chan, lp_chan = tok_out, lp_out

        new = out_buf.permute(1, 2, 0).reshape(B, N)
        res = (torch.cat([prompt, new.to(prompt.dtype)], dim=1),)
        if return_lengths:
            res += (lengths_of(new, eos_id),)
        if return_logprobs:
            res += (lp_buf.permute(1, 2, 0).reshape(B, N),)
        return res if len(res) > 1 else res[0]

    return gen
