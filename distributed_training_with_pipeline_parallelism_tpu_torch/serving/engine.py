"""Slot-level continuous batching over the lockstep pipelined decoder
(counterpart of the JAX package's ``serving/engine.py``: the dense path,
paged KV with a radix prefix cache, and speculative draft-verify
decoding).

The static decoder (:mod:`..parallel.pipelined_decode`) round-robins
``M >= D`` streams that start and drain together. Here each stream is a
*slot* that an open request queue feeds:

- :func:`make_serving_step_fn` builds a :class:`ServingProgram` whose
  ``step`` advances the ring by ``block_ticks`` ticks (default M). Every
  shape is fixed: per-stage caches ``[lps, M, max_len + C - 1, Hkv, hd]``
  (llama keeps its ``n_kv_heads`` there; GQA heads are expanded only at
  attention time), a C-row chunk per visit, a ``[M, 12 + out_max]`` int64
  slot table on the device. ``C - 1`` extra cache rows absorb the junk
  tail of a C-wide write at the last legal offset, so a write never
  clamps.
- Tick ``u``: stage 0 first banks the token that rode in from stage D-1
  (the visit it served D ticks ago, slot ``(u - D) mod M``), then serves
  slot ``u mod M``; stage ``d > 0`` runs the visit stage d-1 ran last
  tick. A visit is a record riding the ring: slot, offset, valid rows,
  whether it ends at a sampling position, and the hidden state. Only the
  last stage runs the head, and only when the record says the chunk ends
  at a sampling position; sampling is greedy.
- *Chunked prefill*: an admitted request's prompt enters
  ``min(prefill_left, C)`` tokens a visit while other slots decode. A
  decode visit moves C rows, the last token and C-1 junk rows. Rows past
  the valid frontier are written but invisible (the band mask hides
  cache keys beyond a query's position) and are overwritten before the
  frontier reaches them.
- :class:`ServingEngine` drives the program from the host between blocks:
  retire finished slots (EOS or budget), refill them from the queue
  (``policy="continuous"``) or only once all have drained
  (``policy="static"``, the fill-drain baseline, on the same program),
  and fast-forward the tick counter across idle gaps.

**Host and device.** The JAX engine keeps its slot tables on the device
and reads them back once per block; this port does the same, with the
schedule split by what it depends on:

- Offsets, valid rows, ``prefill_left`` and the sampling flag do not
  depend on token values, so the host computes them (``pos``,
  ``prefill_left``, ``plen``, ``live`` and ``emitted_pred``, the tokens a
  slot has banked if none was EOS, are numpy arrays in the state). A slot
  whose budget is spent is known to the host and is not served.
- Token values, ``emitted``, ``finished``, ``out_buf`` and the
  ``t_first``/``t_finish`` stamps live in the device slot table and are
  read back once per block, in one copy. The tick loop makes no other
  device-to-host transfer; uploads after admission go from pinned memory
  without a wait.
- EOS is the one thing the host cannot foresee. A visit carries a device
  flag taken when stage 0 serves it (the slot not yet finished); banking
  is masked by it, so a slot that hit EOS mid-block banks nothing more
  and its stamps are those of the JAX engine. The visits it still runs
  until the block ends compute on a retired slot: their cache writes land
  in rows that a later occupant overwrites before it can see them (the
  same discipline as the junk rows), and they bank nothing.

**Paged KV** (``paged=True``): each stage's caches become one page pool
``[lps, n_pages, page_size, Hkv, hd]`` and the slot's rows are found
through its row of a ``[M, P_max]`` page table on the device, filled by
the host's :class:`.paging.PagedKVAllocator` (radix prefix reuse,
copy-on-write of the one page a request diverges inside, backpressure
when the pool is short). A visit writes its C rows into the pages that
hold them and attends the slot's pages gathered into a positionally
contiguous view of ``P_max * page_size`` rows. The JAX block scatters
the whole gathered view back; the rows outside the visit's are the
pages' own bytes, so writing only the visit's rows gives the same pool
and never writes a shared page. A visit carries the page row it was
served with, zeroed (all null page) when its slot had already finished,
so a visit in flight past its slot's retirement writes only the null
page. Queued copy-on-write copies run at block entry, before any tick.

**Speculative decoding** (``speculative=True``): a draft model, whole
and replicated, runs on stage 0 with its own contiguous caches. A visit
is one of three kinds: a prefill chunk (the draft catches up over the
same prompt), a catch-up decode (the draft's frontier trails the
target's, after a paged prefix skip: the draft reads up to C tokens, the
target decodes one), or a verify (the draft proposes ``gamma`` greedy
tokens, which ride in the target's C-wide chunk; the last stage takes
the per-row argmaxes and :func:`..parallel.pipelined_decode.
spec_accept_len` banks ``n_accepted`` tokens at once). Rejected rows lie
past the frontier and are rolled back by overwrite. Here the frontiers
``pos``/``dpos``, the acceptance counters and the budget test are device
columns of the slot table (they depend on ``n_accepted``); the host keeps
the prefill chunks and ``live``, and foresees the visit kind: before a
slot's first verify its frontiers move by amounts the host knows, and
from it on both advance by ``n_accepted`` together, so every later
decode visit is a verify. The device checks that foresight on every
visit (the JAX test ``dpos >= pos``) and flags a miss in the table,
which the host raises on. A served slot that already finished runs a
masked visit at an offset clamped into its own rows; it banks nothing.

On a CUDA device each stage's visit, the head, the verify head and the
draft's two turns (the catch-up chunk; the gamma single-token steps with
their heads) are CUDA graphs captured in ``prepare``; they read their
slot, positions and page row from static device buffers.

One slot table on one card replaces the JAX stage-0 tables and their
replication at the block end. ``ServeResult.host_syncs`` counts the
blocking reads (one per block).

**Tensor parallelism** (``mesh``: a rank's mesh of a (pipe 1, data 1,
model T) world; the JAX pipe x model mesh with its pipe axis kept as the
lockstep stages). Each rank holds its Megatron shard of every stage
(``tensor_parallel.shard_model(model, cfg, mesh, vocab_parallel=False)``)
and runs the whole program: its slot caches and page pools hold its
``Hkv/T`` kv heads, its blocks all-reduce their row-parallel projections
over the model group, and the decode and verify heads go vocab-parallel
(one all-gather of (max, argmax) pairs a head call) where T divides the
vocabulary. The draft runs replicated on every rank (JAX: inside stage
0's TP group). The host scheduler runs SPMD on every rank, over the same
requests and policy: every token value it reads is the same on every
rank, so the ranks admit, retire and serve alike, and ``run`` holds the
ranks' completions to each other at its end. A gloo collective staged
through host memory cannot be captured, so under a staging mesh the
program runs its visits eagerly (``cuda_graphs`` False from the build).
A data, seq or expert axis raises the JAX refusal, a pipe axis above 1
the port's. A ``utils.resilience.FaultPlan`` injects admission faults
(``serve_poison_rids``) and straggler delays (``serve_delay``) as the JAX
engine does. Admission refuses a prompt token outside the vocabulary (a failed
completion): the JAX gather clamps it, a CUDA embedding would fault.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.generate import _attend_cached, model_on
from ..models.transformer import (Transformer, compute_cast, embed_apply,
                                  head_apply, rope_table)
from ..ops import collectives as col
from ..ops.attention import Rope
from ..parallel.pipeline import stack_stage_layers
from ..parallel.pipelined_decode import spec_accept_len, vocab_parallel_greedy
from ..parallel.tensor_parallel import (check_block_shard, check_decode_mesh,
                                        check_tp, kv_shard_heads)
from ..utils.config import ModelConfig, resolve_device, torch_dtype
from ..utils.resilience import SimulatedFault
from .paging import PagedKVAllocator

# columns of the device slot table; out_buf follows them. POS, DPOS and
# PLEN and the acceptance counters serve the paged and speculative modes;
# ERR counts visits whose kind the host foresaw wrongly
(_TOK, _EMITTED, _FINISHED, _T_FIRST, _T_FINISH, _BUDGET, _POS, _DPOS,
 _PLEN, _SPEC_VISITS, _SPEC_ACC, _ERR) = range(12)
_NCOL = 12


@dataclasses.dataclass
class Request:
    """One serving request: ``prompt`` token ids, a per-request output
    budget, and an arrival time in *ticks* (0 = available immediately)."""
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival: float = 0.0


@dataclasses.dataclass
class Completion:
    """A finished request with its emitted tokens and tick-exact stamps.

    ``tokens`` includes the EOS token when the request ended on one.
    ``ttft_ticks`` counts from *arrival* (queue wait included);
    ``tpot_ticks`` is the mean tick gap between consecutive output tokens
    (None for single-token outputs). A request the scheduler retired
    without serving comes back with ``status="failed"``, a ``reason``, no
    tokens and ``-1`` stamps."""
    rid: int
    prompt: List[int]
    tokens: List[int]
    slot: int
    admit_tick: int
    first_token_tick: int
    finish_tick: int
    arrival: float
    status: str = "ok"
    reason: Optional[str] = None

    @property
    def ttft_ticks(self) -> float:
        return self.first_token_tick - self.arrival

    @property
    def admit_wait_ticks(self) -> float:
        """Queue wait: ticks between arrival and slot admission."""
        return self.admit_tick - self.arrival

    @property
    def service_ttft_ticks(self) -> float:
        """TTFT without the queue wait: admission to the first token."""
        return self.first_token_tick - self.admit_tick

    @property
    def tpot_ticks(self) -> Optional[float]:
        n = len(self.tokens)
        if n < 2:
            return None
        return (self.finish_tick - self.first_token_tick) / (n - 1)


@dataclasses.dataclass
class ServeResult:
    """What :meth:`ServingEngine.run` returns: completions in finish
    order, the slot occupancy and admission-queue depth sampled at every
    block boundary as ``(tick, n)`` (plus a ``(tick, 0)`` sample at every
    idle fast-forward), the ticks the ring advanced, the ticks it was
    busy, and the host wall-clock of the run. ``n_blocks`` and
    ``host_syncs`` (blocking device-to-host reads) are the port's own.

    Paged runs add the page gauges: ``pages_used`` and
    ``page_fragmentation`` as ``(tick, value)`` series at the same
    boundaries, the token-weighted ``prefix_hit_rate``, the prefill
    tokens the cache skipped, the COW copies and the admissions deferred
    by a short pool. Speculative runs add the verify visits and accepted
    proposals summed over the completions and the running acceptance
    rate at each boundary."""
    completions: List[Completion]
    occupancy: List[Any]
    ticks: int
    wall_s: float
    n_slots: int
    policy: str
    queue_depth: List[Any] = dataclasses.field(default_factory=list)
    busy_ticks: int = 0
    paged: bool = False
    pages_capacity: int = 0
    pages_used: List[Any] = dataclasses.field(default_factory=list)
    page_fragmentation: List[Any] = dataclasses.field(default_factory=list)
    prefix_hit_rate: Optional[float] = None
    prefill_skipped_tokens: int = 0
    n_cow: int = 0
    n_backpressure: int = 0
    speculative: bool = False
    gamma: int = 0
    spec_verify_visits: int = 0
    spec_accepted_tokens: int = 0
    acceptance_series: List[Any] = dataclasses.field(default_factory=list)
    n_blocks: int = 0
    host_syncs: int = 0

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Accepted proposals over offered ones, ``sum(n_acc - 1) /
        (gamma * verify_visits)``; None before a verify visit."""
        if not (self.speculative and self.gamma and self.spec_verify_visits):
            return None
        return self.spec_accepted_tokens / (self.gamma
                                            * self.spec_verify_visits)

    @property
    def accepted_len_mean(self) -> Optional[float]:
        """Mean tokens banked per verify visit, in ``[1, gamma+1]``."""
        if not (self.speculative and self.spec_verify_visits):
            return None
        return 1.0 + self.spec_accepted_tokens / self.spec_verify_visits

    @property
    def tokens_out(self) -> int:
        return sum(len(c.tokens) for c in self.completions)

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def goodput(self) -> float:
        """Emitted tokens per tick (idle fast-forwarded gaps included)."""
        return self.tokens_out / self.ticks if self.ticks else 0.0

    @property
    def goodput_busy(self) -> float:
        """Emitted tokens per busy tick (ticks run with >= 1 live slot at
        block entry)."""
        return self.tokens_out / self.busy_ticks if self.busy_ticks else 0.0

    @property
    def n_failed(self) -> int:
        return sum(1 for c in self.completions if c.status == "failed")


class _Visit(NamedTuple):
    """One slot visit riding the ring: slot, the slot's admission count
    when it was served, first position (an int, or a [1] device tensor in
    speculative mode), valid rows, whether its last valid row is a
    sampling position, the device flag that the slot was live when stage 0
    served it (None when the host knows it), the input or hidden state
    (None at stage 0 under CUDA graphs: the graph reads its token buffer),
    the sampled token(s), the kind (``"pre"``, ``"dec"`` or ``"ver"``),
    the page-table row it was served with (paged), and the draft's
    proposals (a verify)."""
    g: int
    epoch: int
    offset: Any
    s_valid: int
    sample: bool
    act: Optional[torch.Tensor]
    h: Optional[torch.Tensor]
    tok: Optional[torch.Tensor] = None
    kind: str = "dec"
    pt: Optional[torch.Tensor] = None
    drafts: Optional[torch.Tensor] = None


class _Graph:
    """One CUDA graph of ``fn`` (which takes no argument: it reads static
    device buffers); ``replay()`` reruns it and returns its output, a
    static buffer that the next replay overwrites."""

    def __init__(self, fn, device: torch.device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm-up, as capture asks
            for _ in range(2):
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.out


class _Weights(NamedTuple):
    model: Transformer  # in the compute dtype
    stages: List        # D layer slices
    rope: Any           # the RoPE table of mlen_alloc rows (None: GPT-2)
    graphs: Optional[Dict[str, Any]] = None  # "stages", "head", ... graphs
    draft: Optional[Transformer] = None  # speculative: in its compute dtype
    drope: Any = None   # the draft's RoPE table


def _apply_layers(cfg: ModelConfig, layers, h: torch.Tensor,
                  kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
                  rope: Optional[Rope], slot: torch.Tensor,
                  pt: Optional[torch.Tensor],
                  ar_t: torch.Tensor, tp=None) -> torch.Tensor:
    """A layer slice on one visit: h [1, S, dim] at positions ``pos``
    [S]. Writes the rows' k/v into the cache and attends the slot's
    cache under the band at those positions (the JAX
    ``_slot_cache_apply``, or ``_paged_cache_apply`` when ``pt`` is the
    slot's page-table row [P_max]: the rows go to (page, row in page)
    and the attention reads the slot's pages gathered in table order, a
    view of ``P_max * page_size`` rows). Caches: [L, M, T, Hkv, hd]
    contiguous, [L, n_pages, page_size, Hkv, hd] paged; ``ar_t`` is
    ``arange`` of the rows the attention sees. ``tp``: the rank's mesh,
    its blocks a model shard and its caches Hkv/T heads."""
    rope_at = None if rope is None else Rope(
        rope.cos.index_select(0, pos), rope.sin.index_select(0, pos))
    mask = pos[:, None] >= ar_t[None, :]
    if cfg.sliding_window is not None:
        mask &= pos[:, None] - ar_t[None, :] < cfg.sliding_window
    if pt is None:
        rows = (slot.expand(pos.shape[0]), pos)
    else:
        ps = kc.shape[2]
        rows = (pt.index_select(0, pos // ps), pos % ps)
    for i, block in enumerate(layers):
        kl, vl = kc[i], vc[i]
        a = col.tp_copy(block.attn_norm(h), tp)
        q, k, v = block.qkv(cfg, a, rope_at)
        kl.index_put_(rows, k[0].to(kl.dtype))
        vl.index_put_(rows, v[0].to(vl.dtype))
        if pt is None:
            ks, vs = kl.index_select(0, slot), vl.index_select(0, slot)
        else:
            ks = kl.index_select(0, pt).view(1, -1, *kl.shape[2:])
            vs = vl.index_select(0, pt).view(1, -1, *vl.shape[2:])
        att = _attend_cached(q, ks, vs, 0, q.shape[2], mask=mask)
        h = block.mlp(h + block.proj(att, tp), tp=tp)
    return h


def _greedy(cfg: ModelConfig, model: Transformer, y: torch.Tensor,
            tp=None, vocab_parallel: bool = False) -> torch.Tensor:
    """Greedy tokens [N] of hidden rows y [N, dim]; split over the vocab
    under ``vocab_parallel`` (rows are the batch, so the verify head takes
    the same path per row)."""
    if vocab_parallel:
        return vocab_parallel_greedy(cfg, model, y, tp)
    return torch.argmax(head_apply(cfg, model, y), dim=-1)


class ServingProgram:
    """The tick block and its fixed configuration. Built by
    :func:`make_serving_step_fn`; drive it through :class:`ServingEngine`
    (or ``prepare(model[, draft])``, ``init_state()`` and ``step(weights,
    state)``). The program owns the device buffers (caches, slot table,
    page table, the visits' inputs), so one engine at a time runs on it.

    A stage visit reads its slot, positions and page row from device
    tensors, so on a CUDA device each stage's visit, the heads and the
    draft's turns are CUDA graphs, captured by ``prepare`` and replayed
    for every visit; on the CPU they run eagerly. ``cuda_graphs = False``
    before ``prepare`` launches the same operations one by one on the
    card too (``chip_smoke.py`` holds the graphs to that); a staging
    ``mesh`` sets it False at the build (see the module doc)."""

    def __init__(self, cfg: ModelConfig, *, n_stages: int, n_slots: int,
                 max_len: int, prompt_max: int, out_max: int,
                 prefill_chunk: int, block_ticks: int,
                 eos_id: Optional[int], device: torch.device,
                 paged: bool = False, page_size: int = 0, n_pages: int = 0,
                 speculative: bool = False, gamma: int = 0,
                 draft_cfg: Optional[ModelConfig] = None,
                 mesh=None) -> None:
        self.cfg = cfg
        self.n_stages = n_stages
        self.n_slots = n_slots
        self.max_len = max_len
        self.prompt_max = prompt_max
        self.out_max = out_max
        self.prefill_chunk = prefill_chunk
        self.block_ticks = block_ticks
        self.eos_id = eos_id
        self.device = device
        self.paged = paged
        self.page_size = page_size
        self.n_pages = n_pages
        self.speculative = speculative
        self.gamma = gamma
        self.draft_cfg = draft_cfg
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.n_model
        self.vocab_parallel = self.tp > 1 and cfg.vocab_size % self.tp == 0
        # a collective staged through host memory cannot be captured
        self.cuda_graphs = device.type == "cuda" and not (
            self.tp > 1 and mesh.staging)
        self.n_captures = 0  # graph captures by prepare (one per weights)
        self._buf: Optional[Dict[str, Any]] = None

    @property
    def mlen_alloc(self) -> int:
        """Cache rows per slot: ``max_len`` plus the junk tail of a C-wide
        write at the last legal offset."""
        return self.max_len + self.prefill_chunk - 1

    @property
    def max_pages_per_slot(self) -> int:
        """Static page-table width: pages to cover ``mlen_alloc`` rows."""
        if not self.paged:
            return 0
        return -(-self.mlen_alloc // self.page_size)

    def _buffers(self) -> Dict[str, Any]:
        """The device buffers, allocated at first use: per-stage caches
        ([lps, M, mlen_alloc, Hkv, hd], or the page pools [lps, n_pages,
        page_size, Hkv, hd] and the page table), the slot table, the
        prompt buffer, the visits' inputs (a token row, each stage's
        positions, slot and page row, the head's row), and in speculative
        mode the draft's caches [L_draft, M, mlen_alloc, Hkv, hd], its
        slot and prefill flag, and the verify head's proposals. Under TP
        the target's caches hold the rank's Hkv/T heads, the replicated
        draft's all of its own."""
        if self._buf is None:
            cfg, D, M, C = self.cfg, self.n_stages, self.n_slots, \
                self.prefill_chunk
            dev = self.device

            def longs(*shape):
                return torch.zeros(shape, dtype=torch.long, device=dev)

            def caches(c, shape):
                return [torch.zeros(shape, dtype=torch_dtype(c.dtype),
                                    device=dev) for _ in range(D)]

            lps = cfg.n_layers // D
            kv = (kv_shard_heads(cfg, self.mesh), cfg.head_dim)
            if self.paged:
                pmax = self.max_pages_per_slot
                shape = (lps, self.n_pages, self.page_size) + kv
                n_rows = pmax * self.page_size
            else:
                shape = (lps, M, self.mlen_alloc) + kv
                n_rows = self.mlen_alloc
            self._buf = {
                "kc": caches(cfg, shape), "vc": caches(cfg, shape),
                "slots": longs(M, _NCOL + self.out_max),
                "prompt_buf": longs(M, self.prompt_max + C - 1),
                "pad": longs(C - 1),
                "ar_c": torch.arange(C, device=dev),
                "ar_t": torch.arange(n_rows, device=dev),
                "tok_in": longs(1, C),
                "pos": [longs(C) for _ in range(D)],
                "slot": [longs(1) for _ in range(D)],
                "row": longs(1),
            }
            if self.paged:
                self._buf["page_tbl"] = longs(M, pmax)
                self._buf["pt"] = [longs(pmax) for _ in range(D)]
            if self.speculative:
                dc = self.draft_cfg
                dshape = (dc.n_layers, M, self.mlen_alloc, dc.kv_heads,
                          dc.head_dim)
                self._buf.update(
                    dkc=caches(dc, dshape)[0], dvc=caches(dc, dshape)[0],
                    ar_m=torch.arange(self.mlen_alloc, device=dev),
                    ar_g=torch.arange(self.gamma + 1, device=dev),
                    ar_out=torch.arange(self.out_max, device=dev),
                    dslot=longs(1), dpre=longs(1),
                    vdrafts=longs(self.gamma))
        return self._buf

    # -- the visits (each one CUDA graph on a card) ----------------------

    def _stage(self, w: _Weights, d: int, x: torch.Tensor,
               pos: torch.Tensor, slot: torch.Tensor,
               pt: Optional[torch.Tensor]) -> torch.Tensor:
        """Stage d's layers on one visit: x is the [1, C] token row at
        stage 0 (embedded here) and the [1, C, dim] hidden state after it;
        ``pos`` [C] the rows' positions, ``slot`` [1] the slot, ``pt`` its
        page-table row (paged)."""
        cfg, b = self.cfg, self._buffers()
        h = embed_apply(cfg, w.model, x, pos) if d == 0 else x
        return _apply_layers(cfg, w.stages[d], h, b["kc"][d], b["vc"][d],
                             pos, w.rope, slot, pt, b["ar_t"], self.mesh)

    def _head(self, w: _Weights, y: torch.Tensor,
              row: torch.Tensor) -> torch.Tensor:
        """The greedy token [1] of row ``row`` [1] of the last stage's
        hidden state y [1, C, dim]."""
        return _greedy(self.cfg, w.model, y.index_select(1, row)[:, 0],
                       self.mesh, self.vocab_parallel)

    def _verify_head(self, w: _Weights, y: torch.Tensor,
                     drafts: torch.Tensor) -> torch.Tensor:
        """A verify visit's head: the argmaxes of rows 0..gamma of y and
        the accepted length, as [gamma + 2]."""
        ys = _greedy(self.cfg, w.model, y[0, :self.gamma + 1], self.mesh,
                     self.vocab_parallel)
        return torch.cat([ys, spec_accept_len(drafts, ys).view(1)])

    def _draft_row(self):
        """The served slot [1], its slot-table row, and the draft's
        frontier clamped into the slot's rows (a finished slot's frontier
        can lie past them; an active slot's never does; the graphs'
        warm-up runs on an empty row)."""
        b = self._buffers()
        g = b["dslot"]
        row = b["slots"].index_select(0, g)[0]
        dp = torch.minimum(row[_DPOS], row[_PLEN] + row[_BUDGET] - 1)
        return g, row, dp.clamp(min=0)

    def _draft_catchup(self, w: _Weights) -> torch.Tensor:
        """The draft's turn on a prefill or catch-up visit: up to C tokens
        from its frontier, read from the prompt and then the banked
        output, through the draft's layers; the frontier advances to the
        prompt's end (prefill) or past the slot's last banked token, by
        at most C, if the slot is live."""
        b, C, dc = self._buffers(), self.prefill_chunk, self.draft_cfg
        g, row, dp = self._draft_row()
        dp0, plen = row[_DPOS], row[_PLEN]
        hi = torch.where(b["dpre"][0] == 1, plen, row[_POS] + 1)
        dn = (hi - dp0).clamp(min=0, max=C)
        pp = dp + b["ar_c"]
        prompt = b["prompt_buf"].index_select(0, g)[0]
        from_prompt = prompt.index_select(0, pp.clamp(max=prompt.numel() - 1))
        from_out = row[_NCOL:].index_select(
            0, (pp - plen).clamp(min=0, max=self.out_max - 1))
        toks = torch.where(pp < plen, from_prompt, from_out)[None]
        h = embed_apply(dc, w.draft, toks, pp)
        _apply_layers(dc, w.draft.layers, h, b["dkc"], b["dvc"], pp, w.drope,
                      g, None, b["ar_m"])
        new = torch.where(row[_FINISHED] == 0, dp0 + dn, dp0)
        b["slots"].index_put_((g, g.new_full((1,), _DPOS)), new.view(1))
        return dn

    def _draft_propose(self, w: _Weights) -> torch.Tensor:
        """The draft's turn on a verify visit: ``gamma`` greedy
        single-token steps from the slot's last banked token at its
        frontier; the proposals [gamma]."""
        b, dc = self._buffers(), self.draft_cfg
        g, row, dp = self._draft_row()
        t, toks = row[_TOK:_TOK + 1], []
        for i in range(self.gamma):
            pos = (dp + i).view(1)
            h = embed_apply(dc, w.draft, t[None], pos)
            h = _apply_layers(dc, w.draft.layers, h, b["dkc"], b["dvc"], pos,
                              w.drope, g, None, b["ar_m"])
            t = _greedy(dc, w.draft, h[:, 0])
            toks.append(t)
        return torch.cat(toks)

    @torch.no_grad()
    def prepare(self, model: Transformer,
                draft: Optional[Transformer] = None) -> _Weights:
        """The model in the compute dtype, split over the stages, its RoPE
        table, the draft (speculative) in its compute dtype, and on a CUDA
        device the visits' graphs (once per weights, not per block)."""
        model_on(model, self.device)
        check_block_shard(model, self.mesh)
        model_c = compute_cast(self.cfg, model)
        stages = [chunks[0] for chunks in
                  stack_stage_layers(model_c.layers, self.n_stages)]
        w = _Weights(model_c, stages,
                     rope_table(self.cfg, self.mlen_alloc, self.device))
        if self.speculative:
            if draft is None:
                raise ValueError("speculative programs need draft_params "
                                 "(the draft model)")
            model_on(draft, self.device)
            w = w._replace(draft=compute_cast(self.draft_cfg, draft),
                           drope=rope_table(self.draft_cfg, self.mlen_alloc,
                                            self.device))
        if not self.cuda_graphs:
            return w
        b, dev = self._buffers(), self.device
        self.n_captures += 1
        graphs: Dict[str, Any] = {"stages": []}
        x = b["tok_in"]
        for d in range(self.n_stages):  # stage d reads stage d-1's output
            graphs["stages"].append(_Graph(functools.partial(
                self._stage, w, d, x, b["pos"][d], b["slot"][d],
                b["pt"][d] if self.paged else None), dev))
            x = graphs["stages"][-1].out
        graphs["head"] = _Graph(functools.partial(self._head, w, x, b["row"]),
                                dev)
        if self.speculative:
            graphs["verify"] = _Graph(functools.partial(
                self._verify_head, w, x, b["vdrafts"]), dev)
            graphs["catchup"] = _Graph(
                functools.partial(self._draft_catchup, w), dev)
            graphs["propose"] = _Graph(
                functools.partial(self._draft_propose, w), dev)
        return w._replace(graphs=graphs)

    def init_state(self) -> Dict[str, Any]:
        """Zeroed caches, a fresh slot table, prompt buffer and page table
        on the device; the host's schedule arrays; an empty ring."""
        b = self._buffers()
        for t in b["kc"] + b["vc"] + [b[k] for k in (
                "dkc", "dvc", "slots", "prompt_buf", "page_tbl") if k in b]:
            t.zero_()
        b["slots"][:, _T_FIRST] = -1
        b["slots"][:, _T_FINISH] = -1
        M = self.n_slots
        return {
            "u": 0, "slots": b["slots"], "prompt_buf": b["prompt_buf"],
            "page_tbl": b.get("page_tbl"),
            "pos": np.zeros(M, np.int64),
            "prefill_left": np.zeros(M, np.int64),
            "plen": np.zeros(M, np.int64),
            "budget": np.zeros(M, np.int64),
            "emitted_pred": np.zeros(M, np.int64),
            "epoch": np.zeros(M, np.int64),
            "live": np.zeros(M, bool),
            # speculative: the frontiers while the host still foresees
            # them (before the slot's first verify), and whether it began
            "dpos": np.zeros(M, np.int64),
            "verifying": np.zeros(M, bool),
            "chan": [None] * self.n_stages,
        }

    @torch.no_grad()
    def step(self, weights: _Weights, state: Dict[str, Any]
             ) -> Dict[str, Any]:
        """Advance the ring by ``block_ticks`` ticks, in place."""
        for _ in range(self.block_ticks):
            self._tick(weights, state)
        return state

    # -- banking (stage 0, before it serves) -----------------------------

    def _bank(self, st: Dict[str, Any], v: _Visit, u: int) -> None:
        """Stage 0 banks visit ``v``'s token into its slot's row: out_buf,
        the stamps, ``emitted``, ``finished`` (budget or EOS) and the
        slot's next input token, all on the device; masked by ``v.act``."""
        row = st["slots"][v.g]
        head = row[:_BUDGET + 1]
        tk = v.tok[0]
        em = head[_EMITTED]
        fin = em + 1 >= head[_BUDGET]
        if self.eos_id is not None:
            fin = fin | (tk == self.eos_id)
        new = torch.stack([
            tk, em + 1, torch.maximum(head[_FINISHED], fin.long()),
            torch.where(em == 0, u, head[_T_FIRST]),
            torch.where(fin, u, head[_T_FINISH]), head[_BUDGET]])
        at = (em + _NCOL).clamp(max=row.numel() - 1).view(1)
        if v.act is None:
            row.scatter_(0, at, v.tok)
            head.copy_(new)
        else:
            row.scatter_(0, at, torch.where(v.act, v.tok, row.gather(0, at)))
            head.copy_(torch.where(v.act, new, head))

    def _bank_verify(self, st: Dict[str, Any], v: _Visit, u: int) -> None:
        """Stage 0 banks a verify visit: up to ``n_accepted`` of the rows'
        argmaxes, in order, stopping after the one that spends the budget
        or is EOS (the JAX loop over ``gamma + 1``, vectorised); both
        frontiers advance by ``n_accepted`` and the acceptance counters
        count the visit. Masked by ``v.act``."""
        b, G = self._buffers(), self.gamma
        row = st["slots"][v.g]
        ys, n_acc = v.tok[:G + 1], v.tok[G + 1].clamp(1, G + 1)
        em0, k = row[_EMITTED], b["ar_g"]
        valid = k < n_acc
        fin_tok = em0 + k + 1 >= row[_BUDGET]
        if self.eos_id is not None:
            fin_tok = fin_tok | (ys == self.eos_id)
        stop = (valid & fin_tok).long()
        do = valid & (torch.cumsum(stop, 0) - stop == 0)
        n = do.sum()
        fin = (do & fin_tok).any()
        at = b["ar_out"] - em0
        out = torch.where((at >= 0) & (at < n),
                          ys.index_select(0, at.clamp(0, G)), row[_NCOL:])
        last = ys.index_select(0, (n - 1).clamp(min=0).view(1))[0]
        new = torch.stack([
            last, em0 + n,
            torch.maximum(row[_FINISHED], fin.long()),
            torch.where(em0 == 0, u, row[_T_FIRST]),
            torch.where(fin, u, row[_T_FINISH]), row[_BUDGET],
            row[_POS] + n_acc, row[_DPOS] + n_acc, row[_PLEN],
            row[_SPEC_VISITS] + 1, row[_SPEC_ACC] + n_acc - 1, row[_ERR]])
        row.copy_(torch.where(v.act, torch.cat([new, out]), row))

    # -- serving (stage 0) -----------------------------------------------

    def _serve(self, w: _Weights, st: Dict[str, Any], u: int
               ) -> Optional[_Visit]:
        """Stage 0's visit of slot ``u mod M``, or None when the host knows
        the slot idle (not live, or, unless speculative, its budget
        spent)."""
        g = u % self.n_slots
        if not st["live"][g] or (not self.speculative and
                                 st["emitted_pred"][g] >= st["budget"][g]):
            return None
        b, C = self._buffers(), self.prefill_chunk
        row = st["slots"][g]
        act = (None if self.eos_id is None and not self.speculative
               else row[_FINISHED] == 0)
        pleft = int(st["prefill_left"][g])
        if self.speculative:
            return self._serve_spec(w, st, g, row, act, pleft)
        off = int(st["pos"][g])
        if pleft > 0:  # the next prompt chunk
            s_valid, sample = min(pleft, C), pleft <= C
            start = int(st["plen"][g]) - pleft
            toks = st["prompt_buf"][g, start:start + C]
            st["prefill_left"][g] = pleft - s_valid
        else:  # the last banked token, then C-1 junk rows
            s_valid, sample = 1, True
            toks = torch.cat([row[_TOK:_TOK + 1], b["pad"]])
        st["pos"][g] = off + s_valid
        pt = None
        if self.paged:  # the device frontier, for the allocator's ledger
            self._advance_pos(row, act, s_valid)
            pt = self._page_row(st, g, act)
        return self._visit(w, st, g, off, s_valid, sample, act, toks,
                           "pre" if pleft > 0 else "dec", pt)

    def _serve_spec(self, w: _Weights, st: Dict[str, Any], g: int,
                    row: torch.Tensor, act: torch.Tensor,
                    pleft: int) -> _Visit:
        """A speculative visit: the host foresees its kind (see the module
        doc) and the device checks it; the draft takes its turn, then the
        target's chunk is built at the device frontier."""
        b, C, G = self._buffers(), self.prefill_chunk, self.gamma
        plen, pos, dpos = int(st["plen"][g]), st["pos"], st["dpos"]
        if pleft > 0:
            kind, s_valid, sample = "pre", min(pleft, C), pleft <= C
            st["prefill_left"][g] = pleft - s_valid
            dpos[g] = min(dpos[g] + C, plen)
            pos[g] += s_valid
        elif not st["verifying"][g] and dpos[g] < pos[g]:
            kind, s_valid, sample = "dec", 1, True
            dpos[g] = min(dpos[g] + C, pos[g] + 1)
            pos[g] += 1
        else:
            kind, s_valid, sample = "ver", G + 1, True
            st["verifying"][g] = True
        if pleft == 0:  # the JAX kind test, dpos >= pos; a miss is flagged
            isver = row[_DPOS] >= row[_POS]
            miss = act & (~isver if kind == "ver" else isver)
            row[_ERR:_ERR + 1].add_(miss.long())
        # a finished slot's frontier may lie past its rows: clamp it there
        off = torch.minimum(row[_POS], row[_PLEN] + row[_BUDGET] - 1).view(1)
        graphs = w.graphs
        b["dslot"].fill_(g)
        drafts = None
        if kind == "ver":
            drafts = (graphs["propose"].replay() if graphs
                      else self._draft_propose(w)).clone()
        else:
            b["dpre"].fill_(int(kind == "pre"))
            if graphs:
                graphs["catchup"].replay()
            else:
                self._draft_catchup(w)
            self._advance_pos(row, act, s_valid)
        if kind == "pre":
            start = plen - pleft
            toks = st["prompt_buf"][g, start:start + C]
        elif kind == "dec":
            toks = torch.cat([row[_TOK:_TOK + 1], b["pad"]])
        else:
            toks = torch.cat([row[_TOK:_TOK + 1], drafts, b["pad"][G:]])
        pt = self._page_row(st, g, act) if self.paged else None
        return self._visit(w, st, g, off, s_valid, sample, act, toks, kind,
                           pt, drafts)

    @staticmethod
    def _advance_pos(row: torch.Tensor, act: Optional[torch.Tensor],
                     n: int) -> None:
        """The device frontier ``row[POS] += n``, if the slot is live."""
        at = row[_POS:_POS + 1]
        if act is None:
            at.add_(n)
        else:
            at.add_(act.long(), alpha=n)

    @staticmethod
    def _page_row(st: Dict[str, Any], g: int,
                  act: Optional[torch.Tensor]) -> torch.Tensor:
        """A copy of slot g's page-table row for the visit to carry; all
        null pages when the slot has already finished."""
        row = st["page_tbl"][g]
        return row.clone() if act is None else row * act

    def _visit(self, w: _Weights, st: Dict[str, Any], g: int, off,
               s_valid: int, sample: bool, act, toks: torch.Tensor,
               kind: str, pt, drafts=None) -> _Visit:
        if w.graphs:
            self._buffers()["tok_in"][0].copy_(toks)
            toks = None
        else:
            toks = toks[None]
        return _Visit(g, int(st["epoch"][g]), off, s_valid, sample, act,
                      toks, None, kind, pt, drafts)

    def _run_stage(self, w: _Weights, d: int, v: _Visit) -> _Visit:
        b, D = self._buffers(), self.n_stages
        if w.graphs:
            torch.add(b["ar_c"], v.offset, out=b["pos"][d])
            b["slot"][d].fill_(v.g)
            if v.pt is not None:
                b["pt"][d].copy_(v.pt)
            y = w.graphs["stages"][d].replay()
        else:
            y = self._stage(w, d, v.h, b["ar_c"] + v.offset,
                            torch.full((1,), v.g, device=self.device), v.pt)
        tok = None
        if d == D - 1 and v.sample:
            if v.kind == "ver":
                if w.graphs:
                    b["vdrafts"].copy_(v.drafts)
                    tok = w.graphs["verify"].replay()
                else:
                    tok = self._verify_head(w, y, v.drafts)
            elif w.graphs:
                b["row"].fill_(v.s_valid - 1)
                tok = w.graphs["head"].replay()
            else:
                tok = self._head(w, y, torch.full((1,), v.s_valid - 1,
                                                  device=self.device))
        return v._replace(h=y, tok=tok)

    def _tick(self, w: _Weights, st: Dict[str, Any]) -> None:
        u, D, chan = st["u"], self.n_stages, st["chan"]
        # bank before serving, so the M == D same-tick arrive-and-serve
        # case sees the fresh slot state. A visit of a slot's earlier
        # occupant (served after it hit EOS, still in flight when the
        # block ended and the slot was refilled) banks nothing: its flag
        # is off, and the host must not count it for the new occupant
        arrived = chan[0]
        if (arrived is not None and arrived.sample
                and arrived.epoch == st["epoch"][arrived.g]):
            if arrived.kind == "ver":
                self._bank_verify(st, arrived, u)
            else:
                self._bank(st, arrived, u)
            st["emitted_pred"][arrived.g] += 1
        ins = [self._serve(w, st, u)] + chan[1:]
        outs: List[Optional[_Visit]] = [None] * D
        # last stage first: under graphs stage d reads stage d-1's output
        # buffer, which holds last tick's visit until stage d-1 runs again
        for d in reversed(range(D)):
            if ins[d] is not None:
                outs[d] = self._run_stage(w, d, ins[d])
        st["chan"] = [outs[-1]] + outs[:-1]
        st["u"] = u + 1


def make_serving_step_fn(cfg: ModelConfig, n_stages: int, *, n_slots: int,
                         max_len: int, prompt_max: int, out_max: int,
                         prefill_chunk: int = 1,
                         block_ticks: Optional[int] = None,
                         eos_id: Optional[int] = None,
                         paged: bool = False, page_size: int = 8,
                         n_pages: Optional[int] = None,
                         speculative: bool = False, gamma: int = 2,
                         draft_cfg: Optional[ModelConfig] = None,
                         mesh=None, device="cuda") -> ServingProgram:
    """Build the serving tick-block program over ``n_stages`` (D) lockstep
    stages on one device.

    ``n_slots`` is the ring's M (each slot carries one request);
    ``max_len`` bounds prompt + output per slot; ``prompt_max`` /
    ``out_max`` size the prompt and output buffers; ``prefill_chunk`` (C)
    is how many prompt tokens a slot takes in per visit; ``block_ticks``
    is how many ticks one ``step`` advances (default M: every slot visited
    once per block). ``eos_id`` retires a slot the moment it emits that
    token; budget retirement applies always.

    ``paged=True`` swaps the per-slot caches for a page pool of
    ``n_pages`` pages of ``page_size`` rows per stage (page 0 the null
    page; default ``1 + M * P_max``, every slot fully backed, with
    ``P_max = ceil((max_len + C - 1) / page_size)``). ``speculative=True``
    adds greedy draft-verify decoding with a draft of config
    ``draft_cfg`` (same vocabulary) proposing ``gamma`` tokens a verify
    visit; ``prefill_chunk`` must be at least ``gamma + 1``. The two
    compose. The validation and its messages are the JAX
    ``make_serving_step_fn``'s.

    ``mesh``: the rank's mesh of a (pipe 1, data 1, model T) world (see
    the module doc); each rank's engine takes its model shard and the
    whole draft.
    """
    if cfg.arch not in ("gpt2", "llama"):
        raise ValueError(
            f"generation is undefined for arch {cfg.arch!r} (see "
            "models.generate)")
    T = check_decode_mesh(mesh, "serving")
    check_tp(cfg, T)
    D = n_stages
    if cfg.n_layers % D:
        raise ValueError(f"n_layers={cfg.n_layers} must divide over {D} "
                         "stages")
    M = n_slots
    if M < D:
        raise ValueError(f"n_slots={M} must be >= the pipe degree {D} "
                         "(fewer slots than stages stalls the ring)")
    C = prefill_chunk
    if C < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {C}")
    if not speculative:
        gamma = 0
        draft_cfg = None
    else:
        if draft_cfg is None:
            raise ValueError("speculative=True needs draft_cfg (the "
                             "draft model's ModelConfig)")
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if gamma + 1 > C:
            raise ValueError(
                f"speculative verify scores gamma+1={gamma + 1} positions "
                f"through the C-wide chunk channel; set prefill_chunk >= "
                f"gamma+1 (got prefill_chunk={C})")
        if draft_cfg.arch not in ("gpt2", "llama"):
            raise ValueError(f"draft arch {draft_cfg.arch!r} is not "
                             "generable (see models.generate)")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size ({draft_cfg.vocab_size}) must match the "
                f"target's ({cfg.vocab_size}) — acceptance compares token "
                "ids")
        if draft_cfg.arch == "gpt2" \
                and max_len + C - 1 > draft_cfg.max_seq_len:
            raise ValueError(
                f"max_len + prefill_chunk - 1 ({max_len + C - 1}) exceeds "
                f"the gpt2 draft position table "
                f"(max_seq_len={draft_cfg.max_seq_len})")
    from ..analysis import maybe_verify_serving
    maybe_verify_serving(D, M, gamma=gamma if speculative else None,
                         prefill_chunk=C)
    if prompt_max < 1 or out_max < 1:
        raise ValueError("prompt_max and out_max must be >= 1")
    if prompt_max + 1 > max_len:
        raise ValueError(f"prompt_max ({prompt_max}) + 1 output token "
                         f"exceeds max_len ({max_len})")
    if cfg.arch == "gpt2" and max_len + C - 1 > cfg.max_seq_len:
        raise ValueError(f"max_len ({max_len}) + prefill_chunk - 1 "
                         f"({C - 1}) exceeds the gpt2 position table "
                         f"(max_seq_len={cfg.max_seq_len})")
    block = block_ticks or M
    if block < 1:
        raise ValueError(f"block_ticks must be >= 1, got {block}")
    if paged:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        pmax = -(-(max_len + C - 1) // page_size)
        if n_pages is None:
            n_pages = 1 + M * pmax  # null page + full parity capacity
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the "
                             f"reserved null page), got {n_pages}")
    return ServingProgram(cfg, n_stages=D, n_slots=M, max_len=max_len,
                          prompt_max=prompt_max, out_max=out_max,
                          prefill_chunk=C, block_ticks=block, eos_id=eos_id,
                          device=resolve_device(device), paged=paged,
                          page_size=page_size if paged else 0,
                          n_pages=n_pages if paged else 0,
                          speculative=speculative, gamma=gamma,
                          draft_cfg=draft_cfg, mesh=mesh)


class ServingEngine:
    """Host-side scheduler driving a :class:`ServingProgram`.

    ``submit`` queues requests; ``run`` advances the ring block by block,
    retiring finished slots and admitting queued requests between blocks.
    ``submit`` raises on an invalid request; ``run`` retires an invalid
    one, or one whose admission fails, with a ``status="failed"``
    :class:`Completion` and keeps serving. A speculative program takes the
    draft as ``draft_params`` (a port :class:`Transformer`); a paged one
    keeps a radix prefix cache unless ``prefix_cache=False``. ``report``
    (a ``utils.telemetry.RunReport``) receives the JAX engine's events:
    ``serve_admit`` and ``serve_finish`` for each request, ``serve_failed``
    (and its counter) for each failed one, and one ``serve_run`` a run.
    """

    def __init__(self, program: ServingProgram, model: Transformer, *,
                 draft_params: Optional[Transformer] = None, report=None,
                 fault_plan=None, prefix_cache: bool = True) -> None:
        self.program = program
        self.report = report
        self.fault_plan = fault_plan
        self.prefix_cache = prefix_cache
        self.weights = program.prepare(model, draft_params)
        self.reset()

    def reset(self) -> None:
        p = self.program
        self.state = p.init_state()
        # host mirrors of the device slot table, prompt buffer and page
        # table (pinned on a card, so the upload after admission does not
        # wait); the numpy views are what the scheduler reads and writes
        pin = p.device.type == "cuda"

        def mirror(t):
            return torch.zeros(t.shape, dtype=torch.long, pin_memory=pin)

        self._slots_t = mirror(self.state["slots"])
        self._slots_t[:, _T_FIRST] = -1
        self._slots_t[:, _T_FINISH] = -1
        self._prompt_t = mirror(self.state["prompt_buf"])
        self.slots = self._slots_t.numpy()
        self.prompt_buf = self._prompt_t.numpy()
        self._pt_t = self.page_tbl = None
        self.paging: Optional[PagedKVAllocator] = None
        if p.paged:
            self._pt_t = mirror(self.state["page_tbl"])
            self.page_tbl = self._pt_t.numpy()
            self.paging = PagedKVAllocator(
                n_pages=p.n_pages, page_size=p.page_size,
                max_pages_per_slot=p.max_pages_per_slot,
                prefill_chunk=p.prefill_chunk,
                prefix_cache=self.prefix_cache)
        self._cow: List[Any] = []  # (src, dst) copies for the next block
        self._dirty = False
        self.pending: deque = deque()
        self.waiting: deque = deque()
        self.completions: List[Completion] = []
        self.occupancy: List[Any] = []
        self.queue_depth: List[Any] = []
        self.pages_used: List[Any] = []
        self.page_fragmentation: List[Any] = []
        self.acceptance_series: List[Any] = []
        self._slot_req: Dict[int, Request] = {}
        self._slot_admit: Dict[int, int] = {}
        self._tick = 0
        self._busy_ticks = 0
        self._n_blocks = 0
        self._host_syncs = 0
        self._n_backpressure = 0
        self._spec_visits = 0
        self._spec_accepted = 0

    # -- request intake --------------------------------------------------

    def submit(self, req: Request) -> None:
        """Validate and queue one request (ordered by ``arrival``)."""
        p = self.program
        plen = len(req.prompt)
        if plen < 1 or plen > p.prompt_max:
            raise ValueError(f"request {req.rid}: prompt length {plen} "
                             f"outside [1, prompt_max={p.prompt_max}]")
        if req.max_new_tokens < 1 or req.max_new_tokens > p.out_max:
            raise ValueError(f"request {req.rid}: max_new_tokens="
                             f"{req.max_new_tokens} outside [1, out_max="
                             f"{p.out_max}]")
        if plen + req.max_new_tokens > p.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({plen}) + budget "
                f"({req.max_new_tokens}) overflows the slot max_len "
                f"({p.max_len})")
        self.pending.append(req)

    # -- scheduling ------------------------------------------------------

    def _admit(self, slot: int, req: Request, plan=None) -> None:
        """Bind ``req`` to ``slot``: the host mirrors and schedule arrays,
        uploaded before the next block; a paged plan maps its pages,
        queues its copy-on-write and starts the frontier past the cached
        prefix. Raises, before writing anything, on a prompt that is not
        a row of token ids of the vocabulary."""
        prompt = np.asarray(req.prompt, np.int64)
        vocab = self.program.cfg.vocab_size
        if prompt.ndim != 1 or ((prompt < 0) | (prompt >= vocab)).any():
            raise ValueError(f"prompt tokens must be ids in [0, {vocab})")
        st = self.state
        plen = len(prompt)
        start = 0
        if plan is not None:
            from ..analysis import maybe_verify_page_table
            p = self.program
            maybe_verify_page_table(
                plan.pages, refcount=self.paging.pool.refcount,
                n_pages=p.n_pages, page_size=p.page_size,
                write_lo=plan.matched_len,
                write_hi=plen + req.max_new_tokens + p.prefill_chunk - 1,
                cow_dst=plan.cow_dst)
            start = plan.matched_len
            self.page_tbl[slot] = 0
            self.page_tbl[slot, :plan.n_pages] = plan.pages
            if plan.cow_dst >= 0:
                self._cow.append((plan.cow_src, plan.cow_dst))
            self.paging.bind(slot, plan)
        self.prompt_buf[slot] = 0
        self.prompt_buf[slot, :plen] = prompt
        row = self.slots[slot]
        row[:] = 0
        row[_T_FIRST] = row[_T_FINISH] = -1
        row[_BUDGET] = req.max_new_tokens
        row[_POS] = start
        row[_PLEN] = plen
        st["plen"][slot] = plen
        st["prefill_left"][slot] = plen - start
        st["pos"][slot] = start
        st["dpos"][slot] = 0  # the draft starts cold, even past a prefix
        st["verifying"][slot] = False
        st["budget"][slot] = req.max_new_tokens
        st["emitted_pred"][slot] = 0
        st["epoch"][slot] += 1
        st["live"][slot] = True
        self._dirty = True
        self._slot_req[slot] = req
        self._slot_admit[slot] = self._tick
        if self.report is not None:
            paged_kv = ({"matched_len": plan.matched_len,
                         "n_pages": plan.n_pages}
                        if plan is not None else {})
            self.report.event("serve_admit", rid=req.rid, slot=slot,
                              tick=self._tick, prompt_len=plen,
                              budget=req.max_new_tokens,
                              arrival=req.arrival,
                              wait_ticks=self._tick - req.arrival,
                              **paged_kv)

    def _fail_request(self, req: Request, reason: str) -> None:
        """Retire ``req`` unserved with a ``failed`` completion (and a
        ``serve_failed`` report event)."""
        self.completions.append(Completion(
            rid=req.rid, prompt=list(map(int, req.prompt)), tokens=[],
            slot=-1, admit_tick=-1, first_token_tick=-1, finish_tick=-1,
            arrival=req.arrival, status="failed", reason=reason))
        if self.report is not None:
            self.report.event("serve_failed", rid=req.rid, tick=self._tick,
                              reason=reason)
            self.report.count("serve_failed")

    def _harvest(self) -> None:
        for slot, req in list(self._slot_req.items()):
            row = self.slots[slot]
            if not row[_FINISHED]:
                continue
            n = int(row[_EMITTED])
            comp = Completion(
                rid=req.rid, prompt=list(map(int, req.prompt)),
                tokens=[int(t) for t in row[_NCOL:_NCOL + n]],
                slot=slot, admit_tick=self._slot_admit[slot],
                first_token_tick=int(row[_T_FIRST]),
                finish_tick=int(row[_T_FINISH]), arrival=req.arrival)
            self.completions.append(comp)
            self.state["live"][slot] = False
            if self.paging is not None:
                # decref the slot's pages and cache its prompt-covered ones
                self.paging.retire(slot, req.prompt)
                self.page_tbl[slot] = 0
                self._dirty = True
            sv, sa = int(row[_SPEC_VISITS]), int(row[_SPEC_ACC])
            self._spec_visits += sv
            self._spec_accepted += sa
            del self._slot_req[slot]
            del self._slot_admit[slot]
            if self.report is not None:
                spec_kv = ({"spec_verify_visits": sv, "spec_accepted": sa,
                            "accepted_len_mean": (round(1 + sa / sv, 4)
                                                  if sv else None)}
                           if self.program.speculative else {})
                self.report.event("serve_finish", rid=req.rid, slot=slot,
                                  tick=self._tick, n_tokens=n,
                                  ttft_ticks=comp.ttft_ticks, **spec_kv)

    def _run_block(self) -> None:
        """Upload what admission wrote, run the queued copy-on-write
        copies and one block, read the slot table back (the block's one
        blocking transfer)."""
        st, p = self.state, self.program
        pin = p.device.type == "cuda"
        if self._dirty:
            st["slots"].copy_(self._slots_t, non_blocking=pin)
            st["prompt_buf"].copy_(self._prompt_t, non_blocking=pin)
            if p.paged:
                st["page_tbl"].copy_(self._pt_t, non_blocking=pin)
            self._dirty = False
        b = p._buffers()
        for src, dst in self._cow:  # before any tick of the block
            for pool in b["kc"] + b["vc"]:
                pool[:, dst].copy_(pool[:, src])
        self._cow.clear()
        st["u"] = self._tick
        p.step(self.weights, st)
        self._slots_t.copy_(st["slots"], non_blocking=pin)
        if pin:
            torch.cuda.current_stream(p.device).synchronize()
        self._host_syncs += 1
        self._n_blocks += 1
        self._tick = st["u"]
        if self.slots[:, _ERR].any():
            raise RuntimeError(
                "a speculative visit's kind differed from the host's "
                f"foresight (slots {np.nonzero(self.slots[:, _ERR])[0]})")

    def _try_plan(self, req: Request):
        """Paged admission of the queue's head: its plan, ``None`` to
        wait (the pool is short; slots will retire), or ``False`` when
        the request has failed (it can never fit, or nothing is left to
        retire)."""
        paging = self.paging
        if not paging.admissible(len(req.prompt), req.max_new_tokens):
            self.waiting.popleft()
            self._fail_request(
                req, f"request needs "
                f"{paging.pages_needed(len(req.prompt), req.max_new_tokens)}"
                f" pages but the pool holds {paging.pool.capacity}")
            return False
        plan = paging.try_admit(req.prompt, req.max_new_tokens)
        if plan is None:  # backpressure: the request stays at the head
            self._n_backpressure += 1
            if not self._slot_req:
                self.waiting.popleft()
                self._fail_request(req, "page pool exhausted with no "
                                   "active slots to retire")
                return False
        return plan

    def _block_gauges(self) -> None:
        """The paged ledger and gauges and the running acceptance rate at
        a block boundary, from the slot table just read back."""
        p, live = self.program, list(self._slot_req)
        if self.paging is not None:
            # the committed-frontier ledger follows the device's pos,
            # which advances only by accepted rows
            frontier = {s: int(self.slots[s, _POS]) for s in live}
            for s, f in frontier.items():
                self.paging.advance(s, f)
            self.pages_used.append((self._tick, self.paging.pages_used))
            self.page_fragmentation.append(
                (self._tick, round(self.paging.fragmentation(frontier), 6)))
        if p.speculative:
            tv = self._spec_visits + sum(int(self.slots[s, _SPEC_VISITS])
                                         for s in live)
            ta = self._spec_accepted + sum(int(self.slots[s, _SPEC_ACC])
                                           for s in live)
            self.acceptance_series.append(
                (self._tick, round(ta / (p.gamma * tv), 6) if tv else None))

    def _check_ranks_agree(self, result: ServeResult) -> None:
        """Raise unless every model rank's completions (tokens, stamps,
        status) equal this rank's: the SPMD scheduler's contract."""
        mesh = self.program.mesh
        mine = [(c.rid, c.tokens, c.slot, c.first_token_tick,
                 c.finish_tick, c.status) for c in result.completions]
        ranks = mesh.all_gather_object(mine, "model")
        differ = [j for j, r in enumerate(ranks) if r != mine]
        if differ:
            raise RuntimeError(
                f"the model ranks' completions differ: model rank "
                f"{mesh.model}'s against those of model ranks {differ}")

    def run(self, requests: Sequence[Request], *,
            policy: str = "continuous",
            max_blocks: int = 200_000) -> ServeResult:
        """Serve ``requests`` to completion and return the
        :class:`ServeResult`. ``policy="continuous"`` refills freed
        slots immediately; ``policy="static"`` admits a fresh batch only
        once every slot has drained (the fill-drain baseline)."""
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r} (continuous|static)")
        self.reset()
        plan = self.fault_plan
        delay = dict(getattr(plan, "serve_delay", None) or {})
        poison = set(getattr(plan, "serve_poison_rids", ()) or ())
        # injected stragglers shift arrival BEFORE the sort: the pending
        # queue's pop loop relies on arrival order
        retimed = [dataclasses.replace(r, arrival=r.arrival + delay[r.rid])
                   if r.rid in delay else r for r in requests]
        for r in sorted(retimed, key=lambda r: r.arrival):
            try:
                self.submit(r)
            except ValueError as e:
                # an over-budget prompt etc. is a per-request outcome, not
                # a scheduler crash: the live slots keep serving
                self._fail_request(r, str(e))
        p = self.program
        free = list(range(p.n_slots))
        wall0 = time.perf_counter()
        for _ in range(max_blocks):
            while self.pending and self.pending[0].arrival <= self._tick:
                self.waiting.append(self.pending.popleft())
            if policy == "continuous" or len(free) == p.n_slots:
                while free and self.waiting:
                    req = self.waiting[0]
                    plan = None
                    if self.paging is not None:
                        plan = self._try_plan(req)
                        if plan is False:
                            continue
                        if plan is None:
                            break
                    self.waiting.popleft()
                    try:  # refused before any write: the slot stays free
                        if req.rid in poison:
                            raise SimulatedFault(f"injected admission fault "
                                                 f"for rid {req.rid}")
                        self._admit(free[0], req, plan)
                    except (ValueError, TypeError, SimulatedFault) as e:
                        if plan is not None:
                            self.paging.release_plan(plan)
                        self._fail_request(req, f"admission failed: {e}")
                        continue
                    free.pop(0)
            if not self._slot_req:
                if not self.waiting and not self.pending:
                    break  # drained
                if not self.waiting:
                    # an idle gap before the next arrival: no live visit is
                    # in flight, so jumping the tick counter equals running
                    # empty blocks; bank a zero sample at the jump target so
                    # time integrals over the series see the gap
                    nxt = int(np.ceil(self.pending[0].arrival))
                    self._tick = max(self._tick, nxt)
                    self.occupancy.append((self._tick, 0))
                    self.queue_depth.append((self._tick, 0))
                    if self.paging is not None:
                        self.pages_used.append(
                            (self._tick, self.paging.pages_used))
                        self.page_fragmentation.append((self._tick, 0.0))
                    continue
            tick_before = self._tick
            self._run_block()
            if self.paging is not None:
                self.paging.cow_flush()  # the block ran the copies
            # every executed block had >= 1 live slot at entry, so its
            # ticks are busy
            self._busy_ticks += self._tick - tick_before
            n_active = sum(1 for g in range(p.n_slots)
                           if self.state["live"][g]
                           and not self.slots[g, _FINISHED])
            self.occupancy.append((self._tick, n_active))
            # requests that have arrived by now but hold no slot yet
            n_wait = len(self.waiting)
            for r in self.pending:  # arrival-sorted: stop at the future
                if r.arrival > self._tick:
                    break
                n_wait += 1
            self.queue_depth.append((self._tick, n_wait))
            self._block_gauges()
            self._harvest()
            free = [g for g in range(p.n_slots) if g not in self._slot_req]
        else:
            raise RuntimeError(f"serving did not drain within {max_blocks} "
                               "blocks — check arrivals/budgets")
        wall = time.perf_counter() - wall0
        extra: Dict[str, Any] = {}
        if self.paging is not None:
            self.paging.cow_flush()  # a refused final admission's hold
            extra.update(
                paged=True, pages_capacity=self.paging.pool.capacity,
                pages_used=self.pages_used,
                page_fragmentation=self.page_fragmentation,
                prefix_hit_rate=round(self.paging.prefix_hit_rate(), 6),
                prefill_skipped_tokens=self.paging.matched_tokens,
                n_cow=self.paging.n_cow,
                n_backpressure=self._n_backpressure)
        if p.speculative:
            extra.update(speculative=True, gamma=p.gamma,
                         spec_verify_visits=self._spec_visits,
                         spec_accepted_tokens=self._spec_accepted,
                         acceptance_series=self.acceptance_series)
        result = ServeResult(completions=self.completions,
                             occupancy=self.occupancy, ticks=self._tick,
                             wall_s=wall, n_slots=p.n_slots, policy=policy,
                             queue_depth=self.queue_depth,
                             busy_ticks=self._busy_ticks,
                             n_blocks=self._n_blocks,
                             host_syncs=self._host_syncs, **extra)
        if p.tp > 1:
            self._check_ranks_agree(result)
        if self.report is not None:
            # one event a run with the measured tick rate
            self.report.event(
                "serve_run", policy=policy, ticks=result.ticks,
                busy_ticks=result.busy_ticks,
                wall_s=round(wall, 4), tokens_out=result.tokens_out,
                s_per_tick=(round(wall / result.ticks, 6)
                            if result.ticks else None),
                **({"prefix_hit_rate": result.prefix_hit_rate,
                    "n_backpressure": result.n_backpressure,
                    "n_cow": result.n_cow} if self.paging is not None
                   else {}),
                **({"gamma": p.gamma,
                    "acceptance_rate": result.acceptance_rate,
                    "accepted_len_mean": result.accepted_len_mean}
                   if p.speculative else {}))
        return result
