"""Slot-level continuous batching over the lockstep pipelined decoder
(counterpart of the JAX package's ``serving/engine.py``, its dense path).

The static decoder (:mod:`..parallel.pipelined_decode`) round-robins
``M >= D`` streams that start and drain together. Here each stream is a
*slot* that an open request queue feeds:

- :func:`make_serving_step_fn` builds a :class:`ServingProgram` whose
  ``step`` advances the ring by ``block_ticks`` ticks (default M). Every
  shape is fixed: per-stage caches ``[lps, M, max_len + C - 1, Hkv, hd]``
  (llama keeps its ``n_kv_heads`` there; GQA heads are expanded only at
  attention time), a C-row chunk per visit, a ``[M, 6 + out_max]`` int64
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

One slot table on one card replaces the JAX stage-0 tables and their
replication at the block end. ``ServeResult.host_syncs`` counts the
blocking reads (one per block).

Paged KV (``paged=True``), speculative decoding, tensor parallelism, a
``RunReport`` and a ``FaultPlan`` raise ``NotImplementedError`` naming
their ``ROADMAP.md`` items. Admission refuses a prompt token outside the
vocabulary (a failed completion): the JAX gather clamps it, a CUDA
embedding would fault.
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
from ..ops.attention import Rope
from ..parallel.pipeline import stack_stage_layers
from ..utils.config import ModelConfig, resolve_device, torch_dtype

# columns of the device slot table; out_buf follows them
_TOK, _EMITTED, _FINISHED, _T_FIRST, _T_FINISH, _BUDGET = range(6)
_NCOL = 6

_NOT_PORTED = {
    "paged": "ROADMAP.md Queue 1, item 0 (paged KV and speculative serving)",
    "speculative": "ROADMAP.md Queue 1, item 0 (paged KV and speculative "
                   "serving)",
    "tp": "ROADMAP.md Queue 1, item 11 (tensor parallelism)",
    "report": "ROADMAP.md Queue 1, item 12 (observability: RunReport)",
    "fault_plan": "ROADMAP.md Queue 1, item 6 (resilience: FaultPlan)",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {_NOT_PORTED[key]}")


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
    ``host_syncs`` (blocking device-to-host reads) are the port's own."""
    completions: List[Completion]
    occupancy: List[Any]
    ticks: int
    wall_s: float
    n_slots: int
    policy: str
    queue_depth: List[Any] = dataclasses.field(default_factory=list)
    busy_ticks: int = 0
    n_blocks: int = 0
    host_syncs: int = 0

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
    when it was served, first position, valid rows, whether its last valid
    row is a sampling position, the device flag that the slot was live
    when stage 0 served it (None without an EOS: the host then knows it),
    the input or hidden state (None at stage 0 under CUDA graphs: the
    graph reads its token buffer), and the sampled token."""
    g: int
    epoch: int
    offset: int
    s_valid: int
    sample: bool
    act: Optional[torch.Tensor]
    h: Optional[torch.Tensor]
    tok: Optional[torch.Tensor] = None


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
    graphs: Optional[List[_Graph]] = None  # D stage visits, then the head


class ServingProgram:
    """The tick block and its fixed configuration. Built by
    :func:`make_serving_step_fn`; drive it through :class:`ServingEngine`
    (or ``prepare(model)``, ``init_state()`` and ``step(weights,
    state)``). The program owns the device buffers (caches, slot table,
    the visits' inputs), so one engine at a time runs on it.

    A stage visit reads its slot and positions from device tensors, so on
    a CUDA device each stage's visit, and the head, is one CUDA graph,
    captured by ``prepare`` and replayed for every visit; on the CPU they
    run eagerly. ``cuda_graphs = False`` before ``prepare`` launches the
    same operations one by one on the card too (``chip_smoke.py`` holds
    the graphs to that)."""

    def __init__(self, cfg: ModelConfig, *, n_stages: int, n_slots: int,
                 max_len: int, prompt_max: int, out_max: int,
                 prefill_chunk: int, block_ticks: int,
                 eos_id: Optional[int], device: torch.device) -> None:
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
        self.cuda_graphs = device.type == "cuda"
        self._buf: Optional[Dict[str, Any]] = None

    @property
    def mlen_alloc(self) -> int:
        """Cache rows per slot: ``max_len`` plus the junk tail of a C-wide
        write at the last legal offset."""
        return self.max_len + self.prefill_chunk - 1

    def _buffers(self) -> Dict[str, Any]:
        """The device buffers, allocated at first use: per-stage caches
        [lps, M, mlen_alloc, Hkv, hd], the slot table, the prompt buffer,
        and the visits' inputs (a token row, each stage's positions and
        slot, the head's row)."""
        if self._buf is None:
            cfg, D, M, C = self.cfg, self.n_stages, self.n_slots, \
                self.prefill_chunk
            dev = self.device

            def longs(*shape):
                return torch.zeros(shape, dtype=torch.long, device=dev)

            shape = (cfg.n_layers // D, M, self.mlen_alloc, cfg.kv_heads,
                     cfg.head_dim)
            dt = torch_dtype(cfg.dtype)
            self._buf = {
                "kc": [torch.zeros(shape, dtype=dt, device=dev)
                       for _ in range(D)],
                "vc": [torch.zeros(shape, dtype=dt, device=dev)
                       for _ in range(D)],
                "slots": longs(M, _NCOL + self.out_max),
                "prompt_buf": longs(M, self.prompt_max + C - 1),
                "pad": longs(C - 1),
                "ar_c": torch.arange(C, device=dev),
                "ar_t": torch.arange(self.mlen_alloc, device=dev),
                "tok_in": longs(1, C),
                "pos": [longs(C) for _ in range(D)],
                "slot": [longs(1) for _ in range(D)],
                "row": longs(1),
            }
        return self._buf

    def _stage(self, w: _Weights, d: int, x: torch.Tensor,
               pos: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
        """Stage d's layers on one visit: x is the [1, C] token row at
        stage 0 (embedded here) and the [1, C, dim] hidden state after it;
        ``pos`` [C] the rows' positions, ``slot`` [1] the slot. Writes the
        rows' k/v into the slot's cache and attends the whole slot cache
        under the band at those positions (the JAX ``_slot_cache_apply``)."""
        cfg, b = self.cfg, self._buffers()
        h = embed_apply(cfg, w.model, x, pos) if d == 0 else x
        rope = None if w.rope is None else Rope(
            w.rope.cos.index_select(0, pos), w.rope.sin.index_select(0, pos))
        mask = pos[:, None] >= b["ar_t"][None, :]
        if cfg.sliding_window is not None:
            mask &= pos[:, None] - b["ar_t"][None, :] < cfg.sliding_window
        rows = (slot.expand(pos.shape[0]), pos)
        for i, block in enumerate(w.stages[d]):
            kc, vc = b["kc"][d][i], b["vc"][d][i]
            q, k, v = block.qkv(cfg, block.attn_norm(h), rope)
            kc.index_put_(rows, k[0].to(kc.dtype))
            vc.index_put_(rows, v[0].to(vc.dtype))
            att = _attend_cached(q, kc.index_select(0, slot),
                                 vc.index_select(0, slot), 0, cfg.n_heads,
                                 mask=mask)
            h = block.mlp(h + block.proj(att))
        return h

    def _head(self, w: _Weights, y: torch.Tensor,
              row: torch.Tensor) -> torch.Tensor:
        """The greedy token [1] of row ``row`` [1] of the last stage's
        hidden state y [1, C, dim]."""
        logits = head_apply(self.cfg, w.model, y.index_select(1, row)[:, 0])
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def prepare(self, model: Transformer) -> _Weights:
        """The model in the compute dtype, split over the stages, its RoPE
        table, and on a CUDA device the visits' graphs (once per weights,
        not per block)."""
        model_on(model, self.device)
        model_c = compute_cast(self.cfg, model)
        stages = [chunks[0] for chunks in
                  stack_stage_layers(model_c.layers, self.n_stages)]
        w = _Weights(model_c, stages,
                     rope_table(self.cfg, self.mlen_alloc, self.device))
        if not self.cuda_graphs:
            return w
        b = self._buffers()
        graphs, x = [], b["tok_in"]
        for d in range(self.n_stages):  # stage d reads stage d-1's output
            graphs.append(_Graph(functools.partial(
                self._stage, w, d, x, b["pos"][d], b["slot"][d]),
                self.device))
            x = graphs[-1].out
        graphs.append(_Graph(functools.partial(self._head, w, x, b["row"]),
                             self.device))
        return w._replace(graphs=graphs)

    def init_state(self) -> Dict[str, Any]:
        """Zeroed caches, a fresh slot table and prompt buffer on the
        device; the host's schedule arrays; an empty ring."""
        b = self._buffers()
        for t in b["kc"] + b["vc"] + [b["slots"], b["prompt_buf"]]:
            t.zero_()
        b["slots"][:, _T_FIRST] = -1
        b["slots"][:, _T_FINISH] = -1
        M = self.n_slots
        return {
            "u": 0, "slots": b["slots"], "prompt_buf": b["prompt_buf"],
            "pos": np.zeros(M, np.int64),
            "prefill_left": np.zeros(M, np.int64),
            "plen": np.zeros(M, np.int64),
            "budget": np.zeros(M, np.int64),
            "emitted_pred": np.zeros(M, np.int64),
            "epoch": np.zeros(M, np.int64),
            "live": np.zeros(M, bool),
            "chan": [None] * self.n_stages,
        }

    @torch.no_grad()
    def step(self, weights: _Weights, state: Dict[str, Any]
             ) -> Dict[str, Any]:
        """Advance the ring by ``block_ticks`` ticks, in place."""
        for _ in range(self.block_ticks):
            self._tick(weights, state)
        return state

    def _bank(self, st: Dict[str, Any], v: _Visit, u: int) -> None:
        """Stage 0 banks visit ``v``'s token into its slot's row: out_buf,
        the stamps, ``emitted``, ``finished`` (budget or EOS) and the
        slot's next input token, all on the device; masked by ``v.act``."""
        row = st["slots"][v.g]
        head = row[:_NCOL]
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

    def _serve(self, w: _Weights, st: Dict[str, Any], u: int
               ) -> Optional[_Visit]:
        """Stage 0's visit of slot ``u mod M``, or None when the host knows
        the slot idle (not live, or its budget spent)."""
        g = u % self.n_slots
        if not st["live"][g] or st["emitted_pred"][g] >= st["budget"][g]:
            return None
        C = self.prefill_chunk
        off, pleft = int(st["pos"][g]), int(st["prefill_left"][g])
        if pleft > 0:  # the next prompt chunk
            s_valid, sample = min(pleft, C), pleft <= C
            start = int(st["plen"][g]) - pleft
            toks = st["prompt_buf"][g, start:start + C]
            st["prefill_left"][g] = pleft - s_valid
        else:  # the last banked token, then C-1 junk rows
            s_valid, sample = 1, True
            toks = torch.cat([st["slots"][g, _TOK:_TOK + 1],
                              self._buffers()["pad"]])
        st["pos"][g] = off + s_valid
        act = (None if self.eos_id is None
               else st["slots"][g, _FINISHED] == 0)
        if w.graphs:
            self._buffers()["tok_in"][0].copy_(toks)
            toks = None
        else:
            toks = toks[None]
        return _Visit(g, int(st["epoch"][g]), off, s_valid, sample, act,
                      toks)

    def _run_stage(self, w: _Weights, d: int, v: _Visit) -> _Visit:
        b, D = self._buffers(), self.n_stages
        if w.graphs:
            torch.add(b["ar_c"], v.offset, out=b["pos"][d])
            b["slot"][d].fill_(v.g)
            y = w.graphs[d].replay()
        else:
            y = self._stage(w, d, v.h, b["ar_c"] + v.offset,
                            torch.full((1,), v.g, device=self.device))
        tok = None
        if d == D - 1 and v.sample:
            if w.graphs:
                b["row"].fill_(v.s_valid - 1)
                tok = w.graphs[D].replay()
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
                         paged: bool = False, speculative: bool = False,
                         tp_size: int = 1, device="cuda") -> ServingProgram:
    """Build the serving tick-block program over ``n_stages`` (D) lockstep
    stages on one device.

    ``n_slots`` is the ring's M (each slot carries one request);
    ``max_len`` bounds prompt + output per slot; ``prompt_max`` /
    ``out_max`` size the prompt and output buffers; ``prefill_chunk`` (C)
    is how many prompt tokens a slot takes in per visit; ``block_ticks``
    is how many ticks one ``step`` advances (default M: every slot visited
    once per block). ``eos_id`` retires a slot the moment it emits that
    token; budget retirement applies always. The validation and its
    messages are the JAX ``make_serving_step_fn``'s.
    """
    if cfg.arch not in ("gpt2", "llama"):
        raise ValueError(
            f"generation is undefined for arch {cfg.arch!r} (see "
            "models.generate)")
    if paged:
        raise _not_ported("paged KV serving", "paged")
    if speculative:
        raise _not_ported("speculative serving", "speculative")
    if tp_size != 1:
        raise _not_ported("a 'model' axis (tensor parallelism)", "tp")
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
    return ServingProgram(cfg, n_stages=D, n_slots=M, max_len=max_len,
                          prompt_max=prompt_max, out_max=out_max,
                          prefill_chunk=C, block_ticks=block, eos_id=eos_id,
                          device=resolve_device(device))


class ServingEngine:
    """Host-side scheduler driving a :class:`ServingProgram`.

    ``submit`` queues requests; ``run`` advances the ring block by block,
    retiring finished slots and admitting queued requests between blocks.
    ``submit`` raises on an invalid request; ``run`` retires an invalid
    one, or one whose admission fails, with a ``status="failed"``
    :class:`Completion` and keeps serving.
    """

    def __init__(self, program: ServingProgram, model: Transformer, *,
                 draft_params=None, report=None, fault_plan=None) -> None:
        if draft_params is not None:
            raise _not_ported("a draft model (speculative serving)",
                              "speculative")
        if report is not None:
            raise _not_ported("a RunReport", "report")
        if fault_plan is not None:
            raise _not_ported("a FaultPlan", "fault_plan")
        self.program = program
        self.weights = program.prepare(model)
        self.reset()

    def reset(self) -> None:
        p = self.program
        self.state = p.init_state()
        # host mirrors of the device slot table and prompt buffer (pinned
        # on a card, so the upload after admission does not wait); the
        # numpy views are what the scheduler reads and writes
        pin = p.device.type == "cuda"
        self._slots_t = torch.zeros(self.state["slots"].shape,
                                    dtype=torch.long, pin_memory=pin)
        self._slots_t[:, _T_FIRST] = -1
        self._slots_t[:, _T_FINISH] = -1
        self._prompt_t = torch.zeros(self.state["prompt_buf"].shape,
                                     dtype=torch.long, pin_memory=pin)
        self.slots = self._slots_t.numpy()
        self.prompt_buf = self._prompt_t.numpy()
        self._dirty = False
        self.pending: deque = deque()
        self.waiting: deque = deque()
        self.completions: List[Completion] = []
        self.occupancy: List[Any] = []
        self.queue_depth: List[Any] = []
        self._slot_req: Dict[int, Request] = {}
        self._slot_admit: Dict[int, int] = {}
        self._tick = 0
        self._busy_ticks = 0
        self._n_blocks = 0
        self._host_syncs = 0

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

    def _admit(self, slot: int, req: Request) -> None:
        """Bind ``req`` to ``slot``: the host mirrors and schedule arrays,
        uploaded before the next block. Raises, before writing anything,
        on a prompt that is not a row of token ids of the vocabulary."""
        prompt = np.asarray(req.prompt, np.int64)
        vocab = self.program.cfg.vocab_size
        if prompt.ndim != 1 or ((prompt < 0) | (prompt >= vocab)).any():
            raise ValueError(f"prompt tokens must be ids in [0, {vocab})")
        st = self.state
        plen = len(prompt)
        self.prompt_buf[slot] = 0
        self.prompt_buf[slot, :plen] = prompt
        row = self.slots[slot]
        row[:] = 0
        row[_T_FIRST] = row[_T_FINISH] = -1
        row[_BUDGET] = req.max_new_tokens
        st["plen"][slot] = plen
        st["prefill_left"][slot] = plen
        st["pos"][slot] = 0
        st["budget"][slot] = req.max_new_tokens
        st["emitted_pred"][slot] = 0
        st["epoch"][slot] += 1
        st["live"][slot] = True
        self._dirty = True
        self._slot_req[slot] = req
        self._slot_admit[slot] = self._tick

    def _fail_request(self, req: Request, reason: str) -> None:
        """Retire ``req`` unserved with a ``failed`` completion."""
        self.completions.append(Completion(
            rid=req.rid, prompt=list(map(int, req.prompt)), tokens=[],
            slot=-1, admit_tick=-1, first_token_tick=-1, finish_tick=-1,
            arrival=req.arrival, status="failed", reason=reason))

    def _harvest(self) -> None:
        for slot, req in list(self._slot_req.items()):
            row = self.slots[slot]
            if not row[_FINISHED]:
                continue
            n = int(row[_EMITTED])
            self.completions.append(Completion(
                rid=req.rid, prompt=list(map(int, req.prompt)),
                tokens=[int(t) for t in row[_NCOL:_NCOL + n]],
                slot=slot, admit_tick=self._slot_admit[slot],
                first_token_tick=int(row[_T_FIRST]),
                finish_tick=int(row[_T_FINISH]), arrival=req.arrival))
            self.state["live"][slot] = False
            del self._slot_req[slot]
            del self._slot_admit[slot]

    def _run_block(self) -> None:
        """Upload what admission wrote, run one block, read the slot table
        back (the block's one blocking transfer)."""
        st, p = self.state, self.program
        pin = p.device.type == "cuda"
        if self._dirty:
            st["slots"].copy_(self._slots_t, non_blocking=pin)
            st["prompt_buf"].copy_(self._prompt_t, non_blocking=pin)
            self._dirty = False
        st["u"] = self._tick
        p.step(self.weights, st)
        self._slots_t.copy_(st["slots"], non_blocking=pin)
        if pin:
            torch.cuda.current_stream(p.device).synchronize()
        self._host_syncs += 1
        self._n_blocks += 1
        self._tick = st["u"]

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
        for r in sorted(requests, key=lambda r: r.arrival):
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
                    req = self.waiting.popleft()
                    try:  # refused before any write: the slot stays free
                        self._admit(free[0], req)
                    except (ValueError, TypeError) as e:
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
                    continue
            tick_before = self._tick
            self._run_block()
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
            self._harvest()
            free = [g for g in range(p.n_slots) if g not in self._slot_req]
        else:
            raise RuntimeError(f"serving did not drain within {max_blocks} "
                               "blocks — check arrivals/budgets")
        return ServeResult(completions=self.completions,
                           occupancy=self.occupancy, ticks=self._tick,
                           wall_s=time.perf_counter() - wall0,
                           n_slots=p.n_slots, policy=policy,
                           queue_depth=self.queue_depth,
                           busy_ticks=self._busy_ticks,
                           n_blocks=self._n_blocks,
                           host_syncs=self._host_syncs)
