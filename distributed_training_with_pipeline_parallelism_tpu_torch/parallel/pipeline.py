"""The pipeline executor: the stage split and the training tick executor
(counterparts of the JAX package's ``parallel/pipeline.py``:
``stack_stage_layers`` ``:199``, ``_stage_index_map`` ``:190`` and
``make_pipeline_grad_fn`` ``:589``; its last-stage loss ``_stage_ce``
``:251`` is ``models.transformer.head_loss``).

All D stages run in one process on one device, in lockstep over the
compiled ``[T, D, 17]`` tick table: each tick, each device banks last
tick's arrivals into the slots columns 0 and 4 name, runs its forward unit
(columns 1-3), then its backward unit (columns 5-8); the ring hops are
hand-overs between per-device Python mailboxes, delivered at the end of
the tick (the single-process lockstep transport of ``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.transformer import (Transformer, _check_arch, body_apply,
                                  embed_apply, head_loss)
from ..ops.layers import global_pad_scale
from ..utils.config import ModelConfig, ScheduleConfig, resolve_device
from .schedules import (COL_BWD_ASLOT, COL_BWD_GSLOT, COL_BWD_M, COL_BWD_V,
                        COL_FWD_M, COL_FWD_SLOT, COL_FWD_V, COL_STORE_B_SLOT,
                        COL_STORE_F_SLOT, compile_schedule, stage_of)

# mesh axes of the JAX executor that the single-device port does not run
_AXIS_ITEMS = {
    "data": "ROADMAP.md Queue 1, item 8 (torch.distributed transport)",
    "model": "ROADMAP.md Queue 1, item 11 (tensor parallelism)",
    "seq": "ROADMAP.md Queue 1, item 11 (sequence parallelism)",
    "expert": "ROADMAP.md Queue 1, item 11 (expert parallelism)",
}


def _stage_index_map(n_devices: int, n_virtual: int) -> np.ndarray:
    """[D, V] array: the global stage held by (device, chunk) under the
    wrap placement, ``v * D + d``."""
    return np.array([[stage_of(d, v, n_devices) for v in range(n_virtual)]
                     for d in range(n_devices)])


def stack_stage_layers(layers: nn.ModuleList, n_devices: int,
                       n_virtual: int = 1) -> List[List[nn.ModuleList]]:
    """Split ``layers`` over S = D * V stages: ``[D][V]`` slices, where
    device d's chunk v holds stage ``s = v * D + d``, i.e. layers
    ``s * L/S .. (s+1) * L/S - 1`` (the blocks are shared, not copied)."""
    n = len(layers)
    S = n_devices * n_virtual
    if n % S != 0:
        raise ValueError(f"n_layers={n} must divide evenly into {S} stages")
    lps = n // S
    idx = _stage_index_map(n_devices, n_virtual)
    return [[nn.ModuleList(layers[s * lps:(s + 1) * lps]) for s in row]
            for row in idx.tolist()]


def make_pipeline_grad_fn(cfg: ModelConfig, sched: ScheduleConfig,
                          n_stages: int, remat_backward=None,
                          device="cuda", axes: Optional[Dict[str, int]] = None
                          ) -> Callable[[Transformer, torch.Tensor,
                                         torch.Tensor], torch.Tensor]:
    """``(model, tokens, targets) -> loss``: one pipelined forward and
    backward over ``n_stages`` (D) lockstep devices under ``sched``, with
    the gradients accumulated into the parameters' ``.grad`` (zero them
    first). ``tokens``/``targets`` are [B, S] with B divisible by
    ``sched.n_microbatches`` (M); microbatches split dim 0.

    The loss matches the JAX executor: the last stage takes the token-mean
    cross entropy of its microbatch, the loss is the mean over
    microbatches, and the gradients are those of that mean (the last
    stage seeds its backward with 1/M, so every cotangent on the -1 ring
    carries the 1/M scale).

    ``remat_backward`` (the JAX ``pipeline.py:865`` rule):

    - ``None``: rematerialise at D > 1; at D == 1, plain autograd over the
      microbatches (no tick table to run).
    - ``True``: the forward unit runs under ``no_grad`` and keeps only the
      stage input in its activation slot; the backward unit re-runs the
      stage under autograd, back-propagates the incoming cotangent (or,
      on the last stage, the loss) and sends the input's gradient down
      the -1 ring.
    - ``False``: stored; the forward unit keeps its autograd graph until
      its backward unit.

    Raises ``NotImplementedError`` for ``cfg.dropout > 0`` and for any
    ``axes`` entry (``"data"``, ``"model"``, ``"seq"``, ``"expert"``) of
    size > 1, naming the ``ROADMAP.md`` item that ports it.
    """
    device = resolve_device(device)
    _check_arch(cfg)
    for name, size in (axes or {}).items():
        if name not in _AXIS_ITEMS:
            raise ValueError(f"unknown mesh axis {name!r}; expected one of "
                             f"{sorted(_AXIS_ITEMS)}")
        if size > 1:
            raise NotImplementedError(
                f"a {name!r} axis of size {size} is not ported yet: "
                f"{_AXIS_ITEMS[name]}")
    if cfg.dropout > 0.0:
        raise NotImplementedError(
            "dropout > 0 in the pipeline is not ported yet: ROADMAP.md "
            "Queue 1, item 3 (dropout masks)")
    D, V, M = n_stages, sched.n_virtual, sched.n_microbatches
    cs = compile_schedule(sched.name, D, V, M)  # raises on a bad (D, V, M)
    S = D * V
    if cfg.n_layers % S != 0:
        raise ValueError(f"n_layers={cfg.n_layers} must divide evenly into "
                         f"{S} stages")
    plain = D == 1 and remat_backward is None
    remat = remat_backward is None or bool(remat_backward)
    table = cs.table
    inv = 1.0 / M

    def grad_fn(model: Transformer, tokens, targets) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=device).long()
        targets = torch.as_tensor(targets, device=device).long()
        b, seq = tokens.shape
        if b % M:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_microbatches={M}")
        toks = tokens.view(M, b // M, seq)
        tgts = targets.view(M, b // M, seq)
        pad_scale = (global_pad_scale(targets, cfg.pad_token_id, M)
                     if cfg.pad_token_id is not None else None)
        loss = torch.zeros((), dtype=torch.float32, device=device)
        if plain:
            with torch.enable_grad():
                for m in range(M):
                    y = body_apply(cfg, model.layers,
                                   embed_apply(cfg, model, toks[m]))
                    ce = head_loss(cfg, model, y, tgts[m], pad_scale)
                    (ce * inv).backward()
                    loss += ce.detach()
            return loss * inv

        stages = stack_stage_layers(model.layers, D, V)
        act: List[List] = [[None] * cs.n_act_slots for _ in range(D)]
        grad: List[List] = [[None] * cs.n_grad_slots for _ in range(D)]
        graphs: List[Dict] = [dict() for _ in range(D)]  # stored: slot -> (x, y)
        fwd_in: List = [None] * D  # mailboxes: last tick's +1 ring hop
        bwd_in: List = [None] * D  # ... -1 ring hop

        def forward_unit(d, row):
            v, m, slot = (int(row[c]) for c in (COL_FWD_V, COL_FWD_M,
                                                 COL_FWD_SLOT))
            s = stage_of(d, v, D)
            if remat:
                with torch.no_grad():
                    x = embed_apply(cfg, model, toks[m]) if s == 0 \
                        else act[d][slot]
                    act[d][slot] = x  # the saved stage input
                    y = body_apply(cfg, stages[d][v], x)
            else:
                with torch.enable_grad():
                    x = embed_apply(cfg, model, toks[m]) if s == 0 \
                        else act[d][slot].detach().requires_grad_()
                    act[d][slot] = x
                    y = body_apply(cfg, stages[d][v], x)
                graphs[d][slot] = (x, y)
                y = y.detach()
            return y if s < S - 1 else None

        def backward_unit(d, row):
            nonlocal loss
            v, m, aslot = (int(row[c]) for c in (COL_BWD_V, COL_BWD_M,
                                                  COL_BWD_ASLOT))
            s = stage_of(d, v, D)
            with torch.enable_grad():
                if remat:
                    # stage 0 recomputes its embedding under autograd, so
                    # the input's gradient flows on into the tables
                    x = embed_apply(cfg, model, toks[m]) if s == 0 \
                        else act[d][aslot].detach().requires_grad_()
                    y = body_apply(cfg, stages[d][v], x)
                else:
                    x, y = graphs[d].pop(aslot)
                if s == S - 1:
                    ce = head_loss(cfg, model, y, tgts[m], pad_scale)
                    (ce * inv).backward()
                    loss += ce.detach()
                else:
                    gslot = int(row[COL_BWD_GSLOT])
                    torch.autograd.backward(y, grad[d][gslot])
                    grad[d][gslot] = None  # released: B(s, m) read it last
            act[d][aslot] = None
            return x.grad if s > 0 else None

        for t in range(table.shape[0]):
            fwd_send: List = [None] * D
            bwd_send: List = [None] * D
            for d in range(D):
                row = table[t, d]
                if row[COL_STORE_F_SLOT] >= 0:
                    act[d][row[COL_STORE_F_SLOT]] = fwd_in[d]
                if row[COL_STORE_B_SLOT] >= 0:
                    grad[d][row[COL_STORE_B_SLOT]] = bwd_in[d]
                if row[COL_FWD_M] >= 0:
                    fwd_send[d] = forward_unit(d, row)
                if row[COL_BWD_M] >= 0:
                    bwd_send[d] = backward_unit(d, row)
            fwd_in = [fwd_send[(d - 1) % D] for d in range(D)]
            bwd_in = [bwd_send[(d + 1) % D] for d in range(D)]
        return loss * inv

    return grad_fn
