"""The world of processes: one per (data, pipe, model, seq, expert)
coordinate (the counterpart of the JAX package's ``parallel/mesh.py``).

The JAX mesh is one program over a ('data', 'pipe') grid of devices; the
reference runs one process per pipeline stage and joins them with
``torch.distributed`` (``LLMsDistributedTrainingHelper.py:168-178``).
The port does the latter: :func:`launch` spawns one process per
coordinate, :func:`init_multihost` joins it to the process group and
:func:`make_mesh` gives it a :class:`Mesh`, its place in the grid and the
groups it reduces over. Ranks follow the JAX grid's row-major order
(``mesh.py:44-66``: data, pipe, model, seq, expert, the expert axis
innermost), ``rank = (((data * n_pipe + pipe) * n_model + model) * n_seq
+ seq) * n_expert + expert``. The model group (the ranks that share every
other coordinate) is where a stage's Megatron shards meet
(``parallel.tensor_parallel``); the seq group is where a stage's sequence
shards meet (``parallel.seq_parallel``); the expert group is where a MoE
stage's expert shards exchange their token slots (``parallel.
expert_parallel``; the expert axis doubles as a batch axis); the data
group carries the FSDP gathers and reduce-scatters (``parallel.fsdp``).
Any shape makes its groups: a MoE stage runs on a world with every axis
above 1, its rows split over data x expert and its sequences over seq.

The backend is the caller's choice, never switched quietly:

- ``"nccl"`` needs one CUDA device per rank on the host; rank r computes
  on ``cuda:r``. NCCL refuses two ranks on one card, so fewer cards than
  ranks raise.
- ``"gloo"`` moves CPU tensors only. Where the ranks compute on CUDA,
  every hand-off and collective is *staged*: copied into a pinned host
  buffer, moved by gloo, copied back. :meth:`Mesh.describe` reports it.
  Rank r computes on the device the caller named: ``cuda:i`` for all of
  them when an index was given, else ``cuda:(r % device_count)``.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.config import MeshConfig, resolve_device

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
BACKENDS = ("gloo", "nccl")
# collectives and hand-offs that wait longer than this fail the rank (and
# so the world) instead of hanging
DEFAULT_TIMEOUT_S = 600.0
# the tag of a hop of the model-axis ring (ops.collectives): above every
# hand-off channel's tag, and on the model group, never the world's
RING_TAG = 1 << 10
# the tag of a hop of the seq-axis ring (ring attention), on the seq group
SEQ_TAG = 1 << 11


class WorldError(RuntimeError):
    """A rank of a :func:`launch` world failed; the message holds its
    traceback."""


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: choose one of {BACKENDS}")


def rank_device(device, backend: str, rank: int, world: int) -> torch.device:
    """The device rank ``rank`` of a ``world``-rank world computes on (see
    the module doc). Raises where the backend cannot serve it."""
    _check_backend(backend)
    device = resolve_device(device)
    if device.type != "cuda":
        if backend == "nccl":
            raise ValueError(f"backend='nccl' moves CUDA tensors only; "
                             f"device={str(device)!r} needs backend='gloo'")
        return device
    count = torch.cuda.device_count()
    if backend == "nccl":
        if count < world:
            raise RuntimeError(
                f"backend='nccl' needs one CUDA device per rank: {world} "
                f"ranks, {count} device(s) on this host (NCCL refuses two "
                f"ranks on one card); use backend='gloo', which stages "
                f"through host memory")
        if device.index is not None:
            raise ValueError(f"backend='nccl' puts rank r on cuda:r; "
                             f"device={str(device)!r} names one card")
        return torch.device("cuda", rank)
    if device.index is not None:
        return device
    return torch.device("cuda", rank % count)


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, *, backend: str,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the world (the JAX ``init_multihost``, the
    reference's ``init_process_group``): ``coordinator_address`` is the
    rendezvous, ``tcp://host:port`` or ``file:///path``; ``num_processes``
    the world size; ``process_id`` this process's rank."""
    _check_backend(backend)
    dist.init_process_group(
        backend, init_method=coordinator_address, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass
class Mesh:
    """This rank's place in the ('data', 'pipe', 'model', 'seq', 'expert')
    grid, its groups and its device. Built by :func:`make_mesh`."""

    n_pipe: int
    n_data: int
    rank: int
    backend: str
    device: torch.device
    pipe_group: Any = None  # the ranks sharing every coordinate but pipe
    data_group: Any = None  # the ranks sharing every coordinate but data
    n_model: int = 1
    model_group: Any = None  # the ranks at this (data, pipe, seq) coordinate
    hops: int = 0  # model-ring hops posted (:meth:`ring_post`)
    n_seq: int = 1
    seq_group: Any = None  # the ranks at this (data, pipe, model) coordinate
    n_expert: int = 1
    expert_group: Any = None  # the ranks sharing every coordinate but expert
    a2a: int = 0  # expert all-to-alls posted (ops.collectives)
    # the model-axis all-reduces and all-gathers of ops.collectives: kind
    # -> [count, host seconds]
    tp_stats: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)

    @property
    def world(self) -> int:
        return (self.n_pipe * self.n_data * self.n_model * self.n_seq
                * self.n_expert)

    @property
    def expert(self) -> int:
        return self.rank % self.n_expert

    @property
    def seq(self) -> int:
        return (self.rank // self.n_expert) % self.n_seq

    @property
    def model(self) -> int:
        return (self.rank // (self.n_expert * self.n_seq)) % self.n_model

    @property
    def pipe(self) -> int:
        return (self.rank // (self.n_expert * self.n_seq * self.n_model)
                ) % self.n_pipe

    @property
    def data(self) -> int:
        return self.rank // (self.n_expert * self.n_seq * self.n_model
                             * self.n_pipe)

    @property
    def shape(self) -> Dict[str, int]:
        """The JAX ``mesh.shape``: axis name -> size (the model, seq and
        expert axes where they are above 1, as a config fingerprint of a
        (data, pipe) world stays what it was)."""
        shape = {DATA_AXIS: self.n_data, PIPE_AXIS: self.n_pipe}
        if self.n_model > 1:
            shape[MODEL_AXIS] = self.n_model
        if self.n_seq > 1:
            shape[SEQ_AXIS] = self.n_seq
        if self.n_expert > 1:
            shape[EXPERT_AXIS] = self.n_expert
        return shape

    @property
    def staging(self) -> bool:
        """True where gloo moves this rank's CUDA tensors through pinned
        host buffers."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        """What moves this rank's messages: ``"gloo-staged"`` (CUDA
        tensors through pinned host buffers), ``"gloo"`` or ``"nccl"``."""
        return "gloo-staged" if self.staging else self.backend

    def rank_of(self, data: int, pipe: int, model: int = 0,
                seq: int = 0, expert: int = 0) -> int:
        return (((data * self.n_pipe + pipe) * self.n_model
                 + model) * self.n_seq + seq) * self.n_expert + expert

    def describe(self) -> Dict[str, Any]:
        return {"backend": self.backend, "staging": self.staging,
                "transport": self.transport,
                "world": self.world, "shape": self.shape,
                "rank": self.rank, "coords": {DATA_AXIS: self.data,
                                              PIPE_AXIS: self.pipe,
                                              MODEL_AXIS: self.model,
                                              SEQ_AXIS: self.seq,
                                              EXPERT_AXIS: self.expert},
                "device": str(self.device)}

    # -- collectives -----------------------------------------------------

    def _group(self, axis: str):
        """(process group, size) of ``axis``: "pipe", "data", "model",
        "seq", "expert" or "world"."""
        if axis == PIPE_AXIS:
            return self.pipe_group, self.n_pipe
        if axis == DATA_AXIS:
            return self.data_group, self.n_data
        if axis == MODEL_AXIS:
            return self.model_group, self.n_model
        if axis == SEQ_AXIS:
            return self.seq_group, self.n_seq
        if axis == EXPERT_AXIS:
            return self.expert_group, self.n_expert
        if axis == "world":
            return None, self.world
        raise ValueError(f"unknown axis {axis!r}")

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """What the backend moves for ``t``: a pinned host copy under
        staging (the caller synchronises before handing it over)."""
        if not self.staging:
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _wire_buffer(self, shape, dtype) -> torch.Tensor:
        if self.staging:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _sync_for_wire(self) -> None:
        if self.staging:
            torch.cuda.current_stream(self.device).synchronize()

    def all_reduce(self, tensors: Sequence[torch.Tensor], axis: str,
                   op: str = "sum") -> None:
        """Reduce ``tensors`` in place over ``axis`` ("sum" or "max"), as
        one flat message per dtype."""
        group, size = self._group(axis)
        if size == 1 or not tensors:
            return
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            wire = self._to_wire(flat)
            self._sync_for_wire()
            dist.all_reduce(wire, op=red, group=group)
            if wire is not flat:
                flat.copy_(wire, non_blocking=True)
            offset = 0
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n

    def reduce_scatter(self, out: torch.Tensor, flat: torch.Tensor,
                       axis: str = DATA_AXIS) -> None:
        """``out`` <- this rank's block of the sum of ``flat`` over
        ``axis`` (``flat`` holds ``size`` blocks of ``out``'s size)."""
        group, size = self._group(axis)
        if size == 1:
            out.copy_(flat)
            return
        wire_in = self._to_wire(flat)
        wire_out = self._wire_buffer(out.shape, out.dtype)
        self._sync_for_wire()
        dist.reduce_scatter_tensor(wire_out, wire_in, group=group)
        out.copy_(wire_out, non_blocking=self.staging)

    def all_gather(self, out: torch.Tensor, shard: torch.Tensor,
                   axis: str = DATA_AXIS) -> None:
        """``out`` <- the blocks of every rank of ``axis`` in coordinate
        order."""
        group, size = self._group(axis)
        if size == 1:
            out.copy_(shard)
            return
        wire_in = self._to_wire(shard)
        wire_out = self._wire_buffer(out.shape, out.dtype)
        self._sync_for_wire()
        dist.all_gather_into_tensor(wire_out, wire_in, group=group)
        out.copy_(wire_out, non_blocking=self.staging)

    def all_to_all(self, out: torch.Tensor, parts: torch.Tensor,
                   axis: str = SEQ_AXIS) -> None:
        """``out[j]`` <- block ``index`` of rank j's ``parts``, where
        ``index`` is this rank's coordinate on ``axis``: ``parts`` and
        ``out`` are ``[size, ...]``, block j of ``parts`` going to the
        axis's rank j (gloo moves CPU tensors only, so a CUDA tensor is
        staged like the other collectives)."""
        group, size = self._group(axis)
        if size == 1:
            out.copy_(parts)
            return
        wire_in = self._to_wire(parts)
        wire_out = self._wire_buffer(out.shape, out.dtype)
        self._sync_for_wire()
        dist.all_to_all_single(wire_out, wire_in, group=group)
        out.copy_(wire_out, non_blocking=self.staging)

    def all_gather_object(self, obj, axis: str = "world") -> list:
        group, size = self._group(axis)
        out = [None] * size
        dist.all_gather_object(out, obj, group=group)
        return out

    def any(self, flag: bool, axis: str = "world") -> bool:
        """True on every rank when ``flag`` is true on one (a host
        value)."""
        t = torch.tensor([float(flag)], device=self.device)
        self.all_reduce([t], axis, op="max")
        return bool(t.item())

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    # -- point to point --------------------------------------------------

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int, int]],
                 recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int,
                                       int]]):
        """Post this rank's sends ``(tensor, peer pipe coordinate, tag)``
        and receives ``(shape, dtype, peer, tag)`` together
        (``batch_isend_irecv``: one order on every rank, so no pairing can
        deadlock). Peers are pipe coordinates of this rank's other
        coordinates.
        Returns ``(send_works, [(work, buffer), ...])``: wait a receive's
        work before reading its buffer (:meth:`landed`), and keep the send
        works until they complete."""
        def at(peer):
            return self.rank_of(self.data, peer, self.model, self.seq,
                                self.expert)

        ops, wires = [], []
        for t, peer, tag in sends:
            wire = self._to_wire(t)
            wires.append(wire)
            ops.append(dist.P2POp(dist.isend, wire, at(peer), tag=tag))
        self._sync_for_wire()
        bufs = []
        for shape, dtype, peer, tag in recvs:
            buf = self._wire_buffer(shape, dtype)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, at(peer), tag=tag))
        works = dist.batch_isend_irecv(ops) if ops else []
        n = len(sends)
        return (list(zip(works[:n], wires)),
                list(zip(works[n:], bufs)))

    def landed(self, work, buf: torch.Tensor) -> torch.Tensor:
        """Wait for a receive and return it on this rank's device."""
        work.wait()
        if self.staging:
            return buf.to(self.device, non_blocking=True)
        return buf

    def ring_post(self, x: torch.Tensor, offset: int):
        """Post one hop of the model-axis ring: ``x`` to model coordinate
        ``(model + offset) % n_model``, and the receive of the same shape
        from ``(model - offset) % n_model``, on the model group under
        :data:`RING_TAG` (so no hop can match a pipe hand-off pending on
        the world group). Counts the hop; :meth:`ring_wait` returns what
        arrived."""
        T, m = self.n_model, self.model

        def at(j):
            return self.rank_of(self.data, self.pipe, j % T, self.seq,
                                self.expert)

        wire = self._to_wire(x)
        self._sync_for_wire()
        buf = self._wire_buffer(x.shape, x.dtype)
        ops = [dist.P2POp(dist.isend, wire, at(m + offset),
                          group=self.model_group, tag=RING_TAG),
               dist.P2POp(dist.irecv, buf, at(m - offset),
                          group=self.model_group, tag=RING_TAG)]
        self.hops += 1
        return dist.batch_isend_irecv(ops), wire, buf

    def ring_wait(self, handle) -> torch.Tensor:
        works, _, buf = handle
        for w in works:
            w.wait()
        if self.staging:
            return buf.to(self.device, non_blocking=True)
        return buf

    def seq_shift(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """One hop of the seq-axis ring (the JAX ``ppermute`` of ring
        attention): ``x`` to seq coordinate ``(seq + offset) % n_seq``,
        and what seq coordinate ``(seq - offset) % n_seq`` sent, returned,
        on the seq group under :data:`SEQ_TAG` (no pipe hand-off or
        model-ring hop can match it). Every rank of a seq group posts its
        hops in one order, so the pairs meet."""
        D, s = self.n_seq, self.seq

        def at(j):
            return self.rank_of(self.data, self.pipe, self.model, j % D,
                                self.expert)

        wire = self._to_wire(x)
        self._sync_for_wire()
        buf = self._wire_buffer(x.shape, x.dtype)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, wire, at(s + offset),
                       group=self.seq_group, tag=SEQ_TAG),
            dist.P2POp(dist.irecv, buf, at(s - offset),
                       group=self.seq_group, tag=SEQ_TAG)])
        for w in works:
            w.wait()
        if self.staging:
            return buf.to(self.device, non_blocking=True)
        return buf


def make_mesh(n_pipe: int, n_data: int = 1, n_model: int = 1,
              n_seq: int = 1, n_expert: int = 1, *, backend: str,
              device) -> Mesh:
    """This rank's :class:`Mesh` over the joined world
    (:func:`init_multihost` first): the world must hold ``n_pipe * n_data
    * n_model * n_seq * n_expert`` ranks. Every rank calls it with the same
    shape, in the same order (it creates the pipe, data, model, seq and
    expert groups, a collective)."""
    _check_backend(backend)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined world: call "
                           "init_multihost (or run under launch) first")
    if dist.get_backend() != backend:
        raise ValueError(f"backend={backend!r}, but the world was joined "
                         f"with {dist.get_backend()!r}")
    world = dist.get_world_size()
    sizes = (n_data, n_pipe, n_model, n_seq, n_expert)
    need = math.prod(sizes)
    if world != need:
        raise ValueError(f"a ({n_data} data x {n_pipe} pipe x {n_model} "
                         f"model x {n_seq} seq x {n_expert} expert) mesh "
                         f"needs {need} ranks, the world has {world}")
    rank = dist.get_rank()
    mesh = Mesh(n_pipe, n_data, rank, backend,
                rank_device(device, backend, rank, world), n_model=n_model,
                n_seq=n_seq, n_expert=n_expert)
    me = (mesh.data, mesh.pipe, mesh.model, mesh.seq, mesh.expert)
    # every rank creates every group of every axis, in one order: an
    # axis's groups run over the other axes' coordinates row-major
    for axis, attr in enumerate(("data_group", "pipe_group", "model_group",
                                 "seq_group", "expert_group")):
        if sizes[axis] == 1 and attr in ("model_group", "seq_group",
                                         "expert_group"):
            continue
        others = [range(n) for i, n in enumerate(sizes) if i != axis]
        for rest in itertools.product(*others):
            coords = [list(rest[:axis]) + [c] + list(rest[axis:])
                      for c in range(sizes[axis])]
            g = dist.new_group([mesh.rank_of(k, p, j, s, e)
                                for k, p, j, s, e in coords])
            if tuple(rest) == me[:axis] + me[axis + 1:]:
                setattr(mesh, attr, g)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


# ---------------------------------------------------------------------------
# Spawning a world
# ---------------------------------------------------------------------------


def _watch_parent(parent_pid: int) -> None:
    """A child outlives no launcher: exit once the parent is gone."""
    while True:
        if os.getppid() != parent_pid:
            os._exit(1)
        time.sleep(0.5)


def _child(rank, mesh_cfg, store, backend, device, timeout_s, call,
           results, parent_pid):
    threading.Thread(target=_watch_parent, args=(parent_pid,),
                     daemon=True).start()
    try:
        with open(call, "rb") as f:  # written by the launcher
            fn, args = pickle.load(f)
        world = mesh_cfg.n_devices
        if rank_device(device, backend, rank, world).type == "cpu":
            # the ranks share the host's cores: no oversubscription; and a
            # fixed thread count for MKL, whose dynamic one (its default)
            # changes a product's summation order from call to call, so
            # the model ranks' replicated leaves would part
            os.environ["MKL_DYNAMIC"] = "FALSE"
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_multihost(f"file://{store}", world, rank, backend=backend,
                       timeout_s=timeout_s)
        mesh = make_mesh(mesh_cfg.n_pipe, mesh_cfg.n_data, mesh_cfg.n_model,
                         mesh_cfg.n_seq, mesh_cfg.n_expert, backend=backend,
                         device=device)
        value = fn(mesh, *args)
        mesh.barrier()  # no rank leaves while another still talks to it
        results.put((rank, True, value))
    except BaseException:  # reported to the launcher, which fails the world
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, mesh_cfg: MeshConfig, *args, backend: str,
           device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``mesh_cfg`` world of
    processes started with ``spawn`` (the reference's ``mp.spawn`` and
    its rendezvous) and return the ranks' results in rank order. ``fn``
    and ``args`` are pickled, so ``fn`` lives at a module's top level.

    The ranks meet through a ``FileStore`` in a fresh temporary directory
    (no port to collide on); ``fn`` and ``args`` go to them as a file
    there, so the launcher never waits for one child's start-up before
    the next one's (a spawned child reads its arguments only once it has
    started). A rank that raises (or dies) fails the
    launch: the others are terminated and :class:`WorldError` carries the
    rank's traceback. Every process started here is stopped before the
    call returns; a child also exits if the launcher dies. Ranks on the
    CPU take ``cpu_count // world`` intra-op threads each."""
    import torch.multiprocessing as mp

    world = mesh_cfg.n_devices
    _check_backend(backend)
    for r in range(world):  # the device rule, checked before any spawn
        rank_device(device, backend, r, world)
    tmp = tempfile.mkdtemp(prefix="dtpp-world-")
    call = os.path.join(tmp, "call.pkl")
    with open(call, "wb") as f:
        pickle.dump((fn, args), f)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_child, daemon=True,
        args=(r, mesh_cfg, os.path.join(tmp, "store"), backend, str(device),
              timeout_s, call, results, os.getpid()))
        for r in range(world)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    try:  # a last message may still be in the pipe
                        rank, ok, value = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise WorldError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                else:
                    continue
            if not ok:
                raise WorldError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join()
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
