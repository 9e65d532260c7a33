"""Resilience: committed checkpoints, the anomaly guard, preemption and
stall handling, and the deterministic fault plan (the counterpart of the
JAX package's ``utils/resilience.py``; its own copy, importing nothing of
the JAX package).

- **Commit protocol** (:class:`CheckpointManager`,
  :func:`latest_committed_step_dir`, :func:`gc_checkpoints`): a save
  counts only once its ``_COMMITTED.json`` marker (step, config
  fingerprint, state digest) is in place, and restore walks past
  uncommitted or mismatched dirs to the newest committed one. Keep-last-k
  retention removes older committed checkpoints and dead shells strictly
  older than the newest committed step, never a newer shell (it may be an
  async save in flight). The directory logic is the JAX function over the
  same trees.
- **Anomaly guard** (:class:`AnomalyGuard`, :func:`init_guard_state`):
  the train step (``utils.train.make_train_step``) checks the loss and a
  per-stage non-finite count on the device and skips a bad step there;
  the counters are device tensors read only at log points.
- **Preemption and stalls** (:class:`PreemptionHandler`,
  :class:`StepWatchdog`).
- **Fault injection** (:class:`FaultPlan`): NaN gradients at chosen steps,
  a raising data iterator, a kill between flush and commit
  (:class:`SimulatedKill`), a simulated preemption, poisoned and delayed
  serving requests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import signal
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import torch

from .checkpoint import (STATE_FILE, PendingSave, is_committed,
                         prepare_checkpoint_dir, read_commit_marker,
                         restore_checkpoint, save_checkpoint,
                         write_commit_marker)
from .config import resolve_device

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


class SimulatedFault(RuntimeError):
    """Base class for every injected fault — tests catch this to tell an
    injected failure from a real one."""


class SimulatedKill(SimulatedFault):
    """Raised by :meth:`CheckpointManager.save` after the checkpoint data
    has been flushed but BEFORE the commit marker is written — the
    moment a real host death leaves an uncommitted ``step_N`` shell."""


class InjectedDataFault(SimulatedFault):
    """Raised from inside the (wrapped) data iterator at a chosen batch
    index — a host-side input-pipeline failure mid-run."""


class AnomalyBudgetExceeded(RuntimeError):
    """The guarded train loop saw more consecutive anomalous (non-finite)
    steps than :attr:`AnomalyGuard.max_consecutive`. ``fit`` writes a
    final committed checkpoint before raising this."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic script of faults to inject into one run (the JAX
    ``FaultPlan``; all fields are step or request indices, so two runs
    with one plan fail identically).

    - ``nan_grad_steps``: poison the gradients (and loss) with NaN at
      these global step indices, by a step-index compare on the device;
      requires an :class:`AnomalyGuard`.
    - ``nan_grad_stage``: narrow ``nan_grad_steps`` to one pipeline stage:
      only its layers' gradients are poisoned and the loss stays finite,
      so only the per-stage reduction catches it, and the guard's
      ``last_bad_stage`` must name this stage.
    - ``data_fail_step``: the wrapped data iterator raises
      :class:`InjectedDataFault` instead of yielding this batch index
      (counted over the iterator's lifetime, resume drain included).
    - ``kill_in_save_step``: :meth:`CheckpointManager.save` of this step
      writes the checkpoint fully, then raises :class:`SimulatedKill`
      without writing the commit marker.
    - ``preempt_at_step``: ``fit`` triggers its own preemption handler at
      the top of this step (the stand-in for a real SIGTERM).
    - ``serve_poison_rids``: the serving scheduler raises
      :class:`SimulatedFault` while admitting these request ids; the loop
      retires them as ``failed`` without wedging the slot.
    - ``serve_delay``: per-rid extra arrival delay in ticks (a straggler).
    """
    nan_grad_steps: Tuple[int, ...] = ()
    nan_grad_stage: Optional[int] = None
    data_fail_step: Optional[int] = None
    kill_in_save_step: Optional[int] = None
    preempt_at_step: Optional[int] = None
    serve_poison_rids: Tuple[int, ...] = ()
    serve_delay: Optional[Mapping[int, float]] = None

    def wrap_data(self, data: Iterator) -> Iterator:
        """Wrap a data iterator so batch ``data_fail_step`` raises
        :class:`InjectedDataFault` instead of being yielded. Identity
        when no data fault is scheduled."""
        if self.data_fail_step is None:
            return data

        def gen():
            for i, batch in enumerate(data):
                if i == self.data_fail_step:
                    raise InjectedDataFault(
                        f"injected data-iterator failure at batch {i}")
                yield batch
        return gen()


# ---------------------------------------------------------------------------
# Fingerprints / digests
# ---------------------------------------------------------------------------


def config_fingerprint(*objs: Any) -> str:
    """Stable 16-hex-char fingerprint of run-defining configuration
    (dataclasses, dicts, primitives), stored in the commit marker so a
    resume under a *different* config skips that checkpoint."""
    def canon(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return {"__dc__": type(x).__name__,
                    **{k: canon(v)
                       for k, v in sorted(dataclasses.asdict(x).items())}}
        if isinstance(x, Mapping):
            return {str(k): canon(v) for k, v in sorted(x.items())}
        if isinstance(x, (list, tuple)):
            return [canon(v) for v in x]
        return x
    blob = json.dumps([canon(o) for o in objs], sort_keys=True,
                      default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict/list state, dict keys sorted."""
    if isinstance(tree, Mapping):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def pytree_digest(tree) -> str:
    """Structural digest of a state dict, 16 hex chars: every leaf's key
    path, in sorted key order, with its shape and dtype (a tensor) or its
    type (a plain value), hashed as bytes. Deliberately not a content hash
    (that would read every tensor back on each save); it catches the
    realistic corruption class — wrong template, truncated or mixed-up
    state, a changed optimizer — as the JAX digest does."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            desc = f"{tuple(leaf.shape)}:{leaf.dtype}"
        else:
            desc = type(leaf).__name__
        h.update(f"{'/'.join(path)}={desc};".encode())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# Committed-checkpoint discovery + retention
# ---------------------------------------------------------------------------


def list_step_dirs(checkpoint_dir: str) -> List[Tuple[int, str]]:
    """All ``step_{n}`` dirs under ``checkpoint_dir``, newest first."""
    if not os.path.isdir(checkpoint_dir):
        return []
    out = []
    for name in os.listdir(checkpoint_dir):
        if name.startswith("step_"):
            try:
                n = int(name[len("step_"):])
            except ValueError:
                continue
            out.append((n, os.path.join(checkpoint_dir, name)))
    return sorted(out, reverse=True)


def latest_committed_step_dir(checkpoint_dir: str,
                              fingerprint: Optional[str] = None,
                              digest: Optional[str] = None,
                              ) -> Optional[Tuple[int, str]]:
    """Newest *committed* ``step_{n}`` under ``checkpoint_dir`` as
    ``(n, path)``, or None.

    Walks newest-to-oldest, skipping (with a warning) dirs with no commit
    marker — a save that died mid-flush — and committed dirs whose
    marker's config ``fingerprint`` / state ``digest`` disagree with the
    expected ones (when given). A tree where NO dir carries a marker
    predates the commit protocol: its newest dir is returned with a
    warning."""
    dirs = list_step_dirs(checkpoint_dir)
    if not dirs:
        return None
    any_marker = False
    skipped: List[str] = []
    for n, path in dirs:
        marker = read_commit_marker(path)
        if marker is None:
            skipped.append(f"step_{n} (uncommitted)")
            continue
        any_marker = True
        if (fingerprint and marker.get("fingerprint")
                and marker["fingerprint"] != fingerprint):
            skipped.append(f"step_{n} (config fingerprint "
                           f"{marker['fingerprint']} != {fingerprint})")
            continue
        if digest and marker.get("digest") and marker["digest"] != digest:
            skipped.append(f"step_{n} (state digest mismatch)")
            continue
        if skipped:
            log.warning(
                "checkpoint resume: skipping %s; falling back to committed "
                "step_%d under %s", ", ".join(skipped), n, checkpoint_dir)
        return n, path
    if not any_marker:
        n, path = dirs[0]
        log.warning(
            "checkpoint resume: no commit markers anywhere under %s "
            "(legacy checkpoints predating the commit protocol); using "
            "newest step_%d unverified", checkpoint_dir, n)
        return n, path
    log.warning("checkpoint resume: no usable committed checkpoint under "
                "%s (skipped: %s)", checkpoint_dir, ", ".join(skipped))
    return None


def gc_checkpoints(checkpoint_dir: str, keep_last: int) -> List[str]:
    """Retention GC: keep the newest ``keep_last`` *committed*
    checkpoints, remove older committed ones and uncommitted shells
    strictly older than the newest committed step. Uncommitted dirs at or
    past the newest committed step are never touched — one of them may be
    an in-flight async save. Returns the removed paths."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    dirs = list_step_dirs(checkpoint_dir)
    committed = [(n, p) for n, p in dirs if is_committed(p)]
    if not committed:
        return []
    keep = {p for _, p in committed[:keep_last]}
    newest_committed = committed[0][0]
    removed = []
    for n, path in dirs:
        if path in keep:
            continue
        if is_committed(path) or n < newest_committed:
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    if removed:
        log.info("checkpoint GC: removed %d of %d dirs under %s "
                 "(keep_last=%d)", len(removed), len(dirs), checkpoint_dir,
                 keep_last)
    return removed


def world_state_file(mesh, zero1: bool = False, fsdp: bool = False) -> str:
    """The file a rank of ``mesh`` saves and restores in a step dir
    (:class:`CheckpointManager`): ``state.pt`` without a mesh, else
    ``state_pipe{d}[_data{k}][_model{m}].pt`` (the data coordinate with
    ZeRO-1 or FSDP over a data axis, the model coordinate with a model
    axis). The seq ranks of a coordinate hold the same state and share its
    file."""
    if mesh is None:
        return STATE_FILE
    name = f"state_pipe{mesh.pipe}"
    if (zero1 or fsdp) and mesh.n_data > 1:
        name += f"_data{mesh.data}"
    if mesh.n_model > 1:
        name += f"_model{mesh.model}"
    return name + ".pt"


class CheckpointManager:
    """Crash-safe step-checkpoint lifecycle over one directory.

    A synchronous save writes, commits, then GCs; an async save
    (``wait=False``) keeps the write and its marker *pending* and
    :meth:`commit_pending` (called before the next save or restore) waits
    for the write and commits it. A process that dies between write and
    commit leaves an uncommitted shell that restore skips and a later save
    of the same step overwrites.

    With ``mesh`` (a ``parallel.mesh.Mesh``) every rank of the world calls
    each method at the same point. Global rank 0 prepares ``step_{n}/``;
    each pipe rank of data replica 0 writes its own part as
    ``state_pipe{d}.pt`` (with ``zero1`` or ``fsdp`` every data rank
    writes, as ``state_pipe{d}_data{k}.pt``, since each holds other moment
    blocks or shards; with a model axis each name ends in ``_model{m}``,
    every model rank writing its shard; on a seq axis only seq coordinate
    0 writes, the others holding the same state, and on an expert axis
    only expert coordinate 0, the state being the expert group's gathered
    one (``utils.train.fit``): :func:`world_state_file`);
    rank 0 places the commit marker only after a barrier that follows
    every rank's ``fsync``, and alone runs retention. The digest is the
    world's (every rank's structural digest, hashed in rank order), and
    a rank restores the file of its own coordinates.
    """

    def __init__(self, checkpoint_dir: str, *, keep_last: Optional[int] = None,
                 fingerprint: Optional[str] = None,
                 fault_plan: Optional[FaultPlan] = None, mesh=None,
                 zero1: bool = False, fsdp: bool = False) -> None:
        self.checkpoint_dir = checkpoint_dir
        self.keep_last = keep_last
        self.fingerprint = fingerprint
        self.fault_plan = fault_plan
        self.mesh = mesh
        self.gc_removed = 0
        self.n_saved = 0
        self.last_restored_path: Optional[str] = None
        self._pending: Optional[Tuple[Optional[PendingSave], Dict[str, Any],
                                      str]] = None
        self.lead = mesh is None or mesh.rank == 0
        self.state_file = world_state_file(mesh, zero1, fsdp)
        self.writes = mesh is None or (
            ((zero1 or fsdp) and mesh.n_data > 1 or mesh.data == 0)
            and mesh.seq == 0 and mesh.expert == 0)
        if self.lead:
            os.makedirs(checkpoint_dir, exist_ok=True)
        self._barrier()

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _digest(self, state) -> str:
        digest = pytree_digest(state)
        if self.mesh is None:
            return digest
        joined = ";".join(self.mesh.all_gather_object(digest))
        return hashlib.sha256(joined.encode()).hexdigest()[:16]

    def step_path(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir, f"step_{step}")

    def save(self, step: int, state, wait: bool = True) -> str:
        """Save ``state`` as ``step_{step}``; commit now (``wait=True``)
        or leave the commit pending behind the async write
        (``wait=False``). A step already committed with the same state
        digest is left alone (the crash path may re-save the last
        completed step)."""
        self.commit_pending()
        path = self.step_path(step)
        meta = {"step": int(step),
                "fingerprint": self.fingerprint,
                "digest": self._digest(state),
                "committed_unix": time.time()}
        prior = read_commit_marker(path)
        if (prior is not None and prior.get("step") == int(step)
                and prior.get("digest") == meta["digest"]):
            return path
        kill = (self.fault_plan is not None
                and self.fault_plan.kill_in_save_step == step)
        if self.lead:
            prepare_checkpoint_dir(path)
        self._barrier()
        # an injected kill must leave a fully-written-but-uncommitted
        # shell, so the write finishes before "dying"
        pending = None
        if self.writes:
            pending = save_checkpoint(path, state, wait=wait or kill,
                                      filename=self.state_file,
                                      prepare=False)
        if kill:
            self._barrier()
            raise SimulatedKill(
                f"injected kill after writing step_{step} (no commit "
                "marker written)")
        self._pending = (pending, meta, path)
        if wait:
            self.commit_pending()
        return path

    def commit_pending(self) -> None:
        """Land any outstanding save: wait for its write, write its
        commit marker, run retention GC (under a mesh: every rank's write
        first, then rank 0's marker)."""
        if self._pending is None:
            return
        pending, meta, path = self._pending
        self._pending = None
        if pending is not None:
            pending.wait()
        self._barrier()
        if self.lead:
            write_commit_marker(path, meta)
            self._gc()
        self._barrier()
        self.n_saved += 1

    def restore_latest(self, template) -> Optional[Tuple[int, str, Any]]:
        """The newest committed checkpoint matching this manager's
        fingerprint and the template's structural digest, as
        ``(step, path, state)`` with this rank's state on the host, or
        None."""
        self.commit_pending()
        latest = latest_committed_step_dir(
            self.checkpoint_dir, fingerprint=self.fingerprint,
            digest=self._digest(template))
        if latest is None:
            return None
        n, path = latest
        self.last_restored_path = path
        return n, path, restore_checkpoint(path, self.state_file)

    def _gc(self) -> None:
        if self.keep_last:
            self.gc_removed += len(
                gc_checkpoints(self.checkpoint_dir, self.keep_last))

    def stats(self) -> Dict[str, Any]:
        committed = [n for n, p in list_step_dirs(self.checkpoint_dir)
                     if is_committed(p)]
        return {"n_committed": len(committed),
                "last_committed_step": committed[0] if committed else None,
                "n_saved": self.n_saved,
                "gc_removed": self.gc_removed}


# ---------------------------------------------------------------------------
# Anomaly guard (device-side state; the check lives in train.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnomalyGuard:
    """Policy for the train step's finite-check: ``max_consecutive``
    anomalous steps in a row are skipped before the loop checkpoints and
    raises :class:`AnomalyBudgetExceeded`. The budget is enforced at log
    points (the counters are read where the loss is), so with
    ``log_every > 1`` the abort fires at the first log point at or after
    the budget was crossed."""
    max_consecutive: int = 3


GUARD_KEYS = ("step", "consec", "total", "last_anomaly_step",
              "last_bad_stage")


def init_guard_state(start_step: int = 0, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """The guard counters as int32 tensors on ``device`` (the card unless
    the caller passes ``device="cpu"``, as every entry point): the current
    global step, consecutive and total anomaly counts, the last anomalous
    step (-1 = none) and the last anomaly's ``last_bad_stage`` (first
    pipeline stage with non-finite gradients; -2 = only the loss was
    non-finite; -1 = no anomaly yet)."""
    device = resolve_device(device)
    values = (start_step, 0, 0, -1, -1)
    return {k: torch.full((), v, dtype=torch.int32, device=device)
            for k, v in zip(GUARD_KEYS, values)}


# ---------------------------------------------------------------------------
# Preemption + stall watchdog
# ---------------------------------------------------------------------------


class PreemptionHandler:
    """Context manager turning SIGTERM/SIGINT into a cooperative flag:
    the handler only records the signal and the loop checks
    :attr:`triggered` after each completed step. :meth:`trigger` sets the
    same flag programmatically (``FaultPlan.preempt_at_step``). Handlers
    are restored on exit; off the main thread installation is skipped."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 enabled: bool = True) -> None:
        self.signals = tuple(signals)
        self.enabled = enabled
        self.signum: Optional[int] = None
        self._triggered = False
        self._old: Dict[int, Any] = {}

    @property
    def triggered(self) -> bool:
        return self._triggered

    def trigger(self, signum: int = signal.SIGTERM) -> None:
        self._on(signum, None)

    def _on(self, signum, _frame) -> None:
        self.signum = signum
        self._triggered = True

    def __enter__(self) -> "PreemptionHandler":
        if self.enabled:
            for s in self.signals:
                try:
                    self._old[s] = signal.signal(s, self._on)
                except ValueError:  # not the main thread
                    log.debug("preemption handler: cannot install signal "
                              "%s off the main thread", s)
        return self

    def __exit__(self, *exc) -> None:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
        return None


class StepWatchdog:
    """Wall-clock stall detector: a daemon thread that calls
    ``on_stall({"step", "stalled_s"})`` once per stall when no
    :meth:`beat` arrives within ``timeout_s``. Re-arms after the next
    beat; never interrupts the run."""

    def __init__(self, timeout_s: float,
                 on_stall: Callable[[Dict[str, Any]], None],
                 poll_s: Optional[float] = None) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self.stalls = 0
        self._last_beat = time.monotonic()
        self._last_step: Optional[int] = None
        self._fired = False
        self._stop = threading.Event()
        self._lock = threading.Lock()
        poll = poll_s if poll_s is not None else max(timeout_s / 4.0, 0.01)
        self._thread = threading.Thread(
            target=self._watch, args=(poll,), name="dtpp-step-watchdog",
            daemon=True)
        self._thread.start()

    def beat(self, step: int) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self._last_step = step
            self._fired = False

    def _watch(self, poll: float) -> None:
        while not self._stop.wait(poll):
            with self._lock:
                stalled = time.monotonic() - self._last_beat
                fire = stalled >= self.timeout_s and not self._fired
                step = self._last_step
                if fire:
                    self._fired = True
                    self.stalls += 1
            if fire:
                try:
                    self.on_stall({"step": step,
                                   "stalled_s": round(stalled, 3)})
                except Exception:  # a broken callback must not kill the dog
                    log.exception("step watchdog: on_stall callback raised")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
