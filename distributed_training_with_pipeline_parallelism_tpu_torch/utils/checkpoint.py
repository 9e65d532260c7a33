"""Checkpoint save and restore with ``torch.save`` (the counterpart of the
JAX package's ``utils/checkpoint.py``, which saves through Orbax).

A checkpoint is a directory ``step_{n}/`` holding one ``state.pt``: a
nested dict of tensors and plain values (the model's state dict, the
optimizer's, the step, the guard and accumulation state), written by
``torch.save`` and read back with ``torch.load(weights_only=True)``. A
world's checkpoint holds one file per writing rank instead
(``resilience.CheckpointManager``: ``state_pipe{d}.pt``). The
directory counts as *committed* once its ``_COMMITTED.json`` marker (the
JAX file name and keys) has been renamed into place, strictly after the
data file was flushed and ``fsync``ed; :mod:`.resilience` builds the
manager, retention and fallback restore on these primitives. A world
with a model axis writes one file per (pipe, model) coordinate, an FSDP
world one per (pipe, data, model) coordinate with its shards' dims;
:func:`restore_world_model` merges a world's files into the whole model.

Async saves and in-place updates: JAX arrays are immutable, so a JAX save
may read the live state later. The port's optimizer updates the
parameters in place, so the next step would overwrite a save still being
written. An async save therefore first snapshots every CUDA tensor into
pinned host buffers with ``non_blocking`` copies on the current (compute)
stream and records an event; stream order puts the copies before any
later update. A writer thread waits on that event, then writes. The
caller blocks only for enqueueing the copies. CPU tensors are cloned.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import torch

# A checkpoint dir is COMMITTED once this marker file exists inside it,
# written atomically (tmp + rename) strictly AFTER the data file's flush
COMMIT_MARKER = "_COMMITTED.json"
STATE_FILE = "state.pt"


def write_commit_marker(path: str, meta: Dict[str, Any]) -> None:
    """Atomically place the commit marker inside checkpoint dir ``path``:
    write to a tmp file, ``os.replace`` into place — a crash mid-write
    leaves no (partial) marker, so commitment is all-or-nothing."""
    tmp = os.path.join(path, COMMIT_MARKER + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(meta, fh, indent=2, default=str)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, os.path.join(path, COMMIT_MARKER))


def read_commit_marker(path: str) -> Optional[Dict[str, Any]]:
    """The commit-marker dict of checkpoint dir ``path``, or None when
    absent or unreadable (an unreadable marker is treated as
    uncommitted — restore must not trust it)."""
    marker = os.path.join(path, COMMIT_MARKER)
    try:
        with open(marker) as fh:
            out = json.load(fh)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None


def is_committed(path: str) -> bool:
    return read_commit_marker(path) is not None


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def snapshot_to_host(state):
    """``state`` with every tensor copied to the host, and the CUDA event
    after the copies (None when no tensor lives on a card). CUDA tensors
    go into pinned buffers by ``non_blocking`` copies on the current
    stream, so the caller does not wait for them; read the snapshot only
    after the event completes."""
    devices = set()

    def copy(t):
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        devices.add(t.device)
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    host = _map_tensors(copy, state)
    if not devices:
        return host, None
    if len(devices) > 1:
        raise ValueError(f"a checkpoint's tensors span {sorted(map(str, devices))}; "
                         f"the port saves from one card")
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(devices.pop()))
    return host, event


def _write(path: str, host_state, event, filename: str = STATE_FILE
           ) -> None:
    if event is not None:
        event.synchronize()
    tmp = os.path.join(path, filename + ".tmp")
    with open(tmp, "wb") as fh:
        torch.save(host_state, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, os.path.join(path, filename))


class PendingSave:
    """An async save in flight on its writer thread. :meth:`wait` joins it
    and re-raises what the writer raised."""

    def __init__(self, path: str, host_state, event,
                 filename: str = STATE_FILE) -> None:
        self.path = path
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(host_state, event, filename),
            name="dtpp-checkpoint-writer", daemon=True)
        self._thread.start()

    def _run(self, host_state, event, filename) -> None:
        try:
            _write(self.path, host_state, event, filename)
        except BaseException as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def wait(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error


def prepare_checkpoint_dir(path: str) -> str:
    """Make checkpoint dir ``path`` (absolute) empty and ready: refuse a
    *committed* one (silent overwrite of good state is never right);
    remove an existing **uncommitted** one — the shell a run killed
    between flush and commit leaves behind — so a resumed run can re-save
    the step it died on."""
    apath = os.path.abspath(path)
    if os.path.isdir(apath):
        if is_committed(apath):
            raise ValueError(
                f"refusing to overwrite committed checkpoint {apath} — "
                "remove it (or let retention GC) first")
        logging.getLogger(__name__).warning(
            "save_checkpoint: %s exists without a commit marker (prior "
            "save died mid-flush?); removing and re-saving", apath)
        shutil.rmtree(apath)
    os.makedirs(apath)
    return apath


def save_checkpoint(path: str, state, wait: bool = True,
                    filename: str = STATE_FILE, prepare: bool = True
                    ) -> Optional[PendingSave]:
    """Save ``state`` (a nested dict of tensors and plain values) to
    checkpoint dir ``path`` as ``filename``, after
    :func:`prepare_checkpoint_dir` (``prepare=False``: the dir was
    prepared already, as the ranks of a world write their files into one
    dir that global rank 0 prepared).

    ``wait=False`` returns a :class:`PendingSave` as soon as the snapshot
    is enqueued (see the module doc) and writes in the background; wait on
    it before trusting the file. Saving does NOT write the commit marker:
    callers (``resilience.CheckpointManager``) commit once the write has
    finished."""
    apath = prepare_checkpoint_dir(path) if prepare \
        else os.path.abspath(path)
    host, event = snapshot_to_host(state)
    if wait:
        _write(apath, host, event, filename)
        return None
    return PendingSave(apath, host, event, filename)


_WORLD_FILE = re.compile(r"state_pipe(\d+)(?:_data(\d+))?(?:_model(\d+))?\.pt")


def restore_world_model(path: str, cfg) -> Dict[str, torch.Tensor]:
    """The whole model's state dict from step dir ``path``: ``state.pt``'s
    model, or a world's files merged (data replica 0's; each pipe rank's
    blocks, and its model ranks' Megatron shards concatenated by
    ``parallel.tensor_parallel.gather_model``, a vocab-split head
    recognised by its shape), so a world's checkpoint loads whole into
    one process. An FSDP world's files record their shards' dims
    (``"fsdp"``): the data ranks' files of each (pipe, model) coordinate
    are concatenated first (``parallel.fsdp.gather_fsdp``), as JAX saves
    the global arrays."""
    from ..parallel.fsdp import gather_fsdp
    from ..parallel.tensor_parallel import gather_model
    if os.path.exists(os.path.join(path, STATE_FILE)):
        return restore_checkpoint(path)["model"]
    files = {}
    for f in os.listdir(path):
        m = _WORLD_FILE.fullmatch(f)
        if m:
            files[(int(m.group(1)), int(m.group(2) or 0),
                   int(m.group(3) or 0))] = f
    if not files:
        raise FileNotFoundError(f"{path}: no model state to restore")

    def model_of(d, j):
        state = restore_checkpoint(path, files[(d, 0, j)])
        spec = state.get("fsdp")
        if not spec:
            return state["model"]
        return gather_fsdp(
            [state["model"]] + [restore_checkpoint(path, files[(d, k, j)])
                                ["model"] for k in range(1, spec["n"])],
            spec["dims"])

    out: Dict[str, torch.Tensor] = {}
    for d in sorted({d for d, _, _ in files}):
        shards = [model_of(d, j) for j in sorted(
            {j for dd, k, j in files if dd == d and k == 0})]
        out_w = shards[0].get("out.weight")
        vocab = out_w is not None and out_w.shape[0] != cfg.vocab_size
        out.update(gather_model(shards, cfg, vocab))
    return out


def restore_checkpoint(path: str, filename: str = STATE_FILE):
    """The state saved by :func:`save_checkpoint` in ``path``, on the host
    (``torch.load(weights_only=True)``; the caller copies it into its live
    objects)."""
    return torch.load(os.path.join(path, filename), map_location="cpu",
                      weights_only=True)
