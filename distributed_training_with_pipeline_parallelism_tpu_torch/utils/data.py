"""Data pipeline: token datasets, host-side batching, device prefetch (the
counterpart of the JAX package's ``utils/data.py``).

The samplers are the JAX package's numpy code, so one seed gives
bit-identical batches on both sides:

- :func:`synthetic_batches`: the reference's random-token regime;
- :class:`TokenFileDataset`: random crops over a memory-mapped flat token
  file (the GPT-2-style ``.bin`` format); its native twin, whose crop
  assembly runs in C++ threads, is
  :class:`.data_native.NativeTokenLoader`.

:func:`prefetch_to_device` keeps ``depth`` batches in flight to the card:
each batch is pinned on the host (a copy from pageable memory would
synchronise the host with the device) and copied with ``non_blocking`` on
a side stream; the compute stream waits on the copy's event when the
batch is taken, and the tensors are marked as used by it
(``record_stream``), so the allocator does not hand their memory back to
the side stream early.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .config import resolve_device

Batch = Tuple[torch.Tensor, torch.Tensor]  # (tokens, targets), both [B, S]


class BatchSharding:
    """One rank's share of a global ``[B, S]`` batch: block ``index`` of
    ``n`` contiguous blocks of dim 0 (the JAX ``P(DATA_AXIS)`` split), and
    of those rows block ``seq_index`` of ``n_seq`` contiguous blocks of
    dim 1, the sequence (the JAX ``P(DATA_AXIS, SEQ_AXIS)`` split). A call
    maps a batch (a tuple of arrays or tensors) to the rank's part."""

    def __init__(self, n: int, index: int, n_seq: int = 1,
                 seq_index: int = 0):
        if not 0 <= index < n:
            raise ValueError(f"block {index} of {n}")
        if not 0 <= seq_index < n_seq:
            raise ValueError(f"sequence block {seq_index} of {n_seq}")
        self.n, self.index = n, index
        self.n_seq, self.seq_index = n_seq, seq_index

    def rows(self, x):
        b = x.shape[0]
        if b % self.n:
            raise ValueError(f"batch {b} does not split into {self.n} "
                             f"data shards")
        k = b // self.n
        x = x[self.index * k:(self.index + 1) * k]
        if self.n_seq == 1:
            return x
        s = x.shape[1]
        if s % self.n_seq:
            raise ValueError(f"sequence {s} does not split into "
                             f"{self.n_seq} seq shards")
        c = s // self.n_seq
        return x[:, self.seq_index * c:(self.seq_index + 1) * c]

    def __call__(self, batch):
        return tuple(self.rows(x) for x in batch)


def batch_sharding(mesh, axis: str = "data") -> BatchSharding:
    """The rank's slice of global ``[B, S]`` batches over the mesh's data
    axis (a :class:`.mesh.Mesh`; the JAX ``batch_sharding``): contiguous
    blocks of dim 0 in data-coordinate order, the same for every pipe rank
    of a data replica, and on a seq axis the rank's contiguous chunk of
    each sequence in seq-coordinate order. On an expert axis, which
    doubles as a batch axis, the rows split over data x expert,
    data-major (the JAX ``P((DATA_AXIS, EXPERT_AXIS))``). The loaders and
    :func:`prefetch_to_device` take it, so each rank draws the global
    batch stream and keeps its part."""
    coords = {"data": mesh.data, "pipe": mesh.pipe}
    n_seq = getattr(mesh, "n_seq", 1)
    n, index = mesh.shape[axis], coords[axis]
    n_expert = getattr(mesh, "n_expert", 1)
    if axis == "data" and n_expert > 1:
        n, index = n * n_expert, index * n_expert + mesh.expert
    return BatchSharding(n, index, n_seq, mesh.seq if n_seq > 1 else 0)


def _sharded(it: Iterator, sharding: Optional[BatchSharding]) -> Iterator:
    return it if sharding is None else map(sharding, it)


def synthetic_batches(vocab_size: int, batch_size: int, seq_length: int,
                      seed: int = 0, next_token_targets: bool = True,
                      sharding: Optional[BatchSharding] = None,
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless random-token batches — the reference's data regime.

    ``next_token_targets=True`` yields targets shifted by one (so training
    can actually reduce loss); ``False`` reproduces the reference exactly
    (independent random targets, loss pinned at the entropy floor).
    ``sharding`` (:func:`batch_sharding`) yields the rank's rows of each
    global batch."""
    def gen():
        rng = np.random.default_rng(seed)
        while True:
            if next_token_targets:
                toks = rng.integers(0, vocab_size,
                                    (batch_size, seq_length + 1),
                                    dtype=np.int32)
                yield toks[:, :-1], toks[:, 1:]
            else:
                yield (rng.integers(0, vocab_size, (batch_size, seq_length),
                                    dtype=np.int32),
                       rng.integers(0, vocab_size, (batch_size, seq_length),
                                    dtype=np.int32))
    return _sharded(gen(), sharding)


def token_file_dtype(path: str, default: np.dtype = np.uint16) -> np.dtype:
    """The element dtype of a packed token file: the ``<path>.meta.json``
    sidecar's ``dtype`` entry when present (a >= 2^16 vocab's uint32
    corpus), else ``default`` (uint16, the standard packed-corpus
    format)."""
    meta = os.fspath(path) + ".meta.json"
    if os.path.exists(meta):
        with open(meta) as f:
            return np.dtype(json.load(f).get("dtype", default))
    return np.dtype(default)


class TokenFileDataset:
    """Random-crop sampler over a flat binary token file.

    ``path`` holds token ids as a flat array of ``dtype`` (uint16 fits any
    vocab < 65536; ``dtype=None`` consults the ``.meta.json`` sidecar).
    Batches are independent random crops of ``seq_length + 1`` tokens;
    targets are the crop shifted by one.
    """

    def __init__(self, path: str, seq_length: int,
                 dtype: Optional[np.dtype] = None, seed: int = 0):
        if dtype is None:
            dtype = token_file_dtype(path)
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self.tokens) < seq_length + 1:
            raise ValueError(
                f"{path} holds {len(self.tokens)} tokens, need at least "
                f"{seq_length + 1}")
        self.seq_length = seq_length
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.tokens)

    def sample(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        # valid crop starts: 0 .. len - (seq_length+1) inclusive
        starts = self._rng.integers(
            0, len(self.tokens) - self.seq_length, batch_size)
        crops = np.stack([
            np.asarray(self.tokens[s: s + self.seq_length + 1])
            for s in starts]).astype(np.int32)
        return crops[:, :-1], crops[:, 1:]

    def batches(self, batch_size: int,
                sharding: Optional[BatchSharding] = None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Endless global batches of ``batch_size`` crops, or the rank's
        rows of each (``sharding``)."""
        def gen():
            while True:
                yield self.sample(batch_size)
        return _sharded(gen(), sharding)


def write_token_file(path: str, tokens: np.ndarray,
                     dtype: np.dtype = np.uint16) -> None:
    """Pack a 1-D token-id array into the flat binary format."""
    np.asarray(tokens, dtype=dtype).tofile(path)


def encode_text_file(text_path: str, out_path: str) -> int:
    """Byte-level "tokenize" a UTF-8 text file into the packed format
    (vocab 256, no external tokenizer). Returns the token (byte) count.
    Pair with ``ModelConfig(vocab_size=256)``."""
    data = np.fromfile(text_path, dtype=np.uint8)
    write_token_file(out_path, data)
    return int(data.size)


def encode_text_file_hf(text_path: str, out_path: str, tokenizer="gpt2",
                        chunk_chars: int = 1 << 20) -> int:
    """Tokenize a UTF-8 text file into the packed format with a Hugging Face
    tokenizer. ``tokenizer`` is a name or local path for
    ``AutoTokenizer.from_pretrained`` ("gpt2" BPE by default — pair with
    the gpt2-* models and their 50257 vocab) or an already-constructed
    tokenizer object (any callable with ``len()`` returning
    ``{"input_ids": [...]}``). Streams ``chunk_chars``-character chunks,
    so a corpus of any size encodes in bounded memory. Returns the token
    count.

    uint16 packs vocabs < 65536; a larger tokenizer writes uint32 and a
    ``<out_path>.meta.json`` sidecar that :class:`TokenFileDataset`
    (``dtype=None``) reads; a stale sidecar from an earlier uint32
    encoding of the same path is removed.

    Chunks cut at whitespace so the stream matches one-shot encoding;
    whitespace-free runs accumulate (up to 64x ``chunk_chars``) until a
    cut point appears. Only a single whitespace-free run longer than that
    bound is cut mid-run, where one token may split against one-shot
    encoding. ``add_special_tokens=False``: no BOS/EOS lands at a chunk
    boundary of one continuous corpus."""
    if isinstance(tokenizer, str):
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(tokenizer)
    else:
        tok = tokenizer
    dtype = np.uint16 if len(tok) < (1 << 16) else np.uint32
    sidecar = os.fspath(out_path) + ".meta.json"
    if dtype != np.uint16:
        # a uint32 file read as uint16 would train on half-tokens
        with open(sidecar, "w") as f:
            json.dump({"dtype": "uint32", "vocab_size": len(tok)}, f)
    elif os.path.exists(sidecar):
        os.remove(sidecar)
    n = 0

    def emit(text, out):
        nonlocal n
        ids = np.asarray(tok(text, add_special_tokens=False)["input_ids"],
                         dtype=dtype)
        ids.tofile(out)
        n += int(ids.size)

    carry = ""
    with open(text_path, encoding="utf-8") as src, open(out_path, "wb") as out:
        while True:
            chunk = src.read(chunk_chars)
            if not chunk:
                break
            chunk = carry + chunk
            # cut at the last whitespace so no word (or BPE merge) straddles
            # a chunk boundary; the whitespace travels with the next chunk
            # (GPT-2-style BPE attaches the leading space to the word)
            cut = max(chunk.rfind(" "), chunk.rfind("\n"))
            if cut <= 0:
                # no whitespace: keep accumulating, up to 64x chunk_chars,
                # past which the chunk goes whole (the one documented split)
                if len(chunk) < 64 * chunk_chars:
                    carry = chunk
                else:
                    carry = ""
                    emit(chunk, out)
            else:
                carry = chunk[cut:]
                emit(chunk[:cut], out)
        if carry:
            emit(carry, out)
    return n


class DigestedBatch(tuple):
    """A batch on the device with its host arrays' content digest
    (``dynamics.batch_digest``), taken before the copy."""

    digest: str

    def __new__(cls, tensors, digest: str):
        out = super().__new__(cls, tensors)
        out.digest = digest
        return out


def prefetch_to_device(it: Iterator, depth: int = 2,
                       device="cuda",
                       sharding: Optional[BatchSharding] = None,
                       digest: bool = False) -> Iterator[Batch]:
    """Keep ``depth`` batches of ``it`` (tuples of numpy arrays or host
    tensors) in flight to ``device`` and yield them there as tensors (see
    the module doc); ``sharding`` first keeps the rank's rows of each. On
    the CPU the batches are only converted. ``digest``: yield
    :class:`DigestedBatch` es, each with its host arrays' digest (for
    ``fit``'s forensics: hashing the device tensors would wait for the
    copy)."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = resolve_device(device)
    it = _sharded(it, sharding)

    def digested(host, dev):
        if not digest:
            return dev
        from .dynamics import batch_digest
        return DigestedBatch(dev, batch_digest(*host))

    if device.type != "cuda":
        for batch in it:
            yield digested(batch, tuple(torch.as_tensor(x) for x in batch))
        return
    stream = torch.cuda.Stream(device)
    queue: collections.deque = collections.deque()

    def put(batch):
        host = [torch.as_tensor(np.ascontiguousarray(x)).pin_memory()
                for x in batch]
        with torch.cuda.stream(stream):
            dev = tuple(h.to(device, non_blocking=True) for h in host)
            done = torch.cuda.Event()
            done.record(stream)
        return digested(batch, dev), done

    def take():
        dev, done = queue.popleft()
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        for x in dev:
            x.record_stream(compute)
        return dev

    for batch in it:
        queue.append(put(batch))
        if len(queue) >= depth:
            yield take()
    while queue:
        yield take()
