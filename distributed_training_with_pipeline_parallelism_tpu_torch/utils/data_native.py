"""ctypes binding for the native (C++) prefetching token loader (the
counterpart of the JAX package's ``utils/data_native.py``).

``NativeTokenLoader`` is the threaded twin of
:class:`.data.TokenFileDataset`: random crops of ``seq_length + 1``
tokens from an mmap'd flat token file, assembled into int32
``[batch, seq]`` token/target pairs by background C++ threads behind a
bounded queue. The source is the port's own copy, ``csrc/data_loader.cpp``
(host code, not a kernel), built at first use with ``g++`` into the
package's ``_build/`` under a name keyed on a hash of the source, the
flags and the compiler's version line, as ``ops/_build.py`` keys the CUDA
builds. A failed build raises; nothing falls back to the Python sampler.
With ``n_threads=1`` the batch stream is deterministic in ``seed``, the
same stream as the JAX package's loader (one source, one generator).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Iterator, Tuple

import numpy as np

from ..ops._build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "data_loader.cpp"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]
_DTYPE_CODES = {np.dtype(np.uint16): 0, np.dtype(np.int32): 1}


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found: the native data "
                           "loader builds at first use")
    return found


@functools.lru_cache(maxsize=None)
def _library_path() -> str:
    """Build the loader if this source, flags and compiler have not been
    built yet (to a temporary name, renamed into place, so a concurrent
    build never sees a partial library); its path."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60,
                             check=True).stdout.splitlines()[0]
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join([*CXX_FLAGS, version]).encode())
    out = BUILD_DIR / f"libdata_loader-{h.hexdigest()[:12]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built loader, with its C functions' types declared."""
    lib = ctypes.CDLL(_library_path())
    lib.dtpp_dl_open.restype = ctypes.c_void_p
    lib.dtpp_dl_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.dtpp_dl_next.restype = ctypes.c_int
    lib.dtpp_dl_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dtpp_dl_stop.restype = None
    lib.dtpp_dl_stop.argtypes = [ctypes.c_void_p]
    lib.dtpp_dl_close.restype = None
    lib.dtpp_dl_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeTokenLoader:
    """Threaded native random-crop loader over a flat binary token file.

    Yields ``(tokens, targets)`` int32 ``[batch_size, seq_length]`` numpy
    pairs, targets shifted by one (``TokenFileDataset.sample``
    semantics). With ``n_threads=1`` the stream is deterministic in
    ``seed``.
    """

    def __init__(self, path: str, seq_length: int, batch_size: int,
                 dtype: np.dtype = np.uint16, seed: int = 0,
                 n_threads: int = 2, depth: int = 4):
        code = _DTYPE_CODES.get(np.dtype(dtype))
        if code is None:
            raise ValueError(f"unsupported token dtype {dtype!r}; "
                             f"use uint16 or int32")
        lib = load_library()
        err = ctypes.create_string_buffer(256)
        self._lib = lib
        self._handle = lib.dtpp_dl_open(
            os.fspath(path).encode(), seq_length, batch_size, code,
            seed, n_threads, depth, err, len(err))
        if not self._handle:
            raise ValueError(err.value.decode() or "dtpp_dl_open failed")
        self.seq_length = seq_length
        self.batch_size = batch_size
        # close() must not free the native loader under a next() blocked in
        # C (ctypes releases the GIL): next() registers in flight under
        # this condition; close() nulls the handle, stops the loader (which
        # unblocks readers), waits for them to drain, then frees
        self._cond = threading.Condition()
        self._inflight = 0

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._cond:
            if self._handle is None:
                raise RuntimeError("loader is closed")
            handle = self._handle
            self._inflight += 1
        try:
            shape = (self.batch_size, self.seq_length)
            toks = np.empty(shape, np.int32)
            tgts = np.empty(shape, np.int32)
            rc = self._lib.dtpp_dl_next(
                handle,
                toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                tgts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        finally:
            with self._cond:
                self._inflight -= 1
                if self._inflight == 0:
                    self._cond.notify_all()
        if rc != 0:
            raise RuntimeError("loader closed while waiting for a batch")
        return toks, tgts

    def batches(self, sharding=None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Endless batches, or the rank's rows of each (``sharding``, a
        ``utils.data.BatchSharding``)."""
        def gen():
            while True:
                yield self.next()
        return gen() if sharding is None else map(sharding, gen())

    def close(self) -> None:
        with self._cond:
            if self._handle is None:
                return
            handle, self._handle = self._handle, None
            self._lib.dtpp_dl_stop(handle)  # unblocks in-flight next() calls
            while self._inflight:
                self._cond.wait()
        self._lib.dtpp_dl_close(handle)

    def __enter__(self) -> "NativeTokenLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
