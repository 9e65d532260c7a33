"""Build the port's CUDA sources at first use and bind them with ctypes.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>-<hash>.so csrc/<name>.cu

into ``_build/`` beside this package (listed in ``.gitignore``). The file
name carries a hash of the source, the shared headers (``csrc/*.cuh``), the
flags and the nvcc version line, so a change to any of them rebuilds and a
built library is reused only as it was built. Every C entry point returns
``cudaGetLastError()`` after its launch; :meth:`Kernel.call` raises when
that is not 0 and counts the launch when it is. Nothing here falls back to
a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its release and build)."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[-1]


class Kernel:
    """One CUDA source: its library, its C entry points and the count of
    launches made through :meth:`call`.

    ``signatures`` maps each exported C function to its ctypes argument
    types; every function returns an ``int`` CUDA error code.
    """

    def __init__(self, source: str, signatures: Dict[str, List]):
        self.source = CSRC_DIR / source
        self.name = self.source.stem
        self.signatures = signatures
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update("\0".join([*NVCC_FLAGS, nvcc_version()]).encode())
        digest = h.hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def _start_build(self) -> Optional[subprocess.Popen]:
        out = self.library_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{self.build_log}")
        os.replace(tmp, self.library_path)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self._finish_build(self._start_build())
            lib = ctypes.CDLL(str(self.library_path))
            for fn, argtypes in self.signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        """Launch through C entry ``fn``; raise on a CUDA error, else count
        the launch."""
        lib = self.load()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = getattr(lib, f"{self.name}_error_string")(rc).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc} ({msg})")
        self.launches += 1


def build_all(kernels: Iterable[Kernel]) -> None:
    """Compile every kernel not yet built, one ``nvcc`` per source, all
    started together, then load them."""
    kernels = list(kernels)
    procs = [k._start_build() for k in kernels]
    try:
        for k, p in zip(kernels, procs):
            k._finish_build(p)
            k.load()
    finally:
        for p in procs:  # a failed build leaves no compiler running
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
