"""Build the ``csrc/*.cu`` kernels with nvcc and bind them with ctypes.

Each source is compiled on its own, at first use, into
``<repo>/build/kernels/<name>-<digest>.so`` for ``sm_90a``; the digest
covers the source, the shared header and the flags, so an edited source
builds anew.  Nothing is compiled or loaded when a module is imported.
``build_all`` starts one nvcc per missing library at once and waits for
all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


_BUILD_SEQ = itertools.count()


class CudaKernel:
    """One csrc source, its C entry point, and the count of its launches.

    ``launch`` calls the entry point, which launches on the given stream
    and returns ``cudaGetLastError()``; a non-zero code raises.  Safe
    across threads: the first launch builds and loads the library once.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None
        self._fn = None
        self._lock = threading.Lock()

    @property
    def library(self) -> Path:
        h = hashlib.sha256()
        for p in (CSRC / self.source, CSRC / "common.cuh"):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start nvcc if the library is missing; returns a ``_Build`` or
        None.  nvcc writes a temporary name, renamed when it succeeds."""
        lib = self.library
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a thread's ident is reused once it has ended: the count keeps two
        # builds of one process apart whichever threads start them
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}."
                              f"{next(_BUILD_SEQ)}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return _Build(proc, tmp, lib)

    def _function(self):
        with self._lock:
            if self._fn is None:
                build = self.start_build()
                if build is not None:
                    build.finish()
                self._lib = ctypes.CDLL(str(self.library))
                fn = getattr(self._lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = self._lib.rgba_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        rc = self._function()(*args)
        if rc != 0:
            msg = self._lib.rgba_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{rc} ({msg})")
        with self._lock:
            self.launches += 1


class _Build:
    def __init__(self, proc, tmp: Path, lib: Path):
        self.proc, self.tmp, self.lib = proc, tmp, lib

    def finish(self) -> str:
        """Wait for nvcc; returns its log (ptxas register and shared-memory
        report) and raises if it failed."""
        log, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.lib.name}:\n{log}")
        os.replace(self.tmp, self.lib)
        self.lib.with_suffix(".log").write_text(log)
        return log


def build_all(kernels) -> dict:
    """Build every missing library with one nvcc per source, all started
    together, and wait for every one; returns {source: nvcc log or
    'cached'} and raises after all have ended if any failed."""
    builds = {k.source: k.start_build() for k in kernels}
    logs, errors = {}, []
    for source, build in builds.items():
        if build is None:
            logs[source] = "cached"
            continue
        try:
            logs[source] = build.finish()
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs
