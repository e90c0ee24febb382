"""Building and loading the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into a shared library with a plain C
interface (`-gencode arch=compute_90a,code=sm_90a`, no fast-math), which
ctypes loads; pointers and the stream pass as `c_void_p`. The build
runs at first use, into build/torch_kernels/ of the checkout, under a
name that hashes the source and flags, so an edited source never loads
a stale library. `build_all` starts one nvcc per source at once.

Nothing here runs at import: the CPU tests import every module on a
host with no nvcc and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH); the CUDA kernels build only on a host "
                           "with the CUDA toolkit")
    return found


class CudaLibrary:
    """One csrc/ source, its build, its loaded library and the launch
    count of its kernel. `functions` maps each exported C function to
    its ctypes argtypes (every function returns cudaGetLastError())."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC / source
        self.functions = dict(functions)
        self.flags = ARCH_FLAGS + BASE_FLAGS
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.ptxas_log = ""
        self._lib = None
        self._proc = None          # nvcc while a build runs
        self._tmp = None           # its output, renamed into place
        self._t0 = 0.0

    @property
    def so_path(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes()
                         + " ".join(self.flags).encode()).hexdigest()[:12]
        return BUILD_DIR / f"{self.source.stem}-{h}.so"

    def start_build(self):
        """Start nvcc unless the library is already built."""
        if self._lib is not None or self._proc is not None \
                or self.so_path.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self._tmp = self.so_path.with_suffix(f".{os.getpid()}.tmp")
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(
            [nvcc_path(), *self.flags, "-o", str(self._tmp),
             str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish_build(self):
        if self._proc is None:
            return
        out, err = self._proc.communicate()
        rc, self._proc = self._proc.returncode, None
        self.build_seconds = time.perf_counter() - self._t0
        self.ptxas_log = (out + err).strip()
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(rc {rc}):\n{self.ptxas_log}")
        os.replace(self._tmp, self.so_path)   # atomic under concurrent builds

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.start_build()
            self.finish_build()
            lib = ctypes.CDLL(str(self.so_path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, name: str, *args):
        """Call C function `name` (it launches the kernel on the stream
        passed among `args`), raise if the launch failed, count it."""
        rc = getattr(self.lib(), name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} ({self.source.name}) launch "
                               f"failed: cudaError {rc}")
        self.launches += 1


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def build_all(libs: Iterable[CudaLibrary]) -> float:
    """Build every library with one nvcc each, all started together;
    returns the wall seconds."""
    libs = list(libs)
    t0 = time.perf_counter()
    for lib in libs:
        lib.start_build()
    for lib in libs:
        lib.lib()
    return time.perf_counter() - t0


def all_libraries() -> list:
    from .fault import fused, hw_aware
    from .ops import pool_backward
    return [hw_aware.CROSSBAR_LIB, fused.FUSED_LIB,
            pool_backward.POOL_BWD_LIB]


def reset_launches():
    for lib in all_libraries():
        lib.launches = 0
