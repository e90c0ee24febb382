"""Building and loading the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into a shared library with a plain C
interface (`-gencode arch=compute_90a,code=sm_90a`, no fast-math), which
ctypes loads; pointers and the stream pass as `c_void_p`. The build
runs at first use, into build/torch_kernels/ of the checkout, under a
name that hashes the source and flags, so an edited source never loads
a stale library (the hash covers csrc/*.cuh, the headers the sources
share). Loading a library also loads its kernels into the CUDA context
(each source exports `rram_<stem>_load_module`), which CUDA's lazy
loading would otherwise do at each kernel's first launch. `build_all`
starts one nvcc per source at once. Launches are counted per exported C
function, so two kernels that share a source keep their own counts.
One lock guards every build, load and count, so a runner built on
another thread (`parallel.GroupPrefetcher`) never starts nvcc or loads
a library twice.

Nothing here runs at import: the CPU tests import every module on a
host with no nvcc and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


# this process's nvcc accounting (the observe `setup` record's compile
# fields): seconds in nvcc, builds run, libraries loaded
_BUILDS = {"seconds": 0.0, "builds": 0, "loaded": 0}
_LOCK = threading.RLock()


def compile_seconds() -> float:
    """Seconds of the nvcc builds this process ran, summed over the
    builds (builds started together overlap)."""
    return _BUILDS["seconds"]


def builds() -> int:
    """Kernel libraries this process has built with nvcc."""
    return _BUILDS["builds"]


def loaded() -> int:
    """Kernel libraries this process has loaded (built or found)."""
    return _BUILDS["loaded"]


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
    count of each exported C function (`counts`; `launches` is their
    sum). `functions` maps each exported C function to its ctypes
    argtypes (every function returns cudaGetLastError())."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC / source
        self.functions = dict(functions)
        self.flags = ARCH_FLAGS + BASE_FLAGS
        self.counts = dict.fromkeys(self.functions, 0)
        # launches by the tag a wrapper passes (kernel B1: its mode)
        self.tagged: Dict[str, int] = {}
        self.build_seconds: Optional[float] = None
        self.load_seconds: Optional[float] = None   # CDLL + module load
        self.ptxas_log = ""
        self._lib = None
        self._proc = None          # nvcc while a build runs
        self._tmp = None           # its output, renamed into place
        self._t0 = 0.0

    @property
    def launches(self) -> int:
        return sum(self.counts.values())

    def reset(self):
        self.counts = dict.fromkeys(self.functions, 0)
        self.tagged = {}

    @property
    def so_path(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    def start_build(self):
        """Start nvcc unless the library is already built."""
        with _LOCK:
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
        _BUILDS["seconds"] += self.build_seconds
        _BUILDS["builds"] += 1
        self.ptxas_log = (out + err).strip()
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(rc {rc}):\n{self.ptxas_log}")
        os.replace(self._tmp, self.so_path)   # atomic under concurrent builds

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if need be; its kernels are
        loaded into the current CUDA context with it."""
        if self._lib is not None:
            return self._lib
        with _LOCK:
            if self._lib is None:
                self.start_build()
                self.finish_build()
                t0 = time.perf_counter()
                lib = ctypes.CDLL(str(self.so_path))
                for name, argtypes in self.functions.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                load = getattr(lib, f"rram_{self.source.stem}_load_module")
                load.restype = ctypes.c_int
                rc = load()
                if rc != 0:
                    raise RuntimeError(f"loading {self.source.name}'s "
                                       f"kernels failed: cudaError {rc}")
                self.load_seconds = time.perf_counter() - t0
                self._lib = lib
                _BUILDS["loaded"] += 1
        return self._lib

    def call(self, name: str, *args, tag: Optional[str] = None):
        """Call C function `name` (it launches the kernel on the stream
        passed among `args`), raise if the launch failed, count it (and
        under `tag` in `tagged`)."""
        rc = getattr(self.lib(), name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} ({self.source.name}) launch "
                               f"failed: cudaError {rc}")
        with _LOCK:
            self.counts[name] += 1
            if tag is not None:
                self.tagged[tag] = self.tagged.get(tag, 0) + 1


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
        lib.reset()
