"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into ``build/kernels``
at the root of the checkout (listed in ``.gitignore``). The library's file
name carries a hash of its source and flags, so an edited source builds
anew. :func:`build` starts one ``nvcc`` per missing library, all at once.
Nothing here runs at import time; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("grouped_gemm", "flash_fwd")

# loaded libraries, by source name (ctypes handles stay valid for the process)
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the libraries not yet built, one ``nvcc`` each, in parallel.
    Returns the wall seconds of each compile it ran; the compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) goes next to each
    library as ``<lib>.log``."""
    names = list(names or SOURCES)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List = []
    t0 = time.perf_counter()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    secs: Dict[str, float] = {}
    errors = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {p.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Load (building if needed) ``csrc/<name>.cu``'s library and declare
    each entry point's argument types; every entry returns the
    ``cudaError_t`` of its launch as an int."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {rc}")
