"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` on its own into a shared
library with a plain C interface (no PyTorch headers: a build takes seconds),
for ``sm_90a`` with ``--fmad=false`` (the kernels' float arithmetic must
match the plain PyTorch versions bit for bit).  Libraries go to
``build/kernels/`` at the repository root, named by a digest of their sources
and flags, so an unchanged kernel is built once.  ``build_all`` starts one
``nvcc`` per source, all at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_OPS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_OPS), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_OPS)), "build", "kernels")
SOURCES = ("flood", "dtws")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``'s,
    else the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")) and (fn.endswith(".cuh") or fn == name + ".cu"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source started
    together.  Returns seconds per source built (empty when all exist);
    raises with the compiler's output on failure.  ``-Xptxas -v`` register
    and spill reports go to ``build/kernels/<name>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        cmd = [nvcc(), *NVCC_FLAGS, "-o", out + ".tmp",
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), out)
    seconds = {}
    errors = []
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(out + ".tmp", out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError`` code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
