"""ctypes bindings for the native C++ solver library.

Port of ``cluster_tools_tpu/native/__init__.py`` over the port's own copy of
``solvers.cpp``.  The library is built with ``g++ -O3 -std=c++17 -shared
-fPIC`` at first use into ``build/native/`` at the repository root, named by
a digest of the source and the flags, so an unchanged source is built once
and no library is kept in the tree.  ``available()`` says whether it could
be built and loaded; ``load_error`` holds the compiler's or loader's message
when it could not, and callers of ``ops.multicut`` then take the pure-Python
solvers.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "solvers.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
load_error: Optional[str] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libctt_solvers-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    """Compile to a file unique to this process and thread, then move it
    into place, so concurrent first uses never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
            check=True, capture_output=True, text=True, timeout=300,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, load_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        out = library_path()
        try:
            if not os.path.exists(out):
                _build(out)
            try:
                lib = ctypes.CDLL(out)
            except OSError:
                # a library built by another toolchain (a copied build
                # directory): build it here once more
                _build(out)
                lib = ctypes.CDLL(out)
        except subprocess.CalledProcessError as e:
            load_error = f"g++ failed ({e.returncode}):\n{e.stderr}"
            return None
        except (OSError, subprocess.TimeoutExpired) as e:
            load_error = f"{type(e).__name__}: {e}"
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.gaec_multicut.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, f64p, i64p]
        lib.gaec_multicut.restype = None
        lib.agglomerative_clustering.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, f64p, ctypes.c_void_p,
            ctypes.c_double, i64p,
        ]
        lib.agglomerative_clustering.restype = None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.mutex_watershed.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, f64p, u8p, i64p]
        lib.mutex_watershed.restype = None
        lib.lifted_gaec.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, f64p, ctypes.c_int64, i64p, f64p, i64p,
        ]
        lib.lifted_gaec.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native solver library unavailable: {load_error}")
    return lib


def _edges(uv: np.ndarray, n_nodes: int) -> np.ndarray:
    uv = np.ascontiguousarray(uv, dtype=np.int64).reshape(-1, 2)
    if uv.size and (uv.min() < 0 or uv.max() >= n_nodes):
        raise ValueError(f"edge endpoints outside [0, {n_nodes})")
    return uv


def gaec_multicut(n_nodes: int, uv: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """Greedy additive edge contraction; returns a root per node."""
    lib = _require()
    uv = _edges(uv, n_nodes)
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    if costs.shape != (uv.shape[0],):
        raise ValueError(f"{costs.shape} costs for {uv.shape[0]} edges")
    labels = np.empty(n_nodes, dtype=np.int64)
    lib.gaec_multicut(n_nodes, uv.shape[0], uv.reshape(-1), costs, labels)
    return labels


def agglomerative_clustering(
    n_nodes: int,
    uv: np.ndarray,
    weights: np.ndarray,
    threshold: float,
    sizes: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Size-weighted mean agglomeration below ``threshold``; a root per node."""
    lib = _require()
    uv = _edges(uv, n_nodes)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    if weights.shape != (uv.shape[0],):
        raise ValueError(f"{weights.shape} weights for {uv.shape[0]} edges")
    labels = np.empty(n_nodes, dtype=np.int64)
    if sizes is None:
        sizes_ptr = None
    else:
        sizes = np.ascontiguousarray(sizes, dtype=np.float64)
        if sizes.shape != weights.shape:
            raise ValueError(f"{sizes.shape} sizes for {weights.shape[0]} edges")
        sizes_ptr = sizes.ctypes.data_as(ctypes.c_void_p)
    lib.agglomerative_clustering(
        n_nodes, uv.shape[0], uv.reshape(-1), weights, sizes_ptr,
        float(threshold), labels,
    )
    return labels


def lifted_gaec(
    n_nodes: int,
    uv: np.ndarray,
    costs: np.ndarray,
    lifted_uv: np.ndarray,
    lifted_costs: np.ndarray,
) -> np.ndarray:
    """Greedy additive edge contraction with lifted costs: clusters contract
    along local edges only, by the combined local + lifted cost; returns a
    root per node."""
    lib = _require()
    uv = _edges(uv, n_nodes)
    lifted_uv = _edges(lifted_uv, n_nodes)
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    lifted_costs = np.ascontiguousarray(lifted_costs, dtype=np.float64)
    if costs.shape != (uv.shape[0],) or lifted_costs.shape != (lifted_uv.shape[0],):
        raise ValueError(
            f"{costs.shape} costs for {uv.shape[0]} edges, {lifted_costs.shape} for "
            f"{lifted_uv.shape[0]} lifted edges"
        )
    labels = np.empty(n_nodes, dtype=np.int64)
    lib.lifted_gaec(
        n_nodes, uv.shape[0], uv.reshape(-1), costs,
        lifted_uv.shape[0], lifted_uv.reshape(-1), lifted_costs, labels,
    )
    return labels


def mutex_watershed(
    n_nodes: int, uv: np.ndarray, weights: np.ndarray, attractive: np.ndarray
) -> np.ndarray:
    """Kruskal with mutex constraints over edges by weight, descending
    (stable); attractive edges merge unless their clusters are mutexed,
    repulsive ones record a mutex.  Returns a root per node."""
    lib = _require()
    uv = _edges(uv, n_nodes)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    attractive = np.ascontiguousarray(attractive, dtype=np.uint8)
    if weights.shape != (uv.shape[0],) or attractive.shape != weights.shape:
        raise ValueError(
            f"{weights.shape} weights and {attractive.shape} flags for {uv.shape[0]} edges"
        )
    labels = np.empty(n_nodes, dtype=np.int64)
    lib.mutex_watershed(n_nodes, uv.shape[0], uv.reshape(-1), weights, attractive, labels)
    return labels
