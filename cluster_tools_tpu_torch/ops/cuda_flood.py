"""Kernel 1: the per-slice seeded flood, written in CUDA for Hopper.

Replaces ``cluster_tools_tpu/ops/pallas_flood.py::flood_slices``.  The
kernel (``csrc/flood.cuh``) floods each (H, W) slice of an (N, H, W) stack in
one thread block; ``flood_slices_plain`` computes the same function with
PyTorch ops, the JAX package's XLA fixpoint (``_seeded_watershed_scan`` with
``per_slice=True``) written as Jacobi neighbour relaxation.  Both reach the
unique fixpoint (see ``csrc/flood.cuh``), so labels are equal exactly.

``flood_slices`` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .cc import shift

BIG = 3.0e38
BIG_DIST = 2**31 - 2
_OFFSETS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def flood_slices_plain(hmap: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Flood every z-slice of ``hmap`` (N, H, W) from ``seeds`` (0 =
    unlabeled), restricted to ``mask``.  Returns int32 labels, 0 off mask."""
    hmap = hmap.to(torch.float32)
    mask = mask.bool()
    seeds = torch.where(mask, seeds.to(torch.int32), 0)
    is_seed = seeds > 0
    conduct = mask & ~is_seed
    big = torch.tensor(BIG, dtype=torch.float32, device=hmap.device)

    # phase 1: altitude A(p) = min(A(p), max(min_q A(q), h(p)))
    alt = torch.where(is_seed, hmap, big)
    while True:
        alt_m = torch.where(mask, alt, big)
        nb = torch.full_like(alt, BIG)
        for off in _OFFSETS:
            nb = torch.minimum(nb, shift(alt_m, off, BIG))
        new = torch.where(conduct, torch.minimum(alt, torch.maximum(nb, hmap)), alt)
        if torch.equal(new, alt):
            break
        alt = new

    # phase 2: (hops, label) over optimal-prefix edges, smaller label on ties
    alt_m = torch.where(mask, alt, big)
    dist = torch.where(is_seed, 0, BIG_DIST).to(torch.int64)
    label = seeds
    edges = [
        (off, conduct & (alt == torch.maximum(shift(alt_m, off, BIG), hmap)))
        for off in _OFFSETS
    ]
    from .watershed import minlex

    while True:
        best_d, best_l = dist, label
        lab_m = torch.where(mask, label, 0)
        for off, ok in edges:
            q_l = torch.where(ok, shift(lab_m, off, 0), 0)
            best_d, best_l = minlex(shift(dist, off, BIG_DIST) + 1, q_l, best_d, best_l)
        if torch.equal(best_d, dist) and torch.equal(best_l, label):
            break
        dist, label = best_d, best_l
    return torch.where(mask, label, 0).to(torch.int32)


def flood_slices(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    rounds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-slice seeded flood of an (N, H, W) stack: the CUDA kernel for
    CUDA tensors, ``flood_slices_plain`` for CPU tensors.  ``rounds`` (an
    int32 (N, 2) CUDA tensor) receives each slice's phase-1 and phase-2
    round counts."""
    if hmap.dim() != 3 or seeds.shape != hmap.shape or mask.shape != hmap.shape:
        raise ValueError(f"flood_slices takes three (N, H, W) tensors, got "
                         f"{tuple(hmap.shape)}, {tuple(seeds.shape)}, {tuple(mask.shape)}")
    if hmap.device.type == "cpu":
        return flood_slices_plain(hmap, seeds, mask)
    if hmap.device.type != "cuda":
        raise ValueError(f"flood_slices: unsupported device {hmap.device}")
    n, h, w = hmap.shape
    dev = hmap.device
    if n * h * w == 0:
        return torch.zeros((n, h, w), dtype=torch.int32, device=dev)
    hm = hmap.to(torch.float32).contiguous()
    sd = seeds.to(torch.int32).contiguous()
    mk = mask.to(torch.int32).contiguous()
    if sd.device != dev or mk.device != dev:
        raise ValueError("flood_slices: all tensors must be on one device")
    out = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    alt = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    dist = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    if rounds is not None and (rounds.shape != (n, 2) or rounds.dtype != torch.int32
                               or rounds.device != dev):
        raise ValueError("flood_slices: rounds must be an int32 (N, 2) tensor on the device")
    lib = _build.library("flood")
    fn = lib.ctt_flood_slices
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(
            _build.ptr(hm), _build.ptr(sd), _build.ptr(mk), _build.ptr(out),
            _build.ptr(alt), _build.ptr(dist), n, h, w,
            _build.ptr(rounds) if rounds is not None else None,
            _build.stream_handle(dev),
        )
    _build.check(rc, "ctt_flood_slices")
    flood_slices.launches += 1
    return out


flood_slices.launches = 0
