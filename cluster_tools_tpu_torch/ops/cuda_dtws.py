"""Kernel 2: the whole per-slice DT-watershed, written in CUDA for Hopper.

Replaces ``cluster_tools_tpu/ops/pallas_dtws.py::dtws_slices`` and its host
wrapper ``pallas_dt_watershed``.  ``dtws_slices`` runs threshold → 2d EDT →
smoothed-maxima seeds (8-connected CC) → height map → flood for every z-slice
of a (B, Z, H, W) batch of blocks in one launch (``csrc/dtws.cuh``);
``dtws_slices_plain`` is the same function in PyTorch ops, following the
JAX package's XLA path.  ``dt_watershed_slices`` is the host wrapper: it
ranks the seed roots per block and runs the size filter, whose re-flood is
kernel 1 (``cuda_flood``).

Numbering is per block: seed roots are block-flat indices (z*H + row)*W + col
with z the slice within its block, ranked per block; the size filter's
segment bound is ``prod(block)//2 + 2`` per block.

Float arithmetic is pinned (taps summed left to right with one fused
multiply-add each, the height-map blend one fused multiply-add, every other
operation rounded on its own, ``1 - alpha`` rounded from float64), so the
kernel and the plain version agree bit for bit.  The JAX XLA path sums its
gaussian taps in its convolution library's order, so its height map differs
from the port's in the last bits (a few 1e-7); labels agree (see ROADMAP
Queue C for the near-ties of padded blocks).

``dtws_slices`` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .cc import connected_components_raw, rank_of_flat_roots
from .dt import distance_transform_2d_stack
from .filters import gauss_kernel
from .cuda_flood import flood_slices_plain
from .watershed import (
    apply_size_filter,
    hmap_weights,
    local_maxima,
    make_hmap,
    num_segments_of,
)


def _inputs(x, threshold, invert):
    x = x.to(torch.float32)
    if invert:
        x = 1.0 - x
    return x, x < torch.tensor(threshold, dtype=torch.float32, device=x.device)


def dtws_slices_plain(
    x: torch.Tensor,
    mask: torch.Tensor,
    valid: torch.Tensor,
    threshold: float = 0.5,
    sigma_seeds: float = 2.0,
    sigma_weights: float = 2.0,
    alpha: float = 0.8,
    invert: bool = False,
):
    """Plain PyTorch version of kernel 2 on a (B, Z, H, W) batch.  Returns
    ``(labels, roots, hmap)``: labels are block-flat seed roots + 1 (0 off the
    flood mask), roots the maxima CC roots (-1 off the maxima)."""
    b, z, h, w = x.shape
    x, below = _inputs(x, threshold, invert)
    fg = below & mask.bool()
    dt = distance_transform_2d_stack(fg)
    lm = local_maxima(dt, sigma_seeds)
    raw = connected_components_raw(lm, connectivity=3, per_slice=True)
    roots = torch.where(lm, raw, -1).to(torch.int32)
    seed_ids = torch.where(lm, raw + 1, 0)
    hmap = make_hmap(x, dt, alpha, sigma_weights)
    labels = flood_slices_plain(
        hmap.view(-1, h, w), seed_ids.view(-1, h, w), (fg & valid.bool()).view(-1, h, w)
    ).view(b, z, h, w)
    return labels, roots, hmap


_TAPS = {}


def _taps(sigma: float, device) -> Optional[torch.Tensor]:
    if not sigma or sigma <= 0:
        return None
    key = (float(sigma), str(device))
    if key not in _TAPS:
        _TAPS[key] = torch.from_numpy(gauss_kernel(float(sigma))).to(device)
    return _TAPS[key]


def dtws_slices(
    x: torch.Tensor,
    mask: torch.Tensor,
    valid: torch.Tensor,
    threshold: float = 0.5,
    sigma_seeds: float = 2.0,
    sigma_weights: float = 2.0,
    alpha: float = 0.8,
    invert: bool = False,
    rounds: Optional[torch.Tensor] = None,
):
    """Kernel 2 over a (B, Z, H, W) batch of blocks (the plain version for
    CPU tensors).  ``rounds`` (int32 (B*Z, 3) CUDA tensor) receives each
    slice's CC, flood-altitude and flood-assignment round counts."""
    if x.dim() != 4 or mask.shape != x.shape or valid.shape != x.shape:
        raise ValueError(f"dtws_slices takes three (B, Z, H, W) tensors, got "
                         f"{tuple(x.shape)}, {tuple(mask.shape)}, {tuple(valid.shape)}")
    if x.device.type == "cpu":
        return dtws_slices_plain(
            x, mask, valid, threshold, sigma_seeds, sigma_weights, alpha, invert
        )
    if x.device.type != "cuda":
        raise ValueError(f"dtws_slices: unsupported device {x.device}")
    b, z, h, w = x.shape
    dev = x.device
    if z * h * w >= 2**31 - 2:
        raise ValueError("dtws_slices: a block must hold fewer than 2**31 - 2 voxels")
    n = b * z
    xs = x.to(torch.float32).contiguous()
    ms = mask.to(torch.int32).contiguous()
    vs = valid.to(torch.int32).contiguous()
    if ms.device != dev or vs.device != dev:
        raise ValueError("dtws_slices: all tensors must be on one device")
    labels = torch.empty((b, z, h, w), dtype=torch.int32, device=dev)
    roots = torch.empty_like(labels)
    hmap = torch.empty((b, z, h, w), dtype=torch.float32, device=dev)
    if n == 0:
        return labels, roots, hmap
    dt = torch.empty_like(hmap)
    tmp = torch.empty_like(hmap)
    alt = torch.empty_like(hmap)
    dist = torch.empty_like(labels)
    flags = torch.empty((b, z, h, w), dtype=torch.uint8, device=dev)
    if rounds is not None and (rounds.shape != (n, 3) or rounds.dtype != torch.int32
                               or rounds.device != dev):
        raise ValueError("dtws_slices: rounds must be an int32 (B*Z, 3) tensor on the device")
    st, wt = _taps(sigma_seeds, dev), _taps(sigma_weights, dev)
    a, c = hmap_weights(alpha)
    lib = _build.library("dtws")
    fn = lib.ctt_dtws_slices
    fn.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(
            _build.ptr(xs), _build.ptr(ms), _build.ptr(vs), _build.ptr(labels),
            _build.ptr(roots), _build.ptr(hmap), _build.ptr(dt), _build.ptr(tmp),
            _build.ptr(alt), _build.ptr(dist), _build.ptr(flags),
            n, z, h, w,
            float(torch.tensor(threshold, dtype=torch.float32)), float(a), float(c),
            int(bool(invert)),
            _build.ptr(st) if st is not None else None, 0 if st is None else st.numel(),
            _build.ptr(wt) if wt is not None else None, 0 if wt is None else wt.numel(),
            _build.ptr(rounds) if rounds is not None else None,
            _build.stream_handle(dev),
        )
    _build.check(rc, "ctt_dtws_slices")
    dtws_slices.launches += 1
    return labels, roots, hmap


dtws_slices.launches = 0


def dt_watershed_slices(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    threshold: float = 0.5,
    sigma_seeds: float = 2.0,
    sigma_weights: float = 2.0,
    alpha: float = 0.8,
    size_filter: int = 25,
    invert_input: bool = False,
):
    """Host wrapper of kernel 2 on a (B, Z, H, W) batch: fused kernel, seeds
    ranked per block in minimal-flat-index order, then the size filter
    (kernel 1 re-flood).  Returns ``(int32 labels, n_seeds per block)``."""
    b, z, h, w = x.shape
    size = z * h * w
    ones = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    mask = ones if mask is None else mask.bool()
    valid = ones if valid is None else valid.bool()
    labels_flat, roots, hmap = dtws_slices(
        x, mask, valid, threshold=threshold, sigma_seeds=sigma_seeds,
        sigma_weights=sigma_weights, alpha=alpha, invert=invert_input,
    )
    rank, n_seeds = rank_of_flat_roots(roots.view(b, size).to(torch.int64), size)
    lf = labels_flat.view(b, size).to(torch.int64)
    labels = torch.where(
        lf > 0, torch.gather(rank, 1, torch.clamp(lf - 1, 0, size - 1)), 0
    ).to(torch.int32).view(x.shape)
    if size_filter > 0:
        _, below = _inputs(x, threshold, invert_input)
        labels = apply_size_filter(
            labels, hmap, size_filter, num_segments_of((z, h, w)),
            mask=below & mask & valid,
        )
    return labels, n_seeds
