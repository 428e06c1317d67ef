"""Separable image filters in plain PyTorch.

Port of ``cluster_tools_tpu/ops/filters.py`` — the parts the per-block
DT-watershed needs.  Tensors carry a leading batch axis where the JAX package
used ``vmap``.  Arithmetic is pinned so that the CUDA kernel of
``ops/cuda_dtws.py`` reproduces it bit for bit:

  * taps are the float32 values of ``gauss_kernel`` (bit-identical to the
    JAX package's ``_gauss_kernel``);
  * a tap sum runs left to right as ``acc = fma(w_k, x_k, acc)``, one
    rounding per tap (``fma32``).  The JAX package on the CPU contracts its
    tap sums into fused multiply-adds too; with separately rounded products
    the smoothed distances of edge-replicated padding split plateau ties the
    JAX package keeps, and seeds differ;
  * the boundary is numpy's ``mode="symmetric"`` reflection for any radius,
    including radii larger than the axis (the reflection cycles).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

Sigma = Union[float, Sequence[float]]


def gauss_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Float32 gaussian taps of radius ``max(int(truncate*sigma+0.5), 1)``,
    normalized in float64 before the cast (the JAX package's recipe)."""
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a*b + c`` (what CUDA's ``__fmaf_rn``
    computes): the product is exact in float64, the sum's rounding error is
    recovered exactly (two-sum) and folded in by rounding to odd, so the
    final rounding to float32 is the only one that counts."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    inf = torch.full_like(s, float("inf"))
    s = torch.where(fix, torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


def symmetric_index(q: torch.Tensor, n: int) -> torch.Tensor:
    """Source index of padded position ``q`` under numpy's ``symmetric``
    padding of an axis of length ``n`` (edge sample repeated, period 2n)."""
    q = torch.remainder(q, 2 * n)
    return torch.where(q >= n, 2 * n - 1 - q, q)


def conv_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlation with symmetric ``taps`` along ``axis``, symmetric boundary,
    summed tap by tap from the left with one rounding per tap."""
    n = x.shape[axis]
    r = len(taps) // 2
    pos = torch.arange(n, device=x.device)
    acc = None
    for k, w in enumerate(taps):
        v = torch.index_select(x, axis, symmetric_index(pos + (k - r), n))
        wt = torch.tensor(w, dtype=torch.float32, device=x.device)
        acc = v * wt if acc is None else fma32(wt.expand_as(v), v, acc)
    return acc


def gaussian(x: torch.Tensor, sigma: Sigma, truncate: float = 4.0) -> torch.Tensor:
    """Gaussian smoothing; ``sigma`` scalar or per trailing axis (0 skips an
    axis, e.g. ``(0, 2, 2)`` smooths each z-slice of a (..., Z, H, W) stack)."""
    x = x.to(torch.float32)
    nd = x.dim() if np.isscalar(sigma) else len(sigma)
    sigmas = (sigma,) * nd if np.isscalar(sigma) else tuple(sigma)
    first = x.dim() - nd
    for i, s in enumerate(sigmas):
        if s and s > 0:
            x = conv_axis(x, gauss_kernel(float(s), truncate), first + i)
    return x


def maximum_filter(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Moving-window maximum over the trailing ``len(size)`` axes, symmetric
    boundary (for a window of 3 that is edge replication)."""
    out = x
    first = x.dim() - len(size)
    for i, s in enumerate(size):
        axis = first + i
        n = x.shape[axis]
        pos = torch.arange(n, device=x.device)
        lo = s // 2
        res = None
        for d in range(s):
            v = torch.index_select(out, axis, symmetric_index(pos + d - lo, n))
            res = v if res is None else torch.maximum(res, v)
        out = res
    return out


def normalize(x: torch.Tensor, dims: Sequence[int], eps: float = 1e-6) -> torch.Tensor:
    """Min-max normalize to [0, 1] over ``dims``: ``(x-lo)/max(hi-lo, eps)``."""
    x = x.to(torch.float32)
    lo = torch.amin(x, dim=tuple(dims), keepdim=True)
    hi = torch.amax(x, dim=tuple(dims), keepdim=True)
    den = torch.maximum(
        hi - lo, torch.tensor(eps, dtype=torch.float32, device=x.device)
    )
    return (x - lo) / den
