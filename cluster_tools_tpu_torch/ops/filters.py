"""Separable image filters in plain PyTorch.

Port of ``cluster_tools_tpu/ops/filters.py``: the gaussian and its
derivatives, the filter bank of edge and region features (``FILTERS``,
``apply_filter``: gaussian smoothing, gradient magnitude, Laplacian of
gaussian, hessian eigenvalues), min/max window filters and normalisation.
Tensors carry leading batch axes where the JAX package used ``vmap``; a
filter works on the trailing ``ndim`` axes.  Arithmetic is pinned so that
the CUDA kernel of ``ops/cuda_dtws.py`` reproduces it bit for bit, and so
that a filter gives the same bits on the card as on the CPU:

  * taps are the float32 values of ``gauss_kernel`` (bit-identical to the
    JAX package's ``_gauss_kernel``, derivative orders 1 and 2 too);
  * a tap sum runs left to right as ``acc = fma(w_k, x_k, acc)``, one
    rounding per tap (``fma32``).  The JAX package on the CPU contracts its
    tap sums into fused multiply-adds too; with separately rounded products
    the smoothed distances of edge-replicated padding split plateau ties the
    JAX package keeps, and seeds differ;
  * the boundary is numpy's ``mode="symmetric"`` reflection for any radius,
    including radii larger than the axis (the reflection cycles).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ._build import count_on_card

Sigma = Union[float, Sequence[float]]


def gauss_kernel(sigma: float, truncate: float = 4.0, order: int = 0) -> np.ndarray:
    """Float32 taps of a gaussian (``order`` 0) or of its first or second
    derivative, radius ``max(int(truncate*sigma+0.5), 1)``, computed and
    normalized in float64 before the cast (the JAX package's recipe)."""
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    if order == 1:  # first derivative of the gaussian
        k = k * (-x / sigma**2)
    elif order == 2:
        k = k * ((x**2 / sigma**4) - 1.0 / sigma**2)
    elif order != 0:
        raise ValueError(f"unsupported derivative order {order}")
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
    """Correlation with ``taps`` along ``axis``, symmetric boundary, summed
    tap by tap from the left with one rounding per tap (a convolution is
    the correlation with the taps reversed)."""
    n = x.shape[axis]
    r = len(taps) // 2
    pos = torch.arange(n, device=x.device)
    acc = None
    for k, w in enumerate(taps):
        v = torch.index_select(x, axis, symmetric_index(pos + (k - r), n))
        wt = torch.tensor(w, dtype=torch.float32, device=x.device)
        acc = v * wt if acc is None else fma32(wt.expand_as(v), v, acc)
    return acc


def _trailing(x: torch.Tensor, value, ndim=None) -> tuple:
    """Per-axis values over the trailing axes: a scalar covers ``ndim``
    axes (all of them by default), a sequence its own length."""
    if np.isscalar(value):
        return (value,) * (x.dim() if ndim is None else ndim)
    return tuple(value)


def gaussian(x: torch.Tensor, sigma: Sigma, truncate: float = 4.0) -> torch.Tensor:
    """Gaussian smoothing; ``sigma`` scalar or per trailing axis (0 skips an
    axis, e.g. ``(0, 2, 2)`` smooths each z-slice of a (..., Z, H, W) stack)."""
    x = x.to(torch.float32)
    sigmas = _trailing(x, sigma)
    first = x.dim() - len(sigmas)
    for i, s in enumerate(sigmas):
        if s and s > 0:
            x = conv_axis(x, gauss_kernel(float(s), truncate), first + i)
    return x


def _window_filter(x: torch.Tensor, size, reduce) -> torch.Tensor:
    out = x
    sizes = _trailing(x, size)
    first = x.dim() - len(sizes)
    for i, s in enumerate(sizes):
        axis = first + i
        n = x.shape[axis]
        pos = torch.arange(n, device=x.device)
        lo = s // 2
        res = None
        for d in range(s):
            v = torch.index_select(out, axis, symmetric_index(pos + d - lo, n))
            res = v if res is None else reduce(res, v)
        out = res
    return out


def maximum_filter(x: torch.Tensor, size: Union[int, Sequence[int]]) -> torch.Tensor:
    """Moving-window maximum over the trailing ``len(size)`` axes (every
    axis for an int), symmetric boundary — for any window that is the
    maximum over the window clipped to the volume."""
    return _window_filter(x, size, torch.maximum)


def minimum_filter(x: torch.Tensor, size: Union[int, Sequence[int]]) -> torch.Tensor:
    """Moving-window minimum (scipy.ndimage.minimum_filter equivalent —
    reference masking/minfilter.py:110-119), as ``maximum_filter``."""
    count_on_card(minimum_filter, x)
    return _window_filter(x, size, torch.minimum)


minimum_filter.launches = 0  # calls on a card


def normalize(x: torch.Tensor, dims: Optional[Sequence[int]] = None, eps: float = 1e-6) -> torch.Tensor:
    """Min-max normalize to [0, 1] over ``dims`` (every axis by default):
    ``(x-lo)/max(hi-lo, eps)``."""
    x = x.to(torch.float32)
    dims = tuple(range(x.dim())) if dims is None else tuple(dims)
    lo = torch.amin(x, dim=dims, keepdim=True)
    hi = torch.amax(x, dim=dims, keepdim=True)
    den = torch.maximum(
        hi - lo, torch.tensor(eps, dtype=torch.float32, device=x.device)
    )
    return (x - lo) / den


def normalize_input(x: torch.Tensor) -> torch.Tensor:
    """uint8/uint16 inputs → [0,1] floats by dtype range; floats pass through
    min-max normalize (reference ``cast_type`` semantics in volume_utils)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    if x.dtype == torch.uint16:
        return x.to(torch.float32) / 65535.0
    return normalize(x)


def _separable(x: torch.Tensor, sigma: float, orders: Sequence[int], truncate: float = 4.0):
    """Convolve the trailing ``len(orders)`` axes in turn with the gaussian
    derivative of the given order (the JAX package's ``_conv_along_axis``,
    a convolution: the taps reversed)."""
    first = x.dim() - len(orders)
    for i, order in enumerate(orders):
        x = conv_axis(x, gauss_kernel(float(sigma), truncate, order)[::-1], first + i)
    return x


def gaussian_derivative(
    x: torch.Tensor, sigma: float, axis: int = 0, truncate: float = 4.0, ndim=None
) -> torch.Tensor:
    """Gaussian derivative along trailing spatial ``axis`` (of ``ndim``,
    all axes by default), plain smoothing along the others."""
    x = x.to(torch.float32)
    nd = x.dim() if ndim is None else ndim
    return _separable(x, sigma, [1 if ax == axis else 0 for ax in range(nd)], truncate)


def gradient_magnitude(x: torch.Tensor, sigma: float, ndim=None) -> torch.Tensor:
    """Gaussian gradient magnitude (vigra.gaussianGradientMagnitude
    equivalent); the squares summed in axis order, the square root
    correctly rounded (``dt.sqrt_rn``)."""
    from .dt import sqrt_rn

    nd = x.dim() if ndim is None else ndim
    acc = None
    for ax in range(nd):
        g = gaussian_derivative(x, sigma, axis=ax, ndim=nd)
        acc = g * g if acc is None else acc + g * g
    return sqrt_rn(acc)


def laplacian_of_gaussian(x: torch.Tensor, sigma: float, ndim=None) -> torch.Tensor:
    """Sum of unmixed second gaussian derivatives, in axis order."""
    x = x.to(torch.float32)
    nd = x.dim() if ndim is None else ndim
    out = torch.zeros_like(x)
    for ax in range(nd):
        out = out + _separable(x, sigma, [2 if a == ax else 0 for a in range(nd)])
    return out


# matrices per ``torch.linalg.eigvalsh`` call on the card: cuSOLVER's batched
# symmetric solver (``cusolverDnXsyevBatched``) refuses 32,768 and more 3 x 3
# matrices (CUSOLVER_STATUS_INVALID_VALUE; NVIDIA H100) and takes 16,384
EIGVALSH_CHUNK = 1 << 14

# PyTorch loads its CUDA linear-algebra library at the first linalg call on
# a card, through a wrapper that raises ("lazy wrapper should be called at
# most once") when two threads make that first call at once — as the
# threaded block tasks do.  The first call on the card is made under a lock.
_LINALG_LOCK = threading.Lock()
_linalg_loaded = False


def _load_cuda_linalg(device: torch.device) -> None:
    global _linalg_loaded
    with _LINALG_LOCK:
        if not _linalg_loaded:
            torch.linalg.eigvalsh(torch.eye(2, device=device)[None])
            _linalg_loaded = True


def eigenvalues_descending(h: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.eigvalsh`` of a batch of symmetric matrices (..., n, n),
    flipped to descending order, in chunks of ``EIGVALSH_CHUNK`` matrices
    (each matrix is solved on its own, so the chunks change no value)."""
    n = h.shape[-1]
    flat = h.reshape((-1, n, n))
    if flat.is_cuda and not _linalg_loaded:
        _load_cuda_linalg(flat.device)
    eig = torch.empty(flat.shape[:-1], dtype=h.dtype, device=h.device)
    for i in range(0, flat.shape[0], EIGVALSH_CHUNK):
        eig[i:i + EIGVALSH_CHUNK] = torch.linalg.eigvalsh(flat[i:i + EIGVALSH_CHUNK])
    return eig.reshape(h.shape[:-1]).flip(-1)


def hessian_of_gaussian_eigenvalues(x: torch.Tensor, sigma: float, ndim=None) -> torch.Tensor:
    """Eigenvalues of the gaussian hessian, sorted descending; channels
    last: ``torch.linalg.eigvalsh`` of one symmetric ``ndim`` × ``ndim``
    matrix per voxel (``eigenvalues_descending``), as the JAX package's
    ``jnp.linalg.eigvalsh``."""
    x = x.to(torch.float32)
    nd = x.dim() if ndim is None else ndim
    hess = [[None] * nd for _ in range(nd)]
    for i in range(nd):
        for j in range(i, nd):
            orders = [(1 if ax == i else 0) + (1 if ax == j else 0) for ax in range(nd)]
            hess[i][j] = hess[j][i] = _separable(x, sigma, orders)
    h = torch.stack([torch.stack(row, dim=-1) for row in hess], dim=-2)
    return eigenvalues_descending(h)


def _gaussian_filter(x: torch.Tensor, sigma, ndim=None) -> torch.Tensor:
    return gaussian(x, _trailing(x, sigma, ndim))


# name → callable(x, sigma, ndim), mirroring the reference's filter-name
# config strings
FILTERS = {
    "gaussianSmoothing": _gaussian_filter,
    "gaussianGradientMagnitude": gradient_magnitude,
    "laplacianOfGaussian": laplacian_of_gaussian,
    "hessianOfGaussianEigenvalues": hessian_of_gaussian_eigenvalues,
}


def apply_filter(x: torch.Tensor, filter_name: str, sigma, apply_in_2d: bool = False) -> torch.Tensor:
    """Filter dispatch by name (reference volume_utils.py:80-94) over every
    axis of ``x``, or with ``apply_in_2d`` over all but the first (each
    z-slice on its own).  The hessian's eigenvalues come channels last.  A
    call on a CUDA tensor adds one to ``apply_filter.launches``."""
    count_on_card(apply_filter, x)
    return FILTERS[filter_name](x, sigma, ndim=x.dim() - 1 if apply_in_2d else x.dim())


apply_filter.launches = 0


def filter_channels(filter_name: str, ndim: int = 3, apply_in_2d: bool = False) -> int:
    """Response channels of a named filter (hessian eigenvalues are
    per-dimension, channels-last in apply_filter's output)."""
    if filter_name == "hessianOfGaussianEigenvalues":
        return 2 if apply_in_2d else ndim
    return 1
