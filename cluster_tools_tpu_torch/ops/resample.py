"""Resampling for scale pyramids, in PyTorch on the given tensor's device
(port of ``cluster_tools_tpu/ops/resample.py``, where these are XLA
functions, not Pallas kernels).

  * ``nearest``      — order-0 strided subsample (a view);
  * ``mean``         — box mean: edge padding to a multiple of the factor,
                       the window summed voxel by voxel in row-major window
                       order from 0.0 (``lax.reduce_window``'s order), divided
                       by ``prod(sf)``;
  * ``interpolate``  — ``jax.image.resize(..., "linear")`` with its default
                       ``antialias=True``: per resized axis one weight matrix
                       by JAX's ``scale_and_translate`` rule (a triangle
                       kernel widened by ``max(1, in/out)``, half-pixel
                       centres, each output's taps renormalised, outputs whose
                       centre falls outside the input zeroed), applied axis
                       by axis in axis order, the order of JAX's einsum path.

``torch.nn.functional.interpolate`` antialiases only its 2d modes
(bilinear, bicubic), not the trilinear resize a 3d factor needs, and
computes its weights its own way; ``F.avg_pool3d`` agrees with ``mean``
only where the factors divide the shape.  So neither is used: the weight
matrices are built here, as JAX builds them, for parity with its outputs.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ._build import count_on_card

ScaleFactor = Union[int, Sequence[int]]

#: methods usable for dtypes that cannot be interpolated (integer labels)
ORDER0_METHODS = ("nearest",)
#: reference library names accepted as aliases
METHOD_ALIASES = {"vigra": "interpolate", "skimage": "mean"}
_F32_EPS = float(np.finfo(np.float32).eps)


def per_axis_factor(scale_factor: ScaleFactor, ndim: int) -> Tuple[int, ...]:
    if isinstance(scale_factor, (int, np.integer)):
        return (int(scale_factor),) * ndim
    sf = tuple(int(s) for s in scale_factor)
    if len(sf) != ndim:
        raise ValueError(f"scale factor {sf} does not match rank {ndim}")
    return sf


def downscale_shape(shape: Sequence[int], scale_factor: ScaleFactor) -> Tuple[int, ...]:
    """ceil(shape / factor) per axis (elf.util.downscale_shape semantics)."""
    sf = per_axis_factor(scale_factor, len(shape))
    return tuple(-(-s // f) for s, f in zip(shape, sf))


def _mean_pool(x: torch.Tensor, sf: Tuple[int, ...]) -> torch.Tensor:
    x = x.to(torch.float32)
    for ax, f in enumerate(sf):
        pad = (-x.shape[ax]) % f
        if pad:
            edge = x.narrow(ax, x.shape[ax] - 1, 1)
            x = torch.cat([x, edge.expand(*x.shape[:ax], pad, *x.shape[ax + 1:])], ax)
    acc = torch.zeros(tuple(s // f for s, f in zip(x.shape, sf)), dtype=torch.float32,
                      device=x.device)
    for offs in np.ndindex(*sf):
        acc = acc + x[tuple(slice(o, None, f) for o, f in zip(offs, sf))]
    return acc / float(np.prod(sf))


def weight_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) float32 weights of one axis resized from ``n_in`` to
    ``n_out`` voxels: ``jax.image.scale_and_translate``'s
    ``compute_weight_mat`` for the triangle kernel with antialiasing, as
    XLA computes it inside the jitted resize — the reciprocals folded in
    double and rounded once, ``(i + 0.5) * inv - 0.5`` and
    ``1 - d * (1 / kernel_scale)`` fused multiply-adds (a few edge columns
    of JAX's matrix still differ by up to 1.7e-6: ROADMAP Queue C)."""
    from .filters import fma32

    f32 = dict(dtype=torch.float32, device=device)
    scale = float(np.float32(n_out / n_in))
    inv_scale = float(np.float32(1.0 / scale))
    kernel_scale = max(inv_scale, 1.0)
    rcp_kernel = torch.tensor(float(np.float32(1.0 / kernel_scale)), **f32)
    centres = torch.arange(n_out, **f32) + 0.5
    sample_f = fma32(centres, torch.full_like(centres, inv_scale), torch.full_like(centres, -0.5))
    d = torch.abs(sample_f[None, :] - torch.arange(n_in, **f32)[:, None])
    weights = torch.clamp(fma32(-d, rcp_kernel.expand_as(d), torch.ones_like(d)), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _linear_resize(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, out_shape, "linear")``: axes whose size does
    not change are left alone, the others contracted with their weight
    matrix one after another in axis order."""
    x = x.to(torch.float32)
    for ax, n in enumerate(out_shape):
        m = x.shape[ax]
        if m == n:
            continue
        w = weight_matrix(m, int(n), x.device)
        x = torch.movedim(torch.tensordot(torch.movedim(x, ax, -1), w, dims=1), -1, ax)
    return x.contiguous()


def downscale(x: torch.Tensor, scale_factor: ScaleFactor, method: str = "interpolate") -> torch.Tensor:
    """Downsample to ``downscale_shape(x.shape, scale_factor)``."""
    method = METHOD_ALIASES.get(method, method)
    sf = per_axis_factor(scale_factor, x.dim())
    out_shape = downscale_shape(x.shape, sf)
    if method == "nearest":
        return x[tuple(slice(None, None, f) for f in sf)]
    if method == "mean":
        count_on_card(downscale, x)
        return _mean_pool(x, sf)
    if method == "interpolate":
        count_on_card(downscale, x)
        return _linear_resize(x, out_shape)
    raise ValueError(f"unknown downscaling method {method!r}")


downscale.launches = 0  # calls on a card (mean or interpolate; nearest is a view)


def _resize_nearest(x: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")``: output i of an axis reads input
    ``floor((i + 0.5) * m / n)``, computed in float32."""
    for ax, n in enumerate(out_shape):
        m = x.shape[ax]
        if m == n:
            continue
        pos = (torch.arange(int(n), dtype=torch.float32, device=x.device) + 0.5) * float(m)
        idx = torch.floor(pos / float(n)).to(torch.int64)
        x = torch.index_select(x, ax, idx)
    return x


def upscale(x: torch.Tensor, out_shape: Sequence[int], method: str = "interpolate") -> torch.Tensor:
    """Upsample to ``out_shape`` (reference upscaling.py sampler wrap)."""
    method = METHOD_ALIASES.get(method, method)
    if method not in ("nearest", "mean", "interpolate"):
        raise ValueError(f"unknown upscaling method {method!r}")
    out_shape = tuple(int(s) for s in out_shape)
    count_on_card(upscale, x)
    if method == "nearest":
        return _resize_nearest(x, out_shape)
    return _linear_resize(x, out_shape)  # mean pooling has no upscale analog


upscale.launches = 0  # calls on a card


def cast_resampled(out, dtype) -> np.ndarray:
    """Round (half to even) and clip float resampling results back to uint8
    or uint16 (reference downscaling.py:217-224); a host array."""
    dtype = np.dtype(dtype)
    if isinstance(out, torch.Tensor):
        if dtype in (np.dtype("uint8"), np.dtype("uint16")):
            out = torch.round(torch.clamp(out, 0, np.iinfo(dtype).max))
        return out.cpu().numpy().astype(dtype)
    out = np.asarray(out)
    if dtype in (np.dtype("uint8"), np.dtype("uint16")):
        out = np.round(np.clip(out, 0, np.iinfo(dtype).max))
    return out.astype(dtype)
