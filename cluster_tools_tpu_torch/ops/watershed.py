"""Seeded watershed and seed detection in PyTorch — the per-block 2d
DT-watershed.

Port of the parts of ``cluster_tools_tpu/ops/watershed.py`` the production
configuration runs (``apply_dt_2d=True, apply_ws_2d=True``): every z-slice
goes threshold → 2d EDT → smoothed-maxima seeds → height map → seeded flood,
then a block-wide size filter re-floods the voxels of small segments.

The flood is the unique fixpoint of the lexicographic path cost
(pass height, hops, seed label), ties to the smaller label (``minlex``), so
any schedule gives the same labels; the port runs it in the CUDA kernels of
``cuda_flood`` and ``cuda_dtws`` on the card and in their plain PyTorch
versions on the CPU.  Tensors carry a leading batch axis of blocks
(B, Z, H, W) where the JAX package used ``vmap``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .cc import connected_components
from .cuda_flood import flood_slices
from .filters import fma32, gaussian, maximum_filter, normalize


def minlex(d1, l1, d2, l2):
    """Min over (dist, label) in lexicographic order where label 0 is +inf."""
    take1 = (l1 > 0) & ((l2 == 0) | (d1 < d2) | ((d1 == d2) & (l1 < l2)))
    return torch.where(take1, d1, d2), torch.where(take1, l1, l2)


def hmap_weights(alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``alpha`` and ``1 - alpha`` (the difference taken in float64,
    then rounded — as the JAX package's traced Python constant is)."""
    return (
        torch.tensor(alpha, dtype=torch.float32),
        torch.tensor(1.0 - alpha, dtype=torch.float32),
    )


def local_maxima(dt: torch.Tensor, sigma: float) -> torch.Tensor:
    """Per-slice plateau maxima of the smoothed distances, where dt > 0."""
    sm = gaussian(dt, (0.0, 0.0, sigma, sigma)) if sigma and sigma > 0 else dt
    return (maximum_filter(sm, (3, 3)) == sm) & (dt > 0)


def dt_seeds(dt: torch.Tensor, sigma: float = 2.0):
    """Seeds from a (B, Z, H, W) distance transform, per slice: smooth →
    3×3 plateau maxima → 8-connected CC → consecutive ids per block in
    minimal-flat-index order.  Returns ``(int32 seeds, n per block)``."""
    return connected_components(local_maxima(dt, sigma), connectivity=3, per_slice=True)


def make_hmap(x: torch.Tensor, dt: torch.Tensor, alpha: float, sigma: float = 0.0) -> torch.Tensor:
    """Height map ``alpha·x + (1-alpha)·(1 - normalize(dt))`` with the
    distances normalized and the result smoothed within each z-slice; the
    blend is ``fma(alpha, x, (1-alpha)·(1-dtn))``, the JAX package's
    contraction of it on the CPU."""
    a, b = (w.to(x.device) for w in hmap_weights(alpha))
    dtn = normalize(dt, dims=(-2, -1))
    hmap = fma32(a.expand_as(x), x, b * (1 - dtn))
    if sigma and sigma > 0:
        hmap = gaussian(hmap, (0.0, 0.0, sigma, sigma))
    return hmap


def seeded_watershed(hmap: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-slice flood of a (..., H, W) stack from ``seeds`` (0 = unlabeled)
    over ``hmap``, restricted to ``mask`` (connectivity 1, to the fixpoint):
    kernel 1 on the card, its plain version on the CPU."""
    shape = hmap.shape
    h, w = shape[-2:]
    out = flood_slices(
        hmap.reshape(-1, h, w), seeds.reshape(-1, h, w), mask.reshape(-1, h, w)
    )
    return out.view(shape)


def apply_size_filter(
    labels: torch.Tensor,
    hmap: torch.Tensor,
    size_filter: int,
    num_segments: int,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Per block of a (B, Z, H, W) batch: zero the segments with fewer than
    ``size_filter`` voxels and re-flood the freed voxels from the survivors.
    ``num_segments`` bounds the label values (exclusive)."""
    b = labels.shape[0]
    flat = labels.reshape(b, -1).to(torch.int64)
    base = (torch.arange(b, device=labels.device) * num_segments)[:, None]
    counts = torch.bincount((flat + base).reshape(-1), minlength=b * num_segments)
    counts = counts[: b * num_segments].view(b, num_segments)
    too_small = torch.gather(counts, 1, torch.clamp(flat, max=num_segments - 1)) < size_filter
    kept = torch.where(too_small, 0, flat).view(labels.shape).to(torch.int32)
    return seeded_watershed(hmap, kept, mask)


def dt_watershed(
    input_: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    threshold: float = 0.25,
    apply_dt_2d: bool = True,
    apply_ws_2d: bool = True,
    pixel_pitch=None,
    sigma_seeds: float = 2.0,
    sigma_weights: float = 2.0,
    alpha: float = 0.8,
    size_filter: int = 25,
    invert_input: bool = False,
    non_maximum_suppression: bool = False,
    valid: Optional[torch.Tensor] = None,
):
    """The full per-block DT-watershed of a (Z, H, W) block or a (B, Z, H, W)
    batch of blocks, on the tensor's device.  Returns ``(int32 labels,
    n_seeds)`` (n_seeds per block for a batch).

    Only the production 2d mode is ported; the 3d distance transform, pixel
    pitch and non-maximum suppression raise."""
    from .cuda_dtws import dt_watershed_slices

    if not (apply_dt_2d and apply_ws_2d):
        raise NotImplementedError(
            "3d DT-watershed mode is not ported yet (ROADMAP Queue A 5)"
        )
    if pixel_pitch is not None or non_maximum_suppression:
        raise NotImplementedError(
            "pixel_pitch / non_maximum_suppression are not ported yet (ROADMAP Queue A 5)"
        )
    single = input_.dim() == 3
    x = input_[None] if single else input_
    m = None if mask is None else (mask[None] if single else mask)
    v = None if valid is None else (valid[None] if single else valid)
    labels, n = dt_watershed_slices(
        x, m, v, threshold=threshold, sigma_seeds=sigma_seeds,
        sigma_weights=sigma_weights, alpha=alpha, size_filter=size_filter,
        invert_input=invert_input,
    )
    if single:
        return labels[0], n[0]
    return labels, n


def num_segments_of(block_shape) -> int:
    """Exclusive bound of the seed ids of one block (the JAX package's
    ``prod(shape)//2 + 2``)."""
    return int(np.prod(block_shape)) // 2 + 2
