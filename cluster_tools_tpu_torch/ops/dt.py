"""Per-slice 2d Euclidean distance transform in plain PyTorch.

Port of ``cluster_tools_tpu/ops/dt.py::distance_transform_2d_stack``: exact
1d line distances along H (``line_scan_distance``), squared, then the
min-plus parabola reduction ``g'(i) = min_j g(j) + (i-j)²`` along W
(``parabola_pass``), evaluated densely in j-tiles.  Squared distances are
integers held exactly in float32; a column without background saturates at
``BIG`` (1e10) before the square, as in the JAX package, so the result is the
same bit pattern whatever the evaluation order.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e10


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  PyTorch's vectorized CPU kernel is an
    approximation that misses the nearest float on some inputs, so CPU
    tensors go through numpy's (IEEE) ``sqrt``; on the card ``torch.sqrt``
    is the IEEE square root."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


def line_scan_distance(bg: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact distance (in samples) to the nearest True of ``bg`` along
    ``axis``, ``BIG`` where the line holds no True."""
    n = bg.shape[axis]
    shape = [1] * bg.dim()
    shape[axis] = n
    iota = torch.arange(n, device=bg.device, dtype=torch.float32).view(shape)
    neg = torch.tensor(-3.0e38, dtype=torch.float32, device=bg.device)
    last = torch.cummax(torch.where(bg, iota, neg), dim=axis).values
    fwd = torch.clamp(iota - last, max=BIG)
    riota = (n - 1) - iota
    rlast = torch.flip(
        torch.cummax(torch.flip(torch.where(bg, riota, neg), [axis]), dim=axis).values,
        [axis],
    )
    bwd = torch.clamp(riota - rlast, max=BIG)
    return torch.minimum(fwd, bwd)


def parabola_pass(g: torch.Tensor, tile: int = 32) -> torch.Tensor:
    """``min(BIG, min_j g[..., j] + (i-j)²)`` along the last axis."""
    n = g.shape[-1]
    i_idx = torch.arange(n, device=g.device, dtype=torch.float32)
    out = torch.full_like(g, BIG)
    for j0 in range(0, n, tile):
        j1 = min(j0 + tile, n)
        j_idx = torch.arange(j0, j1, device=g.device, dtype=torch.float32)
        diff = i_idx[:, None] - j_idx[None, :]
        cost = g[..., None, j0:j1] + diff * diff
        out = torch.minimum(out, cost.amin(dim=-1))
    return out


def distance_transform_2d_stack(fg: torch.Tensor) -> torch.Tensor:
    """Distance of each True voxel to the nearest False voxel within its
    z-slice, for a (..., H, W) stack."""
    d = line_scan_distance(~fg.bool(), fg.dim() - 2)
    g = parabola_pass(d * d)
    return sqrt_rn(torch.clamp(g, max=BIG))
