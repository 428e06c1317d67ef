"""Euclidean distance transforms in plain PyTorch: per slice (2d) and per
block (3d, with a pixel pitch).

Port of ``cluster_tools_tpu/ops/dt.py``: exact 1d line distances along the
first axis, squared, then the min-plus parabola reduction
``g'(i) = min_j g(j) + (pitch·(i-j))²`` along each further axis
(``parabola_pass``), evaluated densely in j-tiles.  With a pitch of 1 the
squared distances are integers held exactly in float32; a line without
background saturates at ``BIG`` (1e10) before the square, as in the JAX
package, so the result is the same bit pattern whatever the evaluation
order.  With another pitch the port rounds as the JAX package does on the
CPU: line distances are sums of the pitch carried along the line, and each
parabola cost is one fused multiply-add ``fma(d, d, g)`` of the scaled
difference ``d``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .filters import fma32

BIG = 1e10


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root.  PyTorch's vectorized CPU kernel is an
    approximation that misses the nearest float on some inputs, so CPU
    tensors go through numpy's (IEEE) ``sqrt``; on the card ``torch.sqrt``
    is the IEEE square root."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


def line_scan_distance(bg: torch.Tensor, axis: int, pitch: float = 1.0) -> torch.Tensor:
    """Exact distance (in ``pitch`` units) to the nearest True of ``bg``
    along ``axis``, ``BIG`` where the line holds no True: carried along the
    line as the running sum ``d + pitch`` from ``BIG`` (the JAX package's
    sequential scan on the CPU, so that every pitch rounds alike)."""
    b = bg.movedim(axis, 0)
    p = torch.tensor(pitch, dtype=torch.float32, device=bg.device)
    zero = torch.zeros((), dtype=torch.float32, device=bg.device)

    def directional(lines):
        out = torch.empty(lines.shape, dtype=torch.float32, device=bg.device)
        carry = torch.full(lines.shape[1:], BIG, dtype=torch.float32, device=bg.device)
        for k in range(lines.shape[0]):
            carry = torch.where(lines[k], zero, carry + p)
            out[k] = carry
        return out

    d = torch.minimum(directional(b), directional(b.flip(0)).flip(0))
    return d.movedim(0, axis)


def _exact_squares(n: int, pitch: float) -> bool:
    """Whether every ``(pitch·(i-j))²`` of an axis of length ``n`` is an
    integer held exactly in float32 (then a plain sum rounds as the FMA)."""
    return float(pitch).is_integer() and (n - 1) * abs(pitch) < 4096


def parabola_pass(g: torch.Tensor, pitch: float = 1.0, tile: int = 32) -> torch.Tensor:
    """``min(BIG, min_j g[..., j] + (pitch·(i-j))²)`` along the last axis."""
    n = g.shape[-1]
    exact = _exact_squares(n, pitch)
    if not exact:
        tile = min(tile, 8)  # the fused multiply-add works in float64
    p = torch.tensor(pitch, dtype=torch.float32, device=g.device)
    i_idx = torch.arange(n, device=g.device, dtype=torch.float32)
    out = torch.full_like(g, BIG)
    for j0 in range(0, n, tile):
        j1 = min(j0 + tile, n)
        j_idx = torch.arange(j0, j1, device=g.device, dtype=torch.float32)
        diff = i_idx[:, None] - j_idx[None, :]
        if pitch != 1.0:
            diff = diff * p
        src = g[..., None, j0:j1]
        if exact:
            cost = src + diff * diff
        else:
            src = src.expand(g.shape[:-1] + diff.shape)
            d = diff.expand_as(src)
            cost = fma32(d, d, src)
        out = torch.minimum(out, cost.amin(dim=-1))
    return out


def parabola_pass_axis(g: torch.Tensor, axis: int, pitch: float = 1.0) -> torch.Tensor:
    """``parabola_pass`` along ``axis``."""
    return parabola_pass(g.movedim(axis, -1), pitch).movedim(-1, axis)


def distance_transform(fg: torch.Tensor, pixel_pitch: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Distance of each True voxel to the nearest False voxel over the three
    trailing axes of a (..., Z, H, W) tensor, ``pixel_pitch`` per axis."""
    pitch = (1.0, 1.0, 1.0) if pixel_pitch is None else tuple(float(p) for p in pixel_pitch)
    if len(pitch) != 3:
        raise ValueError(f"pixel_pitch must have 3 entries, got {pixel_pitch!r}")
    nd = fg.dim()
    d = line_scan_distance(~fg.bool(), nd - 3, pitch[0])
    g = d * d
    for axis in (nd - 2, nd - 1):
        g = parabola_pass_axis(g, axis, pitch[axis - nd + 3])
    return sqrt_rn(torch.clamp(g, max=BIG))


def distance_transform_2d_stack(fg: torch.Tensor) -> torch.Tensor:
    """Distance of each True voxel to the nearest False voxel within its
    z-slice, for a (..., H, W) stack."""
    d = line_scan_distance(~fg.bool(), fg.dim() - 2)
    g = parabola_pass(d * d)
    return sqrt_rn(torch.clamp(g, max=BIG))
