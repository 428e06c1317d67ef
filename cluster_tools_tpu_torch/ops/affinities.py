"""Affinity-map operators in plain PyTorch: label→affinity synthesis,
embedding distances, morphological dilation/erosion, gradients.

Port of ``cluster_tools_tpu/ops/affinities.py``, which replaces the
reference's affogato C++ calls (reference affinities/insert_affinities.py:16
``compute_affinities``, affinities/embedding_distances.py
``compute_embedding_distances``) with shift-and-compare programs: an
affinity channel for offset ``o`` compares the volume with itself rolled by
``o``.  Every function works on the tensors' device; a call of
``binary_dilation`` on a CUDA tensor adds one to its ``launches``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ._build import count_on_card

from .dt import sqrt_rn
from .filters import fma32


def _offset_valid(shape: Sequence[int], offset: Sequence[int], device) -> torch.Tensor:
    """Mask of voxels whose ``v + offset`` neighbor stays inside ``shape``."""
    ndim = len(shape)
    valid = torch.ones(tuple(shape), dtype=torch.bool, device=device)
    for ax, o in enumerate(offset):
        if o == 0:
            continue
        idx = torch.arange(shape[ax], device=device)
        ok = (idx < shape[ax] - o) if o > 0 else (idx >= -o)
        bshape = [1] * ndim
        bshape[ax] = shape[ax]
        valid = valid & ok.reshape(bshape)
    return valid


def _shifted(x: torch.Tensor, offset: Sequence[int], first: int = 0) -> torch.Tensor:
    """``x[v + offset]`` over the axes from ``first`` on, wrapping around
    (the wrapped voxels are the invalid ones)."""
    return torch.roll(x, shifts=[-int(o) for o in offset], dims=tuple(range(first, first + len(offset))))


def compact_labels(labels: np.ndarray) -> np.ndarray:
    """Labels wider than 32 bits → int64 ranks of their unique values
    (torch has no uint64 arithmetic); equality is all affinities need."""
    labels = np.asarray(labels)
    if labels.dtype.itemsize > 4 or labels.dtype == np.uint32:
        _, inv = np.unique(labels, return_inverse=True)
        return inv.reshape(labels.shape).astype(np.int64)
    return labels


def compute_affinities(labels, offsets, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affinities of a label volume: channel c is 1 where the labels at ``v``
    and ``v + offsets[c]`` agree (affogato convention: 1 = attractive), plus a
    validity mask (0 where the offset leaves the volume).  ``labels`` is a
    tensor or a host array (uint64 ids compacted on the host first, so ids
    colliding mod 2**32 stay apart); float32 affinities, bool masks."""
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(compact_labels(labels)).to(device or "cpu")
    affs, masks = [], []
    for off in offsets:
        valid = _offset_valid(labels.shape, off, labels.device)
        same = labels == _shifted(labels, off)
        affs.append(torch.where(valid, same.to(torch.float32), 0.0))
        masks.append(valid)
    return torch.stack(affs), torch.stack(masks)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the channel axis of ``a * b``, one fused multiply-add per
    channel in channel order (the JAX package's fused reduction on the CPU)."""
    acc = a[0] * b[0]
    for k in range(1, a.shape[0]):
        acc = fma32(a[k], b[k], acc)
    return acc


def embedding_distances(emb: torch.Tensor, offsets, norm: str = "l2") -> torch.Tensor:
    """Per-offset distances between embedding vectors (reference
    embedding_distances.py via affogato ``compute_embedding_distances``):
    emb [C, *spatial] → [len(offsets), *spatial], 0 where the offset leaves
    the volume."""
    emb = emb.to(torch.float32)
    out = []
    for off in offsets:
        shifted = _shifted(emb, off, first=1)
        if norm == "l2":
            diff = emb - shifted
            d = sqrt_rn(_dot(diff, diff) + 1e-12)
        elif norm == "cosine":
            num = _dot(emb, shifted)
            den = sqrt_rn(_dot(emb, emb)) * sqrt_rn(_dot(shifted, shifted))
            d = 1.0 - num / torch.clamp(den, min=1e-12)
        else:
            raise ValueError(f"unknown norm {norm!r}")
        out.append(torch.where(_offset_valid(emb.shape[1:], off, emb.device), d, 0.0))
    return torch.stack(out)


def _neighbor_or(x: torch.Tensor, axes: Sequence[int], fill: bool) -> torch.Tensor:
    """OR over the cross neighbourhood; ``fill`` is the out-of-volume value."""
    out = x
    for ax in axes:
        n = x.shape[ax]
        edge = torch.full_like(x.narrow(ax, 0, 1), fill)
        out = out | torch.cat([edge, x.narrow(ax, 0, n - 1)], dim=ax)
        out = out | torch.cat([x.narrow(ax, 1, n - 1), edge], dim=ax)
    return out


def binary_dilation(x: torch.Tensor, iterations: int, in_2d: bool = False) -> torch.Tensor:
    """Cross-structuring-element dilation iterated (scipy binary_dilation
    equivalent; ``in_2d`` restricts to the trailing two axes)."""
    count_on_card(binary_dilation, x)
    m = x.to(torch.bool)
    axes = list(range(m.dim()))[-2:] if in_2d else list(range(m.dim()))
    for _ in range(int(iterations)):
        m = _neighbor_or(m, axes, False)
    return m


def binary_erosion(x: torch.Tensor, iterations: int) -> torch.Tensor:
    """Cross-structuring-element erosion iterated (dilation of the
    complement; out-of-volume counts as background, scipy's border_value=0)."""
    inv = ~x.to(torch.bool)
    for _ in range(int(iterations)):
        inv = _neighbor_or(inv, list(range(inv.dim())), True)
    return ~inv


binary_dilation.launches = 0


def gradient_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over per-axis central-difference gradients (np.gradient average,
    reference gradients.py:131-140): ``(x[i+1] - x[i-1]) * 0.5`` inside,
    one-sided differences at the ends, summed in axis order."""
    x = x.to(torch.float32)
    acc = None
    for ax in range(x.dim()):
        n = x.shape[ax]
        sl = lambda a, b: x.narrow(ax, a, b - a)  # noqa: E731
        inner = (sl(2, n) - sl(0, n - 2)) * 0.5
        g = torch.cat([sl(1, 2) - sl(0, 1), inner, sl(n - 1, n) - sl(n - 2, n - 1)], dim=ax)
        acc = g if acc is None else acc + g
    # the sum times the float32 reciprocal of the axis count, as XLA's mean
    return acc * (1.0 / x.dim())
