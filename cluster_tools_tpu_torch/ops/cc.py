"""Connected components in plain PyTorch.

Port of the parts of ``cluster_tools_tpu/ops/cc.py`` the per-block watershed
uses: per-slice 8-connected labeling of the seed maxima (connectivity 3 with
``per_slice``), the partition CC of the halo re-close
(``connected_components_labels``) and the consecutive ranking of flat-index
roots.  Every component is identified by the minimal flat index of its
voxels inside its block, then numbered 1..n in that order — the JAX
package's numbering, whatever the propagation schedule.

Inputs carry a leading batch axis of independent blocks: (B, Z, H, W).
The algorithm is min-label propagation over the neighborhood plus pointer
jumping (``lab[p] <- lab[lab[p]]``), iterated to its fixpoint.
"""

from __future__ import annotations

from itertools import product
from typing import List, Optional, Tuple

import numpy as np
import torch


def neighbor_offsets(connectivity: int, per_slice: bool = False) -> List[Tuple[int, ...]]:
    """3d offsets with 1 ≤ #nonzero ≤ connectivity; ``per_slice`` keeps the
    in-plane ones only (each z-slice an independent domain)."""
    offs = [
        o for o in product((-1, 0, 1), repeat=3)
        if 0 < sum(c != 0 for c in o) <= connectivity
    ]
    if per_slice:
        offs = [o for o in offs if o[0] == 0]
    return offs


def shift(x: torch.Tensor, offset, fill) -> torch.Tensor:
    """``out[..., p] = x[..., p + offset]`` over the trailing len(offset)
    axes, ``fill`` where ``p + offset`` leaves the volume."""
    out = torch.full_like(x, fill)
    first = x.dim() - len(offset)
    src, dst = [slice(None)] * x.dim(), [slice(None)] * x.dim()
    for i, o in enumerate(offset):
        n = x.shape[first + i]
        if abs(o) >= n:
            return out
        if o > 0:
            src[first + i], dst[first + i] = slice(o, None), slice(0, n - o)
        elif o < 0:
            src[first + i], dst[first + i] = slice(0, n + o), slice(-o, None)
    out[tuple(dst)] = x[tuple(src)]
    return out


def connected_components_raw(
    mask: torch.Tensor,
    connectivity: int = 1,
    partition: Optional[torch.Tensor] = None,
    per_slice: bool = False,
) -> torch.Tensor:
    """(B, Z, H, W) mask → int64 minimal block-flat index of each voxel's
    component, -1 on background.  With ``partition``, neighbors connect only
    where their partition values are equal."""
    mask = mask.bool()
    b = mask.shape[0]
    size = int(np.prod(mask.shape[1:]))
    total = b * size
    big = total
    flat = torch.arange(total, device=mask.device, dtype=torch.int64).view(mask.shape)
    lab = torch.where(mask, flat, torch.full_like(flat, big))
    links = []
    for off in neighbor_offsets(connectivity, per_slice):
        ok = mask & shift(mask, off, False)
        if partition is not None:
            ok = ok & (shift(partition, off, 0) == partition)
        links.append((off, ok))
    while True:
        new = lab
        for off, ok in links:
            nb = shift(lab, off, big)
            new = torch.minimum(new, torch.where(ok, nb, big))
        # pointer jumping: every label is the flat index of a voxel of the
        # same component whose own label is not larger
        jumped = torch.cat([new.reshape(-1), torch.full((1,), big, device=mask.device, dtype=torch.int64)])
        new = torch.minimum(new, jumped[new.reshape(-1)].view(new.shape))
        if torch.equal(new, lab):
            break
        lab = new
    block0 = (torch.arange(b, device=mask.device, dtype=torch.int64) * size).view(
        (b,) + (1,) * (mask.dim() - 1)
    )
    return torch.where(mask, lab - block0, torch.full_like(lab, -1))


def rank_of_flat_roots(flat: torch.Tensor, size: int):
    """Per block (rows of ``flat``, shape (B, size)): ``rank[b, i]`` is the
    1-based consecutive id of the root at flat index i (valid where a root
    exists), and ``n[b]`` the root count."""
    is_root = flat == torch.arange(size, device=flat.device, dtype=flat.dtype)
    rank = torch.cumsum(is_root.to(torch.int64), dim=1)
    n = rank[:, -1] if size > 0 else torch.zeros(flat.shape[0], dtype=torch.int64)
    return rank, n


def consecutive_from_flat_roots(flat: torch.Tensor, size: int):
    """Rank flat-index roots (B, size) into consecutive ids 1..n per block,
    background (negative entries) 0.  Returns (int32 labels, n per block)."""
    rank, n = rank_of_flat_roots(flat, size)
    safe = torch.clamp(flat, 0, max(size - 1, 0))
    labels = torch.where(flat >= 0, torch.gather(rank, 1, safe), torch.zeros_like(rank))
    return labels.to(torch.int32), n


def connected_components(
    mask: torch.Tensor,
    connectivity: int = 1,
    partition: Optional[torch.Tensor] = None,
    per_slice: bool = False,
):
    """Consecutive labeling of a (B, Z, H, W) batch: background 0,
    components 1..n per block in minimal-flat-index order.  Returns
    ``(int32 labels, n per block)``."""
    raw = connected_components_raw(mask, connectivity, partition, per_slice)
    b = mask.shape[0]
    size = int(np.prod(mask.shape[1:]))
    labels, n = consecutive_from_flat_roots(raw.view(b, size), size)
    return labels.view(mask.shape), n


def connected_components_labels(
    labels: torch.Tensor, connectivity: int = 1, per_slice: bool = False
):
    """Split a label batch into its connected pieces (CC within equal
    labels, background 0)."""
    return connected_components(
        labels > 0, connectivity, partition=labels, per_slice=per_slice
    )


def serpentine_mask(shape) -> np.ndarray:
    """One corridor snaking through every other row, turning at alternating
    ends: graph diameter Θ(H·W), a bend every band — the worst case for
    propagation schedules.  3d shapes repeat it in every z-slice."""
    h, w = int(shape[-2]), int(shape[-1])
    m2 = np.zeros((h, w), dtype=bool)
    m2[::2, :] = True
    for i, r in enumerate(range(1, h, 2)):
        m2[r, w - 1 if i % 2 == 0 else 0] = True
    if len(shape) == 2:
        return m2
    return np.broadcast_to(m2, tuple(shape)).copy()
