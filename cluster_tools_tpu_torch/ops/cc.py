"""Connected components in plain PyTorch, and the merges behind kernels 4-5.

Port of the parts of ``cluster_tools_tpu/ops/cc.py`` the ported workflows
use: per-slice 8-connected labeling of the seed maxima (connectivity 3 with
``per_slice``), the partition CC of the halo re-close
(``connected_components_labels``), the consecutive ranking of flat-index
roots, and the volume CC of thresholded components.  Every component is
identified by the minimal flat index of its voxels inside its block, then
numbered 1..n in that order — the JAX package's numbering, whatever the
propagation schedule.

Inputs carry a leading batch axis of independent blocks: (B, Z, H, W).
The plain algorithm is min-label propagation over the neighborhood plus
pointer jumping (``lab[p] <- lab[lab[p]]``), iterated to its fixpoint.
``connected_components`` routes a connectivity-1 volume CC with no
``partition`` and not ``per_slice`` as the JAX package does in its Pallas
mode: per-slice labels from kernel 4 (``cuda_cc.cc_slices``) fused along z
by ``merge_slice_labels`` when a slice fits ``WHOLE_SLICE_MAX``, else
per-tile labels from kernel 5 (``cuda_cc.cc_tiles``) fused over every tile
face by ``merge_tiled_labels``.
"""

from __future__ import annotations

import os
import warnings
from itertools import product
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def neighbor_offsets(connectivity: int, per_slice: bool = False, ndim: int = 3) -> List[Tuple[int, ...]]:
    """Offsets of ``ndim`` axes (3d by default, 2d for detector frames) with
    1 ≤ #nonzero ≤ connectivity; ``per_slice`` keeps those that do not
    cross axis 0 (each z-slice an independent domain)."""
    offs = [
        o for o in product((-1, 0, 1), repeat=ndim)
        if 0 < sum(c != 0 for c in o) <= connectivity
    ]
    if per_slice:
        offs = [o for o in offs if o[0] == 0]
    return offs


def _canonical_offsets(ndim: int, connectivity: int, per_slice: bool) -> List[Tuple[int, ...]]:
    """The lexicographically positive half of the neighbourhood: each
    unordered adjacency {p, p + o} under exactly one offset o."""
    return [o for o in neighbor_offsets(connectivity, per_slice, ndim)
            if [c for c in o if c != 0][0] > 0]


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


def parse_tile_spec(spec, ndim: int) -> Optional[Tuple[int, ...]]:
    """Parse a tile spec ("8,64,64", or a single int for a cube) into an
    ``ndim`` tile tuple: a longer spec keeps its trailing entries, a shorter
    one is left-padded with its first entry.  Invalid specs give None."""
    try:
        parts = [int(p) for p in str(spec).split(",") if p.strip() != ""]
    except (TypeError, ValueError):
        return None
    if not parts or any(p < 1 for p in parts):
        return None
    if len(parts) == 1:
        parts = parts * ndim
    if len(parts) >= ndim:
        return tuple(parts[-ndim:])
    return tuple([parts[0]] * (ndim - len(parts)) + parts)


CC_TILE_ENV = "CTT_CC_TILE"


def default_coarse_tile(ndim: int) -> Tuple[int, ...]:
    """The JAX package's built-in tile: 64 along the two trailing axes, 8
    along every leading one."""
    if ndim <= 2:
        return (64,) * ndim
    return (8,) * (ndim - 2) + (64, 64)


def resolve_coarse_tile(shape, coarse_tile=None) -> Tuple[int, ...]:
    """Tile precedence: an explicit ``coarse_tile`` (int = cube, sequence =
    per axis), then the ``CTT_CC_TILE`` environment variable read at call
    time (an invalid value warns), then ``default_coarse_tile`` — clipped
    per axis to ``shape``."""
    ndim = len(shape)
    if coarse_tile is None:
        pin = os.environ.get(CC_TILE_ENV)
        tile = parse_tile_spec(pin, ndim) if pin is not None else None
        if pin is not None and tile is None:
            warnings.warn(f"invalid {CC_TILE_ENV}={pin!r}; using the default tile",
                          RuntimeWarning, stacklevel=2)
        if tile is None:
            tile = default_coarse_tile(ndim)
    elif isinstance(coarse_tile, (int, np.integer)):
        tile = (int(coarse_tile),) * ndim
    else:
        tile = tuple(int(t) for t in coarse_tile)
        if len(tile) != ndim:
            raise ValueError(f"coarse_tile {coarse_tile!r} does not match ndim {ndim}")
    return tuple(max(1, min(int(t), int(s))) for t, s in zip(tile, shape))


def _tile_grid(shape, tile) -> Tuple[int, ...]:
    return tuple(-(-int(s) // int(t)) for s, t in zip(shape, tile))


def tile_stack(x: torch.Tensor, tile, fill) -> torch.Tensor:
    """Pad ``x`` at the end of every axis to tile multiples with ``fill`` and
    reshape to ``(n_tiles, *tile)``, the tiles in row-major grid order."""
    shape = tuple(x.shape)
    grid = _tile_grid(shape, tile)
    padded = tuple(g * int(t) for g, t in zip(grid, tile))
    if padded != shape:
        out = torch.full(padded, fill, dtype=x.dtype, device=x.device)
        out[tuple(slice(0, s) for s in shape)] = x
        x = out
    ndim = len(shape)
    x = x.reshape(tuple(v for g, t in zip(grid, tile) for v in (g, int(t))))
    perm = tuple(2 * i for i in range(ndim)) + tuple(2 * i + 1 for i in range(ndim))
    return x.permute(perm).reshape((-1,) + tuple(int(t) for t in tile))


def tile_unstack(xt: torch.Tensor, shape, tile, crop: bool = True) -> torch.Tensor:
    """Inverse of ``tile_stack``; ``crop=False`` keeps the padded extent."""
    grid = _tile_grid(shape, tile)
    ndim = len(shape)
    x = xt.reshape(tuple(grid) + tuple(int(t) for t in tile))
    perm = tuple(v for pair in zip(range(ndim), range(ndim, 2 * ndim)) for v in pair)
    x = x.permute(perm).reshape(tuple(g * int(t) for g, t in zip(grid, tile)))
    if crop:
        x = x[tuple(slice(0, int(s)) for s in shape)]
    return x


def tile_crossing_take(arrs, off, tile, grid):
    """For one canonical offset ``off``: the flattened voxel slabs (the last
    plane of every tile along each axis the offset crosses, or the first for
    a negative component) of every tensor in ``arrs``, one tuple per
    crossing axis — the JAX package's static slot order."""
    out = []
    for ax, o_a in enumerate(off):
        if o_a == 0 or grid[ax] == 1:
            continue
        t_a = int(tile[ax])
        idx = torch.arange(t_a - 1 if o_a > 0 else 0, int(arrs[0].shape[ax]), t_a,
                           device=arrs[0].device)
        out.append(tuple(torch.index_select(a, ax, idx).reshape(-1) for a in arrs))
    return out


def _block_offsets(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(B, 1, 1, 1) first batch-flat index of each block, and the block size."""
    b = mask.shape[0]
    size = int(np.prod(mask.shape[1:]))
    block0 = torch.arange(b, device=mask.device, dtype=torch.int64) * size
    return block0.view((b,) + (1,) * (mask.dim() - 1)), size


def _rank_batch(mask: torch.Tensor, glob: torch.Tensor, block0: torch.Tensor, size: int):
    """Batch-flat roots (−1 background) → consecutive labels per block."""
    b = mask.shape[0]
    flat = torch.where(mask, glob - block0, -1)
    labels, n = consecutive_from_flat_roots(flat.reshape(b, size), size)
    return labels.view(mask.shape), n


def _tile_face_pairs(L: torch.Tensor, tile: Sequence[int]):
    """Connectivity-1 equivalences across the tile faces of a (B, Z, H, W)
    label batch ``L`` (−1 background; ``tile`` over (Z, H, W)): the values
    on both sides of every face adjacency where both are foreground, as
    ``(a, b)``, or None when no axis has more than one tile.  Faces never
    cross from one block to the next."""
    grid = _tile_grid(L.shape[1:], tile)
    a_parts, b_parts = [], []
    for ax, (g, t) in enumerate(zip(grid, tile)):
        if g == 1:
            continue
        idx = torch.arange(int(t) - 1, L.shape[ax + 1] - 1, int(t), device=L.device)
        lo = torch.index_select(L, ax + 1, idx)
        hi = torch.index_select(L, ax + 1, idx + 1)
        ok = (lo >= 0) & (hi >= 0)
        a_parts.append(lo[ok])
        b_parts.append(hi[ok])
    if not a_parts:
        return None
    return torch.cat(a_parts), torch.cat(b_parts)


def merge_tiled_labels(mask: torch.Tensor, glabels: torch.Tensor, tile: Sequence[int]):
    """Consecutive volume CC of a (B, Z, H, W) batch from tile-local minimal
    block-flat labels (−1 background, ``tile`` over (Z, H, W)): resolve the
    tile-face equivalences with the compact value union-find, then rank per
    block.  Returns ``(int32 labels, n per block)``; the labels do not
    depend on the tile."""
    from .unionfind import apply_value_roots, merge_value_table

    mask = mask.bool()
    block0, size = _block_offsets(mask)
    L = torch.where(glabels >= 0, glabels.to(torch.int64) + block0, -1)
    pairs = _tile_face_pairs(L, tile)
    if pairs is not None:
        vals, root_vals = merge_value_table(*pairs)
        L = apply_value_roots(L, vals, root_vals)
    return _rank_batch(mask, L, block0, size)


def merge_slice_labels(mask: torch.Tensor, sliced: torch.Tensor):
    """Consecutive volume CC of a (B, Z, H, W) batch from per-slice minimal
    block-flat labels (−1 background): one pointer-jumping union-find over
    the z-face equivalences inside each block, then ranking per block.
    Valid for connectivity 1 only."""
    from .unionfind import merge_labels_device

    mask = mask.bool()
    block0, size = _block_offsets(mask)
    glob = torch.where(sliced >= 0, sliced.to(torch.int64) + block0, -1)
    up, dn = glob[:, :-1].reshape(-1), glob[:, 1:].reshape(-1)
    both = (up >= 0) & (dn >= 0)
    parent = torch.arange(mask.numel(), device=mask.device, dtype=torch.int64)
    roots = merge_labels_device(parent, torch.stack([up[both], dn[both]], dim=1))
    return _rank_batch(mask, roots[glob.clamp(min=0)], block0, size)


def connected_components(
    mask: torch.Tensor,
    connectivity: int = 1,
    partition: Optional[torch.Tensor] = None,
    per_slice: bool = False,
):
    """Consecutive labeling of a (B, Z, H, W) batch: background 0,
    components 1..n per block in minimal-flat-index order.  Returns
    ``(int32 labels, n per block)``.  A connectivity-1 volume CC with no
    ``partition`` goes through kernel 4 or 5 and its merge (see the module
    docstring); every other call is plain propagation."""
    if partition is None and connectivity == 1 and not per_slice and mask.dim() == 4:
        from .cuda_cc import WHOLE_SLICE_MAX, cc_slices, cc_tiles, default_tile

        mask = mask.bool()
        b, z, h, w = mask.shape
        stack = mask.reshape(b * z, h, w)
        if h * w <= WHOLE_SLICE_MAX:
            return merge_slice_labels(mask, cc_slices(stack, depth=z).view(mask.shape))
        tile = default_tile(h, w)
        return merge_tiled_labels(
            mask, cc_tiles(stack, tile, depth=z).view(mask.shape), (1,) + tile
        )
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


def serpentine_mask(shape, pitch: int = 2) -> np.ndarray:
    """One corridor snaking through every ``pitch``-th row, joined by
    ``pitch - 1`` cells at alternating ends: graph diameter Θ(H·W / pitch),
    a bend every band — the worst case for propagation schedules (with
    pitch 8, a connector crosses every band border of kernels 1-2's
    cluster route; transposed, every run crosses them all).  3d shapes
    repeat it in every z-slice."""
    h, w = int(shape[-2]), int(shape[-1])
    m2 = np.zeros((h, w), dtype=bool)
    m2[::pitch, :] = True
    for i, r in enumerate(range(pitch - 1, h, pitch)):
        m2[r - pitch + 2:r + 1, w - 1 if i % 2 == 0 else 0] = True
    if len(shape) == 2:
        return m2
    return np.broadcast_to(m2, tuple(shape)).copy()
