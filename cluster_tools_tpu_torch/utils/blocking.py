"""Block decomposition geometry: blocks, halos, faces, checkerboard colorings.

Pure host-side Python/numpy: a copy of ``cluster_tools_tpu/utils/blocking.py``
(the port imports nothing of the JAX package).  Both packages must agree on this
geometry exactly — identical block ids and bounding boxes give identical label
offsets, which is what makes their outputs byte-comparable.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from itertools import product
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

Coord = Tuple[int, ...]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Block:
    """Half-open bounding box ``[begin, end)`` of one block."""

    begin: Coord
    end: Coord

    @property
    def shape(self) -> Coord:
        return tuple(e - b for b, e in zip(self.begin, self.end))

    @property
    def slicing(self) -> Tuple[slice, ...]:
        return tuple(slice(b, e) for b, e in zip(self.begin, self.end))


@dataclass(frozen=True)
class BlockWithHalo:
    """A block enlarged by a halo.

    ``outer``        — the halo'd box, clipped to the volume,
    ``inner``        — the original block,
    ``inner_local``  — ``inner`` in coordinates relative to ``outer``.

    Mirrors the outer/inner/innerLocal triple of the reference
    (cluster_tools/watershed/watershed.py:253-265).
    """

    outer: Block
    inner: Block
    inner_local: Block


class Blocking:
    """Regular grid decomposition of an nd volume into blocks.

    Blocks are indexed C-order over the grid; the last block along each axis may be
    smaller than ``block_shape``.
    """

    def __init__(self, shape: Sequence[int], block_shape: Sequence[int]):
        if len(shape) != len(block_shape):
            raise ValueError(f"rank mismatch: {shape} vs {block_shape}")
        if any(bs <= 0 for bs in block_shape):
            raise ValueError(f"invalid block shape {block_shape}")
        self.shape = tuple(int(s) for s in shape)
        self.block_shape = tuple(int(b) for b in block_shape)
        self.grid_shape = tuple(
            _ceil_div(s, b) for s, b in zip(self.shape, self.block_shape)
        )
        self.n_blocks = int(np.prod(self.grid_shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # -- id <-> grid position ------------------------------------------------

    def block_grid_position(self, block_id: int) -> Coord:
        if not 0 <= block_id < self.n_blocks:
            raise ValueError(f"block id {block_id} out of range [0, {self.n_blocks})")
        return tuple(int(c) for c in np.unravel_index(block_id, self.grid_shape))

    def block_id_from_grid_position(self, pos: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(pos), self.grid_shape))

    # -- geometry ------------------------------------------------------------

    def block(self, block_id: int) -> Block:
        pos = self.block_grid_position(block_id)
        begin = tuple(p * b for p, b in zip(pos, self.block_shape))
        end = tuple(
            min(p * b + b, s) for p, b, s in zip(pos, self.block_shape, self.shape)
        )
        return Block(begin, end)

    def block_with_halo(self, block_id: int, halo: Sequence[int]) -> BlockWithHalo:
        inner = self.block(block_id)
        outer_begin = tuple(max(b - h, 0) for b, h in zip(inner.begin, halo))
        outer_end = tuple(min(e + h, s) for e, h, s in zip(inner.end, halo, self.shape))
        outer = Block(outer_begin, outer_end)
        local = Block(
            tuple(ib - ob for ib, ob in zip(inner.begin, outer_begin)),
            tuple(ie - ob for ie, ob in zip(inner.end, outer_begin)),
        )
        return BlockWithHalo(outer, inner, local)

    def neighbor_id(self, block_id: int, axis: int, lower: bool) -> Optional[int]:
        """Grid neighbor along ``axis`` (``lower=True`` → towards index 0), or None."""
        pos = list(self.block_grid_position(block_id))
        pos[axis] += -1 if lower else 1
        if not 0 <= pos[axis] < self.grid_shape[axis]:
            return None
        return self.block_id_from_grid_position(pos)

    def blocks_overlapping_roi(
        self, roi_begin: Sequence[int], roi_end: Sequence[int]
    ) -> List[int]:
        lo = tuple(rb // bs for rb, bs in zip(roi_begin, self.block_shape))
        hi = tuple(
            min(_ceil_div(re, bs), gs)
            for re, bs, gs in zip(roi_end, self.block_shape, self.grid_shape)
        )
        ids = [
            self.block_id_from_grid_position(pos)
            for pos in product(*[range(l, h) for l, h in zip(lo, hi)])
        ]
        return sorted(ids)

    # -- faces ---------------------------------------------------------------

    def face(
        self, block_id: int, axis: int, halo: int = 1
    ) -> Optional[Tuple[int, Block]]:
        """The face between ``block_id`` and its *upper* neighbor along ``axis``.

        Returns ``(neighbor_id, face_bb)`` where ``face_bb`` spans
        ``halo`` voxels on each side of the block boundary (global coordinates),
        or None at the volume border.  Mirrors reference ``get_face``
        (volume_utils.py:187-216).
        """
        ngb = self.neighbor_id(block_id, axis, lower=False)
        if ngb is None:
            return None
        this = self.block(block_id)
        other = self.block(ngb)
        begin = list(max(tb, ob) for tb, ob in zip(this.begin, other.begin))
        end = list(min(te, oe) for te, oe in zip(this.end, other.end))
        boundary = this.end[axis]
        begin[axis] = boundary - halo
        end[axis] = boundary + halo
        return ngb, Block(tuple(begin), tuple(end))

    def iterate_faces(
        self, block_id: int, halo: int = 1
    ) -> Iterator[Tuple[int, int, Block]]:
        """Yield ``(axis, neighbor_id, face_bb)`` for all upper faces of a block."""
        for axis in range(self.ndim):
            got = self.face(block_id, axis, halo)
            if got is not None:
                ngb, bb = got
                yield axis, ngb, bb


# -- module level helpers (the reference's volume_utils surface) ----------------


def block_to_bb(block: Block) -> Tuple[slice, ...]:
    return block.slicing


def blocks_in_volume(
    shape: Sequence[int],
    block_shape: Sequence[int],
    roi_begin: Optional[Sequence[int]] = None,
    roi_end: Optional[Sequence[int]] = None,
    block_list_path: Optional[str] = None,
) -> List[int]:
    """Ids of blocks to process: full grid, restricted by ROI and/or a saved list.

    Reference: volume_utils.py:31-73.
    """
    if (roi_begin is None) != (roi_end is None):
        raise ValueError("either both or none of roi_begin / roi_end must be given")
    blocking = Blocking(shape, block_shape)
    if roi_begin is None:
        ids = list(range(blocking.n_blocks))
    else:
        roi_end = [s if re is None else re for re, s in zip(roi_end, shape)]
        ids = blocking.blocks_overlapping_roi(roi_begin, roi_end)
    if block_list_path is not None:
        # a missing list must not silently widen the block set to the full grid
        # (reference asserts existence too, volume_utils.py:39-40)
        if not os.path.exists(block_list_path):
            raise FileNotFoundError(f"block_list_path does not exist: {block_list_path}")
        with open(block_list_path) as f:
            saved = set(json.load(f))
        ids = [b for b in ids if b in saved]
    return ids


def make_checkerboard_block_lists(
    blocking: Blocking, block_ids: Optional[Sequence[int]] = None
) -> Tuple[List[int], List[int]]:
    """2-color the block grid so no two same-color blocks touch on a face.

    Pass-2 blocks of two-pass workflows read pass-1 neighbors' results; the coloring
    makes that dependency safe (reference volume_utils.py:108-171).
    """
    if block_ids is None:
        block_ids = range(blocking.n_blocks)
    white: List[int] = []
    black: List[int] = []
    for bid in block_ids:
        pos = blocking.block_grid_position(bid)
        (white if sum(pos) % 2 == 0 else black).append(bid)
    return white, black


def grid_neighbor_offsets(ndim: int) -> np.ndarray:
    """The 2*ndim face-neighbor offsets (6-connectivity in 3d)."""
    offs = []
    for axis in range(ndim):
        for sign in (-1, 1):
            o = [0] * ndim
            o[axis] = sign
            offs.append(o)
    return np.array(offs, dtype=np.int64)
