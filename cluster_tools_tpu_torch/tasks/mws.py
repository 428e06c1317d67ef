"""Blockwise mutex watershed tasks (port of ``cluster_tools_tpu/tasks/mws.py``).

``MwsBlocksTask``: per halo'd block, the MWS on long-range affinities
(``ops/mws.py``: host C++ by default, the device formulation on the
configured device with ``CTT_MWS_MODE=device``), the whole outer region
relabelled consecutively and offset into the block's id namespace; the
inner box is written and the outer labelling saved for face stitching.

``TwoPassMwsTask``: one checkerboard pass of the two-pass MWS; pass 1
seeds each block with the labels pass 0 wrote in its face slabs.

Neither task has the batch protocol: on target ``cuda`` the executor loops
over ``process_block`` in ``max_jobs`` threads (pass 1 in one thread).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..ops.mws import compute_mws_segmentation, compute_mws_segmentation_with_seeds
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking, make_checkerboard_block_lists
from .base import VolumeTask
from .stitching import save_block_overlap
from .watershed import MAX_IDS_KEY


def _offset_unit(block_id: int, blocking: Blocking, halo) -> np.uint64:
    """A block's id namespace: sized by the FULL outer region, since labels
    are consecutive over the halo'd box (an inner-sized namespace could
    spill into the next block's range)."""
    outer_full = [bs + 2 * h for bs, h in zip(blocking.block_shape, halo)]
    return np.uint64(block_id * int(np.prod(outer_full)))


class MwsBlocksTask(VolumeTask):
    task_name = "mws_blocks"
    output_dtype = "uint64"

    def __init__(self, *args, mask_path: str = None, mask_key: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mask_path = mask_path
        self.mask_key = mask_key

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({
            # CREMI-style long-range offsets (z, y, x)
            "offsets": [
                [-1, 0, 0], [0, -1, 0], [0, 0, -1],
                [-2, 0, 0], [0, -3, 0], [0, 0, -3],
                [-3, -3, -3], [-3, 3, 3],
            ],
            "strides": [1, 1, 1],
            "randomize_strides": False,
            "noise_level": 0.0,
            "halo": [2, 4, 4],
        })
        return conf

    def _load_affs_and_mask(self, bh, config):
        """The halo'd affinities (uint8 cast to [0, 1]) and the optional
        mask; ``empty`` when the whole block is masked out."""
        affs = self.input_ds()[(slice(0, len(config.get("offsets"))),) + bh.outer.slicing]
        if affs.dtype == np.uint8:
            affs = affs.astype(np.float32) / 255.0
        mask = None
        if self.mask_path:
            mask = store.file_reader(self.mask_path, "r")[self.mask_key][bh.outer.slicing].astype(bool)
            if not mask.any():
                return affs, mask, True
        return affs, mask, False

    def _mws_kwargs(self, block_id: int, mask, config) -> Dict[str, Any]:
        return dict(
            strides=config.get("strides"),
            randomize_strides=bool(config.get("randomize_strides", False)),
            mask=mask,
            noise_level=float(config.get("noise_level", 0.0)),
            seed=block_id,
            device=resolve_device(config),
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        out_ds = self.output_ds()
        halo = config.get("halo") or [0, 0, 0]
        bh = blocking.block_with_halo(block_id, halo)
        affs, mask, empty = self._load_affs_and_mask(bh, config)
        if empty:
            out_ds[bh.inner.slicing] = np.zeros(bh.inner.shape, dtype=np.uint64)
            return
        seg = compute_mws_segmentation(
            affs, config.get("offsets"), **self._mws_kwargs(block_id, mask, config)
        )
        # relabel the whole outer region consecutively, then offset it into
        # the block's namespace; the outer labelling is saved too, so the
        # face stitching compares both blocks' labellings of a shared halo
        uniq, inv = np.unique(seg, return_inverse=True)
        inv = inv.reshape(seg.shape).astype(np.uint64)
        lab_outer = inv if uniq[0] == 0 else inv + 1
        offset_unit = _offset_unit(block_id, blocking, halo)
        lab_outer = np.where(lab_outer > 0, lab_outer + offset_unit, 0).astype(np.uint64)
        lab = lab_outer[bh.inner_local.slicing]
        out_ds[bh.inner.slicing] = lab
        save_block_overlap(self.tmp_folder, block_id, bh.outer.begin, bh.outer.end, lab_outer)
        max_ids = self.tmp_ragged(MAX_IDS_KEY, blocking.n_blocks, np.int64)
        max_ids.write_chunk((block_id,), np.array([lab.max()], dtype=np.int64))


class TwoPassMwsTask(MwsBlocksTask):
    """One checkerboard pass of the two-pass mutex watershed.

    Pass 0 runs the plain block MWS on one colour; pass 1 runs on the other
    with the neighbour labels already written in its halo's face slabs as
    seeds (``compute_mws_segmentation_with_seeds``): the shared voxels keep
    the neighbour ids and distinct neighbour segments are mutexed."""

    task_name = "two_pass_mws"

    def __init__(self, *args, pass_id: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.pass_id = int(pass_id)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_pass{self.pass_id}"

    @property
    def pipeline_safe(self) -> bool:
        # pass 1 reads halo'd regions that same-colour diagonal neighbours
        # of the same run write: one block at a time
        return self.pass_id == 0

    def get_block_list(self, blocking: Blocking, gconf: Dict[str, Any]) -> List[int]:
        colors = make_checkerboard_block_lists(blocking, super().get_block_list(blocking, gconf))
        return sorted(colors[self.pass_id])

    def process_block(self, block_id: int, blocking: Blocking, config):
        if self.pass_id == 0:
            super().process_block(block_id, blocking, config)
            return
        out_ds = self.output_ds()
        halo = config.get("halo") or [0, 0, 0]
        bh = blocking.block_with_halo(block_id, halo)
        affs, mask, empty = self._load_affs_and_mask(bh, config)
        if empty:
            out_ds[bh.inner.slicing] = np.zeros(bh.inner.shape, dtype=np.uint64)
            return
        # seeds: what pass-0 neighbours wrote in the outer region's FACE
        # slabs only — the corner and edge wedges overlap diagonal
        # neighbours, which share this pass's colour and may be writing
        written = np.asarray(out_ds[bh.outer.slicing]).astype(np.uint64)
        inner_local = bh.inner_local.slicing
        face_seeds = np.zeros_like(written)
        for axis in range(3):
            for side in (0, 1):
                slab = list(inner_local)
                if side == 0:
                    slab[axis] = slice(0, inner_local[axis].start)
                else:
                    slab[axis] = slice(inner_local[axis].stop, written.shape[axis])
                slab = tuple(slab)
                face_seeds[slab] = written[slab]
        seg = compute_mws_segmentation_with_seeds(
            affs, config.get("offsets"), face_seeds, **self._mws_kwargs(block_id, mask, config)
        )
        # new (unseeded) segments move into this block's namespace; seeded
        # ones keep the neighbour ids
        seed_max = int(face_seeds.max())
        is_new = seg > seed_max
        seg = np.where(is_new, seg - np.uint64(seed_max) + _offset_unit(block_id, blocking, halo), seg)
        out_ds[bh.inner.slicing] = seg[inner_local].astype(np.uint64)
