"""Distributed connected components over thresholded volumes (port of
``cluster_tools_tpu/tasks/thresholded_components.py``, block pipeline):

  1. block_components  — per block: threshold (+ smooth) → CC → write local
                         labels, record the block's max id
  2. merge_offsets     — exclusive prefix sum of max ids → per-block offsets
  3. block_faces       — per inter-block face: touching (a+off_a, b+off_b)
                         label pairs
  4. merge_assignments — union-find over all pairs → dense assignment table
  5. write             — apply offsets + assignment (``tasks/write.py``)

Step 1 computes a whole batch on the configured device: the 3d
connectivity-1 CC is kernel 4 (or kernel 5 for slices over the whole-slice
limit) plus its merge (``ops/cc.py::connected_components``).  Steps 2-4 are
host reductions, step 4 on the card for the ``cuda`` target.  In a fused
chain (``runtime/stream.py``) step 1 takes the threshold's mask from the
device and carries steps 2 and 3's outputs, which the chain then covers.

Edge blocks of a non-divisible volume are zero-padded to the batch shape.
Every voxel outside the block's real extent is set to background before CC,
so the padding never joins components (the JAX package thresholds the
padding too: in ``threshold_mode="less"`` it is foreground there, and two
components of an edge block that are disjoint in the volume can share an
id).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import filters
from ..ops.cc import connected_components
from ..ops.unionfind import merge_assignments_device, merge_assignments_np
from ..parallel.dispatch import BlockBatch, read_block_batch
from ..runtime import hbm
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import (
    VolumeSimpleTask,
    VolumeTask,
    _chunk_aligned,
    merge_threads,
    read_ragged_chunks,
    read_threads,
    resolve_n_blocks,
)

MAX_IDS_KEY = "thresholded_components/max_ids"
FACES_KEY = "thresholded_components/faces"
OFFSETS_NAME = "thresholded_components_offsets.npz"
ASSIGNMENTS_NAME = "thresholded_components_assignments.npy"
THRESHOLD_MODES = ("greater", "less", "equal")


def threshold_mask(x: torch.Tensor, threshold: float, mode: str) -> torch.Tensor:
    """Foreground of a float32 batch: ``x > t``, ``x < t`` or ``x == t``."""
    t = torch.tensor(threshold, dtype=torch.float32, device=x.device)
    if mode == "greater":
        return x > t
    if mode == "less":
        return x < t
    if mode == "equal":
        return x == t
    raise ValueError(f"unsupported threshold_mode {mode!r}; use one of {THRESHOLD_MODES}")


def valid_mask(extents, shape, device) -> torch.Tensor:
    """(B, Z, H, W) bool: True inside each block's real (z, y, x) extent."""
    ext = torch.tensor(extents, dtype=torch.int64, device=device)
    out = None
    for ax, n in enumerate(shape):
        pos = torch.arange(n, device=device).view((1,) + tuple(-1 if i == ax else 1 for i in range(3)))
        inside = pos < ext[:, ax].view(-1, 1, 1, 1)
        out = inside if out is None else out & inside
    return out


class BlockComponentsTask(VolumeTask):
    """Step 1: per-block CC with local consecutive labels."""

    task_name = "block_components"
    output_dtype = "uint64"

    def __init__(self, *args, mask_path: str = None, mask_key: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mask_path = mask_path
        self.mask_key = mask_key

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({
            "threshold": 0.5,
            "threshold_mode": "greater",
            "sigma": 0.0,
            "connectivity": 1,
            # accepted so that one config dir drives both packages, and
            # ignored: the JAX package's coarse-to-fine CC tile.  Here the
            # connectivity-1 CC is kernel 4 (whole slices) or kernel 5 with
            # its own shared-memory tile, and other connectivities propagate
            # over the whole block; the labels never depend on a tile.
            "coarse_tile": None,
        })
        return conf

    # -- stream fusion ---------------------------------------------------------
    #
    # In a chain the task takes the threshold's mask as a device handoff,
    # never a store read, and carries the merge state forward while its
    # labels are on the host for the write anyway: per-block max ids (the
    # offsets' input) and face pairs (the faces' output).  The chain covers
    # MergeOffsetsTask and BlockFacesTask with them, and neither reads a
    # voxel of the labels volume.

    fusable = True

    def fused_read_batch(self, handoffs, block_ids, blocking: Blocking, config):
        """The payload from the threshold's handoff: the uint8 mask on the
        device as float32, the values the store read of the mask dataset
        would give, so it compares against the threshold exactly as that
        read would."""
        h = handoffs[(self.input_path, self.input_key)]
        src = h["batch"]
        labels = h["labels"]
        batch = BlockBatch(
            data=None, valid=src.valid, blocks=list(src.blocks), block_ids=list(src.block_ids),
            device=hbm.DeviceBatch(arrays=(labels.to(torch.float32),), n=int(labels.shape[0]),
                                   nbytes=0))
        return batch, self._read_masks(batch.blocks)

    def fusion_carry_init(self, blocking: Blocking, config):
        return {
            "max_ids": np.zeros(blocking.n_blocks, dtype=np.int64),
            "planes": {},  # (block_id, axis) -> the block's last label plane
            "pairs": {},   # block_id -> axis -> (lo_vals, hi_vals) int64
        }

    def fusion_carry_update(self, carry, result, block_ids, blocking: Blocking, config):
        """Each block's max id and upper boundary planes; the faces to the
        lower neighbours, whose planes the carry holds (ids stream in
        ascending C order, so the carry holds one slab of planes).  Pair
        values stay block-local until finalize knows every offset.  The
        labels are the batch's host copy, which the write needs anyway:
        one device-to-host copy per batch."""
        if result is None:
            return carry
        batch, labels = result
        for i, bid in enumerate(batch.block_ids):
            lab = labels[i][batch.blocks[i].inner_local.slicing]
            carry["max_ids"][bid] = int(lab.max())
            for axis in range(blocking.ndim):
                if blocking.neighbor_id(bid, axis, lower=False) is not None:
                    carry["planes"][(bid, axis)] = np.take(
                        lab, lab.shape[axis] - 1, axis=axis).astype(np.int64)
                nb = blocking.neighbor_id(bid, axis, lower=True)
                if nb is not None:
                    lo = carry["planes"].pop((nb, axis))
                    hi = np.take(lab, 0, axis=axis).astype(np.int64)
                    both = (lo > 0) & (hi > 0)
                    if both.any():
                        carry["pairs"].setdefault(nb, {})[axis] = (lo[both], hi[both])
        return carry

    def fusion_carry_nbytes(self, carry) -> int:
        n = carry["max_ids"].nbytes + sum(a.nbytes for a in carry["planes"].values())
        return n + sum(lo.nbytes + hi.nbytes for per_axis in carry["pairs"].values()
                       for lo, hi in per_axis.values())

    def fusion_finalize(self, carry, blocking: Blocking, config) -> None:
        """The covered tasks' outputs from the carry: the offsets npz
        (``MergeOffsetsTask``) and one ``FACES_KEY`` chunk per block
        (``BlockFacesTask``), byte for byte."""
        if carry is None:
            return
        offsets = save_offsets(self.tmp_folder, carry["max_ids"])
        faces = self.tmp_ragged(FACES_KEY, blocking.n_blocks, np.int64)
        for bid in range(blocking.n_blocks):
            parts = []
            for axis, ngb_id, _ in blocking.iterate_faces(bid, halo=1):
                got = carry["pairs"].get(bid, {}).get(axis)
                if got is not None:
                    lo, hi = got
                    parts.append(np.unique(np.stack([lo + offsets[bid], hi + offsets[ngb_id]],
                                                    axis=1), axis=0))
            out = np.concatenate(parts, axis=0).reshape(-1) if parts else np.array([], np.int64)
            faces.write_chunk((bid,), out)

    # -- split batch protocol ------------------------------------------------

    def _read_masks(self, blocks):
        if not self.mask_path:
            return None
        mask_ds = store.file_reader(self.mask_path, "r")[self.mask_key]
        return [mask_ds[bh.outer.slicing].astype(bool) for bh in blocks]

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the blocks as float32, zero-padded to the block
        shape (through the device-buffer cache when it is on: the mask
        applies on the host after the compute, so only the input rides
        the cache), and the optional mask blocks."""
        batch = read_block_batch(
            self.input_ds(), blocking, block_ids, np.float32, read_threads(config),
            device_source=(self.input_path, self.input_key, ("components-read",), config))
        return batch, self._read_masks(batch.blocks)

    def upload_batch(self, payload, blocking: Blocking, config):
        hbm.batch_device(payload[0], config)
        return payload

    def stack_payloads(self, payloads, blocking: Blocking, config):
        masks = None
        if any(p[1] is not None for p in payloads):
            masks = [m for p in payloads for m in (p[1] or [])]
        return hbm.stack_block_batches([p[0] for p in payloads], config), masks

    def unstack_results(self, result, counts, blocking: Blocking, config):
        batch, labels = result
        return list(zip(hbm.split_block_batch(batch, counts), hbm.split_stacked(labels, counts)))

    def compute_batch(self, payload, blocking: Blocking, config):
        """Stage 2 (device): smooth, threshold, clear the padding, CC; the
        mask zeroes labels afterwards, as in the JAX package."""
        batch, masks = payload
        x = hbm.batch_device(batch, config).arrays[0]
        sigma = config.get("sigma", 0.0) or 0.0
        sigma = tuple(float(s) for s in sigma) if isinstance(sigma, (list, tuple)) else (float(sigma),) * 3
        if any(s > 0 for s in sigma):
            x = filters.gaussian(x, sigma)
        fg = threshold_mask(x, float(config.get("threshold", 0.5)),
                            config.get("threshold_mode", "greater"))
        fg &= valid_mask([bh.outer.shape for bh in batch.blocks], x.shape[1:], x.device)
        labels, _ = connected_components(fg, int(config.get("connectivity", 1)))
        labels = labels.cpu().numpy()
        if masks is not None:
            for i, m in enumerate(masks):
                sl = tuple(slice(0, s) for s in m.shape)
                labels[i][sl] = np.where(m, labels[i][sl], 0)
        return batch, labels

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): inner boxes as uint64 (threaded where every block
        covers whole chunks) and each block's max id."""
        batch, labels = result
        blocks = batch.blocks
        out_ds = self.output_ds()
        max_ids = self.tmp_ragged(MAX_IDS_KEY, blocking.n_blocks, np.int64)

        def _write(i):
            inner = labels[i][blocks[i].inner_local.slicing]
            out_ds[blocks[i].inner.slicing] = inner.astype(np.uint64)
            max_ids.write_chunk((batch.block_ids[i],), np.array([inner.max()], dtype=np.int64))

        n_threads = min(read_threads(config), len(blocks))
        if n_threads > 1 and all(_chunk_aligned(out_ds, bh) for bh in blocks):
            with ThreadPoolExecutor(n_threads) as pool:
                list(pool.map(_write, range(len(blocks))))
        else:
            for i in range(len(blocks)):
                _write(i)

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )


class MergeOffsetsTask(VolumeSimpleTask):
    """Step 2: exclusive prefix sum of per-block max ids."""

    task_name = "merge_offsets"

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        max_ids_ds = self.tmp_store()[MAX_IDS_KEY]
        max_ids = np.zeros(n_blocks, dtype=np.int64)
        for bid, chunk in enumerate(read_ragged_chunks(max_ids_ds, n_blocks, merge_threads(self))):
            if chunk is not None:
                max_ids[bid] = chunk[0]
        save_offsets(self.tmp_folder, max_ids)


def save_offsets(tmp_folder: str, max_ids: np.ndarray) -> np.ndarray:
    """Write the offsets npz of per-block max ids (the exclusive prefix
    sum, the empty blocks, the label count); returns the offsets."""
    offsets = np.roll(np.cumsum(max_ids), 1)
    offsets[0] = 0
    np.savez(
        os.path.join(tmp_folder, OFFSETS_NAME),
        offsets=offsets,
        empty_blocks=np.nonzero(max_ids == 0)[0],
        n_labels=np.int64(max_ids.sum()),
    )
    return offsets


def load_offsets(tmp_folder: str):
    """``(offsets, empty_blocks, n_labels)`` written by ``MergeOffsetsTask``."""
    with np.load(os.path.join(tmp_folder, OFFSETS_NAME)) as f:
        return f["offsets"], f["empty_blocks"], int(f["n_labels"])


class BlockFacesTask(VolumeTask):
    """Step 3: cross-block label equivalences over 1-voxel-halo faces."""

    task_name = "block_faces"
    output_dtype = None  # writes only scratch data

    def process_block(self, block_id: int, blocking: Blocking, config):
        labels_ds = self.input_ds()
        offsets, _, _ = load_offsets(self.tmp_folder)
        pairs = []
        for axis, ngb_id, face in blocking.iterate_faces(block_id, halo=1):
            lo, hi = np.split(labels_ds[face.slicing], 2, axis=axis)
            both = (lo > 0) & (hi > 0)
            if not both.any():
                continue
            a = lo[both].astype(np.int64) + offsets[block_id]
            b = hi[both].astype(np.int64) + offsets[ngb_id]
            pairs.append(np.unique(np.stack([a, b], axis=1), axis=0))
        out = np.concatenate(pairs, axis=0).reshape(-1) if pairs else np.array([], dtype=np.int64)
        self.tmp_ragged(FACES_KEY, blocking.n_blocks, np.int64).write_chunk((block_id,), out)


class MergeAssignmentsTask(VolumeSimpleTask):
    """Step 4: global union-find over the face pairs → dense assignment
    table; on the card for the ``cuda`` target with a CUDA device, on the
    host otherwise."""

    task_name = "merge_assignments"

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        _, _, n_labels = load_offsets(self.tmp_folder)
        faces = self.tmp_store()[FACES_KEY]
        all_pairs = [
            chunk.reshape(-1, 2)
            for chunk in read_ragged_chunks(faces, n_blocks, merge_threads(self))
            if chunk is not None and chunk.size
        ]
        pairs = np.concatenate(all_pairs, axis=0) if all_pairs else np.zeros((0, 2), np.int64)
        conf = {**self.global_config(), **self.get_task_config()}
        dev = resolve_device(conf)
        if conf.get("target") == "cuda" and dev.type == "cuda":
            assignment, n_new = merge_assignments_device(n_labels + 1, pairs, device=dev)
        else:
            assignment, n_new = merge_assignments_np(n_labels + 1, pairs)
        np.save(os.path.join(self.tmp_folder, ASSIGNMENTS_NAME), assignment)
        self.log(f"merged {n_labels} block-local labels into {n_new} components")
