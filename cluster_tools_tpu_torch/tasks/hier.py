"""Build the merge hierarchy once, re-cut it at any threshold (port of
``cluster_tools_tpu/tasks/hier.py``).

  1. ``HierarchyBlocksTask`` — per batch of halo-less blocks on the task's
     device: the DT-watershed (``ops.watershed.dt_watershed``, kernels 2
     and 1 in the default 2d mode) and the block's full-adjacency merge
     table (``ops.hier.block_merge_table``) over the flood's working input;
     the slots that are no edge are dropped on the device.  Writes
     block-local labels, per-block max ids and the reduced in-block table.
  2. ``HierarchyOffsetsTask`` — exclusive prefix sum of the max ids.
  3. ``HierarchyFacesTask`` — per block face: label pairs and saddles over
     the 1-voxel boundary planes, in global ids.
  4. ``BuildHierarchyTask`` — in-block (plus offsets) and face tables,
     reduced to per-pair minimum saddles, sorted by saddle and saved as the
     hierarchy artifact beside the labels, with the identity assignment.
  5. ``WriteTask`` — the labels volume in global ids.

``HierarchyWorkflow`` runs 1–3 as one fused chain (``runtime/stream.py``):
step 1 carries the max ids and the boundary label and height planes batch
by batch, and writes steps 2 and 3's outputs from them at the end, so no
voxel of the labels volume is read back.

``ResegmentTask`` re-cuts a built hierarchy: one value-space union-find on
the device (``ops.hier.cut_table``) in ``prepare``, then one gather per
block batch; ``write_volume: false`` saves the relabel table instead of a
volume.  Past ``INT32_LIMIT`` regions it warns and relabels on the host in
int64.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import hier as hier_ops
from ..ops.watershed import dt_watershed
from ..parallel.dispatch import read_block_batch
from ..runtime import hbm
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import (
    VolumeSimpleTask,
    VolumeTask,
    merge_threads,
    read_ragged_chunks,
    read_threads,
    resolve_n_blocks,
    write_inner_blocks,
)
from .watershed import _normalize_host

HIER_MAX_IDS_KEY = "hier/max_ids"
HIER_PAIRS_KEY = "hier/pairs"            # per block: (k, 2) int64, flattened
HIER_SADDLES_KEY = "hier/saddles"        # per block: (k,) float32
HIER_FACE_PAIRS_KEY = "hier/face_pairs"  # per block: global-id pairs
HIER_FACE_SADDLES_KEY = "hier/face_saddles"
HIER_OFFSETS_NAME = "hier_offsets.npz"
HIER_ASSIGNMENTS_NAME = "hier_assignments.npy"


def default_hierarchy_path(output_path: str, output_key: str) -> str:
    """``<output_path>/<output_key>_hierarchy.npz``, beside the labels."""
    return os.path.join(output_path, f"{output_key}_hierarchy.npz")


def load_hier_offsets(tmp_folder: str):
    with np.load(os.path.join(tmp_folder, HIER_OFFSETS_NAME)) as f:
        return f["offsets"], int(f["n_labels"])


def save_hier_offsets(tmp_folder: str, max_ids: np.ndarray) -> np.ndarray:
    """Write the hierarchy's offsets npz (the exclusive prefix sum of the
    per-block max ids, the label count); returns the offsets."""
    offsets = np.roll(np.cumsum(max_ids), 1)
    offsets[0] = 0
    np.savez(os.path.join(tmp_folder, HIER_OFFSETS_NAME),
             offsets=offsets, n_labels=np.int64(max_ids.sum()))
    return offsets


def _working_heights(raw: np.ndarray, config) -> np.ndarray:
    """The flood's working input as the saddle heights: normalised by dtype
    range and optionally inverted, a per-voxel transform, so that face
    saddles (host) and in-block saddles (device) agree across blocks."""
    x = _normalize_host(np.asarray(raw))
    if config.get("invert_inputs", False):
        x = 1.0 - x
    return x


def _valid_masks(blocks, blocking: Blocking) -> np.ndarray:
    full = tuple(blocking.block_shape)
    out = np.zeros((len(blocks),) + full, dtype=bool)
    for i, bh in enumerate(blocks):
        out[i][tuple(slice(0, e - b) for b, e in zip(bh.outer.begin, bh.outer.end))] = True
    return out


class HierarchyBlocksTask(VolumeTask):
    """Step 1: per block, the flood and its full-adjacency merge table.
    Labels are block-local (the write step adds the offsets); the in-block
    table is reduced to per-pair minimum saddles on the host."""

    task_name = "hierarchy_blocks"
    output_dtype = "uint64"
    # the single member of HierarchyWorkflow's fused chain
    fusable = True

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({
            "threshold": 0.5,
            "apply_dt_2d": True,
            "apply_ws_2d": True,
            "sigma_seeds": 2.0,
            "sigma_weights": 2.0,
            "alpha": 0.8,
            "size_filter": 25,
            "invert_inputs": False,
            "non_maximum_suppression": False,
        })
        return conf

    @staticmethod
    def _kernel_params(config) -> Dict[str, Any]:
        return dict(
            threshold=float(config["threshold"]),
            apply_dt_2d=bool(config.get("apply_dt_2d", True)),
            apply_ws_2d=bool(config.get("apply_ws_2d", True)),
            sigma_seeds=float(config.get("sigma_seeds", 2.0)),
            sigma_weights=float(config.get("sigma_weights", 2.0)),
            alpha=float(config.get("alpha", 0.8)),
            size_filter=int(config.get("size_filter", 25)),
            invert_input=bool(config.get("invert_inputs", False)),
            non_maximum_suppression=bool(config.get("non_maximum_suppression", False)),
        )

    # -- split batch protocol ------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the blocks as float32 (the stored values, as the
        JAX package reads them), zero-padded to the block shape, through the
        device-buffer cache when it is on."""
        return read_block_batch(
            self.input_ds(), blocking, block_ids, np.float32, read_threads(config),
            device_source=(self.input_path, self.input_key, ("hier-read",), config))

    def upload_batch(self, batch, blocking: Blocking, config):
        hbm.batch_device(batch, config)
        return batch

    def stack_payloads(self, payloads, blocking: Blocking, config):
        return hbm.stack_block_batches(payloads, config)

    def unstack_results(self, result, counts, blocking: Blocking, config):
        batch, labels, tables, hplanes = result
        hps, off = [], 0
        for c in counts:
            hps.append(tuple(arr[off: off + c] for arr in hplanes))
            off += c
        return list(zip(hbm.split_block_batch(batch, counts), hbm.split_stacked(labels, counts),
                        hbm.split_stacked(tables, counts), hps))

    def compute_batch(self, batch, blocking: Blocking, config):
        """Stage 2 (device): the watershed of the batch, each block's merge
        table (its edge slots only) and, per axis, the first and last planes
        of the flood's working heights — what the fused chain's carry joins
        the block faces with."""
        params = self._kernel_params(config)
        x = hbm.batch_device(batch, config).arrays[0]
        v = torch.from_numpy(_valid_masks(batch.blocks, blocking)).to(x.device)
        labels, _ = dt_watershed(x, valid=v, **params)
        h = 1.0 - x if params["invert_input"] else x
        a, b, s = hier_ops.block_merge_table(labels, h)
        tables = []
        for i in range(len(batch.blocks)):
            keep = a[i] > 0
            tables.append(tuple(c[i][keep].cpu().numpy() for c in (a, b, s)))
        hplanes = tuple(
            torch.stack([h.select(d + 1, 0), h.select(d + 1, h.shape[d + 1] - 1)], dim=1)
            .cpu().numpy() for d in range(h.dim() - 1))  # per axis: (B, 2, *plane)
        return batch, labels.cpu().numpy().astype(np.int64), tables, hplanes

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): labels, max ids and reduced tables per block."""
        batch, labels, tables, _ = result
        write_inner_blocks(self.output_ds(), batch.blocks, labels, np.uint64,
                           read_threads(config))
        max_ids = self.tmp_ragged(HIER_MAX_IDS_KEY, blocking.n_blocks, np.int64)
        pairs_ds = self.tmp_ragged(HIER_PAIRS_KEY, blocking.n_blocks, np.int64)
        sad_ds = self.tmp_ragged(HIER_SADDLES_KEY, blocking.n_blocks, np.float32)
        for i, bid in enumerate(batch.block_ids):
            inner = labels[i][batch.blocks[i].inner_local.slicing]
            max_ids.write_chunk((bid,), np.array([inner.max()], np.int64))
            pairs, saddles = hier_ops.reduce_merge_table(*tables[i])
            pairs_ds.write_chunk((bid,), pairs.reshape(-1))
            sad_ds.write_chunk((bid,), saddles)

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )

    # -- stream fusion (the chain covers offsets and faces) --------------------
    #
    # The carry: per-block max ids and the blocks' boundary label and height
    # planes, joined with the lower neighbour's carried planes as the blocks
    # stream in ascending C order (one slab of planes in memory).  The
    # heights are the flood's own working planes, so a batch whose read
    # probe hit the device-buffer cache joins its faces without a host read.

    def fusion_carry_init(self, blocking: Blocking, config):
        return {
            "max_ids": np.zeros(blocking.n_blocks, dtype=np.int64),
            "planes": {},  # (block_id, axis) -> (label_plane, height_plane)
            "faces": {},   # block_id -> axis -> (pairs, saddles), block-local ids
        }

    def fusion_carry_update(self, carry, result, block_ids, blocking: Blocking, config):
        if result is None:
            return carry
        batch, labels, _, hplanes = result
        for i, bid in enumerate(batch.block_ids):
            bh = batch.blocks[i]
            lab = labels[i][bh.inner_local.slicing]
            carry["max_ids"][bid] = int(lab.max())
            size = tuple(e - b for b, e in zip(bh.inner.begin, bh.inner.end))
            for axis in range(blocking.ndim):
                first, last = hplanes[axis][i]
                crop = tuple(slice(0, n) for d, n in enumerate(size) if d != axis)
                if blocking.neighbor_id(bid, axis, lower=False) is not None:
                    carry["planes"][(bid, axis)] = (np.take(lab, lab.shape[axis] - 1, axis=axis),
                                                    last[crop])
                nb = blocking.neighbor_id(bid, axis, lower=True)
                if nb is not None:
                    lo_lab, lo_h = carry["planes"].pop((nb, axis))
                    pairs, saddles = hier_ops.merge_face_pairs(
                        lo_lab, np.take(lab, 0, axis=axis), lo_h, first[crop])
                    if pairs.size:
                        carry["faces"].setdefault(nb, {})[axis] = (pairs, saddles)
        return carry

    def fusion_carry_nbytes(self, carry) -> int:
        n = carry["max_ids"].nbytes + sum(la.nbytes + h.nbytes for la, h in carry["planes"].values())
        return n + sum(p.nbytes + s.nbytes for per_axis in carry["faces"].values()
                       for p, s in per_axis.values())

    def fusion_finalize(self, carry, blocking: Blocking, config) -> None:
        """The offsets npz (``HierarchyOffsetsTask``'s output) and the
        global-id face chunks (``HierarchyFacesTask``'s) from the carry."""
        if carry is None:
            return
        offsets = save_hier_offsets(self.tmp_folder, carry["max_ids"])
        fp = self.tmp_ragged(HIER_FACE_PAIRS_KEY, blocking.n_blocks, np.int64)
        fs = self.tmp_ragged(HIER_FACE_SADDLES_KEY, blocking.n_blocks, np.float32)
        for bid in range(blocking.n_blocks):
            parts_p, parts_s = [], []
            for axis, ngb_id, _ in blocking.iterate_faces(bid, halo=1):
                got = carry["faces"].get(bid, {}).get(axis)
                if got is not None:
                    parts_p.append(got[0] + np.array([[offsets[bid], offsets[ngb_id]]], np.int64))
                    parts_s.append(got[1])
            if parts_p:
                pairs, saddles = np.concatenate(parts_p, axis=0), np.concatenate(parts_s)
            else:
                pairs, saddles = np.zeros((0, 2), np.int64), np.zeros((0,), np.float32)
            fp.write_chunk((bid,), pairs.reshape(-1))
            fs.write_chunk((bid,), saddles)


class HierarchyOffsetsTask(VolumeSimpleTask):
    """Step 2: exclusive prefix sum of the per-block max ids."""

    task_name = "hierarchy_offsets"

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        max_ids = np.zeros(n_blocks, dtype=np.int64)
        chunks = read_ragged_chunks(self.tmp_store()[HIER_MAX_IDS_KEY], n_blocks, merge_threads(self))
        for bid, chunk in enumerate(chunks):
            if chunk is not None:
                max_ids[bid] = chunk[0]
        save_hier_offsets(self.tmp_folder, max_ids)


class HierarchyFacesTask(VolumeTask):
    """Step 3: edges across the 1-voxel block faces in global ids — labels
    from the blocks volume, saddles from ``heights_path/key`` under the
    kernel's per-voxel transform."""

    task_name = "hierarchy_faces"
    output_dtype = None  # scratch chunks only

    def __init__(self, *args, heights_path: str = None, heights_key: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.heights_path = heights_path
        self.heights_key = heights_key

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"invert_inputs": False})
        return conf

    def process_block(self, block_id: int, blocking: Blocking, config):
        labels_ds = self.input_ds()
        heights_ds = store.file_reader(self.heights_path, "r")[self.heights_key]
        offsets, _ = load_hier_offsets(self.tmp_folder)
        parts_p, parts_s = [], []
        for axis, ngb_id, face in blocking.iterate_faces(block_id, halo=1):
            slab = labels_ds[face.slicing].astype(np.int64)
            h_slab = _working_heights(heights_ds[face.slicing], config)
            lo, hi = np.split(slab, 2, axis=axis)
            h_lo, h_hi = np.split(h_slab, 2, axis=axis)
            pairs, saddles = hier_ops.merge_face_pairs(lo, hi, h_lo, h_hi)
            if pairs.size:
                parts_p.append(pairs + np.array([[offsets[block_id], offsets[ngb_id]]], np.int64))
                parts_s.append(saddles)
        fp = self.tmp_ragged(HIER_FACE_PAIRS_KEY, blocking.n_blocks, np.int64)
        fs = self.tmp_ragged(HIER_FACE_SADDLES_KEY, blocking.n_blocks, np.float32)
        if parts_p:
            pairs, saddles = np.concatenate(parts_p, axis=0), np.concatenate(parts_s)
        else:
            pairs, saddles = np.zeros((0, 2), np.int64), np.zeros((0,), np.float32)
        fp.write_chunk((block_id,), pairs.reshape(-1))
        fs.write_chunk((block_id,), saddles)


class BuildHierarchyTask(VolumeSimpleTask):
    """Step 4: offset the in-block tables, join the face tables, reduce to
    per-pair minimum saddles, save the artifact sorted by saddle and the
    identity assignment of the write step."""

    task_name = "hierarchy_build"

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        offsets, n_labels = load_hier_offsets(self.tmp_folder)
        tmp = self.tmp_store()
        threads = merge_threads(self)
        pairs_chunks, sad_chunks, fp_chunks, fs_chunks = (
            read_ragged_chunks(tmp[key], n_blocks, threads)
            for key in (HIER_PAIRS_KEY, HIER_SADDLES_KEY, HIER_FACE_PAIRS_KEY, HIER_FACE_SADDLES_KEY)
        )
        all_pairs, all_saddles = [], []
        for bid in range(n_blocks):
            p = pairs_chunks[bid]
            if p is not None and p.size:
                all_pairs.append(p.reshape(-1, 2) + offsets[bid])
                all_saddles.append(sad_chunks[bid])
            fpc = fp_chunks[bid]
            if fpc is not None and fpc.size:
                all_pairs.append(fpc.reshape(-1, 2))
                all_saddles.append(fs_chunks[bid])
        if all_pairs:
            pairs = np.concatenate(all_pairs, axis=0)
            pairs, saddles = hier_ops.reduce_merge_table(
                pairs[:, 0], pairs[:, 1], np.concatenate(all_saddles))
        else:
            pairs, saddles = np.zeros((0, 2), np.int64), np.zeros((0,), np.float32)
        shape = store.file_reader(self.input_path, "r")[self.input_key].shape
        hier_ops.save_hierarchy(self.hierarchy_path, pairs, saddles, n_labels,
                                shape, self.global_config()["block_shape"])
        np.save(os.path.join(self.tmp_folder, HIER_ASSIGNMENTS_NAME),
                np.arange(n_labels + 1, dtype=np.uint64))
        self.log(f"hierarchy: {n_labels} regions, {pairs.shape[0]} saddle edges "
                 f"-> {self.hierarchy_path}")


class ResegmentTask(VolumeTask):
    """Re-segment a hierarchy's labels volume at one threshold: the cut is
    resolved once in ``prepare``, then every block batch is one gather on
    the task's device.  ``write_volume: false`` saves the relabel table
    (``<output_key>_cut.npz`` beside the output) and writes no volume."""

    task_name = "resegment"
    output_dtype = "uint64"

    # ids at or above this overflow the device gather's int32
    INT32_LIMIT = int(np.iinfo(np.int32).max)

    def __init__(self, *args, hierarchy_path: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.hierarchy_path = hierarchy_path
        self._cut = None
        self._cut_ready = False
        self._n_labels = 0
        self._host_relabel = False

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"threshold": 0.5, "write_volume": True})
        return conf

    def cut_table_path(self) -> str:
        return os.path.join(self.output_path, f"{self.output_key}_cut.npz")

    def get_block_list(self, blocking, gconf):
        if not self.get_task_config().get("write_volume", True):
            return []  # table mode: no volume pass
        return super().get_block_list(blocking, gconf)

    def _resolve_cut(self, art, config):
        """The device union-find (int32 gather) below ``INT32_LIMIT``
        regions; at or above it a warned downgrade to the host's int64."""
        threshold = float(config["threshold"])
        self._n_labels = int(art["n_labels"])
        self._host_relabel = self._n_labels >= self.INT32_LIMIT
        t0 = time.perf_counter()
        if self._host_relabel:
            msg = (f"hierarchy holds {self._n_labels} regions (>= {self.INT32_LIMIT}): "
                   "the int32 device gather would overflow — downgrading to the HOST "
                   "relabel path (int64 numpy gather)")
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            self.log(f"resegment: {msg}")
            cut = hier_ops.cut_table_np(art["a"], art["b"], art["saddle"], threshold)
        else:
            cut = hier_ops.cut_table(art["a"], art["b"], art["saddle"], threshold,
                                     device=resolve_device(config))
        self.record_timing("cut_table", 0, time.perf_counter() - t0)
        return cut

    def prepare(self, blocking: Blocking, config) -> None:
        if config.get("write_volume", True):
            super().prepare(blocking, config)
        art = hier_ops.load_hierarchy(self.hierarchy_path)
        self._cut = self._resolve_cut(art, config)
        self._cut_ready = True
        threshold = float(config["threshold"])
        k = int(np.searchsorted(art["saddle"], np.float32(threshold), side="right"))
        self.log(f"resegment @ t={threshold}: {k}/{art['saddle'].size} edges selected")

    def finalize(self, blocking: Blocking, config, block_ids) -> None:
        if not config.get("write_volume", True):
            hier_ops.save_cut_table(self.cut_table_path(), float(config["threshold"]),
                                    self._cut, self._n_labels)

    def _require_cut(self, config):
        if not self._cut_ready:
            self._cut = self._resolve_cut(hier_ops.load_hierarchy(self.hierarchy_path), config)
            self._cut_ready = True
        return self._cut

    # -- split batch protocol ------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the labels as int32, through the device-buffer
        cache when it is on, so a sweep of re-cuts keeps the labels volume
        resident; int64 and uncached on the host path."""
        self._require_cut(config)  # the path decides the read's dtype
        if self._host_relabel:
            return read_block_batch(self.input_ds(), blocking, block_ids, np.int64,
                                    read_threads(config))
        return read_block_batch(
            self.input_ds(), blocking, block_ids, np.int32, read_threads(config),
            device_source=(self.input_path, self.input_key, ("hier-labels",), config))

    def upload_batch(self, batch, blocking: Blocking, config):
        if not self._host_relabel:
            hbm.batch_device(batch, config)
        return batch

    def stack_payloads(self, payloads, blocking: Blocking, config):
        return hbm.stack_block_batches(payloads, config)

    def unstack_results(self, result, counts, blocking: Blocking, config):
        batch, labels = result
        return list(zip(hbm.split_block_batch(batch, counts), hbm.split_stacked(labels, counts)))

    def compute_batch(self, batch, blocking: Blocking, config):
        """Stage 2: one gather of the batch through the cut's table."""
        cut = self._require_cut(config)
        if self._host_relabel:
            return batch, batch.data if cut is None else hier_ops.apply_cut_np(batch.data, *cut)
        x = hbm.batch_device(batch, config).arrays[0]
        if cut is None:  # nothing below the threshold: the identity
            return batch, x.cpu().numpy()
        vals, roots = (torch.from_numpy(t).to(x.device) for t in cut)
        return batch, hier_ops.recut_labels(x, vals, roots).cpu().numpy()

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): the inner boxes as uint64."""
        batch, labels = result
        write_inner_blocks(self.output_ds(), batch.blocks, labels, np.uint64,
                           read_threads(config))

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )
