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

The JAX package's workflow runs 1–3 as one fused chain; its fusion-carry
hooks wait for the port's stream fusion (ROADMAP Queue A 12(c)), and the
port runs the unfused chain, which the JAX tests hold byte-identical to the
fused one.  Device residency of the labels across re-cuts waits for the
port's buffer cache (ROADMAP Queue A 9).

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
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import (
    VolumeSimpleTask,
    VolumeTask,
    merge_threads,
    read_padded_blocks,
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
        JAX package reads them), zero-padded to the block shape."""
        blocks, data = read_padded_blocks(
            self.input_ds(), blocking, block_ids, np.float32, read_threads(config))
        return list(block_ids), blocks, data

    def compute_batch(self, batch, blocking: Blocking, config):
        """Stage 2 (device): the watershed of the batch and each block's
        merge table, its edge slots only."""
        block_ids, blocks, data = batch
        dev = resolve_device(config)
        params = self._kernel_params(config)
        x = torch.from_numpy(data).to(dev)
        v = torch.from_numpy(_valid_masks(blocks, blocking)).to(dev)
        labels, _ = dt_watershed(x, valid=v, **params)
        h = 1.0 - x if params["invert_input"] else x
        a, b, s = hier_ops.block_merge_table(labels, h)
        tables = []
        for i in range(len(blocks)):
            keep = a[i] > 0
            tables.append(tuple(c[i][keep].cpu().numpy() for c in (a, b, s)))
        return block_ids, blocks, labels.cpu().numpy().astype(np.int64), tables

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): labels, max ids and reduced tables per block."""
        block_ids, blocks, labels, tables = result
        write_inner_blocks(self.output_ds(), blocks, labels, np.uint64, read_threads(config))
        max_ids = self.tmp_ragged(HIER_MAX_IDS_KEY, blocking.n_blocks, np.int64)
        pairs_ds = self.tmp_ragged(HIER_PAIRS_KEY, blocking.n_blocks, np.int64)
        sad_ds = self.tmp_ragged(HIER_SADDLES_KEY, blocking.n_blocks, np.float32)
        for i, bid in enumerate(block_ids):
            inner = labels[i][blocks[i].inner_local.slicing]
            max_ids.write_chunk((bid,), np.array([inner.max()], np.int64))
            pairs, saddles = hier_ops.reduce_merge_table(*tables[i])
            pairs_ds.write_chunk((bid,), pairs.reshape(-1))
            sad_ds.write_chunk((bid,), saddles)

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )


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
        offsets = np.roll(np.cumsum(max_ids), 1)
        offsets[0] = 0
        np.savez(os.path.join(self.tmp_folder, HIER_OFFSETS_NAME),
                 offsets=offsets, n_labels=np.int64(max_ids.sum()))


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
        """Stage 1 (host): the labels as int32 (int64 on the host path)."""
        self._require_cut(config)
        blocks, data = read_padded_blocks(
            self.input_ds(), blocking, block_ids,
            np.int64 if self._host_relabel else np.int32, read_threads(config))
        return blocks, data

    def compute_batch(self, batch, blocking: Blocking, config):
        """Stage 2: one gather of the batch through the cut's table."""
        blocks, labels = batch
        cut = self._require_cut(config)
        if cut is None:  # nothing below the threshold: the identity
            return blocks, labels
        vals, roots = cut
        if self._host_relabel:
            return blocks, hier_ops.apply_cut_np(labels, vals, roots)
        dev = resolve_device(config)
        out = hier_ops.recut_labels(torch.from_numpy(labels).to(dev),
                                    torch.from_numpy(vals).to(dev), torch.from_numpy(roots).to(dev))
        return blocks, out.cpu().numpy()

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): the inner boxes as uint64."""
        blocks, labels = result
        write_inner_blocks(self.output_ds(), blocks, labels, np.uint64, read_threads(config))

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )
