"""Per-segment intensity statistics + block-wise image filter bank (port of
``cluster_tools_tpu/tasks/region_features.py``).

* ``RegionFeaturesTask`` / ``MergeRegionFeaturesTask`` — per-block segment
  statistics over an intensity volume (reference features/region_features.py
  via ``vigra.analysis.extractRegionFeatures`` and merge_region_features.py),
  computed as segment reductions on the task's device (ops/segment.py) over
  ids compacted on the host, and merged exactly on the host: counts add,
  means count-weight, min/max reduce.
* ``ImageFilterTask`` — halo'd filter-bank response volume (reference
  features/image_filter.py via fastfilters): ops/filters.apply_filter on the
  task's device, the inner block copied back and written.

Scratch layout:
  region_features/partial   ragged per block: (id, count, mean, min, max) rows
  region_features.npy       merged dense [max_id+1, 4] (count, mean, min, max)
"""

from __future__ import annotations

import os
from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..ops import filters as filter_ops
from ..ops.segment import segment_count, segment_max, segment_mean, segment_min
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks

PARTIAL_KEY = "region_features/partial"
REGION_FEATURES_NAME = "region_features.npy"
FEATURE_COLUMNS = ("count", "mean", "minimum", "maximum")


class RegionFeaturesTask(VolumeTask):
    """Per-block segment statistics (reference region_features.py:25)."""

    task_name = "region_features"
    output_dtype = None

    def __init__(self, *args, labels_path: str = None, labels_key: str = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.labels_path = labels_path
        self.labels_key = labels_key

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"channel": None, "ignore_label": 0})
        return conf

    def process_block(self, block_id: int, blocking: Blocking, config):
        bb = blocking.block(block_id).slicing
        in_ds = self.input_ds()
        labels = np.asarray(
            store.file_reader(self.labels_path, "r")[self.labels_key][bb]
        )
        channel = config.get("channel")
        read_bb = bb if channel is None else (channel,) + bb
        values = np.asarray(in_ds[read_bb], dtype=np.float32)
        # global normalization by the dtype range so statistics are comparable
        # across storage dtypes (reference region_features.py:151-157 handles
        # only uint8; integer inputs here all map to [0, 1])
        if np.issubdtype(np.dtype(in_ds.dtype), np.integer):
            values /= float(np.iinfo(np.dtype(in_ds.dtype)).max)

        out = self.tmp_ragged(PARTIAL_KEY, blocking.n_blocks, np.float64)
        ignore_label = config.get("ignore_label")
        mask = np.ones(labels.shape, dtype=bool)
        if ignore_label is not None:
            mask = labels != ignore_label
        ids = np.unique(labels[mask]) if mask.any() else np.array([], "uint64")
        if ids.size == 0:
            out.write_chunk((block_id,), np.zeros(0, dtype=np.float64))
            return

        # compact per-block ids for the device reductions
        local = np.searchsorted(ids, labels).clip(0, ids.size - 1)
        local = np.where(mask & (labels == ids[local]), local + 1, 0)
        k = ids.size + 1
        dev = resolve_device(config)
        lab = torch.from_numpy(local.astype(np.int64).reshape(-1)).to(dev)
        val = torch.from_numpy(values.reshape(-1)).to(dev)
        count = segment_count(lab, k)[1:].cpu().numpy()
        mean, mn, mx = torch.stack([
            segment_mean(lab, val, k),
            segment_min(lab, val, k),
            segment_max(lab, val, k),
        ])[:, 1:].cpu().numpy()

        rows = np.stack(
            [ids.astype(np.float64), count, mean, mn, mx], axis=1
        )
        out.write_chunk((block_id,), rows.reshape(-1))


class MergeRegionFeaturesTask(VolumeSimpleTask):
    """Exact cross-block merge (reference merge_region_features.py:20)."""

    task_name = "merge_region_features"

    def __init__(self, *args, input_path: str = None, input_key: str = None,
                 **kwargs):
        super().__init__(*args, input_path=input_path, input_key=input_key,
                         **kwargs)

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.input_path, self.input_key)
        ds = self.tmp_store()[PARTIAL_KEY]
        n_cols = len(FEATURE_COLUMNS) + 1
        partials = []
        for chunk in read_ragged_chunks(ds, n_blocks, merge_threads(self)):
            if chunk is not None and chunk.size:
                partials.append(chunk.reshape(-1, n_cols))
        if not partials:
            np.save(os.path.join(self.tmp_folder, REGION_FEATURES_NAME),
                    np.zeros((0, len(FEATURE_COLUMNS))))
            return
        rows = np.concatenate(partials, axis=0)
        ids = rows[:, 0].astype(np.int64)
        max_id = int(ids.max())
        out = np.zeros((max_id + 1, len(FEATURE_COLUMNS)), dtype=np.float64)
        count = np.zeros(max_id + 1)
        wsum = np.zeros(max_id + 1)
        mn = np.full(max_id + 1, np.inf)
        mx = np.full(max_id + 1, -np.inf)
        np.add.at(count, ids, rows[:, 1])
        np.add.at(wsum, ids, rows[:, 1] * rows[:, 2])
        np.minimum.at(mn, ids, rows[:, 3])
        np.maximum.at(mx, ids, rows[:, 4])
        seen = count > 0
        out[:, 0] = count
        out[seen, 1] = wsum[seen] / count[seen]
        out[seen, 2] = mn[seen]
        out[seen, 3] = mx[seen]
        np.save(os.path.join(self.tmp_folder, REGION_FEATURES_NAME), out)
        self.log(f"merged region features for {int(seen.sum())} segments")


def load_region_features(tmp_folder: str) -> np.ndarray:
    return np.load(os.path.join(tmp_folder, REGION_FEATURES_NAME))


class ImageFilterTask(VolumeTask):
    """Filter-response volume (reference features/image_filter.py:24)."""

    task_name = "image_filter"

    def __init__(self, *args, filter_name: str = "gaussianSmoothing",
                 sigma=2.0, halo: Sequence[int] = None,
                 apply_in_2d: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.filter_name = filter_name
        self.sigma = sigma
        self.apply_in_2d = apply_in_2d
        self.halo = (
            list(halo)
            if halo is not None
            else [int(np.ceil(4 * (self.sigma if np.isscalar(self.sigma)
                                   else max(self.sigma))))] * 3
        )

    @property
    def identifier(self) -> str:
        # every parameter that changes the output must land in the identifier,
        # or a second filter in the same tmp_folder is skipped as complete
        sig = (
            str(self.sigma)
            if np.isscalar(self.sigma)
            else "x".join(str(s) for s in self.sigma)
        )
        suffix = "_2d" if self.apply_in_2d else ""
        out = str(self.output_key or "").replace("/", "-")
        return f"{self.task_name}_{self.filter_name}_{sig}{suffix}_{out}"

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        n_chan = filter_ops.filter_channels(
            self.filter_name, apply_in_2d=self.apply_in_2d
        )
        shape = tuple(blocking.shape)
        chunks = tuple(blocking.block_shape)
        if n_chan > 1:
            shape = (n_chan,) + shape
            chunks = (1,) + chunks
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key, shape=shape, dtype="float32",
            chunks=tuple(min(c, s) for c, s in zip(chunks, shape)),
            compression="gzip",
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        bh = blocking.block_with_halo(block_id, self.halo)
        x = np.asarray(self.input_ds()[bh.outer.slicing], dtype=np.float32)
        resp = filter_ops.apply_filter(
            torch.from_numpy(x).to(resolve_device(config)), self.filter_name,
            self.sigma, apply_in_2d=self.apply_in_2d,
        )
        out_ds = self.output_ds()
        local = bh.inner_local.slicing
        if resp.dim() == x.ndim + 1:  # multi-channel response (channels last)
            out_ds[(slice(None),) + bh.inner.slicing] = (
                resp[local].movedim(-1, 0).cpu().numpy()
            )
        else:
            out_ds[bh.inner.slicing] = resp[local].cpu().numpy()
