"""Paintera label-multiset datasets (port of
``cluster_tools_tpu/tasks/label_multisets.py``, host numpy as there;
reference label_multisets/ package).  Chunks are n5 varlength chunks
(``store.Dataset.write_chunk_varlen``), byte for byte the JAX package's.

``CreateMultisetTask`` turns a uint64 label dataset into a scale-0 multiset
dataset (one varlen n5 chunk per block, reference create_multiset.py:25);
``DownscaleMultisetTask`` builds coarser levels by pooling child entries with
an entry-count cap per scale (reference downscale_multiset.py:29)."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ..ops import label_multiset as lms
from ..ops.resample import downscale_shape
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask

PAINTERA_IGNORE_LABEL = 18446744073709551615


def read_multiset_region(ds, bb) -> lms.LabelMultiset:
    """Assemble a LabelMultiset for an arbitrary region from varlen chunks
    (vectorized gathers — no per-voxel Python loop)."""
    begin = [b.start for b in bb]
    end = [b.stop for b in bb]
    shape = tuple(e - b for b, e in zip(begin, end))
    n = int(np.prod(shape))
    entry_offsets = np.full(n, -1, dtype=np.int64)
    entry_sizes = np.zeros(n, dtype=np.int64)
    ids_out: List[np.ndarray] = []
    counts_out: List[np.ndarray] = []
    cursor = 0

    grid_lo = [b // c for b, c in zip(begin, ds.chunks)]
    grid_hi = [(e - 1) // c for e, c in zip(end, ds.chunks)]
    region_idx = np.arange(n).reshape(shape)
    for gz in range(grid_lo[0], grid_hi[0] + 1):
        for gy in range(grid_lo[1], grid_hi[1] + 1):
            for gx in range(grid_lo[2], grid_hi[2] + 1):
                gp = (gz, gy, gx)
                payload = ds.read_chunk_varlen(gp)
                c_begin = [g * c for g, c in zip(gp, ds.chunks)]
                c_end = [
                    min((g + 1) * c, s)
                    for g, c, s in zip(gp, ds.chunks, ds.shape)
                ]
                c_shape = tuple(e - b for b, e in zip(c_begin, c_end))
                # region ∩ chunk, in each coordinate system
                lo = [max(b, cb) for b, cb in zip(begin, c_begin)]
                hi = [min(e, ce) for e, ce in zip(end, c_end)]
                if any(l >= h for l, h in zip(lo, hi)):
                    continue
                reg_sl = tuple(
                    slice(l - b, h - b) for l, h, b in zip(lo, hi, begin)
                )
                targets = region_idx[reg_sl].reshape(-1)
                if payload is None:
                    continue  # missing chunk → background fill below
                sub = lms.deserialize_multiset(payload, c_shape)
                chunk_idx = np.arange(int(np.prod(c_shape))).reshape(c_shape)
                chunk_sl = tuple(
                    slice(l - cb, h - cb) for l, h, cb in zip(lo, hi, c_begin)
                )
                sources = chunk_idx[chunk_sl].reshape(-1)
                # gather the selected voxels' entry slices in one shot
                s_off = sub.entry_offsets[sources]
                s_size = sub.entry_sizes[sources]
                entry_idx, _ = lms._gather_indices(s_off, s_size)
                ids_out.append(sub.ids[entry_idx])
                counts_out.append(sub.counts[entry_idx])
                entry_sizes[targets] = s_size
                entry_offsets[targets] = cursor + np.concatenate(
                    [[0], np.cumsum(s_size)[:-1]]
                )
                cursor += int(s_size.sum())
    missing = entry_offsets < 0
    if missing.any():
        m = int(missing.sum())
        entry_offsets[missing] = cursor + np.arange(m)
        entry_sizes[missing] = 1
        ids_out.append(np.zeros(m, dtype=np.uint64))
        counts_out.append(np.ones(m, dtype=np.int32))
    return lms.LabelMultiset(
        shape,
        entry_offsets,
        entry_sizes,
        np.concatenate(ids_out) if ids_out else np.zeros(0, np.uint64),
        np.concatenate(counts_out) if counts_out else np.zeros(0, np.int32),
    )


class CreateMultisetTask(VolumeTask):
    task_name = "create_multiset"

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        f = store.file_reader(self.output_path, "a")
        ds = f.require_dataset(
            self.output_key,
            shape=tuple(blocking.shape),
            dtype="uint8",
            chunks=tuple(blocking.block_shape),
            compression="gzip",
        )
        in_ds = self.input_ds()
        ds.attrs["isLabelMultiset"] = True
        if "maxId" in in_ds.attrs:
            ds.attrs["maxId"] = in_ds.attrs["maxId"]

    def process_block(self, block_id: int, blocking: Blocking, config):
        block = blocking.block(block_id)
        labels = np.asarray(self.input_ds()[block.slicing]).astype(np.uint64)
        # paintera's ignore label cannot be encoded (reference
        # create_multiset.py:115-118)
        labels[labels == PAINTERA_IGNORE_LABEL] = 0
        if not labels.any():
            return
        multiset = lms.create_multiset_from_labels(labels)
        ser = lms.serialize_multiset(multiset)
        out_ds = self.output_ds()
        grid_pos = tuple(b // c for b, c in zip(block.begin, out_ds.chunks))
        out_ds.write_chunk_varlen(grid_pos, ser)


class DownscaleMultisetTask(VolumeTask):
    """One multiset pyramid step; blocking over the OUTPUT (coarser) shape."""

    task_name = "downscale_multiset"

    def __init__(self, *args, scale_factor=2, restrict_set: int = -1,
                 effective_scale_factor: Sequence[int] = (),
                 scale_prefix: str = "", **kwargs):
        super().__init__(*args, **kwargs)
        self.scale_factor = (
            [scale_factor] * 3 if isinstance(scale_factor, int)
            else list(scale_factor)
        )
        self.restrict_set = restrict_set
        self.effective_scale_factor = list(effective_scale_factor)
        self.scale_prefix = scale_prefix

    @property
    def identifier(self) -> str:
        return (
            f"{self.task_name}_{self.scale_prefix}"
            if self.scale_prefix
            else self.task_name
        )

    def get_shape(self) -> Sequence[int]:
        return downscale_shape(self.input_ds().shape, self.scale_factor)

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        f = store.file_reader(self.output_path, "a")
        ds = f.require_dataset(
            self.output_key,
            shape=tuple(blocking.shape),
            dtype="uint8",
            chunks=tuple(blocking.block_shape),
            compression="gzip",
        )
        ds.attrs["isLabelMultiset"] = True
        eff = self.effective_scale_factor or self.scale_factor
        ds.attrs["downsamplingFactors"] = [float(e) for e in eff[::-1]]
        in_ds = self.input_ds()
        if "maxId" in in_ds.attrs:
            ds.attrs["maxId"] = in_ds.attrs["maxId"]

    def process_block(self, block_id: int, blocking: Blocking, config):
        block = blocking.block(block_id)
        in_ds = self.input_ds()
        sf = self.scale_factor
        in_bb = tuple(
            slice(b.start * f, min(b.stop * f, s))
            for b, f, s in zip(block.slicing, sf, in_ds.shape)
        )
        sub = read_multiset_region(in_ds, in_bb)
        pooled = lms.downsample_multiset(sub, sf, self.restrict_set)
        out_ds = self.output_ds()
        grid_pos = tuple(b // c for b, c in zip(block.begin, out_ds.chunks))
        out_ds.write_chunk_varlen(grid_pos, lms.serialize_multiset(pooled))
