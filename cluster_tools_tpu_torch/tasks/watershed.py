"""Watershed tasks (port of ``cluster_tools_tpu/tasks/watershed.py``):
``WatershedTask`` and ``WatershedFromSeedsTask``.

``WatershedTask``, per halo'd block: run the DT-watershed, crop the inner
box and re-close the labels by connected components (only with a halo), add
the block's id offset ``block_id * prod(block_shape)``, write.  The split
batch protocol reads the halo'd blocks on host threads (edge blocks padded
to the static batch shape by ``_pad_block``, a ``valid`` mask marking real
voxels), computes a whole batch as one (B, Z, H, W) tensor on the
configured device — in the 2d mode kernel 2 plus the size filter's kernel-1
re-flood on the card, in the other modes the plain steps and the 3d flood —
and writes on a host thread.  ``MAX_IDS_KEY`` holds each block's largest
written id.

``WatershedFromSeedsTask``, per halo'd block: smooth the boundary map,
flood it from the block's global seed ids (compacted to int32 for the
device and mapped back), optionally size-filter, write the inner box.  It
has no batch protocol: the ``cuda`` target runs ``process_block`` in
``max_jobs`` host threads.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.cc import connected_components_labels
from ..ops.filters import gaussian
from ..ops.watershed import apply_size_filter, dt_watershed, seeded_watershed
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask

MAX_IDS_KEY = "watershed/max_ids"


def kernel_params(config: Dict[str, Any]) -> Dict[str, Any]:
    """Kernel parameters from a watershed task config — the keys and casts
    of the JAX package's ``WatershedTask._kernel_params``, so one config dir
    drives both packages."""
    pitch = config.get("pixel_pitch")
    return dict(
        threshold=float(config["threshold"]),
        apply_dt_2d=bool(config.get("apply_dt_2d", True)),
        apply_ws_2d=bool(config.get("apply_ws_2d", True)),
        pixel_pitch=tuple(pitch) if pitch else None,
        sigma_seeds=float(config.get("sigma_seeds", 2.0)),
        sigma_weights=float(config.get("sigma_weights", 2.0)),
        alpha=float(config.get("alpha", 0.8)),
        size_filter=int(config.get("size_filter", 25)),
        invert_input=bool(config.get("invert_inputs", False)),
        non_maximum_suppression=bool(config["non_maximum_suppression"]),
    )


def _normalize_host(data: np.ndarray) -> np.ndarray:
    """uint8/uint16 → [0, 1] by dtype range; other dtypes cast to float32."""
    if data.dtype == np.uint8:
        return data.astype(np.float32) / 255.0
    if data.dtype == np.uint16:
        return data.astype(np.float32) / 65535.0
    return data.astype(np.float32)


def _read_input_block(ds, bb, config) -> np.ndarray:
    """Read a (possibly multi-channel) block, normalize integer dtypes and
    agglomerate channels (mean, or max)."""
    if ds.ndim == 4:
        c0 = config.get("channel_begin", 0)
        c1 = config.get("channel_end", None)
        data = _normalize_host(ds[(slice(c0, c1),) + tuple(bb)])
        if config.get("agglomerate_channels", "mean") == "max":
            return data.max(axis=0)
        return data.mean(axis=0)
    return _normalize_host(ds[bb])


def _pad_block(arr: np.ndarray, full_shape, mode: str = "edge") -> np.ndarray:
    """Pad a clipped edge-block read up to the static batch shape: data and
    masks replicate their border (``edge``), label-like arrays pad zeros."""
    pad = [(0, fs - s) for fs, s in zip(full_shape, arr.shape)]
    if not any(p for _, p in pad):
        return arr
    if mode == "zero":
        return np.pad(arr, pad)
    return np.pad(arr, pad, mode=mode)


class WatershedTask(VolumeTask):
    task_name = "watershed"
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
            "apply_dt_2d": True,
            "apply_ws_2d": True,
            "pixel_pitch": None,
            "sigma_seeds": 2.0,
            "sigma_weights": 2.0,
            "size_filter": 25,
            "alpha": 0.8,
            "halo": [0, 0, 0],
            "invert_inputs": False,
            "channel_begin": 0,
            "channel_end": None,
            "agglomerate_channels": "mean",
            "non_maximum_suppression": False,
        })
        return conf

    def _load_mask_batch(self, blocks, full_shape) -> Optional[np.ndarray]:
        if not self.mask_path:
            return None
        mask_ds = store.file_reader(self.mask_path, "r")[self.mask_key]
        return np.stack([
            _pad_block(mask_ds[bh.outer.slicing].astype(bool), full_shape)
            for bh in blocks
        ])

    # -- split batch protocol ---------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the halo'd blocks padded to one static shape, their
        ``valid`` masks, and the optional mask batch."""
        in_ds = self.input_ds()
        halo = config.get("halo") or [0, 0, 0]
        full_shape = tuple(bs + 2 * h for bs, h in zip(blocking.block_shape, halo))
        blocks = [blocking.block_with_halo(bid, halo) for bid in block_ids]
        datas, valids = [], []
        for bh in blocks:
            arr = _read_input_block(in_ds, bh.outer.slicing, config)
            datas.append(_pad_block(arr, full_shape))
            valids.append(_pad_block(np.ones(arr.shape, dtype=bool), full_shape, "zero"))
        return (
            list(block_ids), blocks, np.stack(datas), np.stack(valids),
            self._load_mask_batch(blocks, full_shape),
        )

    def compute_batch(self, payload, blocking: Blocking, config):
        """Stage 2 (device): the DT-watershed of the whole batch, then, with a
        halo, the crop to the inner box and the CC re-close."""
        block_ids, blocks, data, valid, mask = payload
        dev = resolve_device(config)
        halo = config.get("halo") or [0, 0, 0]
        x = torch.from_numpy(data).to(dev)
        v = torch.from_numpy(valid).to(dev)
        m = None if mask is None else torch.from_numpy(mask).to(dev)
        labels, _ = dt_watershed(x, mask=m, valid=v, **kernel_params(config))
        if any(h > 0 for h in halo):
            bs = tuple(blocking.block_shape)
            labels = torch.stack([
                lab[tuple(slice(s, s + n) for s, n in zip(bh.inner_local.begin, bs))]
                for lab, bh in zip(labels, blocks)
            ])
            labels, _ = connected_components_labels(labels)
        return block_ids, blocks, labels.cpu().numpy().astype(np.uint64)

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): block-id offsets, per-block max ids, inner boxes."""
        block_ids, blocks, labels = result
        out_ds = self.output_ds()
        has_halo = any(h > 0 for h in (config.get("halo") or [0, 0, 0]))
        offset_unit = int(np.prod(blocking.block_shape))
        max_ids = self.tmp_ragged(MAX_IDS_KEY, blocking.n_blocks, np.int64)
        for bid, bh, lab in zip(block_ids, blocks, labels):
            if has_halo:
                # cropped output is inner-origin at the static block shape
                lab = lab[tuple(slice(0, e - b) for b, e in zip(bh.inner.begin, bh.inner.end))]
            else:
                lab = lab[bh.inner_local.slicing]
            lab = np.where(lab > 0, lab + np.uint64(bid * offset_unit), 0).astype(np.uint64)
            max_ids.write_chunk((bid,), np.array([lab.max()], dtype=np.int64))
            out_ds[bh.inner.slicing] = lab

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )


class WatershedFromSeedsTask(VolumeTask):
    """Seeded watershed from a given (global-id) seed volume.

    ``input_path/key`` is the boundary map, ``seeds_path/key`` a label
    volume whose non-zero ids become the seeds.  The seed ids are global, so
    the output is boundary-consistent across blocks without a stitching
    step."""

    task_name = "watershed_from_seeds"
    output_dtype = "uint64"

    def __init__(self, *args, seeds_path: str = None, seeds_key: str = None,
                 mask_path: str = None, mask_key: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.seeds_path = seeds_path
        self.seeds_key = seeds_key
        self.mask_path = mask_path
        self.mask_key = mask_key

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({
            "sigma_weights": 2.0,
            "halo": [2, 8, 8],
            "invert_inputs": False,
            "apply_ws_2d": False,
            "size_filter": 0,
            "channel_begin": 0,
            "channel_end": None,
            "agglomerate_channels": "mean",
        })
        return conf

    def process_block(self, block_id: int, blocking: Blocking, config):
        dev = resolve_device(config)
        seeds_ds = store.file_reader(self.seeds_path, "r")[self.seeds_key]
        halo = config.get("halo") or [0, 0, 0]
        bh = blocking.block_with_halo(block_id, halo)

        x = _read_input_block(self.input_ds(), bh.outer.slicing, config)
        if config.get("invert_inputs", False):
            x = 1.0 - x
        seeds = seeds_ds[bh.outer.slicing].astype(np.uint64)
        mask = None
        if self.mask_path:
            mask_ds = store.file_reader(self.mask_path, "r")[self.mask_key]
            mask = torch.from_numpy(mask_ds[bh.outer.slicing].astype(bool)).to(dev)

        sigma = float(config.get("sigma_weights", 2.0))
        per_slice = bool(config.get("apply_ws_2d", False))
        hmap = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if sigma > 0:
            hmap = gaussian(hmap, (0.0, sigma, sigma) if per_slice else sigma)

        # flood over compact ids (int32 on the device), map back after
        uniq = np.unique(seeds)
        uniq = uniq[uniq > 0]
        compact = np.where(seeds > 0, np.searchsorted(uniq, seeds) + 1, 0).astype(np.int32)
        labels = seeded_watershed(
            hmap, torch.from_numpy(compact).to(dev), mask=mask, per_slice=per_slice
        )
        size_filter = int(config.get("size_filter", 0))
        if size_filter > 0:
            labels = apply_size_filter(
                labels, hmap, size_filter, int(uniq.size + 2), mask=mask, per_slice=per_slice
            )
        labels = labels.cpu().numpy().astype(np.int64)
        lookup = np.concatenate([[np.uint64(0)], uniq]).astype(np.uint64)
        self.output_ds()[bh.inner.slicing] = lookup[labels[bh.inner_local.slicing]]
