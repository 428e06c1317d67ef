"""Watershed tasks (port of ``cluster_tools_tpu/tasks/watershed.py``):
``WatershedTask``, ``WatershedFromSeedsTask``, ``AgglomerateTask`` and
``TwoPassWatershedTask``.

``WatershedTask``, per halo'd block: run the DT-watershed, crop the inner
box and re-close the labels by connected components (only with a halo), add
the block's id offset ``block_id * prod(block_shape)``, write.  The split
batch protocol reads the halo'd blocks on host threads (edge blocks padded
to the static batch shape by ``_pad_block``, a ``valid`` mask marking real
voxels), computes a whole batch as one (B, Z, H, W) tensor on the
configured device — in the 2d mode kernel 2 plus the size filter's kernel-1
re-flood on the card, in the other modes the plain steps and the 3d flood —
and writes on a host thread.  ``MAX_IDS_KEY`` holds each block's largest
written id.  The upload goes through the device-buffer cache when it is on
(``runtime/hbm.py``), and the task is a member of fused chains
(``runtime/stream.py``), its halo the chain's shared read.

``WatershedFromSeedsTask``, per halo'd block: smooth the boundary map,
flood it from the block's global seed ids (compacted to int32 for the
device and mapped back), optionally size-filter, write the inner box.  It
has no batch protocol: the ``cuda`` target runs ``process_block`` in
``max_jobs`` host threads.

``AgglomerateTask``, per block (host, no batch protocol): the block's
fragments merged below a threshold on their mean boundary evidence, each
merged fragment named by its smallest member id, so ids stay in the
block's offset namespace.

``TwoPassWatershedTask``, one pass of the checkerboard two-pass watershed:
pass 0 is ``WatershedTask`` on the white blocks; pass 1 floods the black
blocks from the labels pass 0 wrote into their halo as well as from their
own seeds (``two_pass_flood`` on the device over the stacked batch), so
segments continue across block faces.  Pass 1 reads what other blocks
write, so its batches run one at a time (``pipeline_safe``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.cc import connected_components_labels
from ..ops.filters import gaussian
from ..ops.multicut import agglomerative_clustering
from ..ops.rag import boundary_edge_features
from ..obs import metrics as obs_metrics
from ..ops.watershed import apply_size_filter, dt_watershed, seeded_watershed, two_pass_flood
from ..parallel.dispatch import BlockBatch
from ..runtime import hbm
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking, make_checkerboard_block_lists
from .base import VolumeTask, fusion_wrap, read_threads

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
    # a fused chain member: its halo'd reads are the chain's shared read, and
    # members with smaller halos take crops of them
    fusable = True

    def __init__(self, *args, mask_path: str = None, mask_key: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mask_path = mask_path
        self.mask_key = mask_key

    def fusion_halo(self, config):
        return tuple(config.get("halo") or [0, 0, 0])

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
        mask_ds = fusion_wrap(store.file_reader(self.mask_path, "r")[self.mask_key],
                              self.mask_path, self.mask_key)
        return np.stack([
            _pad_block(mask_ds[bh.outer.slicing].astype(bool), full_shape)
            for bh in blocks
        ])

    # -- split batch protocol ---------------------------------------------------

    def _read_tag(self, config):
        """What changes the uploaded bytes beyond the store region: the
        channel window and its agglomeration (the normalisation follows the
        dtype)."""
        return ("ws-read", str(config.get("channel_begin", 0)), str(config.get("channel_end")),
                str(config.get("agglomerate_channels", "mean")))

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the halo'd blocks padded to one static shape, their
        ``valid`` masks, and the optional mask batch.  When the batch's upload
        is resident in the device-buffer cache, the host read is skipped and
        the batch carries the geometry only."""
        in_ds = self.input_ds()
        halo = config.get("halo") or [0, 0, 0]
        full_shape = tuple(bs + 2 * h for bs, h in zip(blocking.block_shape, halo))
        blocks = [blocking.block_with_halo(bid, halo) for bid in block_ids]
        source = hbm.dataset_source(in_ds, self.input_path, self.input_key, blocking,
                                    list(block_ids), halo, self._read_tag(config), config)
        dc = hbm.cache() if source is not None else None
        hit = dc.get(source) if dc is not None else None
        if hit is not None:
            obs_metrics.inc("device.uploads_skipped")
            batch = BlockBatch(data=None, valid=None, blocks=blocks, block_ids=list(block_ids),
                               source=source, device=hit)
            return batch, None, self._load_mask_batch(blocks, full_shape)
        datas, valids = [], []
        for bh in blocks:
            arr = _read_input_block(in_ds, bh.outer.slicing, config)
            datas.append(_pad_block(arr, full_shape))
            valids.append(_pad_block(np.ones(arr.shape, dtype=bool), full_shape, "zero"))
        batch = BlockBatch(data=np.stack(datas), valid=None, blocks=blocks,
                           block_ids=list(block_ids), source=source)
        return batch, np.stack(valids), self._load_mask_batch(blocks, full_shape)

    def _device_payload(self, batch, valid, config) -> hbm.DeviceBatch:
        """``(data, valid)`` on the device, one entry of the buffer cache:
        both follow from the signed store region and the geometry.  The
        mask (its own dataset) is copied uncached at each compute."""
        def build():
            data = hbm.require_data(batch)
            dev = resolve_device(config)
            return hbm.DeviceBatch(
                arrays=(torch.from_numpy(data).to(dev), torch.from_numpy(valid).to(dev)),
                n=len(batch.block_ids), nbytes=int(data.nbytes + valid.nbytes))

        return hbm.batch_device(batch, config, build=build)

    def upload_batch(self, payload, blocking: Blocking, config):
        """The transfer stage: batch k+1 crosses to the device while batch
        k floods."""
        batch, valid, _ = payload
        self._device_payload(batch, valid, config)
        return payload

    def stack_payloads(self, payloads, blocking: Blocking, config):
        batch = hbm.stack_block_batches([p[0] for p in payloads], config)
        valids = [p[1] for p in payloads]
        masks = [p[2] for p in payloads]
        return (batch,
                np.concatenate(valids, axis=0) if all(v is not None for v in valids) else None,
                np.concatenate(masks, axis=0) if all(m is not None for m in masks) else None)

    def unstack_results(self, result, counts, blocking: Blocking, config):
        batch, labels = result
        return list(zip(hbm.split_block_batch(batch, counts), hbm.split_stacked(labels, counts)))

    def compute_batch(self, payload, blocking: Blocking, config):
        """Stage 2 (device): the DT-watershed of the whole batch, then, with a
        halo, the crop to the inner box and the CC re-close."""
        batch, valid, mask = payload
        halo = config.get("halo") or [0, 0, 0]
        x, v = self._device_payload(batch, valid, config).arrays
        m = None if mask is None else torch.from_numpy(mask).to(x.device)
        labels, _ = dt_watershed(x, mask=m, valid=v, **kernel_params(config))
        if any(h > 0 for h in halo):
            bs = tuple(blocking.block_shape)
            labels = torch.stack([
                lab[tuple(slice(s, s + n) for s, n in zip(bh.inner_local.begin, bs))]
                for lab, bh in zip(labels, batch.blocks)
            ])
            labels, _ = connected_components_labels(labels)
        return batch, labels.cpu().numpy().astype(np.uint64)

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): block-id offsets, per-block max ids, inner boxes."""
        batch, labels = result
        out_ds = self.output_ds()
        has_halo = any(h > 0 for h in (config.get("halo") or [0, 0, 0]))
        offset_unit = int(np.prod(blocking.block_shape))
        max_ids = self.tmp_ragged(MAX_IDS_KEY, blocking.n_blocks, np.int64)
        for bid, bh, lab in zip(batch.block_ids, batch.blocks, labels):
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


class AgglomerateTask(VolumeTask):
    """Per-block agglomeration of watershed fragments: the block's RAG with
    mean boundary-evidence edge weights, fragments merged below
    ``threshold`` (mala clustering semantics).  ``input_path/key`` is the
    boundary map, ``labels_path/key`` the fragments."""

    task_name = "agglomerate"
    output_dtype = "uint64"

    def __init__(self, *args, labels_path: str = None, labels_key: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.labels_path = labels_path
        self.labels_key = labels_key

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({
            "threshold": 0.9,
            "use_mala_agglomeration": True,
            "channel_begin": 0,
            "channel_end": None,
            "agglomerate_channels": "mean",
            "invert_inputs": False,
        })
        return conf

    def process_block(self, block_id: int, blocking: Blocking, config):
        bb = blocking.block(block_id).slicing
        seg = store.file_reader(self.labels_path, "r")[self.labels_key][bb].astype(np.uint64)
        out_ds = self.output_ds()
        uniq = np.unique(seg)
        uniq = uniq[uniq > 0]
        if uniq.size == 0:
            out_ds[bb] = seg
            return
        x = _read_input_block(self.input_ds(), bb, config)
        if config.get("invert_inputs", False):
            x = 1.0 - x
        edges, feats = boundary_edge_features(seg, x.astype(np.float64))
        if edges.shape[0] == 0:
            out_ds[bb] = seg
            return
        clusters = agglomerative_clustering(
            uniq.size,
            np.searchsorted(uniq, edges).astype(np.int64),  # compact node ids
            feats[:, 0],  # mean boundary evidence
            float(config.get("threshold", 0.9)),
            edge_sizes=feats[:, 9],  # face size
        )
        # a merged fragment takes its smallest member's id
        rep = np.full(int(clusters.max()) + 1, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(rep, clusters, np.arange(uniq.size, dtype=np.int64))
        lookup = np.concatenate([[np.uint64(0)], uniq[rep[clusters]]]).astype(np.uint64)
        dense = np.where(seg > 0, np.searchsorted(uniq, seg) + 1, 0)
        out_ds[bb] = lookup[dense]


class TwoPassWatershedTask(WatershedTask):
    """One pass of the checkerboard two-pass watershed: ``pass_id`` 0 runs
    the white blocks as ``WatershedTask``; ``pass_id`` 1 the black blocks,
    seeded also from the labels already written inside their halo."""

    task_name = "two_pass_watershed"
    # pass 1 reads labels its own run writes: never fuse it into a stream
    fusable = False

    def __init__(self, *args, pass_id: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.pass_id = pass_id

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf["non_maximum_suppression"] = True  # where WatershedTask defaults it off
        return conf

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_pass{self.pass_id}"

    @property
    def pipeline_safe(self) -> bool:
        # pass 1's halo'd reads overlap the inner boxes of same-colour
        # diagonal neighbours of the same run: batches must not overlap
        return self.pass_id == 0

    def get_block_list(self, blocking: Blocking, gconf: Dict[str, Any]) -> List[int]:
        white, black = make_checkerboard_block_lists(blocking, super().get_block_list(blocking, gconf))
        return white if self.pass_id == 0 else black

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Pass 1, stage 1 (host): the halo'd blocks and the labels written
        inside them, compacted per block to int32 1..k, padded to one
        static shape; their ``valid`` masks and the optional mask batch."""
        if self.pass_id == 0:
            return super().read_batch(block_ids, blocking, config)
        halo = config.get("halo") or [0, 0, 0]
        if not any(h > 0 for h in halo):
            raise ValueError(
                "two-pass watershed requires a non-zero halo — pass 2 seeds from "
                "pass-1 neighbors inside the halo (set 'halo' in the task config)"
            )
        in_ds, out_ds = self.input_ds(), self.output_ds()
        full_shape = tuple(bs + 2 * h for bs, h in zip(blocking.block_shape, halo))
        blocks = [blocking.block_with_halo(bid, halo) for bid in block_ids]

        def _read(bh):
            x = _read_input_block(in_ds, bh.outer.slicing, config)
            written = out_ds[bh.outer.slicing].astype(np.int64)
            uniq = np.unique(written)
            uniq = uniq[uniq > 0]
            compact = np.where(written > 0, np.searchsorted(uniq, written) + 1, 0).astype(np.int32)
            return (
                _pad_block(x, full_shape), _pad_block(compact, full_shape, "zero"),
                _pad_block(np.ones(x.shape, dtype=bool), full_shape, "zero"), uniq,
            )

        # the batch reads before it writes, so its blocks read in parallel
        n_threads = min(read_threads(config), len(blocks))
        if n_threads > 1:
            with ThreadPoolExecutor(n_threads) as pool:
                parts = list(pool.map(_read, blocks))
        else:
            parts = [_read(bh) for bh in blocks]
        datas, compacts, valids, uniqs = zip(*parts)
        return (
            list(block_ids), blocks, np.stack(datas), np.stack(compacts), np.stack(valids),
            self._load_mask_batch(blocks, full_shape), list(uniqs),
        )

    def compute_batch(self, payload, blocking: Blocking, config):
        """Pass 1, stage 2 (device): ``two_pass_flood`` over the batch."""
        if self.pass_id == 0:
            return super().compute_batch(payload, blocking, config)
        block_ids, blocks, data, written, valid, mask, uniqs = payload
        dev = resolve_device(config)
        # the size filter's label bound: own seed ids ≤ N/2 above at most
        # k written ids, which lie in the halo shell (pass-0 neighbours
        # write disjoint inner boxes)
        n_outer = int(np.prod(data.shape[1:]))
        shell = n_outer - int(np.prod(blocking.block_shape))
        k_max = max(u.size for u in uniqs)
        labels, _ = two_pass_flood(
            torch.from_numpy(data).to(dev), torch.from_numpy(written).to(dev),
            mask=None if mask is None else torch.from_numpy(mask).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            num_segments=n_outer // 2 + max(shell, k_max) + 2,
            **kernel_params(config),
        )
        return block_ids, blocks, labels.cpu().numpy().astype(np.int64), uniqs

    def write_batch(self, result, blocking: Blocking, config):
        """Pass 1, stage 3 (host): labels ≤ k back to the written ids, the
        rest into the block's offset namespace; inner boxes and max ids."""
        if self.pass_id == 0:
            return super().write_batch(result, blocking, config)
        block_ids, blocks, labels, uniqs = result
        out_ds = self.output_ds()
        offset_unit = int(np.prod(blocking.block_shape))
        max_ids = self.tmp_ragged(MAX_IDS_KEY, blocking.n_blocks, np.int64)
        for bid, bh, lab, uniq in zip(block_ids, blocks, labels, uniqs):
            k = uniq.size
            lab = lab[bh.inner_local.slicing]
            lookup = np.concatenate([[0], uniq])
            is_written = lab <= k
            written_part = lookup[np.where(is_written, lab, 0)]
            new_part = lab - k + bid * offset_unit
            lab = np.where(lab == 0, 0, np.where(is_written, written_part, new_part)).astype(np.uint64)
            out_ds[bh.inner.slicing] = lab
            max_ids.write_chunk((bid,), np.array([lab.max()], dtype=np.int64))
