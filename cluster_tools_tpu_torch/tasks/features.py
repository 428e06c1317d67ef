"""Edge-feature accumulation over boundary maps, affinity maps or a filter
bank (port of ``cluster_tools_tpu/tasks/features.py``).

Reference features/{block_edge_features,merge_edge_features}.py via
nifty.distributed accumulators (SURVEY.md §2.3).  10 features per edge
(mean, var, min, q10..q90, max, count); the cross-block merge is exact for
the moment statistics, and quantiles merge through a per-edge HIST_BINS-bin
histogram sketch carried in the block partials (exact up to one bin width),
or exactly from raw samples with ``quantile_mode: "exact"`` (ops/rag.py
doc).  ``device_accumulation`` computes a block's features with the device
accumulator (``ops.rag.boundary_edge_features_gpu``) on the task's device;
the exact mode's raw samples come from the host path, as in the reference.
Affinity maps (``offsets``) accumulate on the host
(``ops.rag.affinity_edge_features``).  The filter bank (``filters`` ×
``sigmas``, ``ops.filters.apply_filter``) runs on the task's device over the
halo'd block; only the cropped responses come back to the host, where
``ops.rag.filter_edge_features`` accumulates them.

Scratch layout:
  features/ids     ragged per block: global edge ids
  features/vals    ragged per block: flattened [k,10] partial features
  features/hists   ragged per block: flattened [k, HIST_BINS] uint32 sketches
  features/samples ragged per block: raw sorted samples (exact mode)
  features/edges   [m,10] merged feature matrix
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..ops.rag import (
    HIST_BINS,
    N_FEATURES,
    affinity_edge_features,
    boundary_edge_features,
    boundary_edge_features_gpu,
    filter_edge_features,
    merge_edge_features,
    merge_edge_features_multi,
)
from ..runtime import config as cfg
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, merge_threads, read_ragged_chunks, resolve_n_blocks
from .graph import load_graph, read_block_with_upper_halo


def quantile_plan(config):
    """(exact, sketch) from quantile_mode × path — shared by the block task
    (what partials to write) and the merge task (what the partials must
    support), so the two sides cannot silently disagree.  "sketch" and
    "approx" on the filter path both mean approx (filter responses escape
    the sketch's [0,1] bin domain)."""
    mode = config.get("quantile_mode", "auto")
    if mode not in ("auto", "exact", "sketch", "approx"):
        raise ValueError(f"unknown quantile_mode {mode!r}")
    filters = config.get("filters") is not None
    exact = mode == "exact" or (mode == "auto" and filters)
    sketch = not exact and not filters and mode != "approx"
    return exact, sketch


def global_edge_ids(nodes: np.ndarray, gedges: np.ndarray, edges: np.ndarray):
    """Ids in the global graph (``nodes``, dense ``gedges``) of a block's
    label-pair ``edges``, and the mask of the pairs the graph holds."""
    pairs = np.searchsorted(nodes, edges).astype(np.int64)
    keys = gedges[:, 0] * (nodes.size + 1) + gedges[:, 1]
    want = pairs[:, 0] * (nodes.size + 1) + pairs[:, 1]
    ids = np.searchsorted(keys, want)
    valid = keys[np.clip(ids, 0, keys.size - 1)] == want
    return ids, valid


FEATURE_IDS_KEY = "features/ids"
FEATURE_VALS_KEY = "features/vals"
FEATURE_HISTS_KEY = "features/hists"
FEATURE_SAMPLES_KEY = "features/samples"
FEATURES_KEY = "features/edges"


class BlockEdgeFeaturesTask(VolumeTask):
    """Per-block edge features (reference block_edge_features.py:21).

    ``input_path/key`` is the boundary/affinity map; ``labels_path/key`` the
    segmentation whose RAG was extracted.
    """

    task_name = "block_edge_features"
    output_dtype = None

    def __init__(self, *args, labels_path: str = None, labels_key: str = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.labels_path = labels_path
        self.labels_key = labels_key

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update(
            {
                "offsets": None,  # affinity offsets, None → boundary map
                # filter-bank accumulation (reference
                # block_edge_features.py:40-41,151-238): a bank of filters
                # (ops/filters) × sigmas on the task's device, 9 stats per
                # response channel + one trailing count column
                "filters": None,
                "sigmas": None,
                "halo": [0, 0, 0],
                "apply_in_2d": False,
                "channel_agglomeration": "mean",
                # quantile merge strategy: "auto" (sketch for the 10-column
                # default path, exact raw-sample partials for the filter
                # bank), "exact" (raw samples everywhere — zero drift vs a
                # single-shot recompute), "sketch" (histogram sketch; filter
                # responses leave the sketch's [0,1] domain so the filter
                # path degrades to "approx"), or "approx" (count-weighted
                # quantile averaging — smallest partials, largest drift)
                "quantile_mode": "auto",
                # the device accumulator (ops/rag.boundary_edge_features_gpu)
                # on the task's device for the sketch and approx modes
                "device_accumulation": False,
                "max_edges_per_block": 16384,
            }
        )
        return conf

    def labels_ds(self):
        return store.file_reader(self.labels_path, "r")[self.labels_key]

    def _filter_responses(self, blocking: Blocking, block_id: int, config):
        """Halo'd read → filter bank on the task's device → per-channel
        responses cropped to the inner(+1-upper-halo) region, copied to the
        host as float64 (reference block_edge_features.py:172-238 via
        vu.apply_filter).

        Unlike the reference's per-block min-max ``vu.normalize`` this uses
        the task's deterministic normalization (uint8 → /255, floats raw), so
        blocked responses equal a single-shot whole-volume recompute wherever
        the halo covers the filter support."""
        import torch

        from ..ops import filters as F

        block = blocking.block(block_id)
        shape = blocking.shape
        halo = [int(h) for h in (config.get("halo") or [0, 0, 0])]
        # the accumulated region carries a +1 upper halo (cross-block faces
        # are owned by the lower block), so the upper read extends halo + 1:
        # even the +1-slab voxels then see the full filter support
        ob = [max(b - h, 0) for b, h in zip(block.begin, halo)]
        oe = [min(e + h + 1, s) for e, h, s in zip(block.end, halo, shape)]
        bb = tuple(slice(b, e) for b, e in zip(ob, oe))
        data_ds = self.input_ds()
        if len(data_ds.shape) == 4:
            # agglomerate over ALL channels (the reference hardcodes the
            # first three, block_edge_features.py:214-215 — a marked TODO
            # there; silent truncation is worse than the divergence)
            data = self._normalize(data_ds[(slice(None),) + bb])
            agglo = config.get("channel_agglomeration") or "mean"
            data = getattr(np, agglo)(data, axis=0)
        else:
            data = self._normalize(data_ds[bb])
        ie = [min(e + 1, s) for e, s in zip(block.end, shape)]
        local = tuple(
            slice(b - o, e - o) for b, o, e in zip(block.begin, ob, ie)
        )
        if not config.get("sigmas"):
            raise ValueError(
                "filter-bank accumulation needs 'sigmas' (a list of filter "
                "scales) alongside 'filters' in the block_edge_features "
                "config (reference block_edge_features.py:312)"
            )
        responses = []
        x = torch.from_numpy(data.astype(np.float32)).to(resolve_device(config))
        in_2d = bool(config.get("apply_in_2d", False))
        for name in config["filters"]:
            for sigma in config["sigmas"]:
                resp = F.apply_filter(x, name, sigma, apply_in_2d=in_2d)
                if resp.dim() == 4:  # multichannel filters: channels last
                    resp = resp[local].movedim(-1, 0).cpu().numpy()
                    responses.extend(c.astype(np.float64) for c in resp)
                else:
                    responses.append(resp[local].cpu().numpy().astype(np.float64))
        return responses

    def process_block(self, block_id: int, blocking: Blocking, config):
        seg = read_block_with_upper_halo(
            self.labels_ds(), blocking, block_id
        ).astype(np.uint64)
        offsets = config.get("offsets")
        block = blocking.block(block_id)
        end = tuple(min(e + 1, s) for e, s in zip(block.end, blocking.shape))
        bb = tuple(slice(b, e) for b, e in zip(block.begin, end))
        exact, sketch = quantile_plan(config)
        hist_bins = HIST_BINS if sketch else 0
        hists = samples = None
        if config.get("filters") is not None:
            if offsets is not None:
                raise ValueError(
                    "filters and offsets are mutually exclusive "
                    "(reference block_edge_features.py:311)"
                )
            responses = self._filter_responses(blocking, block_id, config)
            out = filter_edge_features(
                seg, responses, owner_shape=block.shape, return_samples=exact
            )
            edges, feats = out[0], out[1]
            if exact:
                samples = out[2]
        elif offsets is not None:
            data = self._normalize(self.input_ds()[(slice(0, len(offsets)),) + bb])
            out = affinity_edge_features(
                seg, data, offsets, hist_bins=hist_bins,
                owner_shape=block.shape, return_samples=exact,
            )
            edges, feats = out[0], out[1]
            if exact:
                samples = out[2]
            elif sketch:
                hists = out[2]
        elif config.get("device_accumulation") and not exact:
            data = self._normalize(self.input_ds()[bb])
            edges, feats, hists = boundary_edge_features_gpu(
                seg, data, hist_bins=HIST_BINS, owner_shape=block.shape,
                max_edges=int(config.get("max_edges_per_block", 16384)),
                device=resolve_device(config),
            )
            if not sketch:
                hists = None
        else:
            data = self._normalize(self.input_ds()[bb])
            out = boundary_edge_features(
                seg, data, hist_bins=hist_bins, owner_shape=block.shape,
                return_samples=exact,
            )
            edges, feats = out[0], out[1]
            if exact:
                samples = out[2]
            elif sketch:
                hists = out[2]

        scratch = self.tmp_store()
        nodes, gedges = load_graph(scratch)
        ids_out = self.tmp_ragged(FEATURE_IDS_KEY, blocking.n_blocks, np.int64)
        vals_out = self.tmp_ragged(FEATURE_VALS_KEY, blocking.n_blocks, np.float64)
        hists_out = self.tmp_ragged(FEATURE_HISTS_KEY, blocking.n_blocks, np.uint32)
        # keep the samples dataset in lockstep even when this run does not
        # produce samples: a previous exact-mode run's stale chunks must not
        # poison this run's merge (empty chunk ⇒ merge rejects exact path)
        samples_out = (
            self.tmp_ragged(FEATURE_SAMPLES_KEY, blocking.n_blocks, np.float64)
            if (samples is not None or FEATURE_SAMPLES_KEY in scratch)
            else None
        )
        if edges.shape[0] == 0:
            ids_out.write_chunk((block_id,), np.array([], dtype=np.int64))
            vals_out.write_chunk((block_id,), np.array([], dtype=np.float64))
            hists_out.write_chunk((block_id,), np.array([], dtype=np.uint32))
            if samples_out is not None:
                samples_out.write_chunk(
                    (block_id,), np.array([], dtype=np.float64)
                )
            return
        ids, valid = global_edge_ids(nodes, gedges, edges)
        ids_out.write_chunk((block_id,), ids[valid].astype(np.int64))
        vals_out.write_chunk((block_id,), feats[valid].reshape(-1))
        hists_out.write_chunk(
            (block_id,),
            hists[valid].reshape(-1) if hists is not None
            else np.array([], dtype=np.uint32),
        )
        if samples_out is not None:
            if samples is None:
                samples_out.write_chunk(
                    (block_id,), np.array([], dtype=np.float64)
                )
            else:
                counts = feats[:, -1].astype(np.int64)
                total = int(counts.sum())
                n_groups = (feats.shape[1] - 1) // 9
                keep = np.repeat(valid, counts)
                kept = (
                    samples.reshape(n_groups, total)[:, keep].reshape(-1)
                    if total
                    else samples
                )
                samples_out.write_chunk((block_id,), kept)

    @staticmethod
    def _normalize(data: np.ndarray) -> np.ndarray:
        if data.dtype == np.uint8:
            return data.astype(np.float64) / 255.0
        return data.astype(np.float64)


class MergeEdgeFeaturesTask(VolumeSimpleTask):
    """Merge per-block partial features (reference merge_edge_features.py:17)."""

    task_name = "merge_edge_features"

    def __init__(self, *args, labels_path: str = None, labels_key: str = None,
                 **kwargs):
        super().__init__(*args, labels_path=labels_path, labels_key=labels_key,
                         **kwargs)

    def run_impl(self) -> None:
        n_blocks = resolve_n_blocks(self.config_dir, self.labels_path, self.labels_key)
        store = self.tmp_store()
        n_edges = store["graph/edges"].attrs["n_edges"]
        ids_ds = store[FEATURE_IDS_KEY]
        vals_ds = store[FEATURE_VALS_KEY]
        ids_list, feats_list, hists_list, samples_list = [], [], [], []
        n_thr = merge_threads(self)
        all_ids = read_ragged_chunks(ids_ds, n_blocks, n_thr)
        all_vals = read_ragged_chunks(vals_ds, n_blocks, n_thr)
        # sketches live in their own uint32 ragged dataset; absent for scratch
        # written before the histogram merge existed (legacy fallback)
        if FEATURE_HISTS_KEY in store:
            all_hists = read_ragged_chunks(store[FEATURE_HISTS_KEY], n_blocks, n_thr)
        else:
            all_hists = [None] * n_blocks
        # raw sorted samples: only written in exact quantile mode
        if FEATURE_SAMPLES_KEY in store:
            all_samples = read_ragged_chunks(
                store[FEATURE_SAMPLES_KEY], n_blocks, n_thr
            )
        else:
            all_samples = [None] * n_blocks
        for ids, vals, hists, samples in zip(
            all_ids, all_vals, all_hists, all_samples
        ):
            if ids is None or ids.size == 0:
                continue
            ids_list.append(ids)
            feats_list.append(vals.reshape(ids.size, -1))
            hists_list.append(
                hists.reshape(ids.size, -1)
                if hists is not None and hists.size
                else None
            )
            samples_list.append(samples)
        n_cols = next(
            (f.shape[1] for f in feats_list if f.shape[0]), N_FEATURES
        )
        widths = {f.shape[1] for f in feats_list if f.shape[0]}
        if len(widths) > 1:
            raise ValueError(
                f"mixed per-block feature widths {sorted(widths)} — stale "
                "partials from a config switch; rerun block_edge_features "
                "over all blocks"
            )
        # exact merge only when EVERY nonempty block shipped a size-consistent
        # sample partial (stale/empty chunks from a mode switch disqualify)
        n_groups = (n_cols - 1) // 9
        exact = bool(samples_list) and all(
            s is not None and s.size == n_groups * int(f[:, -1].sum())
            for s, f in zip(samples_list, feats_list)
        )
        # never silently downgrade a configured exact merge: partials from a
        # sketch-mode run (e.g. mode switched without rerunning the blocks)
        # lack usable samples
        bconf = cfg.read_config(self.config_dir, "block_edge_features")
        wants_exact, _ = quantile_plan(bconf)
        if wants_exact and not exact and ids_list:
            raise ValueError(
                "quantile_mode requests the exact merge but the block "
                "partials carry no usable sample arrays — rerun "
                "block_edge_features (clear its status) so the blocks "
                "write exact-mode partials"
            )
        if n_cols == N_FEATURES and not exact:
            merged = merge_edge_features(
                ids_list, feats_list, n_edges, hists_list
            )
        else:
            merged = merge_edge_features_multi(
                ids_list, feats_list, n_edges,
                samples_list if exact else None,
            )
        ds = store.create_dataset(
            FEATURES_KEY,
            data=merged,
            chunks=(max(merged.shape[0], 1), merged.shape[1]),
            exist_ok=True,
        )
        ds.attrs["n_features"] = int(merged.shape[1])
        self.log(
            f"merged {merged.shape[1]}-column features for {n_edges} edges"
        )
