"""Edge-feature accumulation over boundary maps (port of
``cluster_tools_tpu/tasks/features.py``, the boundary-map path).

Reference features/{block_edge_features,merge_edge_features}.py via
nifty.distributed accumulators (SURVEY.md §2.3).  10 features per edge
(mean, var, min, q10..q90, max, count); the cross-block merge is exact for
the moment statistics, and quantiles merge through a per-edge HIST_BINS-bin
histogram sketch carried in the block partials (exact up to one bin width),
or exactly from raw samples with ``quantile_mode: "exact"`` (ops/rag.py
doc).  ``device_accumulation`` computes a block's features with the device
accumulator (``ops.rag.boundary_edge_features_gpu``) on the task's device;
the exact mode's raw samples come from the host path, as in the reference.
Affinity maps (``offsets``) and the filter bank (``filters``) are ROADMAP
Queue A 6(b) and raise.

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
    boundary_edge_features,
    boundary_edge_features_gpu,
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


FEATURE_IDS_KEY = "features/ids"
FEATURE_VALS_KEY = "features/vals"
FEATURE_HISTS_KEY = "features/hists"
FEATURE_SAMPLES_KEY = "features/samples"
FEATURES_KEY = "features/edges"


class BlockEdgeFeaturesTask(VolumeTask):
    """Per-block edge features (reference block_edge_features.py:21).

    ``input_path/key`` is the boundary map; ``labels_path/key`` the
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
                "offsets": None,  # affinity offsets: ROADMAP Queue A 6(b)
                "filters": None,  # filter-bank accumulation: Queue A 6(b)
                # quantile merge strategy: "auto" (the histogram sketch on the
                # boundary-map path), "exact" (raw samples — zero drift vs a
                # single-shot recompute), "sketch", or "approx" (count-weighted
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

    def process_block(self, block_id: int, blocking: Blocking, config):
        for key in ("offsets", "filters"):
            if config.get(key) is not None:
                raise NotImplementedError(
                    f"block_edge_features {key!r} is not ported yet (ROADMAP "
                    "Queue A 6(b)); the port accumulates boundary maps only"
                )
        seg = read_block_with_upper_halo(
            self.labels_ds(), blocking, block_id
        ).astype(np.uint64)
        block = blocking.block(block_id)
        end = tuple(min(e + 1, s) for e, s in zip(block.end, blocking.shape))
        bb = tuple(slice(b, e) for b, e in zip(block.begin, end))
        exact, sketch = quantile_plan(config)
        hist_bins = HIST_BINS if sketch else 0
        hists = samples = None
        data = self._normalize(self.input_ds()[bb])
        if config.get("device_accumulation") and not exact:
            edges, feats, hists = boundary_edge_features_gpu(
                seg, data, hist_bins=HIST_BINS, owner_shape=block.shape,
                max_edges=int(config.get("max_edges_per_block", 16384)),
                device=resolve_device(config),
            )
            if not sketch:
                hists = None
        else:
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
        pairs = np.searchsorted(nodes, edges).astype(np.int64)
        keys = gedges[:, 0] * (nodes.size + 1) + gedges[:, 1]
        want = pairs[:, 0] * (nodes.size + 1) + pairs[:, 1]
        ids = np.searchsorted(keys, want)
        valid = keys[np.clip(ids, 0, keys.size - 1)] == want
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
