"""Per-segment skeletonization + skeleton-based evaluation (port of
``cluster_tools_tpu/tasks/skeletons.py``; reference
skeletons/{skeletonize,upsample_skeletons,skeleton_evaluation}.py).

The id space is blocked (a "block" = a range of segment ids, reference
skeletonize.py blocking over [n_labels]); each id is cropped out by its
morphology bounding box, skeletonized (ops/skeleton.py) and serialized as a
flat varlen record [n_nodes, nodes..., edges...] — the varlen-chunk format in
the spirit of the reference's skeleton n5 serialization.  Each object's EDT
runs on the task's device (``ops/skeleton.py``)."""

from __future__ import annotations

import os
from typing import Any, Dict, Sequence

import numpy as np

from ..ops.skeleton import skeletonize
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask
from .morphology import IdBlockTask

SKELETONS_KEY = "skeletons/objects"
SKELETON_EVAL_NAME = "skeleton_eval.npz"


def serialize_skeleton(nodes: np.ndarray, edges: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [
            [float(nodes.shape[0]), float(edges.shape[0])],
            nodes.reshape(-1),
            edges.reshape(-1).astype(float),
        ]
    )


def deserialize_skeleton(data: np.ndarray):
    n_nodes, n_edges = int(data[0]), int(data[1])
    nodes = data[2 : 2 + 3 * n_nodes].reshape(n_nodes, 3)
    edges = (
        data[2 + 3 * n_nodes : 2 + 3 * n_nodes + 2 * n_edges]
        .reshape(n_edges, 2)
        .astype(np.int64)
    )
    return nodes, edges


class SkeletonizeTask(IdBlockTask):
    task_name = "skeletonize"
    output_dtype = None

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update(
            {"size_threshold": None, "resolution": [1.0, 1.0, 1.0],
             "method": "teasar", "halo": [2, 2, 2]}
        )
        return conf

    def process_block(self, block_id: int, blocking: Blocking, config):
        by_id = self.morphology_by_id()
        seg_ds = self.input_ds()
        shape = seg_ds.shape
        resolution = config.get("resolution", [1.0, 1.0, 1.0])
        size_threshold = config.get("size_threshold")
        halo = config.get("halo", [2, 2, 2])
        device = resolve_device(config)

        block = blocking.block(block_id)
        id_begin = max(1, block.begin[0])  # 0 is the ignore label
        id_end = block.end[0]
        out = self.tmp_ragged(SKELETONS_KEY, blocking.shape[0], np.float64)
        for seg_id in range(id_begin, id_end):
            row = by_id.get(seg_id)
            if row is None:
                continue
            if size_threshold is not None and row[1] < size_threshold:
                continue
            bb = tuple(
                slice(max(int(mi) - h, 0), min(int(ma) + h, sh))
                for mi, ma, sh, h in zip(row[5:8], row[8:11], shape, halo)
            )
            obj = np.asarray(seg_ds[bb]) == seg_id
            try:
                nodes, edges = skeletonize(obj, resolution=None, device=device)
            except Exception as err:  # skip pathological objects (reference)
                self.log(f"skeletonize failed for id {seg_id}: {err}")
                continue
            # global coordinates, physical units
            nodes = (nodes + [b.start for b in bb]) * np.asarray(
                resolution, dtype=float
            )
            out.write_chunk((seg_id,), serialize_skeleton(nodes, edges))


def load_skeletons(tmp_folder: str):
    """{seg_id: (nodes [n,3] physical coords, edges [m,2])}."""
    from .base import scratch_store_path

    ds = store.file_reader(scratch_store_path(tmp_folder), "r")[SKELETONS_KEY]
    out = {}
    for (sid,) in np.ndindex(ds.grid_shape):
        chunk = ds.read_chunk((sid,))
        if chunk is not None and chunk.size:
            out[sid] = deserialize_skeleton(chunk)
    return out


class UpsampleSkeletonsTask(VolumeTask):
    """Paint skeletons into a (finer) label volume
    (reference upsample_skeletons.py:29).

    Blocks over the OUTPUT volume (not the id space) so every voxel belongs to
    exactly one block — concurrent blocks never write overlapping regions."""

    task_name = "upsample_skeletons"
    output_dtype = "uint64"

    def __init__(self, *args, output_shape: Sequence[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.output_shape = list(output_shape) if output_shape else None
        self._skel_voxels = None

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"resolution": [1.0, 1.0, 1.0]})
        return conf

    def get_shape(self) -> Sequence[int]:
        return self.output_shape or self.input_ds().shape

    def _voxels(self, config, shape):
        """All skeleton voxels (with edge midpoints) → (coords [n,3], ids [n]),
        loaded once per process."""
        if self._skel_voxels is None:
            resolution = np.asarray(config.get("resolution", [1.0, 1.0, 1.0]))
            skels = store.file_reader(self.tmp_store_path, "r")[SKELETONS_KEY]
            coords, ids = [], []
            for (sid,) in np.ndindex(skels.grid_shape):
                chunk = skels.read_chunk((sid,))
                if chunk is None or not chunk.size:
                    continue
                nodes, edges = deserialize_skeleton(chunk)
                vox = np.round(nodes / resolution[None]).astype(np.int64)
                if edges.size:
                    mids = np.round(
                        (vox[edges[:, 0]] + vox[edges[:, 1]]) / 2
                    ).astype(np.int64)
                    vox = np.concatenate([vox, mids])
                vox = np.clip(vox, 0, np.asarray(shape) - 1)
                coords.append(vox)
                ids.append(np.full(vox.shape[0], sid, dtype=np.uint64))
            if coords:
                self._skel_voxels = (
                    np.concatenate(coords), np.concatenate(ids)
                )
            else:
                self._skel_voxels = (
                    np.zeros((0, 3), np.int64), np.zeros(0, np.uint64)
                )
        return self._skel_voxels

    def process_block(self, block_id: int, blocking: Blocking, config):
        block = blocking.block(block_id)
        coords, ids = self._voxels(config, blocking.shape)
        lo = np.asarray(block.begin)
        hi = np.asarray(block.end)
        sel = ((coords >= lo) & (coords < hi)).all(axis=1)
        if not sel.any():
            return
        out_ds = self.output_ds()
        region = np.asarray(out_ds[block.slicing])
        local = coords[sel] - lo
        region[tuple(local.T)] = ids[sel]
        out_ds[block.slicing] = region


class SkeletonEvaluationTask(VolumeSimpleTask):
    """Skeleton-vs-segmentation metrics (reference skeleton_evaluation.py:26
    via nifty.ground_truth): per GT skeleton, the distribution of segmentation
    labels its nodes land on gives correctness / split / merge scores."""

    task_name = "skeleton_evaluation"

    def __init__(self, *args, skeleton_folder: str = None, seg_path: str = None,
                 seg_key: str = None, **kwargs):
        super().__init__(*args, skeleton_folder=skeleton_folder,
                         seg_path=seg_path, seg_key=seg_key, **kwargs)

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"resolution": [1.0, 1.0, 1.0]})
        return conf

    def run_impl(self) -> None:
        conf = self.get_task_config()
        resolution = np.asarray(conf.get("resolution", [1.0, 1.0, 1.0]))
        seg = store.file_reader(self.seg_path, "r")[self.seg_key]
        shape = np.asarray(seg.shape)
        skels = load_skeletons(self.skeleton_folder or self.tmp_folder)

        labels_per_skel = {}
        for sid, (nodes, _) in skels.items():
            vox = np.round(nodes / resolution[None]).astype(np.int64)
            vox = np.clip(vox, 0, shape - 1)
            # one bbox read per skeleton instead of one chunk-decompressing
            # voxel read per node
            lo = vox.min(axis=0)
            hi = vox.max(axis=0) + 1
            region = np.asarray(
                seg[tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))]
            )
            labels = region[tuple((vox - lo).T)].astype(np.uint64)
            labels_per_skel[sid] = labels[labels > 0]

        sids = sorted(labels_per_skel)
        correct = []
        n_splits = []
        seen_by_label: Dict[int, set] = {}
        for sid in sids:
            labels = labels_per_skel[sid]
            if labels.size == 0:
                correct.append(0.0)
                n_splits.append(0)
                continue
            vals, counts = np.unique(labels, return_counts=True)
            correct.append(float(counts.max() / labels.size))
            n_splits.append(int(vals.size))
            for v in vals:
                seen_by_label.setdefault(int(v), set()).add(sid)
        merges = sum(1 for v, s in seen_by_label.items() if len(s) > 1)
        np.savez(
            os.path.join(self.tmp_folder, SKELETON_EVAL_NAME),
            skeleton_ids=np.asarray(sids),
            correctness=np.asarray(correct),
            n_splits=np.asarray(n_splits),
            n_merges=np.int64(merges),
        )
        self.log(
            f"skeleton eval: {len(sids)} skeletons, mean correctness "
            f"{np.mean(correct) if correct else 0:.3f}, {merges} merged labels"
        )


def load_skeleton_evaluation(tmp_folder: str) -> Dict[str, Any]:
    with np.load(os.path.join(tmp_folder, SKELETON_EVAL_NAME)) as f:
        return {k: f[k] for k in f.files}
