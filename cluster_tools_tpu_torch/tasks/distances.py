"""Pairwise object distances (port of ``cluster_tools_tpu/tasks/distances.py``;
reference distances/object_distances.py:31).

Per segment id: crop the morphology bounding box, run the Euclidean DT of the
object (``ops/dt.py::distance_transform`` with the resolution as pixel pitch on
the task's device, bit for bit the JAX package's EDT), enlarge the box adaptively
when a face is closer than ``max_distance`` (reference ``_enlarge_bb``:132-153),
then the min DT value per other object inside the box is the pairwise
distance.  Pairs above ``max_distance`` are dropped; a merge task combines the
per-id-chunk dictionaries taking elementwise minima."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..ops.dt import distance_transform
from ..runtime.device import resolve_device
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask
from .morphology import IdBlockTask

DISTANCES_KEY = "distances/pairs"
DISTANCES_NAME = "object_distances.npz"


def _face_distances(dist: np.ndarray):
    """Min DT on each bounding-box face, ordered (z0, z1, y0, y1, x0, x1)."""
    return [
        float(dist[0].min()), float(dist[-1].min()),
        float(dist[:, 0].min()), float(dist[:, -1].min()),
        float(dist[:, :, 0].min()), float(dist[:, :, -1].min()),
    ]


def _enlarge_bb(bb, face_distances, resolution, shape, max_distance):
    enlarged = []
    face_id = 0
    for dim, b in enumerate(bb):
        start, stop = b.start, b.stop
        res = resolution[dim]
        fdist = face_distances[face_id]
        if fdist < max_distance:
            start = max(int(start - (max_distance - fdist) / res), 0)
        face_id += 1
        fdist = face_distances[face_id]
        if fdist < max_distance:
            stop = min(int(stop + (max_distance - fdist) / res), shape[dim])
        face_id += 1
        enlarged.append(slice(start, stop))
    return tuple(enlarged)


def object_distances_for_id(seg_ds, label_id, bb, resolution, max_distance, device="cuda"):
    """{(label_id, other_id): min distance} for other ids within reach; the
    EDT runs on ``device``."""
    shape = seg_ds.shape

    def compute(bb):
        labels = np.asarray(seg_ds[bb])
        fg = torch.from_numpy(labels != label_id).to(device)
        dist = distance_transform(fg, pixel_pitch=resolution).cpu().numpy()
        return labels, dist

    # the object touches every face of its own bounding box, so the reach
    # test always triggers — enlarge by the full reach up front and run the
    # DT once (the reference computes a throwaway first DT here,
    # object_distances.py:155-167)
    bb = _enlarge_bb(bb, [0.0] * 6, resolution, shape, max_distance)
    labels, dist = compute(bb)

    others = np.unique(labels)
    others = others[(others != 0) & (others != label_id)]
    out = {}
    for other in others:
        if label_id >= other:
            continue
        d = float(dist[labels == other].min())
        if d < max_distance:
            out[(int(label_id), int(other))] = d
    return out


class ObjectDistancesTask(IdBlockTask):
    task_name = "object_distances"
    output_dtype = None

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"max_distance": 100.0, "resolution": [1.0, 1.0, 1.0]})
        return conf

    def process_block(self, block_id: int, blocking: Blocking, config):
        by_id = self.morphology_by_id()
        seg_ds = self.input_ds()
        shape = seg_ds.shape
        resolution = [float(r) for r in config.get("resolution", [1, 1, 1])]
        max_distance = float(config.get("max_distance", 100.0))
        device = resolve_device(config)

        block = blocking.block(block_id)
        rows = []
        for seg_id in range(max(1, block.begin[0]), block.end[0]):
            row = by_id.get(seg_id)
            if row is None:
                continue
            bb = tuple(
                slice(max(int(mi), 0), min(int(ma), sh))
                for mi, ma, sh in zip(row[5:8], row[8:11], shape)
            )
            pairs = object_distances_for_id(
                seg_ds, seg_id, bb, resolution, max_distance, device
            )
            rows.extend([a, b, d] for (a, b), d in pairs.items())
        out = self.tmp_ragged(DISTANCES_KEY, blocking.n_blocks, np.float64)
        out.write_chunk(
            (block_id,),
            np.asarray(rows, dtype=np.float64).reshape(-1),
        )


class MergeObjectDistancesTask(VolumeSimpleTask):
    task_name = "merge_object_distances"

    def __init__(self, *args, n_blocks: int = None, **kwargs):
        super().__init__(*args, n_blocks=n_blocks, **kwargs)

    def run_impl(self) -> None:
        ds = self.tmp_store()[DISTANCES_KEY]
        rows = []
        for bid in range(int(np.prod(ds.grid_shape))):
            chunk = ds.read_chunk((bid,))
            if chunk is not None and chunk.size:
                rows.append(chunk.reshape(-1, 3))
        if rows:
            all_rows = np.concatenate(rows, axis=0)
            # min per pair (a pair can be seen from both endpoint ids)
            pairs = all_rows[:, :2].astype(np.int64)
            order = np.lexsort((all_rows[:, 2], pairs[:, 1], pairs[:, 0]))
            pairs, dists = pairs[order], all_rows[order, 2]
            first = np.concatenate(
                [[True], (np.diff(pairs, axis=0) != 0).any(axis=1)]
            )
            pairs, dists = pairs[first], dists[first]
        else:
            pairs = np.zeros((0, 2), dtype=np.int64)
            dists = np.zeros(0)
        np.savez(
            os.path.join(self.tmp_folder, DISTANCES_NAME),
            pairs=pairs, distances=dists,
        )
        self.log(f"merged {pairs.shape[0]} object distance pairs")


def load_object_distances(tmp_folder: str) -> Dict:
    with np.load(os.path.join(tmp_folder, DISTANCES_NAME)) as f:
        return {
            (int(a), int(b)): float(d)
            for (a, b), d in zip(f["pairs"], f["distances"])
        }
