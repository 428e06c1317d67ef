"""Per-segment surface meshes (port of ``cluster_tools_tpu/tasks/meshes.py``;
reference meshes/compute_meshes.py:29).

Each segment id is cropped by its morphology bounding box, meshed with the
surface-nets kernel (ops/mesh.py) and written as obj / ply / npz into the
output directory, vertex coordinates offset to global physical units."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from ..ops import mesh as mesh_ops
from ..utils.blocking import Blocking
from .morphology import IdBlockTask


class ComputeMeshesTask(IdBlockTask):
    task_name = "compute_meshes"
    output_dtype = None

    def __init__(self, *args, output_dir: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.output_dir = output_dir

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update(
            {"size_threshold": None, "resolution": [1.0, 1.0, 1.0],
             "smoothing_iterations": 0, "output_format": "obj"}
        )
        return conf

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        os.makedirs(self.output_dir, exist_ok=True)

    def process_block(self, block_id: int, blocking: Blocking, config):
        by_id = self.morphology_by_id()
        seg_ds = self.input_ds()
        shape = seg_ds.shape
        resolution = np.asarray(
            config.get("resolution", [1.0, 1.0, 1.0]), dtype=float
        )
        size_threshold = config.get("size_threshold")
        smoothing = int(config.get("smoothing_iterations", 0))
        fmt = config.get("output_format", "obj")
        if fmt == "npy":  # reference name for the numpy format; files are .npz
            fmt = "npz"
        if fmt not in ("obj", "ply", "npz"):
            raise ValueError(f"unknown mesh format {fmt!r}")

        block = blocking.block(block_id)
        for seg_id in range(max(1, block.begin[0]), block.end[0]):
            row = by_id.get(seg_id)
            if row is None:
                continue
            if size_threshold is not None and row[1] < size_threshold:
                continue
            bb = tuple(
                slice(max(int(mi), 0), min(int(ma), sh))
                for mi, ma, sh in zip(row[5:8], row[8:11], shape)
            )
            obj = np.asarray(seg_ds[bb]) == seg_id
            verts, faces, normals = mesh_ops.marching_cubes(
                obj, smoothing_iterations=smoothing
            )
            if verts.shape[0] == 0:
                continue
            offset = np.asarray([b.start for b in bb], dtype=float)
            verts = (verts + offset[None]) * resolution[None]
            if fmt == "obj":
                mesh_ops.write_obj(
                    os.path.join(self.output_dir, f"{seg_id}.obj"),
                    verts, faces, normals,
                )
            elif fmt == "ply":
                mesh_ops.write_ply(
                    os.path.join(self.output_dir, f"{seg_id}.ply"),
                    verts, faces, normals,
                )
            else:  # npz
                mesh_ops.write_numpy(
                    os.path.join(self.output_dir, f"{seg_id}.npz"),
                    verts, faces, normals,
                )
