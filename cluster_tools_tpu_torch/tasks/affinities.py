"""Affinity-map postprocessing and synthesis (port of
``cluster_tools_tpu/tasks/affinities.py``; reference affinities/ package).

* ``InsertAffinitiesTask`` — paste affinities derived from labeled objects into
  a predicted affinity volume: refit objects to the affinity height map,
  compute their label affinities, dilate the boundary channels, blend + clip
  (reference insert_affinities.py:33, ``_insert_affinities``:138-157).
* ``EmbeddingDistancesTask`` — per-offset distances between embedding vectors
  (reference embedding_distances.py:32).
* ``GradientsTask`` — channel-averaged central-difference gradients
  (reference gradients.py:26).

All three per-block programs are shift-and-compare / elementwise PyTorch
(ops/affinities.py) over halo'd blocks on the task's device; the object
refit of ``InsertAffinitiesTask`` floods with the 3d flood
(``ops/watershed.fit_to_hmap``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..ops import affinities as aff_ops
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask


def _offsets_halo(offsets) -> List[int]:
    return np.max(np.abs(np.asarray(offsets)), axis=0).astype(int).tolist()


class InsertAffinitiesTask(VolumeTask):
    task_name = "insert_affinities"

    def __init__(self, *args, objects_path: str = None, objects_key: str = None,
                 offsets: Sequence[Sequence[int]] = ((-1, 0, 0), (0, -1, 0), (0, 0, -1)),
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.objects_path = objects_path
        self.objects_key = objects_key
        self.offsets = [list(o) for o in offsets]

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"erode_by": 6, "erode_3d": True, "zero_objects_list": None,
                     "dilate_by": 2, "chunks": None})
        return conf

    def get_shape(self) -> Sequence[int]:
        return self.input_ds().shape[1:]

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        in_ds = self.input_ds()
        chunks = config.get("chunks") or (1,) + tuple(blocking.block_shape)
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=in_ds.shape,
            dtype=str(in_ds.dtype),
            chunks=tuple(min(c, s) for c, s in zip(chunks, in_ds.shape)),
            compression="gzip",
        )

    def _halo(self, config) -> List[int]:
        # offsets + erosion + in-plane dilation all widen the region whose
        # boundary responses can reach the inner block
        halo = _offsets_halo(self.offsets)
        erode_by = int(config["erode_by"])
        dilate_by = int(config.get("dilate_by", 2))
        if config["erode_3d"]:
            halo = [max(h, erode_by) for h in halo]
        else:
            halo = [halo[0]] + [max(h, erode_by) for h in halo[1:]]
        return [halo[0]] + [h + dilate_by for h in halo[1:]]

    def process_block(self, block_id: int, blocking: Blocking, config):
        in_ds = self.input_ds()
        out_ds = self.output_ds()
        objects = store.file_reader(self.objects_path, "r")[self.objects_key]

        bh = blocking.block_with_halo(block_id, self._halo(config))
        outer = bh.outer.slicing
        inner = (slice(None),) + bh.inner.slicing
        local = (slice(None),) + bh.inner_local.slicing

        objs = np.asarray(objects[outer]).astype(np.uint64)
        if not np.any(objs):
            out_ds[inner] = np.asarray(in_ds[inner])
            return

        dev = resolve_device(config)
        uint8 = np.dtype(in_ds.dtype) == np.dtype("uint8")
        affs = torch.from_numpy(
            np.asarray(in_ds[(slice(None),) + outer]).astype(np.float32)
        ).to(dev)
        if uint8:
            affs /= 255.0

        erode_by = int(config["erode_by"])
        if erode_by > 0:
            from ..ops.watershed import fit_to_hmap

            objs = fit_to_hmap(
                objs, affs[0].clone(), erode_by, config["erode_3d"]
            )
        obj_ids = np.unique(objs)
        obj_ids = obj_ids[obj_ids > 0]

        # object affinities in boundary convention, dilated in-plane, the z
        # channel topped up with the mean in-plane response (reference
        # _insert_affinities:138-152)
        affs_insert, mask = aff_ops.compute_affinities(objs, self.offsets, device=dev)
        affs_insert = torch.where(mask, 1.0 - affs_insert, 0.0)
        dilate_by = int(config.get("dilate_by", 2))
        if dilate_by > 0:
            affs_insert = torch.stack([
                aff_ops.binary_dilation(c, dilate_by, in_2d=True).to(torch.float32)
                for c in affs_insert
            ])
        if affs_insert.shape[0] >= 3:
            affs_insert[0] += torch.mean(affs_insert[1:3], dim=0)

        # the reference min-max-normalizes the block here (vu.normalize) — that
        # collapses uniform blocks and makes output partition-dependent; the
        # predictions are already probabilities, so clip instead
        affs = torch.clamp(affs + affs_insert, 0.0, 1.0)

        zero_list = config.get("zero_objects_list")
        if zero_list:
            for zero_id in obj_ids[np.isin(obj_ids, zero_list)]:
                zmask = aff_ops.binary_erosion(
                    torch.from_numpy(objs == zero_id).to(dev), 4
                )
                affs[:, zmask] = 0.0

        if uint8:
            affs = (affs * 255.0).to(torch.uint8)
        out_ds[inner] = affs[local].cpu().numpy().astype(in_ds.dtype, copy=False)


class EmbeddingDistancesTask(VolumeTask):
    task_name = "embedding_distances"

    def __init__(self, *args, input_paths: Sequence[str] = (),
                 input_keys: Sequence[str] = (),
                 offsets: Sequence[Sequence[int]] = ((-1, 0, 0), (0, -1, 0), (0, 0, -1)),
                 **kwargs):
        super().__init__(*args, **kwargs)
        # single-channel datasets stacked into the embedding dimension
        self.input_paths = list(input_paths) or [kwargs.get("input_path")]
        self.input_keys = list(input_keys) or [kwargs.get("input_key")]
        self.offsets = [list(o) for o in offsets]

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"norm": "l2"})
        return conf

    def get_shape(self) -> Sequence[int]:
        shape = store.file_reader(self.input_paths[0], "r")[
            self.input_keys[0]
        ].shape
        if len(shape) != 3:
            # multi-channel embedding datasets are a reference TODO too
            # (embedding_distances.py "TODO support multi-channel input data")
            raise ValueError("embedding channels must be separate 3d datasets")
        return shape

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=(len(self.offsets),) + tuple(blocking.shape),
            dtype="float32",
            chunks=(1,) + tuple(blocking.block_shape),
            compression="gzip",
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        bh = blocking.block_with_halo(block_id, _offsets_halo(self.offsets))
        outer = bh.outer.slicing
        emb = np.stack([
            np.asarray(store.file_reader(p, "r")[k][outer], dtype=np.float32)
            for p, k in zip(self.input_paths, self.input_keys)
        ])
        dist = aff_ops.embedding_distances(
            torch.from_numpy(emb).to(resolve_device(config)), self.offsets,
            config.get("norm", "l2"),
        )
        out_ds = self.output_ds()
        out_ds[(slice(None),) + bh.inner.slicing] = dist[
            (slice(None),) + bh.inner_local.slicing
        ].cpu().numpy()


class GradientsTask(VolumeTask):
    task_name = "gradients"

    def __init__(self, *args, input_paths: Sequence[str] = (),
                 input_keys: Sequence[str] = (), **kwargs):
        super().__init__(*args, **kwargs)
        self.input_paths = list(input_paths) or [kwargs.get("input_path")]
        self.input_keys = list(input_keys) or [kwargs.get("input_key")]

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"halo": [2, 2, 2], "average_gradient": True})
        return conf

    def get_shape(self) -> Sequence[int]:
        shape = store.file_reader(self.input_paths[0], "r")[
            self.input_keys[0]
        ].shape
        if len(shape) != 3:
            raise ValueError("gradient channels must be separate 3d datasets")
        return shape

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        # averaged: one 3d volume; per-channel: leading channel axis
        # (reference gradients.py _compute_average/_compute_all)
        shape = tuple(blocking.shape)
        if not config.get("average_gradient", True):
            shape = (len(self.input_paths),) + shape
            chunks = (1,) + tuple(blocking.block_shape)
        else:
            chunks = tuple(blocking.block_shape)
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key, shape=shape, dtype="float32",
            chunks=tuple(min(c, s) for c, s in zip(chunks, shape)),
            compression="gzip",
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        halo = config.get("halo", [2, 2, 2])
        average = config.get("average_gradient", True)
        bh = blocking.block_with_halo(block_id, halo)
        outer = bh.outer.slicing
        out_ds = self.output_ds()
        dev = resolve_device(config)
        grads = []
        for p, k in zip(self.input_paths, self.input_keys):
            x = np.asarray(store.file_reader(p, "r")[k][outer], dtype=np.float32)
            grads.append(aff_ops.gradient_mean(torch.from_numpy(x).to(dev)).cpu().numpy())
        local = bh.inner_local.slicing
        if average:
            out = np.mean(grads, axis=0)
            out_ds[bh.inner.slicing] = out[local]
        else:
            out = np.stack(grads)
            out_ds[(slice(None),) + bh.inner.slicing] = out[
                (slice(None),) + local
            ]
