"""Scale pyramids: block-wise down/up-scaling and boundary-fitted rescaling
(port of ``cluster_tools_tpu/tasks/downscaling.py``).

Reference downscaling/{downscaling,upscaling,scale_to_boundaries}.py: the
blocking is over the *output* volume; each output block reads its scaled
input footprint, resamples on the task's device (``ops/resample.py``), and
writes its inner region.  Non-interpolatable dtypes (integer labels) force
order-0 sampling (reference downscaling.py:54,99-106), which stays on the
host (a strided slice or ``np.repeat``), so uint64 ids are never narrowed.
``ScaleToBoundariesTask`` refits through ``ops/watershed.py::fit_to_hmap``:
the 3d flood kernel, warm-started by kernel 3 when ``CTT_FLOOD_TILE`` is set.
"""

from __future__ import annotations

from math import ceil
from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..ops import resample
from ..runtime.device import resolve_device
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask

INTERPOLATABLE = ("float32", "float64", "uint8", "uint16")


def _on_device(vol: np.ndarray, dev) -> torch.Tensor:
    """A host block as a tensor on ``dev``; float64 is rounded to float32
    and uint16 widened on the host (as the JAX package's float32 cast)."""
    if vol.dtype == np.float64:
        vol = vol.astype(np.float32)
    elif vol.dtype == np.uint16:
        vol = vol.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(vol)).to(dev)


class DownscalingTask(VolumeTask):
    """One pyramid level: input at scale s-1 → output at scale s
    (reference downscaling.py:36)."""

    task_name = "downscaling"

    def __init__(
        self,
        *args,
        scale_factor=2,
        scale_prefix: str = "",
        halo: Sequence[int] = (),
        effective_scale_factor: Sequence[int] = (),
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.scale_factor = scale_factor
        self.scale_prefix = scale_prefix
        self.halo = list(halo)
        self.effective_scale_factor = list(effective_scale_factor)

    @property
    def identifier(self) -> str:
        return (
            f"{self.task_name}_{self.scale_prefix}"
            if self.scale_prefix
            else self.task_name
        )

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"library": "interpolate", "chunks": None,
                     "compression": "gzip", "library_kwargs": None})
        return conf

    def _method(self, config) -> str:
        method = resample.METHOD_ALIASES.get(
            config.get("library", "interpolate"), config.get("library", "interpolate")
        )
        kwargs = config.get("library_kwargs") or {}
        if kwargs.get("order") == 0:
            method = "nearest"
        dtype = str(self.input_ds().dtype)
        if dtype not in INTERPOLATABLE and method not in resample.ORDER0_METHODS:
            # labels cannot be interpolated — the reference asserts here
            # (downscaling.py:99-106); we fall back with a log line instead
            self.log(f"dtype {dtype} is not interpolatable; forcing nearest")
            method = "nearest"
        return method

    # -- geometry: blocking is over the DOWNSAMPLED shape --------------------

    def _sf(self):
        return resample.per_axis_factor(self.scale_factor, 3)

    def get_shape(self) -> Sequence[int]:
        in_shape = self.input_ds().shape
        space = in_shape[-3:] if len(in_shape) > 3 else in_shape
        return resample.downscale_shape(space, self._sf())

    def _roi_divisor(self):
        """The global ROI is in full-resolution voxels; this task's blocking is
        at the (cumulative) downscaled resolution."""
        eff = self.effective_scale_factor or list(self._sf())
        return [int(e) for e in eff]

    def get_block_list(self, blocking: Blocking, gconf: Dict[str, Any]):
        gconf = dict(gconf)
        div = self._roi_divisor()
        if gconf.get("roi_begin") is not None:
            gconf["roi_begin"] = [
                rb // d for rb, d in zip(gconf["roi_begin"], div)
            ]
        if gconf.get("roi_end") is not None:
            gconf["roi_end"] = [
                -(-re // d) for re, d in zip(gconf["roi_end"], div)
            ]
        return super().get_block_list(blocking, gconf)

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        in_ds = self.input_ds()
        out_shape = tuple(blocking.shape)
        if len(in_ds.shape) == 4:
            out_shape = (in_ds.shape[0],) + out_shape
        chunks = config.get("chunks")
        chunks = tuple(blocking.block_shape) if chunks is None else tuple(chunks)
        if len(out_shape) == 4 and len(chunks) == 3:
            chunks = (1,) + chunks
        chunks = tuple(min(c, s) for c, s in zip(chunks, out_shape))
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=out_shape,
            dtype=str(in_ds.dtype),
            chunks=chunks,
            compression=config.get("compression", "gzip"),
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        sf = self._sf()
        method = self._method(config)
        in_ds = self.input_ds()
        out_ds = self.output_ds()
        in_shape = in_ds.shape
        in_space = in_shape[-3:] if len(in_shape) > 3 else in_shape

        halo = [h // f for h, f in zip(self.halo, sf)] if self.halo else None
        if halo:
            bh = blocking.block_with_halo(block_id, halo)
            out_box, read_box, local = bh.inner, bh.outer, bh.inner_local
        else:
            blk = blocking.block(block_id)
            out_box = read_box = blk
            local = None

        in_bb = tuple(
            slice(b.start * f, min(b.stop * f, s))
            for b, f, s in zip(read_box.slicing, sf, in_space)
        )
        is_4d = len(in_shape) == 4
        x = np.asarray(in_ds[((slice(None),) + in_bb) if is_4d else in_bb])
        if not np.any(x):
            return  # empty block (reference _ds_block)

        dev = resolve_device(config)

        def _one(vol):
            if method == "nearest":
                # pure strided subsample — stays on the host, uint64 ids exact
                return vol[tuple(slice(None, None, f) for f in sf)]
            out = resample.downscale(_on_device(vol, dev), sf, method)
            return resample.cast_resampled(out, in_ds.dtype)

        out = np.stack([_one(c) for c in x]) if is_4d else _one(x)
        if local is not None:
            sl = local.slicing
            out = out[((slice(None),) + sl) if is_4d else sl]
        out_bb = out_box.slicing
        # clip to the true downscaled extent (resample may ceil-round)
        want = tuple(b.stop - b.start for b in out_bb)
        crop = tuple(slice(0, w) for w in want)
        out = out[((slice(None),) + crop) if is_4d else crop]
        out_ds[((slice(None),) + out_bb) if is_4d else out_bb] = out


class UpscalingTask(DownscalingTask):
    """Inverse pyramid step (reference upscaling.py:35): blocking over the
    UPSAMPLED shape; each output block reads its floor/ceil-scaled input
    footprint and resizes up."""

    task_name = "upscaling"

    def get_shape(self) -> Sequence[int]:
        in_shape = self.input_ds().shape
        space = in_shape[-3:] if len(in_shape) > 3 else in_shape
        sf = self._sf()
        return tuple(s * f for s, f in zip(space, sf))

    def get_block_list(self, blocking: Blocking, gconf: Dict[str, Any]):
        # the ROI is given in the coarse source coordinates here — scale it UP
        # to the output resolution (reference upscaling.py:146-157)
        gconf = dict(gconf)
        eff = self.effective_scale_factor
        if eff:
            if gconf.get("roi_begin") is not None:
                gconf["roi_begin"] = [
                    int(rb * e) for rb, e in zip(gconf["roi_begin"], eff)
                ]
            if gconf.get("roi_end") is not None:
                gconf["roi_end"] = [
                    int(re * e) for re, e in zip(gconf["roi_end"], eff)
                ]
        return super(DownscalingTask, self).get_block_list(blocking, gconf)

    def process_block(self, block_id: int, blocking: Blocking, config):
        sf = self._sf()
        method = self._method(config)
        in_ds = self.input_ds()
        out_ds = self.output_ds()
        in_shape = in_ds.shape
        in_space = in_shape[-3:] if len(in_shape) > 3 else in_shape

        blk = blocking.block(block_id)
        out_bb = blk.slicing
        in_bb = tuple(
            slice(b.start // f, min(ceil(b.stop / f), s))
            for b, f, s in zip(out_bb, sf, in_space)
        )
        is_4d = len(in_shape) == 4
        x = np.asarray(in_ds[((slice(None),) + in_bb) if is_4d else in_bb])
        if not np.any(x):
            return
        out_shape = tuple(b.stop - b.start for b in out_bb)
        dev = resolve_device(config)

        def _one(vol):
            # resize the input footprint so that voxel centers align: the
            # footprint covers [start*f, stop*f); crop the output window
            full = tuple(s * f for s, f in zip(vol.shape, sf))
            off = tuple(b.start - ib.start * f
                        for b, ib, f in zip(out_bb, in_bb, sf))
            sl = tuple(slice(o, o + w) for o, w in zip(off, out_shape))
            if method == "nearest":
                # host-side repeat: keeps uint64 label ids exact (no x64 on
                # device) and is a pure memory op anyway
                up = vol
                for ax, f in enumerate(sf):
                    up = np.repeat(up, f, axis=ax)
                return up[sl].astype(in_ds.dtype, copy=False)
            up = resample.upscale(_on_device(vol, dev), full, method)
            return resample.cast_resampled(up[sl], in_ds.dtype)

        out = np.stack([_one(c) for c in x]) if is_4d else _one(x)
        out_ds[((slice(None),) + out_bb) if is_4d else out_bb] = out


class ScaleToBoundariesTask(VolumeTask):
    """Rescale coarse objects to a full-resolution boundary map: upscale
    nearest, erode, re-grow with a seeded watershed on the boundary height map
    (reference scale_to_boundaries.py:32 + volume_utils.fit_to_hmap:336)."""

    task_name = "scale_to_boundaries"
    output_dtype = "uint64"

    def __init__(self, *args, boundaries_path: str = None,
                 boundaries_key: str = None, offset: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.boundaries_path = boundaries_path
        self.boundaries_key = boundaries_key
        self.offset = offset

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"erode_by": 12, "erode_3d": True, "channel": 0})
        return conf

    def get_shape(self) -> Sequence[int]:
        shape = store.file_reader(self.boundaries_path, "r")[
            self.boundaries_key
        ].shape
        return shape[-3:] if len(shape) > 3 else shape

    def _halo(self, config):
        erode_by = config["erode_by"]
        h = int(erode_by) if not isinstance(erode_by, dict) else max(
            erode_by.values()
        )
        return [h, h, h] if config.get("erode_3d", True) else [0, h, h]

    def process_block(self, block_id: int, blocking: Blocking, config):
        from ..ops.watershed import fit_to_hmap

        erode_by = config["erode_by"]
        if isinstance(erode_by, dict):
            erode_by = max(erode_by.values())  # per-object radii: use the max
        erode_by = int(erode_by)
        channel = int(config.get("channel", 0))

        bh = blocking.block_with_halo(block_id, self._halo(config))
        in_bb = bh.outer.slicing

        bd_ds = store.file_reader(self.boundaries_path, "r")[self.boundaries_key]
        in_ds = self.input_ds()
        shape = tuple(blocking.shape)

        # objects may live at a coarser resolution — map the bb through
        # nearest-neighbor index scaling (reference wraps ds_in in ResizedVolume)
        obj_shape = in_ds.shape
        idx = tuple(
            np.minimum(
                (np.arange(b.start, b.stop) * os_ // s).astype(np.int64), os_ - 1
            )
            for b, os_, s in zip(in_bb, obj_shape, shape)
        )
        slab = np.asarray(in_ds[
            tuple(slice(int(i[0]), int(i[-1]) + 1) for i in idx)
        ])
        objs = slab[np.ix_(*(i - i[0] for i in idx))].astype(np.uint64)
        if not np.any(objs):
            return

        if len(bd_ds.shape) == 4:
            hmap = np.asarray(bd_ds[(slice(channel, channel + 1),) + in_bb])[0]
        else:
            hmap = np.asarray(bd_ds[in_bb])

        fitted = fit_to_hmap(
            objs, _on_device(hmap, resolve_device(config)), erode_by,
            config.get("erode_3d", True),
        )[bh.inner_local.slicing]

        fg = fitted != 0
        out_ds = self.output_ds()
        out = np.asarray(out_ds[bh.inner.slicing])
        out[fg] = fitted[fg] + self.offset
        out_ds[bh.inner.slicing] = out
