"""Block-wise volume copy with dtype cast, channel reduction and insert mode
(port of ``cluster_tools_tpu/tasks/copy_volume.py``).

Re-expression of the reference's copy_volume component
(reference copy_volume/copy_volume.py:27 ``CopyVolumeBase``): per block it can
  * cast dtype (uint8 gets normalize→*255 treatment),
  * keep only values in a ``value_list`` (everything else → 0),
  * skip empty / uniform blocks,
  * reduce a leading channel axis (``reduce_channels`` = numpy reduction name),
  * add a constant label ``offset`` to non-zero values,
  * ``insert_mode``: write only where the copied data is non-zero,
  * fit the output to the global ROI (``fit_to_roi``) so the output shape is
    the ROI extent and block boxes are shifted by roi_begin.

This is an IO-bound task — the per-block arithmetic stays on the host where
the bytes already are (a copy through the card would only add PCIe
traffic), as in the JAX package; it runs under the same executor and retry
machinery as the device tasks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask


def cast_type(data: np.ndarray, dtype) -> np.ndarray:
    """dtype cast with the reference's special uint8 path (normalize → *255,
    reference copy_volume.py cast_type)."""
    if np.dtype(data.dtype) == np.dtype(dtype):
        return data
    if np.dtype(dtype) == np.dtype("uint8"):
        data = data.astype("float32")
        dmin, dmax = data.min(), data.max()
        data = (data - dmin) / max(dmax - dmin, 1e-6)
        return (data * 255).astype("uint8")
    return data.astype(dtype)


class CopyVolumeTask(VolumeTask):
    task_name = "copy_volume"
    output_dtype = None  # dataset creation handled in prepare() below

    def __init__(
        self,
        *args,
        prefix: str = "",
        dtype: Optional[str] = None,
        fit_to_roi: bool = False,
        effective_scale_factor: Sequence[float] = (),
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.prefix = prefix
        self.dtype = dtype
        self.fit_to_roi = fit_to_roi
        self.effective_scale_factor = list(effective_scale_factor)

    @property
    def identifier(self) -> str:
        return f"{self.task_name}_{self.prefix}" if self.prefix else self.task_name

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update(
            {
                "chunks": None,
                "compression": "gzip",
                "reduce_channels": None,
                "map_uniform_blocks_to_background": False,
                "value_list": None,
                "offset": None,
                "insert_mode": False,
            }
        )
        return conf

    # -- geometry ------------------------------------------------------------

    def _roi(self, config):
        roi_begin = config.get("roi_begin")
        roi_end = config.get("roi_end")
        if roi_begin is not None and self.effective_scale_factor:
            roi_begin = [int(rb // sf) for rb, sf in
                         zip(roi_begin, self.effective_scale_factor)]
            roi_end = [int(re // sf) for re, sf in
                       zip(roi_end, self.effective_scale_factor)]
        return roi_begin, roi_end

    def get_shape(self) -> Sequence[int]:
        shape = self.input_ds().shape
        return shape[-3:] if len(shape) > 3 else shape

    def _out_space_shape(self, config) -> Sequence[int]:
        shape = self.get_shape()
        roi_begin, roi_end = self._roi(config)
        if self.fit_to_roi and roi_begin is not None:
            return tuple(re - rb for rb, re in zip(roi_begin, roi_end))
        return tuple(shape)

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        in_ds = self.input_ds()
        in_shape = in_ds.shape
        ndim = len(in_shape)
        if ndim not in (3, 4):
            raise ValueError("copy_volume supports 3d and 4d inputs")

        out_shape = self._out_space_shape(config)
        reduce_channels = config.get("reduce_channels")
        if ndim == 4 and reduce_channels is None:
            out_shape = (in_shape[0],) + tuple(out_shape)

        dtype = self.dtype if self.dtype is not None else str(in_ds.dtype)
        chunks = config.get("chunks")
        chunks = tuple(blocking.block_shape) if chunks is None else tuple(chunks)
        if len(out_shape) == 4 and len(chunks) == 3:
            chunks = (1,) + chunks
        chunks = tuple(min(ch, sh) for ch, sh in zip(chunks, out_shape))

        f = store.file_reader(self.output_path, "a")
        f.require_dataset(
            self.output_key,
            shape=tuple(out_shape),
            dtype=dtype,
            chunks=chunks,
            compression=config.get("compression", "gzip"),
        )

    # -- per-block copy ------------------------------------------------------

    def process_block(self, block_id: int, blocking: Blocking, config: Dict[str, Any]):
        in_ds = self.input_ds()
        out_ds = self.output_ds()
        ndim_in = len(in_ds.shape)

        block = blocking.block(block_id)
        bb = block.slicing
        if ndim_in == 4:
            read_bb = (slice(None),) + bb
        else:
            read_bb = bb
        data = np.asarray(in_ds[read_bb])

        value_list = config.get("value_list")
        if value_list is not None:
            data = np.where(np.isin(data, value_list), data, 0)

        # skip empty / uniform blocks (reference copy_volume.py _copy_block)
        if data.size == 0 or not np.any(data):
            return
        if config.get("map_uniform_blocks_to_background", False) and (
            np.unique(data).size == 1
        ):
            return

        out_bb = bb
        roi_begin, _ = self._roi(config)
        if self.fit_to_roi and roi_begin is not None:
            out_bb = tuple(
                slice(b.start - off, b.stop - off)
                for b, off in zip(bb, roi_begin)
            )

        reduce_channels = config.get("reduce_channels")
        if reduce_channels is not None and data.ndim == 4:
            data = getattr(np, reduce_channels)(data[0:3], axis=0)
        elif data.ndim == 4:
            out_bb = (slice(None),) + out_bb

        offset = config.get("offset")
        if offset is not None:
            data = np.where(data != 0, data + offset, data)

        if config.get("insert_mode", False):
            prev = np.asarray(out_ds[out_bb])
            data = np.where(data == 0, prev.astype(data.dtype, copy=False), data)

        out_ds[out_bb] = cast_type(data, out_ds.dtype)

    def finalize(self, blocking, config, block_ids: List[int]) -> None:
        # mirror input attributes onto the output (reference copy_volume job 0)
        in_ds = self.input_ds()
        out_ds = self.output_ds()
        for k in in_ds.attrs.keys():
            out_ds.attrs[k] = in_ds.attrs[k]
