"""Mask-driven ROI restriction (port of ``cluster_tools_tpu/tasks/masking.py``;
reference masking/ package).

Two tasks:

* ``BlocksFromMaskTask`` — the list of blocks intersecting a (possibly
  lower-resolution) mask, written as a JSON block list that every other task
  reads through the global ``block_list_path`` config (reference
  blocks_from_mask.py:22; nearest-neighbour mask upscaling mirrors elf's
  ResizedVolume).  Host numpy, as in the JAX package.
* ``MinfilterTask`` — halo'd minimum filter over a mask, so that every block
  whose receptive field touches masked-out voxels is excluded (reference
  minfilter.py:25).  The split batch protocol reads the halo'd blocks as
  float32, pads each at its far end by edge replication to the batch shape,
  filters the batch with ``ops/filters.py::minimum_filter`` on the task's
  device and writes each block's inner box as uint8; the upload goes
  through the device-buffer cache when it is on (``runtime/hbm.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence

import numpy as np

from ..ops.filters import minimum_filter
from ..parallel.dispatch import read_block_batch
from ..runtime import hbm
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeSimpleTask, VolumeTask, read_threads, write_inner_blocks


def resize_nearest(data: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Nearest-neighbour resize via index mapping (the moral equivalent of
    elf's ResizedVolume used by the reference, blocks_from_mask.py:115)."""
    if tuple(data.shape) == tuple(shape):
        return data
    idx = tuple(
        np.minimum((np.arange(ns) * ds / ns).astype(np.int64), ds - 1)
        for ns, ds in zip(shape, data.shape)
    )
    return data[np.ix_(*idx)]


class BlocksFromMaskTask(VolumeSimpleTask):
    """Write the JSON list of blocks overlapping the mask
    (reference blocks_from_mask.py:22-133)."""

    task_name = "blocks_from_mask"

    def __init__(self, *args, mask_path: str = None, mask_key: str = None,
                 shape: Sequence[int] = None, output_path: str = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mask_path = mask_path
        self.mask_key = mask_key
        self.shape = list(shape) if shape is not None else None
        self.output_path = output_path

    def run_impl(self) -> None:
        from ..runtime import config as cfg

        gconf = cfg.global_config(self.config_dir)
        mask = np.asarray(store.file_reader(self.mask_path, "r")[self.mask_key][:]).astype(bool)
        shape = self.shape if self.shape is not None else list(mask.shape)
        mask = resize_nearest(mask, shape)

        blocking = Blocking(shape, gconf["block_shape"])
        blocks_in_mask = [
            bid for bid in range(blocking.n_blocks)
            if bool(np.any(mask[blocking.block(bid).slicing]))
        ]
        os.makedirs(os.path.dirname(os.path.abspath(self.output_path)), exist_ok=True)
        with open(self.output_path, "w") as f:
            json.dump(blocks_in_mask, f)
        self.log(f"{len(blocks_in_mask)}/{blocking.n_blocks} blocks intersect the mask")


class MinfilterTask(VolumeTask):
    """Halo'd minimum filter over a binary mask (reference minfilter.py:25-119)."""

    task_name = "minfilter"
    output_dtype = "uint8"

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"filter_shape": [10, 100, 100]})
        return conf

    def _halo(self, config) -> List[int]:
        # half the filter extent, rounded up (reference minfilter.py:83)
        return [fs // 2 + 1 for fs in config["filter_shape"]]

    # -- split batch protocol ------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the halo'd blocks as float32, each padded at its
        far end by repeating its edge voxels (a zero fill would leak "masked
        out" into border blocks through the min window).  The cache's tag
        names the edge padding, so the entry never serves a zero-padded
        read of the same region."""
        return read_block_batch(
            self.input_ds(), blocking, block_ids, np.float32, read_threads(config),
            device_source=(self.input_path, self.input_key, ("minfilter-read",), config),
            halo=self._halo(config), pad_mode="edge")

    def upload_batch(self, batch, blocking: Blocking, config):
        hbm.batch_device(batch, config)
        return batch

    def stack_payloads(self, payloads, blocking: Blocking, config):
        return hbm.stack_block_batches(payloads, config)

    def unstack_results(self, result, counts, blocking: Blocking, config):
        batch, out = result
        return list(zip(hbm.split_block_batch(batch, counts), hbm.split_stacked(out, counts)))

    def compute_batch(self, batch, blocking: Blocking, config):
        """Stage 2 (device): the minimum filter over each block of the batch."""
        x = hbm.batch_device(batch, config).arrays[0]
        out = minimum_filter(x, tuple(int(f) for f in config["filter_shape"]))
        return batch, out.cpu().numpy()

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): each block's inner box as uint8."""
        batch, out = result
        write_inner_blocks(self.output_ds(), batch.blocks, out, np.uint8, read_threads(config))

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )
