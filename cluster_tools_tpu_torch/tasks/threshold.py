"""Threshold task (port of ``cluster_tools_tpu/tasks/threshold.py``).

Per block: optional gaussian pre-smoothing, then the comparison against the
threshold, on the task's device.  The split batch protocol reads the blocks
as float32 zero-padded to the block shape (``parallel/dispatch.py::
read_block_batch``, through the device-buffer cache when it is on),
computes the whole batch at once and writes each block's inner box as
uint8.  In a fused chain (``runtime/stream.py``) the task is the head whose
mask may be elided: its handoff is the mask tensor on the device, and an
elided mask is never copied to the host.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import filters
from ..parallel.dispatch import read_block_batch
from ..runtime import hbm
from ..utils.blocking import Blocking
from .base import VolumeTask, read_threads, write_inner_blocks
from .thresholded_components import THRESHOLD_MODES, threshold_mask


def _threshold_batch(batch: torch.Tensor, threshold: float, mode: str, sigma) -> torch.Tensor:
    """uint8 mask of a (B, Z, H, W) batch; ``sigma`` (scalar or per axis)
    smooths each block on its own."""
    x = filters.normalize_input(batch) if batch.dtype != torch.float32 else batch
    if sigma:
        sig = tuple(sigma) if isinstance(sigma, (list, tuple)) else (sigma,) * (x.dim() - 1)
        x = filters.gaussian(x, sig)
    return threshold_mask(x, threshold, mode).to(torch.uint8)


class ThresholdTask(VolumeTask):
    task_name = "threshold"
    output_dtype = "uint8"
    # a fused chain's head, typically elided: the mask stays on the device
    fusable = True

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"threshold": 0.5, "threshold_mode": "greater", "sigma": 0.0})
        return conf

    def _mask(self, batch, config) -> torch.Tensor:
        db = hbm.batch_device(batch, config)
        return _threshold_batch(db.arrays[0], float(config.get("threshold", 0.5)),
                                config.get("threshold_mode", "greater"),
                                config.get("sigma", 0.0) or 0.0)

    # -- stream fusion ---------------------------------------------------------

    def fused_compute_batch(self, payload, blocking: Blocking, config, elided=False):
        """The handoff is the uint8 mask on the device with the batch's
        geometry; an elided mask skips the host copy."""
        mask = self._mask(payload, config)
        result = None if elided else (payload, mask.cpu().numpy())
        return result, {"batch": payload, "labels": mask}

    def fused_elided_nbytes(self, handoff, blocking: Blocking, config) -> int:
        """The uint8 mask bytes neither written nor read back."""
        return sum(int(np.prod(bh.inner.shape)) for bh in handoff["batch"].blocks)

    # -- split batch protocol ------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the blocks as float32, zero-padded to the block
        shape; the threshold and sigma apply on the device, so one cached
        upload serves every configuration."""
        mode = config.get("threshold_mode", "greater")
        if mode not in THRESHOLD_MODES:
            raise ValueError(f"unsupported threshold_mode {mode!r}")
        return read_block_batch(
            self.input_ds(), blocking, block_ids, np.float32, read_threads(config),
            device_source=(self.input_path, self.input_key, ("threshold-read",), config))

    def upload_batch(self, batch, blocking: Blocking, config):
        """The transfer stage: the batch crosses to the device while the
        previous one computes."""
        hbm.batch_device(batch, config)
        return batch

    def stack_payloads(self, payloads, blocking: Blocking, config):
        return hbm.stack_block_batches(payloads, config)

    def unstack_results(self, result, counts, blocking: Blocking, config):
        batch, masks = result
        return list(zip(hbm.split_block_batch(batch, counts), hbm.split_stacked(masks, counts)))

    def compute_batch(self, batch, blocking: Blocking, config):
        """Stage 2 (device): smooth and threshold the batch."""
        return batch, self._mask(batch, config).cpu().numpy()

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): each block's inner box, threaded where every
        block covers whole chunks."""
        batch, masks = result
        write_inner_blocks(self.output_ds(), batch.blocks, masks, np.uint8, read_threads(config))

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )
