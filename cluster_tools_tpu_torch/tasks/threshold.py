"""Threshold task (port of ``cluster_tools_tpu/tasks/threshold.py``).

Per block: optional gaussian pre-smoothing, then the comparison against the
threshold, on the task's device.  The split batch protocol reads the blocks
as float32 zero-padded to the block shape, computes the whole batch at once
and writes each block's inner box as uint8.  The JAX package's stream-fusion
hooks wait for ROADMAP Queue A 12(c); a chained task runs unfused.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import filters
from ..runtime.device import resolve_device
from ..utils.blocking import Blocking
from .base import VolumeTask, read_padded_blocks, read_threads, write_inner_blocks
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

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({"threshold": 0.5, "threshold_mode": "greater", "sigma": 0.0})
        return conf

    # -- split batch protocol ------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the blocks as float32, zero-padded to the block
        shape."""
        mode = config.get("threshold_mode", "greater")
        if mode not in THRESHOLD_MODES:
            raise ValueError(f"unsupported threshold_mode {mode!r}")
        return read_padded_blocks(self.input_ds(), blocking, block_ids, np.float32,
                                  read_threads(config))

    def compute_batch(self, batch, blocking: Blocking, config):
        """Stage 2 (device): smooth and threshold the batch."""
        blocks, data = batch
        sigma = config.get("sigma", 0.0) or 0.0
        x = torch.from_numpy(data).to(resolve_device(config))
        mask = _threshold_batch(x, float(config.get("threshold", 0.5)),
                                config.get("threshold_mode", "greater"), sigma)
        return blocks, mask.cpu().numpy()

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): each block's inner box, threaded where every
        block covers whole chunks."""
        blocks, masks = result
        write_inner_blocks(self.output_ds(), blocks, masks, np.uint8, read_threads(config))

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )
