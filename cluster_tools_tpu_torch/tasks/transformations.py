"""Intensity transformations (port of ``cluster_tools_tpu/tasks/transformations.py``;
reference transformations/linear.py:24).

``a*x + b`` applied block-wise, with either one global ``(a, b)`` pair or a
per-z-slice table ``{z: {"a": .., "b": ..}}``; an optional mask restricts the
transform to mask voxels.  The split batch protocol reads a batch of blocks
as float32 with its ``[B, Z]`` coefficients and mask on the host, applies
the transform on the task's device and writes each block in the input's
dtype.  The JAX package's XLA program contracts ``a*x + b`` into one fused
multiply-add on the CPU; the port computes the correctly rounded fused
result on every device (``ops/filters.py::fma32``), so outputs are equal
bit for bit.  The input's upload goes through the device-buffer cache when
it is on (``runtime/hbm.py``); the coefficients and the mask, which its
store signature does not cover, are copied at each compute.  The JAX
package's ``put_sharded`` waits for ROADMAP Queue A 11.
(The reference's affine task is an empty stub, transformations/affine.py,
and is not built.)
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops._build import count_on_card
from ..ops.filters import fma32
from ..parallel.dispatch import read_block_batch
from ..runtime import hbm
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask, read_threads, write_inner_blocks


def load_transformation(trafo_file: str, n_slices: int) -> Dict[Any, Any]:
    """Global {'a','b'} or per-slice {'0': {'a','b'}, ...} spec
    (reference linear.py:125-139)."""
    with open(trafo_file) as f:
        trafo = json.load(f)
    if set(trafo.keys()) == {"a", "b"}:
        return {"a": float(trafo["a"]), "b": float(trafo["b"])}
    if len(trafo) != n_slices:
        raise ValueError(
            f"per-slice transformation has {len(trafo)} entries, volume has {n_slices} slices"
        )
    return {int(k): {"a": float(v["a"]), "b": float(v["b"])} for k, v in trafo.items()}


def linear_batch(batch: torch.Tensor, a_z: torch.Tensor, b_z: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """batch: [B, Z, Y, X] float32; a_z/b_z: [B, Z] per-slice coefficients;
    mask: [B, Z, Y, X] bool.  ``a*x + b`` rounded once where the mask is
    set, ``x`` elsewhere."""
    count_on_card(linear_batch, batch)
    a = a_z[:, :, None, None].expand_as(batch)
    b = b_z[:, :, None, None].expand_as(batch)
    return torch.where(mask, fma32(a, batch, b), batch)


linear_batch.launches = 0  # calls on a card


class LinearTransformationTask(VolumeTask):
    task_name = "linear"

    def __init__(self, *args, transformation: str = None, mask_path: Optional[str] = None,
                 mask_key: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.transformation = transformation
        self.mask_path = mask_path
        self.mask_key = mask_key

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=tuple(blocking.shape),
            dtype=str(self.input_ds().dtype),
            chunks=tuple(blocking.block_shape),
            compression="gzip",
        )

    def _coefficients(self, blocking: Blocking, block_ids):
        """Per-block per-slice [B, Z] coefficient arrays."""
        n_slices = blocking.shape[0]
        trafo = load_transformation(self.transformation, n_slices)
        bz = blocking.block_shape[0]
        a = np.empty((len(block_ids), bz), dtype=np.float32)
        b = np.empty((len(block_ids), bz), dtype=np.float32)
        if "a" in trafo and isinstance(trafo["a"], float):
            a[:] = trafo["a"]
            b[:] = trafo["b"]
        else:
            for i, bid in enumerate(block_ids):
                z0 = blocking.block(bid).begin[0]
                for dz in range(bz):
                    entry = trafo.get(min(z0 + dz, n_slices - 1))
                    a[i, dz] = entry["a"]
                    b[i, dz] = entry["b"]
        return a, b

    # -- split batch protocol ------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the blocks as float32 zero-padded to the block
        shape, their coefficients and their mask (all set without one)."""
        batch = read_block_batch(
            self.input_ds(), blocking, block_ids, np.float32, read_threads(config),
            device_source=(self.input_path, self.input_key, ("linear-read",), config))
        a, b = self._coefficients(blocking, block_ids)
        full_shape = (len(block_ids),) + tuple(blocking.block_shape)
        if self.mask_path:
            mask_ds = store.file_reader(self.mask_path, "r")[self.mask_key]
            mask = np.zeros(full_shape, dtype=bool)
            for i, bh in enumerate(batch.blocks):
                m = mask_ds[bh.outer.slicing].astype(bool)
                mask[i][tuple(slice(0, s) for s in m.shape)] = m
        else:
            mask = np.ones(full_shape, dtype=bool)
        return batch, a, b, mask

    def upload_batch(self, payload, blocking: Blocking, config):
        hbm.batch_device(payload[0], config)
        return payload

    def stack_payloads(self, payloads, blocking: Blocking, config):
        return (hbm.stack_block_batches([p[0] for p in payloads], config),
                *(np.concatenate([p[i] for p in payloads], axis=0) for i in (1, 2, 3)))

    def unstack_results(self, result, counts, blocking: Blocking, config):
        batch, out = result
        return list(zip(hbm.split_block_batch(batch, counts), hbm.split_stacked(out, counts)))

    def compute_batch(self, payload, blocking: Blocking, config):
        """Stage 2 (device): the transform of the whole batch."""
        batch, a, b, mask = payload
        x = hbm.batch_device(batch, config).arrays[0]
        out = linear_batch(x, *(torch.from_numpy(t).to(x.device) for t in (a, b, mask)))
        return batch, out.cpu().numpy()

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): each block's inner box in the output's dtype."""
        batch, out = result
        out_ds = self.output_ds()
        write_inner_blocks(out_ds, batch.blocks, out, out_ds.dtype, read_threads(config))

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )
