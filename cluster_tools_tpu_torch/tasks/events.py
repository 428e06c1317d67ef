"""Event building over a stack of detector frames (port of
``cluster_tools_tpu/tasks/events.py``).

The input is an ``(n_frames, h, w)`` volume: axis 0 is the frame stream,
and a block is a run of whole frames (``block_shape[1:]`` must cover the
frame).  A batch of blocks becomes one ``(frames, h, w)`` stack labelled on
the task's device by ``ops.events.build_events_device``.  Outputs: a
uint32 per-frame labels volume at ``output_key`` and, at ``<output_key>
_events``, one ragged float64 table per block of ``(n_clusters, 1 +
N_PROPS)`` rows: the global frame index, then ``PROP_FIELDS``.

The blocks are read halo-less as float32, zero-padded to the block shape
(``parallel/dispatch.py::read_block_batch``, through the device-buffer
cache when it is on).  Frames are independent, so the task is fusable as
it is: the fusion contract's defaults (no carry, ``compute_batch`` as the
fused compute) are exact.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..ops import events as events_ops
from ..parallel.dispatch import read_block_batch
from ..runtime import hbm
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask, read_threads, write_inner_blocks

EVENTS_SUFFIX = "_events"


class EventBuildingTask(VolumeTask):
    task_name = "events"
    output_dtype = "uint32"
    fusable = True

    @classmethod
    def default_task_config(cls) -> Dict[str, Any]:
        conf = super().default_task_config()
        conf.update({
            "threshold": 0.0,
            "connectivity": 2,
            "max_clusters": events_ops.DEFAULT_MAX_CLUSTERS,
        })
        return conf

    @property
    def events_key(self) -> str:
        return self.output_key + EVENTS_SUFFIX

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        shape = tuple(self.get_shape())
        if len(shape) != 3:
            raise ValueError(
                f"event building expects an (n_frames, h, w) stack, got shape {shape}"
            )
        bs = tuple(blocking.block_shape)
        if bs[1] < shape[1] or bs[2] < shape[2]:
            raise ValueError(
                f"block_shape {bs} splits frames of shape {shape[1:]} — "
                f"frames are independent and must stay whole per block "
                f"(use block_shape [frames_per_block, {shape[1]}, {shape[2]}])"
            )
        super().prepare(blocking, config)
        store.file_reader(self.output_path, "a").create_ragged_dataset(
            self.events_key, (blocking.n_blocks,), np.float64
        )

    # -- split batch protocol ------------------------------------------------

    def read_batch(self, block_ids: List[int], blocking: Blocking, config):
        """Stage 1 (host): the blocks' frames as float32; the threshold and
        connectivity apply on the device, so one cached upload serves every
        configuration."""
        return read_block_batch(
            self.input_ds(), blocking, block_ids, np.float32, read_threads(config),
            device_source=(self.input_path, self.input_key, ("events-read",), config))

    def upload_batch(self, batch, blocking: Blocking, config):
        hbm.batch_device(batch, config)
        return batch

    def stack_payloads(self, payloads, blocking: Blocking, config):
        return hbm.stack_block_batches(payloads, config)

    def unstack_results(self, result, counts, blocking: Blocking, config):
        batch, labels, evc, evp = result
        return list(zip(hbm.split_block_batch(batch, counts), hbm.split_stacked(labels, counts),
                        hbm.split_stacked(evc, counts), hbm.split_stacked(evp, counts)))

    def compute_batch(self, batch, blocking: Blocking, config):
        """Stage 2 (device): the whole batch's frames as one stack."""
        frames = hbm.batch_device(batch, config).arrays[0]
        b, bf, h, w = frames.shape
        labels, counts, props, _ = events_ops.build_events_device(
            frames.reshape(b * bf, h, w), float(config.get("threshold", 0.0)),
            int(config.get("connectivity", 2)))
        maxc = props.shape[1]
        return (
            batch,
            labels.cpu().numpy().astype(np.uint32).reshape(b, bf, h, w),
            counts.cpu().numpy().reshape(b, bf),
            props.cpu().numpy().reshape(b, bf, maxc, events_ops.N_PROPS),
        )

    def write_batch(self, result, blocking: Blocking, config):
        """Stage 3 (host): the labels' inner boxes and each block's table of
        its real frames, frame indices made global."""
        batch, labels, counts, props = result
        write_inner_blocks(self.output_ds(), batch.blocks, labels, np.uint32,
                           read_threads(config))
        ev_ds = store.file_reader(self.output_path, "a")[self.events_key]
        for i, bh in enumerate(batch.blocks):
            nf = bh.inner.end[0] - bh.inner.begin[0]
            table = events_ops.event_table(counts[i][:nf], props[i][:nf])
            table[:, 0] += bh.inner.begin[0]
            ev_ds.write_chunk((batch.block_ids[i],), table)

    def process_block(self, block_id, blocking, config):
        self.write_batch(
            self.compute_batch(self.read_batch([block_id], blocking, config), blocking, config),
            blocking, config,
        )


def read_event_tables(output_path: str, output_key: str, n_blocks: int) -> np.ndarray:
    """Every block's ragged event table, concatenated and sorted (stably) by
    global frame index."""
    ds = store.file_reader(output_path, "r")[output_key + EVENTS_SUFFIX]
    tables = [ds.read_chunk((bid,)) for bid in range(n_blocks)]
    tables = [t for t in tables if t is not None and len(t)]
    if not tables:
        return np.zeros((0, 1 + events_ops.N_PROPS), np.float64)
    out = np.concatenate(tables, axis=0)
    return out[np.argsort(out[:, 0], kind="stable")]
