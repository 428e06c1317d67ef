"""ilastik integration: block-wise headless pixel classification and the
carving-project export (port of ``cluster_tools_tpu/tasks/ilastik.py``;
reference ilastik/ package, SURVEY.md §2.6).  All host work, as in JAX.

* ``IlastikPredictionTask`` — the subprocess-per-block seam
  (reference prediction.py:104-160): assembles the headless command
  (``run_ilastik.sh``/``ilastik.py --headless --project=… --cutout_subregion=…``)
  for each halo'd block and runs it; each block lands in its own
  ``<prefix>_block<i>.h5`` under ``exported_data``.  ilastik itself is an
  external install — the task validates the executable up front and fails
  with a clear error when absent, so the seam is testable with any stand-in
  executable honoring the CLI contract.
* ``MergePredictionsTask`` — reads each block's h5, crops the halo back to the
  inner block and writes the channel-first result into the output dataset
  (reference merge_predictions.py:91-114, zyxc→czyx transpose).
* ``StackPredictionsTask`` — stacks the raw volume on top of the prediction
  channels into a (1+C, z, y, x) dataset (reference stack_predictions.py).
* ``WriteCarvingTask`` — serializes the RAG + edge features of a watershed
  oversegmentation into an ilastik carving project (.ilp h5): the
  vigra-adjacency-list-graph layout [counts, uv ids, neighborhoods] plus the
  metadata groups ilastik expects (reference carving.py:26-131).
"""

from __future__ import annotations

import os
import subprocess
import time
import uuid
from typing import Any, Dict, Sequence

import numpy as np

from ..runtime.task import SimpleTask
from ..utils import store
from ..utils.blocking import Blocking
from .base import VolumeTask
from .features import FEATURES_KEY
from .graph import EDGES_KEY, NODES_KEY


def ilastik_executable(ilastik_folder: str) -> str:
    """``run_ilastik.sh`` if present, else ``ilastik.py``
    (reference prediction.py:131-135)."""
    exe = os.path.join(ilastik_folder, "run_ilastik.sh")
    if not os.path.exists(exe):
        exe = os.path.join(ilastik_folder, "ilastik.py")
    if not os.path.exists(exe):
        raise RuntimeError(
            f"no ilastik executable (run_ilastik.sh / ilastik.py) under "
            f"{ilastik_folder!r}"
        )
    return exe


def prediction_block_path(prefix: str, block_id: int) -> str:
    return f"{prefix}_block{block_id}.h5"


class IlastikPredictionTask(VolumeTask):
    """Headless ilastik pixel classification, one subprocess per halo'd block
    (reference prediction.py:21,104-160)."""

    task_name = "ilastik_prediction"
    output_dtype = None  # block h5 files; merged by MergePredictionsTask

    def __init__(
        self,
        *args,
        ilastik_folder: str = None,
        ilastik_project: str = None,
        halo: Sequence[int] = (0, 0, 0),
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.ilastik_folder = ilastik_folder
        self.ilastik_project = ilastik_project
        self.halo = list(halo)

    @property
    def output_prefix(self) -> str:
        return os.path.join(self.tmp_folder, "ilastik_prediction")

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        ilastik_executable(self.ilastik_folder)  # fail fast when absent
        if not os.path.exists(self.ilastik_project):
            raise RuntimeError(
                f"ilastik project {self.ilastik_project!r} does not exist"
            )

    def process_block(self, block_id: int, blocking: Blocking, config):
        block = blocking.block_with_halo(block_id, self.halo)
        exe = ilastik_executable(self.ilastik_folder)
        out_path = prediction_block_path(self.output_prefix, block_id)
        # ilastik's cutout axis order: spatial + trailing channel slot
        # (reference prediction.py:113-127)
        start = ",".join(str(b) for b in block.outer.begin) + ",None"
        stop = ",".join(str(e) for e in block.outer.end) + ",None"
        cmd = [
            exe,
            "--headless",
            f"--project={self.ilastik_project}",
            "--output_format=compressed hdf5",
            f"--raw_data={self.input_path}/{self.input_key}",
            f"--cutout_subregion=[({start}), ({stop})]",
            f"--output_filename_format={out_path}",
            "--readonly=1",
        ]
        self.log(f"block {block_id}: {' '.join(cmd)}")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"ilastik failed on block {block_id} "
                f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        if not os.path.exists(out_path):
            raise RuntimeError(
                f"ilastik produced no output for block {block_id} ({out_path})"
            )


class MergePredictionsTask(VolumeTask):
    """Write each block h5's inner region into the merged output dataset
    (reference merge_predictions.py:91-114).  ilastik emits trailing-channel
    (z, y, x, c); the output dataset is channel-first (c, z, y, x)."""

    task_name = "merge_predictions"

    def __init__(
        self,
        *args,
        tmp_prefix: str = None,
        halo: Sequence[int] = (0, 0, 0),
        n_channels: int = 1,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.tmp_prefix = tmp_prefix
        self.halo = list(halo)
        self.n_channels = int(n_channels)

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        shape = tuple(blocking.shape)
        if self.n_channels > 1:
            shape = (self.n_channels,) + shape
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=shape,
            dtype="float32",
            chunks=((1,) if self.n_channels > 1 else ())
            + tuple(blocking.block_shape),
            compression="gzip",
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        block = blocking.block_with_halo(block_id, self.halo)
        tmp_path = prediction_block_path(self.tmp_prefix, block_id)
        with store.file_reader(tmp_path, "r") as f:
            data = f["exported_data"][block.inner_local.slicing]
        inner_bb = block.inner.slicing
        if self.n_channels > 1:
            data = np.moveaxis(data, -1, 0)  # zyxc -> czyx
            inner_bb = (slice(None),) + inner_bb
        elif data.ndim == 4:
            data = data[..., 0]
        ds = self.output_ds()
        ds[inner_bb] = data.astype(np.float32)
        os.remove(tmp_path)


class StackPredictionsTask(VolumeTask):
    """Stack raw + prediction channels into (1+C, z, y, x)
    (reference stack_predictions.py:23-160)."""

    task_name = "stack_predictions"

    def __init__(
        self,
        *args,
        pred_path: str = None,
        pred_key: str = None,
        dtype: str = "float32",
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.pred_path = pred_path
        self.pred_key = pred_key
        self.dtype = dtype

    def prepare(self, blocking: Blocking, config: Dict[str, Any]) -> None:
        pred_shape = store.file_reader(self.pred_path, "r")[self.pred_key].shape
        if len(pred_shape) != 4 or tuple(pred_shape[1:]) != tuple(blocking.shape):
            raise ValueError(
                f"prediction shape {pred_shape} does not stack onto raw shape "
                f"{tuple(blocking.shape)}"
            )
        store.file_reader(self.output_path, "a").require_dataset(
            self.output_key,
            shape=(1 + pred_shape[0],) + tuple(blocking.shape),
            dtype=self.dtype,
            chunks=(1,) + tuple(blocking.block_shape),
            compression="gzip",
        )

    def process_block(self, block_id: int, blocking: Blocking, config):
        bb = blocking.block(block_id).slicing
        raw = self.input_ds()[bb]
        pred = store.file_reader(self.pred_path, "r")[self.pred_key][
            (slice(None),) + bb
        ]
        out = self.output_ds()
        dtype = np.dtype(self.dtype)

        def to_dtype(arr):
            # float data quantized into the integer range, not truncated
            if np.issubdtype(dtype, np.integer) and np.issubdtype(
                np.asarray(arr).dtype, np.floating
            ):
                return (np.clip(arr, 0, 1) * np.iinfo(dtype).max).astype(dtype)
            return arr.astype(dtype)

        out[(slice(0, 1),) + bb] = to_dtype(raw)[None]
        out[(slice(1, 1 + pred.shape[0]),) + bb] = to_dtype(pred)


class WriteCarvingTask(SimpleTask):
    """Export the scratch-store RAG + edge features as an ilastik carving
    project (reference carving.py:10-131).

    Graph serialization follows the vigra adjacency-list-graph layout the
    reference cites: header [n_nodes, n_edges, max_node_id, max_edge_id]
    (uint32), flattened uv ids, then per-node neighborhoods
    [degree, (neighbor, edge_id)...] for every node id 0..max_node_id.
    """

    task_name = "write_carving"

    def __init__(
        self,
        tmp_folder,
        config_dir=None,
        max_jobs=None,
        dependencies=(),
        output_path: str = None,
        raw_path: str = None,
        raw_key: str = None,
        copy_inputs: bool = False,
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        self.output_path = output_path
        self.raw_path = raw_path
        self.raw_key = raw_key
        self.copy_inputs = copy_inputs

    def run_impl(self) -> None:
        import h5py

        from .base import scratch_store_path

        scratch = store.file_reader(scratch_store_path(self.tmp_folder), "r")
        nodes = scratch[NODES_KEY][:]
        edge_idx = scratch[EDGES_KEY][:]
        feats = scratch[FEATURES_KEY][:]
        uv = nodes[edge_idx].astype(np.uint32)

        # size by the full node set, not edge endpoints: isolated fragments
        # are graph nodes too and need seed/result-table slots
        max_node = int(nodes.max()) if nodes.size else 0
        n_nodes = max_node + 1
        n_edges = uv.shape[0]

        # per-node neighborhoods [degree, (neighbor, edge)...] — vectorized:
        # one scatter of the interleaved (dst, eid) stream into a layout with
        # degree-prefix offsets (production RAGs have 1e6+ nodes)
        order = np.argsort(
            np.concatenate([uv[:, 0], uv[:, 1]]), kind="stable"
        )
        src = np.concatenate([uv[:, 0], uv[:, 1]])[order]
        dst = np.concatenate([uv[:, 1], uv[:, 0]])[order]
        eid = np.tile(np.arange(n_edges, dtype=np.uint32), 2)[order]
        degrees = np.bincount(src, minlength=n_nodes).astype(np.uint32)
        total = n_nodes + 2 * 2 * n_edges
        nbh = np.zeros(total, dtype=np.uint32)
        # record start = prefix over (1 + 2*deg); degree goes at the start
        rec_starts = np.concatenate(
            [[0], np.cumsum(1 + 2 * degrees)[:-1]]
        ).astype(np.int64)
        nbh[rec_starts] = degrees
        # position of each (dst, eid) pair within its node's record
        within = np.arange(src.size, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(degrees)[:-1]]).astype(np.int64),
            degrees,
        )
        base = np.repeat(rec_starts, degrees) + 1 + 2 * within
        nbh[base] = dst
        nbh[base + 1] = eid

        header = np.array(
            [n_nodes, n_edges, max_node, max(n_edges - 1, 0)], dtype=np.uint32
        )
        serialization = np.concatenate([header, uv.reshape(-1), nbh])

        uid = str(uuid.uuid4())
        with h5py.File(self.output_path, "a") as f:
            g = f.create_group("preprocessing/graph")
            g.create_dataset("graph", data=serialization, compression="gzip")
            g.create_dataset("nodeSeeds", shape=(n_nodes,), dtype="uint8")
            g.create_dataset("resultSegmentation", shape=(n_nodes,), dtype="uint8")
            g.attrs["numNodes"] = n_nodes
            # carving edge weights: mean boundary probability in 0-255
            g.create_dataset(
                "edgeWeights",
                data=(feats[:, 0] * 255).astype("float32"),
                compression="gzip",
            )
            f.create_dataset("workflowName", data=np.bytes_("Carving"))
            f.create_dataset("time", data=np.bytes_(time.ctime()))
            f.create_dataset("currentApplet", data=2)
            f.create_dataset("preprocessing/StorageVersion", data="0.1")
            f.create_dataset("preprocessing/filter", data=3)
            f.create_dataset("preprocessing/sigma", data=1.0)
            f.create_dataset("preprocessing/invert_watershed_source", data=False)
            f.create_dataset(
                "preprocessing/watershed_source", data=np.bytes_("filtered")
            )
            f.create_dataset("carving/StorageVersion", data="0.1")
            f.create_group("carving/objects")
            gi = f.create_group("Input Data")
            gi.create_dataset(
                "Role Names", data=[np.bytes_("Raw Data"), np.bytes_("Overlay")]
            )
            gi.create_dataset("StorageVersion", data="0.2")
            gi.create_group("local_data")
            gr = f.create_group("Input Data/infos/lane0000/Raw Data")
            gr.create_dataset("allowLabels", data=True)
            gr.create_dataset("axisorder", data=np.bytes_("zyx"))
            gr.create_dataset("fromstack", data=False)
            gr.create_dataset("datasetId", data=uid.encode("utf-8"))
            gr.create_dataset("display_mode", data=np.bytes_("default"))
            raw = os.path.join(self.raw_path or "", self.raw_key or "")
            gr.create_dataset("filePath", data=raw.encode("utf-8"))
            gr.create_dataset(
                "location",
                data=np.bytes_(
                    "ProjectInternal" if self.copy_inputs else "FileSystem"
                ),
            )
            gr.create_dataset("nickname", data=np.bytes_("Input"))
        self.log(
            f"carving project with {n_nodes} nodes / {n_edges} edges "
            f"-> {self.output_path}"
        )
