"""PyTorch port, the sanity checks: ``CheckSubGraphsWorkflow`` /
``CheckSubGraphsTask`` and ``CheckComponentsTask`` give the JAX package's
verdicts on the fixtures of the JAX ``tests/test_debugging.py`` (made by
numpy from a seed): a fresh graph passes, a corrupted block's node list
fails, and labels spanning too many blocks are flagged, with the same
saved arrays."""

import os

import numpy as np
import pytest

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import debugging as jdbg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import CheckSubGraphsWorkflow as JaxCheckSubGraphsWorkflow
from cluster_tools_tpu.workflows import GraphWorkflow as JaxGraphWorkflow
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.tasks import debugging as tdbg
from cluster_tools_tpu_torch.tasks.graph import SUB_NODES_KEY
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.workflows import CheckSubGraphsWorkflow, GraphWorkflow

SHAPE = (16, 32, 32)
BLOCK = [8, 16, 16]
PACKAGES = {
    "jax": (jax_build, JaxCheckSubGraphsWorkflow, JaxGraphWorkflow, jdbg, jax_reader),
    "torch": (build, CheckSubGraphsWorkflow, GraphWorkflow, tdbg, file_reader),
}


def _setup(tmp_path, labels, key):
    path = str(tmp_path / "d.n5")
    jax_reader(path).create_dataset(key, data=labels, chunks=tuple(BLOCK), compression="gzip")
    config_dir = str(tmp_path / "configs")
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu"})
    return path, config_dir


@pytest.mark.parametrize("package", list(PACKAGES))
def test_valid_graph_passes(tmp_path, package):
    run, check_wf, _, dbg, _ = PACKAGES[package]
    labels = np.random.default_rng(0).integers(1, 20, SHAPE).astype("uint64")
    path, config_dir = _setup(tmp_path, labels, "ws")
    tmp = str(tmp_path / "tmp")
    assert run([check_wf(tmp, config_dir, ws_path=path, ws_key="ws")])
    failed = np.load(os.path.join(tmp, dbg.FAILED_SUBGRAPH_BLOCKS_NAME))
    assert failed.dtype == np.int64 and failed.size == 0


@pytest.mark.parametrize("package", list(PACKAGES))
def test_corrupted_serialization_fails(tmp_path, package):
    run, _, graph_wf, dbg, reader = PACKAGES[package]
    labels = np.random.default_rng(1).integers(1, 20, SHAPE).astype("uint64")
    path, config_dir = _setup(tmp_path, labels, "ws")
    tmp = str(tmp_path / "tmp")
    assert run([graph_wf(tmp, config_dir, input_path=path, input_key="ws")])
    reader(os.path.join(tmp, "data.zarr"), "a")[SUB_NODES_KEY].write_chunk(
        (0,), np.asarray([999999], dtype="uint64"))
    check = dbg.CheckSubGraphsTask(tmp, config_dir, input_path=path, input_key="ws")
    with pytest.raises(RuntimeError, match=r"mismatch in blocks \[0\]"):
        run([check], raise_on_failure=True)
    np.testing.assert_array_equal(np.load(os.path.join(tmp, dbg.FAILED_SUBGRAPH_BLOCKS_NAME)), [0])
    assert not check.complete()


def test_fragmented_label_flagged_as_jax(tmp_path):
    labels = np.zeros(SHAPE, dtype="uint64")
    labels[::4] = 7  # in every block
    labels[1, :16, :16] = 2  # in one
    labels[:, 20, 20] = 5  # in two
    path, config_dir = _setup(tmp_path, labels, "seg")
    got = {}
    for package, (run, _, _, dbg, _) in PACKAGES.items():
        tmp = str(tmp_path / f"tmp_{package}")
        task = dbg.CheckComponentsTask(tmp, config_dir, input_path=path, input_key="seg",
                                       max_blocks_per_label=1)
        assert run([task])
        got[package] = np.load(os.path.join(tmp, dbg.VIOLATING_IDS_NAME))
    np.testing.assert_array_equal(got["torch"], got["jax"])
    assert got["torch"].dtype == got["jax"].dtype
    assert {int(i) for i in got["torch"][:, 0]} == {5, 7}
