"""PyTorch port, stitching over the region graph: ``SimpleStitchEdgesTask``,
``SimpleStitchAssignmentsTask``, ``StitchingMulticutTask`` and the
``SimpleStitchingWorkflow`` / ``MulticutStitchingWorkflow`` composites
against the JAX package on the CPU, on one seeded block-wise segmentation of
(24, 48, 48) in blocks of (12, 24, 24), so that z, y and x faces all occur.

Contract: the boundary-edge chunks, the assignment tables and the stitched
volumes byte-identical to JAX's."""

import os

import numpy as np
import pytest

from cluster_tools_tpu import workflows as jwf
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch import workflows as twf
from cluster_tools_tpu_torch.tasks import stitching as tst
from cluster_tools_tpu_torch.tasks.base import scratch_store_path
from cluster_tools_tpu_torch.tasks.graph import load_graph
from cluster_tools_tpu_torch.utils import file_reader
from torch_label_volumes import BLOCK, SHAPE, setup

PACKAGES = {"jax": (jax_build, jwf), "torch": (build, twf)}


def stitch_both(tmp_path, path, config_dir, workflow: str, task_conf=None, **kwargs):
    if task_conf:
        jax_cfg.write_config(config_dir, "stitching_multicut", task_conf)
    tmps = {}
    for package, (run, wf) in PACKAGES.items():
        tmps[package] = str(tmp_path / f"tmp_{package}")
        assert run([getattr(wf, workflow)(
            tmps[package], config_dir, input_path=path, input_key="raw", labels_path=path,
            labels_key="seg", output_path=path, output_key=f"out_{package}", **kwargs)])
    f = file_reader(path, "r")
    got, want = f["out_torch"][:], f["out_jax"][:]
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    for bid in range(8):
        chunks = [file_reader(scratch_store_path(tmps[p]), "r")[tst.BOUNDARY_EDGES_KEY]
                  .read_chunk((bid,)) for p in ("torch", "jax")]
        np.testing.assert_array_equal(*chunks)
    return got, tmps


def face_touching_pairs(seg):
    """Every (a, b) id pair that touches across a block face."""
    pairs = set()
    for axis, step in enumerate(BLOCK):
        for pos in range(step, SHAPE[axis], step):
            lo = np.take(seg, pos - 1, axis=axis)
            hi = np.take(seg, pos, axis=axis)
            both = (lo > 0) & (hi > 0) & (lo != hi)
            pairs.update(zip(lo[both].tolist(), hi[both].tolist()))
    return pairs


@pytest.mark.parametrize("edge_size_threshold", [0, 20])
def test_simple_stitching_matches_jax(tmp_path, edge_size_threshold):
    """Every boundary edge merged (above the edge-size threshold, which
    needs edge features: then the multicut workflow's features are built
    first in the same tmp folder)."""
    path, config_dir, _, seg = setup(tmp_path)
    if edge_size_threshold:
        for package, (run, wf) in PACKAGES.items():
            tmp = str(tmp_path / f"tmp_{package}")
            graph = wf.GraphWorkflow(tmp, config_dir, input_path=path, input_key="seg")
            assert run([wf.EdgeFeaturesWorkflow(tmp, config_dir, input_path=path,
                                                input_key="raw", labels_path=path,
                                                labels_key="seg", dependencies=[graph])])
    got, tmps = stitch_both(tmp_path, path, config_dir, "SimpleStitchingWorkflow",
                            edge_size_threshold=edge_size_threshold)
    tables = [np.load(os.path.join(tmps[p], tst.SIMPLE_STITCH_NAME)) for p in ("torch", "jax")]
    np.testing.assert_array_equal(*tables)
    n_frag, n_seg = np.unique(seg).size - 1, np.unique(got).size - 1
    assert 1 < n_seg < n_frag
    # every merged pair of fragments touches across a block face
    nodes, edges = load_graph(file_reader(scratch_store_path(tmps["torch"]), "r"))
    touching = face_touching_pairs(seg)
    table = dict(zip(tables[0][:, 0].tolist(), tables[0][:, 1].tolist()))
    merged = [(int(nodes[u]), int(nodes[v])) for u, v in edges
              if table[int(nodes[u])] == table[int(nodes[v])] and nodes[u] > 0]
    assert merged and all((a, b) in touching or (b, a) in touching for a, b in merged)


@pytest.mark.parametrize("betas", [None, {"beta1": 0.3, "beta2": 0.7}])
def test_multicut_stitching_matches_jax(tmp_path, betas):
    path, config_dir, _, seg = setup(tmp_path)
    got, tmps = stitch_both(tmp_path, path, config_dir, "MulticutStitchingWorkflow",
                            task_conf=betas)
    tables = [np.load(os.path.join(tmps[p], tst.STITCH_MC_NAME)) for p in ("torch", "jax")]
    np.testing.assert_array_equal(*tables)
    assert 1 <= np.unique(got).size - 1 <= np.unique(seg).size - 1
