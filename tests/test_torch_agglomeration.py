"""PyTorch port: per-block agglomeration (``AgglomerateTask``,
``WatershedWorkflow(agglomeration=True)``) and the global
``AgglomerativeClusteringWorkflow``, each against the JAX one.

Both packages run from one config (plus ``"device": "cpu"`` for the port)
on the same gzip n5 volume, the JAX agglomeration tests' fixture; the
fragments, the agglomerated volume and the global clustering's
(fragment, segment) table must be byte identical.  Run in the tmp folder of
a multicut workflow over the same watershed, the clustering workflow must
reuse its graph and features, not recompute them."""

import os

import numpy as np
import pytest
from scipy import ndimage

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import AgglomerativeClusteringWorkflow as JaxAggloWorkflow
from cluster_tools_tpu.workflows.watershed import WatershedWorkflow as JaxWatershedWorkflow
from cluster_tools_tpu_torch import (
    AgglomerativeClusteringWorkflow,
    MulticutSegmentationWorkflow,
    WatershedWorkflow,
    build,
)
from cluster_tools_tpu_torch.ops.multicut import agglomerative_clustering
from cluster_tools_tpu_torch.ops.rag import boundary_edge_features
from cluster_tools_tpu_torch.tasks.agglomerative_clustering import AGGLO_ASSIGNMENTS_NAME
from cluster_tools_tpu_torch.utils import file_reader

BLOCK = [12, 24, 24]
SHAPE = (24, 48, 48)
WS = {"threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10, "halo": [2, 6, 6],
      "apply_dt_2d": False, "apply_ws_2d": False}


@pytest.fixture
def volume(tmp_path):
    raw = ndimage.gaussian_filter(np.random.default_rng(42).random(SHAPE), (1.0, 2.0, 2.0))
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")
    path = str(tmp_path / "d.n5")
    jax_reader(path).create_dataset("bnd", data=raw, chunks=tuple(BLOCK), compression="gzip")
    return path, raw


def _config(tmp_path, name, **tasks):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu"})
    for task, conf in tasks.items():
        jax_cfg.write_config(config_dir, task, conf)
    return config_dir


def _ws(package, tmp_path, path, config_dir, key, agglomeration):
    wf_cls, run = (
        (JaxWatershedWorkflow, jax_build) if package == "jax" else (WatershedWorkflow, build)
    )
    wf = wf_cls(str(tmp_path / f"tmp_{key}"), config_dir, input_path=path, input_key="bnd",
                output_path=path, output_key=key, agglomeration=agglomeration)
    assert run([wf])
    return wf


def _read(path, key):
    return file_reader(path, "r")[key][:]


@pytest.mark.parametrize("threshold", [0.9, 0.5])
def test_agglomeration_byte_identical_to_jax(tmp_path, volume, threshold):
    """``WatershedWorkflow(agglomeration=True)``: the fragments under
    ``<key>_frag`` and their per-block merge equal JAX's; the merge only
    joins fragments of one block, keeps coverage and names each merged
    fragment by its smallest member."""
    path, _ = volume
    config_dir = _config(tmp_path, "configs", watershed=WS, agglomerate={"threshold": threshold})
    _ws("jax", tmp_path, path, config_dir, "agglo_jax", True)
    _ws("torch", tmp_path, path, config_dir, "agglo_torch", True)
    for suffix in ("_frag", ""):
        want = jax_reader(path, "r")[f"agglo_jax{suffix}"][:]
        got = _read(path, f"agglo_torch{suffix}")
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
    frag, merged = _read(path, "agglo_torch_frag"), _read(path, "agglo_torch")
    assert ((merged > 0) == (frag > 0)).all()
    fg = frag > 0
    pairs = np.unique(np.stack([frag[fg], merged[fg]], axis=1), axis=0)
    assert len(np.unique(pairs[:, 0])) == len(pairs)  # a fragment → one id
    assert (pairs[:, 1] <= pairs[:, 0]).all()  # the smallest member's id
    assert 1 < len(np.unique(merged[fg])) < len(np.unique(frag[fg]))


def test_agglomerate_rerun_is_idempotent(tmp_path, volume):
    """The fragments stay under their own key, so a resumed agglomeration
    (its status file gone) rewrites the same labels."""
    path, _ = volume
    config_dir = _config(tmp_path, "configs", watershed=WS, agglomerate={"threshold": 0.9})
    wf = _ws("torch", tmp_path, path, config_dir, "agglo", True)
    first = _read(path, "agglo")
    agglo = wf.requires()[0]
    os.remove(agglo.output().path)
    assert not wf.complete()
    assert build([wf])
    np.testing.assert_array_equal(_read(path, "agglo"), first)


def test_agglomerate_native_solver_equals_python(volume):
    """The per-block clustering: the native solver and the Python one give
    the same partition of a block's fragments."""
    _, raw = volume
    # fragments: the components of the foreground cut by a 6 x 8 x 8 grid
    cc, n = ndimage.label(raw < 0.5)
    cell = np.indices(SHAPE) // np.array([6, 8, 8])[:, None, None, None]
    cell = (cell[0] * 6 + cell[1]) * 6 + cell[2]
    seg = np.where(cc > 0, cell * (n + 1) + cc, 0).astype(np.uint64)
    edges, feats = boundary_edge_features(seg, raw.astype(np.float64))
    uniq = np.unique(seg[seg > 0])
    uv = np.searchsorted(uniq, edges).astype(np.int64)
    args = (uniq.size, uv, feats[:, 0], 0.3)
    native = agglomerative_clustering(*args, edge_sizes=feats[:, 9])
    python = agglomerative_clustering(*args, edge_sizes=feats[:, 9], use_native=False)
    np.testing.assert_array_equal(native, python)
    assert edges.shape[0] > 100 and 1 < native.max() + 1 < uniq.size


def _clustering(package, tmp_path, path, config_dir, tmp, ws_key, key):
    wf_cls, run = (
        (JaxAggloWorkflow, jax_build) if package == "jax"
        else (AgglomerativeClusteringWorkflow, build)
    )
    wf = wf_cls(str(tmp_path / tmp), config_dir, input_path=path, input_key="bnd",
                ws_path=path, ws_key=ws_key, output_path=path, output_key=key)
    assert run([wf])
    return wf


def test_agglomerative_clustering_workflow_byte_identical_to_jax(tmp_path, volume):
    """Threshold 0.6 over one watershed: the (fragment, segment) table and
    the segmentation equal JAX's; the segmentation merges fragments and
    keeps their coverage."""
    path, _ = volume
    config_dir = _config(tmp_path, "configs", watershed=WS,
                         agglomerative_clustering={"threshold": 0.6})
    _ws("torch", tmp_path, path, config_dir, "ws", False)
    _clustering("jax", tmp_path, path, config_dir, "tmp_ac_jax", "ws", "seg_jax")
    _clustering("torch", tmp_path, path, config_dir, "tmp_ac_torch", "ws", "seg_torch")
    tables = [np.load(str(tmp_path / t / AGGLO_ASSIGNMENTS_NAME))
              for t in ("tmp_ac_jax", "tmp_ac_torch")]
    assert tables[1].dtype == np.uint64
    np.testing.assert_array_equal(tables[1], tables[0])
    want = jax_reader(path, "r")["seg_jax"][:]
    got = _read(path, "seg_torch")
    np.testing.assert_array_equal(got, want)
    ws = _read(path, "ws")
    assert ((got > 0) == (ws > 0)).all()
    assert 1 < len(np.unique(got)) < len(np.unique(ws))


def test_agglomerative_clustering_reuses_multicut_graph_and_features(tmp_path, volume):
    """In a multicut workflow's tmp folder over the same watershed, the
    graph and feature tasks are complete: their status files stay as they
    were, and the segmentation equals a run in a fresh folder."""
    path, _ = volume
    config_dir = _config(tmp_path, "configs", watershed=WS,
                         agglomerative_clustering={"threshold": 0.6})
    mc = MulticutSegmentationWorkflow(
        str(tmp_path / "tmp_mc"), config_dir, input_path=path, input_key="bnd",
        ws_path=path, ws_key="ws", output_path=path, output_key="mc",
    )
    assert build([mc])
    status = os.path.join(tmp_path, "tmp_mc", "status")
    reused = ["initial_sub_graphs", "merge_sub_graphs", "map_edge_ids",
              "block_edge_features", "merge_edge_features"]

    def stamps():
        return {n: os.stat(os.path.join(status, f"{n}.status.json")).st_mtime_ns for n in reused}

    before = stamps()
    wf = _clustering("torch", tmp_path, path, config_dir, "tmp_mc", "ws", "seg_reused")
    assert stamps() == before
    assert os.path.exists(os.path.join(status, "write_agglomerative_clustering.status.json"))
    _clustering("torch", tmp_path, path, config_dir, "tmp_fresh", "ws", "seg_fresh")
    np.testing.assert_array_equal(_read(path, "seg_reused"), _read(path, "seg_fresh"))
    assert wf.complete()
