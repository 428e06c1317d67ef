"""PyTorch port: the lifted multicut against the JAX package.

The ops (the lifted neighborhood's frontier BFS, costs from node labels, the
merged problems, lifted GAEC native and in Python, the energy) equal JAX's
exactly on seeded graphs; the node-label lookup takes int64 and uint64 ids;
``LiftedMulticutSegmentationWorkflow`` on ``"device": "cpu"`` writes the
JAX ``local`` run's watershed, lifted problem, reduced problems, assignment
table and segmentation byte for byte, and each lifted-feature task's output
in a shared folder equals JAX's.

Where the hierarchical solve has more than one block, the port departs from
JAX on purpose (ROADMAP Queue C): JAX's ``SolveLiftedSubproblemsTask`` leaves
the edges between blocks in no subproblem and uncut, so its reduction merges
every pair of fragments that touch across a block face, whatever their
costs; the port cuts those edges and decides them at the next scale.  So
byte parity is held against the JAX workflow with that one rule added to its
subproblem task in the test (``jax_cuts_outer_edges``), and the unchanged
JAX run is held to the fault."""

import os

import numpy as np
import pytest

from cluster_tools_tpu import native as jax_native
from cluster_tools_tpu.ops import lifted as jax_lifted
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import lifted_features as jax_lifted_features
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import LiftedMulticutSegmentationWorkflow as JaxLmcWorkflow
from cluster_tools_tpu_torch import LiftedMulticutSegmentationWorkflow, build, native
from cluster_tools_tpu_torch.ops import lifted
from cluster_tools_tpu_torch.tasks import lifted_features
from cluster_tools_tpu_torch.tasks.lifted_features import (
    ClearLiftedEdgesFromLabelsTask,
    MergeLiftedProblemsTask,
)
from cluster_tools_tpu_torch.tasks.lifted_multicut import LIFTED_ASSIGNMENTS_NAME
from cluster_tools_tpu_torch.utils import file_reader


def _graph(seed, n=60, m=150):
    rng = np.random.default_rng(seed)
    edges = np.unique(np.sort(rng.integers(0, n, (m, 2)), axis=1), axis=0)
    return n, edges[edges[:, 0] != edges[:, 1]].astype(np.int64), rng


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(4))
def test_lifted_neighborhood_equals_jax(seed, depth):
    n, edges, rng = _graph(seed)
    part = rng.random(n) < 0.7
    got = lifted.lifted_neighborhood(n, edges, part, depth=depth)
    want = jax_lifted.lifted_neighborhood(n, edges, part, depth=depth)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_lifted_neighborhood_high_degree_hub():
    """300 parallel 2-paths through a hub layer (past int8 and int16 path
    counts) and a star: every pair JAX finds, and the hub pair itself."""
    n = 400
    inter = np.arange(1, 301)
    edges = np.concatenate([
        np.stack([np.zeros_like(inter), inter], axis=1),
        np.stack([inter, np.full_like(inter, n - 1)], axis=1),
        np.stack([np.full(50, 301), np.arange(302, 352)], axis=1),
    ]).astype(np.int64)
    part = np.ones(n, dtype=bool)
    got = lifted.lifted_neighborhood(n, edges, part, depth=3)
    np.testing.assert_array_equal(got, jax_lifted.lifted_neighborhood(n, edges, part, depth=3))
    assert {(0, n - 1), (302, 351)} <= {tuple(p) for p in got}


@pytest.mark.parametrize("ignore_label", [0, None])
def test_costs_from_node_labels_and_merge_equal_jax(ignore_label):
    n, edges, rng = _graph(5)
    uv = lifted.lifted_neighborhood(n, edges, np.ones(n, bool), depth=3)
    labels = rng.integers(0, 4, n)
    got = lifted.lifted_costs_from_node_labels(uv, labels, 2.5, -1.5, ignore_label)
    want = jax_lifted.lifted_costs_from_node_labels(uv, labels, 2.5, -1.5, ignore_label)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    other = (uv[::3], rng.normal(size=uv[::3].shape[0]))
    empty = (np.zeros((0, 2), np.int64), np.zeros(0))
    for problems in ([got, other], [got, other, empty], [empty]):
        for a, b in zip(lifted.merge_lifted_problems(problems),
                        jax_lifted.merge_lifted_problems(problems)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _problem(seed, n=80):
    n, uv, rng = _graph(seed, n=n, m=3 * n)
    costs = rng.normal(0.5, 1.5, uv.shape[0])
    luv = np.unique(np.sort(rng.integers(0, n, (n // 2, 2)), axis=1), axis=0)
    luv = luv[luv[:, 0] != luv[:, 1]].astype(np.int64)
    return n, uv, costs, luv, rng.normal(-1.0, 2.0, luv.shape[0])


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("seed", range(4))
def test_solve_lifted_multicut_equals_jax(seed, use_native):
    if use_native and not (native.available() and jax_native.available()):
        pytest.skip("native solvers unavailable")
    n, uv, costs, luv, lcosts = _problem(seed)
    got = lifted.solve_lifted_multicut(n, uv, costs, luv, lcosts, use_native=use_native)
    want = jax_lifted.solve_lifted_multicut(n, uv, costs, luv, lcosts, use_native=use_native)
    np.testing.assert_array_equal(got, want)
    assert lifted.lifted_multicut_energy(uv, costs, luv, lcosts, got) == \
        jax_lifted.lifted_multicut_energy(uv, costs, luv, lcosts, want)
    roots = lifted._lifted_gaec_python(n, uv, costs, luv, lcosts)
    np.testing.assert_array_equal(roots, jax_lifted._lifted_gaec_python(n, uv, costs, luv, lcosts))
    if use_native:  # both solvers reach the same partition (their roots differ)
        np.testing.assert_array_equal(_first_seen(got), _first_seen(roots))


def _first_seen(labels):
    """A partition's labels renumbered in order of first appearance."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return np.argsort(np.argsort(first))[inv]


def test_solve_lifted_multicut_degenerate_problems():
    n, uv, costs, luv, lcosts = _problem(7)
    none = np.zeros((0, 2), np.int64)
    for args in ((n, none, np.zeros(0), luv, lcosts), (n, uv, costs, none, np.zeros(0))):
        np.testing.assert_array_equal(lifted.solve_lifted_multicut(*args),
                                      jax_lifted.solve_lifted_multicut(*args))
    with pytest.raises(ValueError, match="outside"):
        native.lifted_gaec(3, np.array([[0, 3]]), np.ones(1), none, np.zeros(0))


class _Task:
    def __init__(self, tmp_folder):
        self.tmp_folder = tmp_folder


@pytest.mark.parametrize("dtype", ["int64", "uint64"])
@pytest.mark.parametrize("form", ["dense", "table", "default"])
def test_dense_node_labels(tmp_path, dtype, form):
    nodes = np.array([0, 3, 4, 9, 2**40], dtype=dtype)
    if form == "dense":
        path = str(tmp_path / "dense.npy")
        table = np.zeros(10, dtype=dtype)
        table[[3, 9]] = [5, 6]
        nodes = nodes[:-1]  # a dense table covers the largest id
    else:
        path = None if form == "default" else str(tmp_path / "table.npy")
        table = np.array([[3, 5], [9, 6], [2**40, 7], [11, 8]], dtype="uint64")
    np.save(path or os.path.join(tmp_path, "node_labels.npy"), table)
    got = lifted_features.dense_node_labels(_Task(str(tmp_path)), nodes, path)
    want = jax_lifted_features.dense_node_labels(_Task(str(tmp_path)), nodes, path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if form == "dense":
        with pytest.raises(ValueError, match="largest graph node"):
            lifted_features.dense_node_labels(_Task(str(tmp_path)), np.array([11]), path)


@pytest.fixture
def cells_with_classes(tmp_path):
    """Voronoi cells with boundary ridges and a 2-class prior (the JAX
    lifted-multicut tests' fixture), gzip n5 written by the JAX package."""
    rng = np.random.default_rng(42)
    shape = (24, 48, 48)
    pts = rng.integers(0, 48, (24, 3))
    pts[:, 0] = pts[:, 0] % shape[0]
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    d = np.full(shape, 1e9)
    second = np.full(shape, 1e9)
    for p in pts:
        dist = (zz - p[0]) ** 2 + (yy - p[1]) ** 2 + (xx - p[2]) ** 2
        newmin = dist < d
        second = np.where(newmin, d, np.minimum(second, dist))
        d = np.where(newmin, dist, d)
    bnd = np.exp(-((np.sqrt(second) - np.sqrt(d)) ** 2) / 8.0).astype("float32")
    classes = np.where(xx < shape[2] // 2, 1, 2).astype("uint64")
    path = str(tmp_path / "d.n5")
    f = jax_reader(path)
    f.create_dataset("bnd", data=bnd, chunks=(12, 24, 24), compression="gzip")
    f.create_dataset("classes", data=classes, chunks=(12, 24, 24), compression="gzip")
    return path, classes


BLOCKS = [12, 24, 24]


@pytest.fixture
def jax_cuts_outer_edges(monkeypatch):
    """The JAX subproblem task with the port's rule: after its own cut
    edges, the edges that leave the block's node set are cut too."""
    from cluster_tools_tpu.tasks import lifted_multicut as jax_lmc

    solve = jax_lmc.SolveLiftedSubproblemsTask.process_block

    def process_block(task, block_id, blocking, config):
        solve(task, block_id, blocking, config)
        nodes, _ = jax_lmc.load_graph(task.tmp_store())
        edges, _, _, _, labeling = jax_lmc.load_lifted_scale_problem(task, task.scale, task.prefix)
        dense = jax_lmc.block_dense_nodes(nodes, task.input_ds()[blocking.block(block_id).slicing])
        if dense.size == 0 or edges.shape[0] == 0:
            return
        member = jax_lmc.extract_cluster_subgraph(edges, labeling, dense)[3]
        outer = np.nonzero(member[edges[:, 0]] != member[edges[:, 1]])[0]
        ds = task.tmp_store()[f"lifted_multicut/s{task.scale}/cut_edges"]
        ds.write_chunk((block_id,), np.union1d(ds.read_chunk((block_id,)), outer).astype(np.int64))

    monkeypatch.setattr(jax_lmc.SolveLiftedSubproblemsTask, "process_block", process_block)


def _config(tmp_path, name, **gconf):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(
        config_dir, {"block_shape": BLOCKS, "device": "cpu", **gconf})
    jax_cfg.write_config(config_dir, "watershed", {
        "threshold": 0.4, "sigma_seeds": 1.6, "size_filter": 10, "apply_dt_2d": False,
        "apply_ws_2d": False, "halo": [2, 4, 4]})
    jax_cfg.write_config(config_dir, "costs_from_node_labels",
                         {"same_cost": 4.0, "different_cost": -4.0})
    return config_dir


def _lmc(package, tmp_path, path, config_dir, tag, **kw):
    wf_cls, run = (JaxLmcWorkflow, jax_build) if package == "jax" else (
        LiftedMulticutSegmentationWorkflow, build)
    tmp = str(tmp_path / f"tmp_{tag}_{package}")
    assert run([wf_cls(tmp, config_dir, input_path=path, input_key="bnd", ws_path=path,
                       ws_key=f"ws_{tag}_{package}", labels_path=path, labels_key="classes",
                       output_path=path, output_key=f"seg_{tag}_{package}", **kw)])
    return tmp


def _npz_equal(a, b):
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("n_scales,target,clear", [
    (1, "local", None), (2, "cuda", None), (1, "local", [2]), (0, "cuda", None),
], ids=["scales1", "scales2-cuda", "clear", "scales0-cuda"])
def test_lifted_segmentation_workflow_byte_identical_to_jax(
        tmp_path, cells_with_classes, jax_cuts_outer_edges, n_scales, target, clear):
    path, classes = cells_with_classes
    jax_dir = _config(tmp_path, "configs_jax")
    port_dir = _config(tmp_path, "configs_port", target=target, device_batch_size=2)
    kw = {"n_scales": n_scales, "clear_labels": clear}
    tmps = {"jax": _lmc("jax", tmp_path, path, jax_dir, "t", **kw),
            "torch": _lmc("torch", tmp_path, path, port_dir, "t", **kw)}
    f = file_reader(path, "r")
    for key in ("ws", "seg"):
        np.testing.assert_array_equal(f[f"{key}_t_torch"][:], f[f"{key}_t_jax"][:])
    names = ["lifted_problem_lifted.npz"] + [
        f"lifted_multicut_s{s}.npz" for s in range(1, n_scales + 1)]
    for name in names:
        _npz_equal(*(os.path.join(tmps[p], name) for p in ("torch", "jax")))
    for s in range(n_scales):
        key = f"lifted_multicut/s{s}/cut_edges"
        cuts = [file_reader(os.path.join(tmps[p], "data.zarr"), "r")[key] for p in ("torch", "jax")]
        for bid in range(8 if s == 0 else 1):
            np.testing.assert_array_equal(*(c.read_chunk((bid,)) for c in cuts))
    for name in (LIFTED_ASSIGNMENTS_NAME, "node_labels.npy", "costs.npy"):
        np.testing.assert_array_equal(*(np.load(os.path.join(tmps[p], name))
                                        for p in ("torch", "jax")))
    seg = f["seg_t_torch"][:]
    ids = np.unique(seg[seg > 0])
    straddle = sum(np.unique(classes[seg == i]).size > 1 for i in ids)
    assert ids.size > 5 and straddle / ids.size < 0.5
    with np.load(os.path.join(tmps["torch"], names[0])) as prob:
        assert prob["uv"].shape[0] > 0
        if clear:  # no lifted edge touches a cleared class
            labels = lifted_features.dense_node_labels(
                _Task(tmps["torch"]), file_reader(
                    os.path.join(tmps["torch"], "data.zarr"), "r")["graph/nodes"][:])
            assert not np.isin(labels[prob["uv"]], clear).any()


def test_edges_between_blocks_are_decided_not_merged(tmp_path, cells_with_classes):
    """Eight blocks, n_scales 1, the class border on a block face: JAX's
    reduction merges every pair of fragments touching across a block face
    (the fault); the port's keeps each such pair in two clusters for the
    global solve, which then holds the classes apart, at a lower lifted
    energy than JAX's.  The watershed, graph, costs and lifted problem stay
    byte-identical."""
    path, classes = cells_with_classes
    config_dir = _config(tmp_path, "configs")
    tmps = {p: _lmc(p, tmp_path, path, config_dir, "f") for p in ("jax", "torch")}
    for name in ("lifted_problem_lifted.npz",):
        _npz_equal(*(os.path.join(tmps[p], name) for p in ("torch", "jax")))
    np.testing.assert_array_equal(*(np.load(os.path.join(tmps[p], "costs.npy"))
                                    for p in ("torch", "jax")))
    scratch = file_reader(os.path.join(tmps["torch"], "data.zarr"), "r")
    nodes, edges = scratch["graph/nodes"][:], scratch["graph/edges"][:]
    block = (nodes.astype(np.int64) - 1) // int(np.prod(BLOCKS))
    across = block[edges[:, 0]] != block[edges[:, 1]]
    assert across.any()
    energy = {}
    for p, tmp in tmps.items():
        with np.load(os.path.join(tmp, "lifted_multicut_s1.npz")) as s1:
            labeling = s1["node_labeling"]
        merged = labeling[edges[across, 0]] == labeling[edges[across, 1]]
        assert merged.all() if p == "jax" else not merged.any()
        table = np.load(os.path.join(tmp, LIFTED_ASSIGNMENTS_NAME))
        costs = np.load(os.path.join(tmp, "costs.npy"))
        with np.load(os.path.join(tmp, "lifted_problem_lifted.npz")) as prob:
            energy[p] = lifted.lifted_multicut_energy(
                edges, costs, prob["uv"], prob["costs"], table[:, 1].astype(np.int64))
    assert energy["torch"] < energy["jax"]
    seg = file_reader(path, "r")["seg_f_torch"][:]
    ids = np.unique(seg[seg > 0])
    straddle = sum(np.unique(classes[seg == i]).size > 1 for i in ids)
    assert ids.size > 5 and straddle / ids.size < 0.5


def test_lifted_feature_tasks_in_a_shared_folder_equal_jax(tmp_path, cells_with_classes):
    """``MergeLiftedProblemsTask`` and ``ClearLiftedEdgesFromLabelsTask`` run
    by each package on copies of one JAX-made tmp folder give JAX's files."""
    import shutil

    from cluster_tools_tpu.tasks.lifted_features import (
        ClearLiftedEdgesFromLabelsTask as JaxClear,
        MergeLiftedProblemsTask as JaxMerge,
    )

    path, _ = cells_with_classes
    config_dir = _config(tmp_path, "configs")
    src = _lmc("jax", tmp_path, path, config_dir, "m")
    with np.load(os.path.join(src, "lifted_problem_lifted.npz")) as p:
        uv, costs = p["uv"], p["costs"]
    for package, merge_cls, clear_cls, run in (
            ("jax", JaxMerge, JaxClear, jax_build),
            ("torch", MergeLiftedProblemsTask, ClearLiftedEdgesFromLabelsTask, build)):
        tmp = str(tmp_path / f"shared_{package}")
        shutil.copytree(src, tmp)
        np.savez(os.path.join(tmp, "lifted_problem_extra.npz"), uv=uv[::2],
                 costs=np.linspace(-1, 1, uv[::2].shape[0]))
        merge = merge_cls(tmp, config_dir, prefixes=("lifted", "extra"), out_prefix="merged")
        clear = clear_cls(tmp, config_dir, dependencies=[merge], prefix="merged",
                          clear_labels=[1])
        assert run([clear])
    _npz_equal(*(os.path.join(str(tmp_path / f"shared_{p}"), "lifted_problem_merged.npz")
                 for p in ("torch", "jax")))
    with np.load(str(tmp_path / "shared_torch" / "lifted_problem_merged.npz")) as merged:
        assert 0 < merged["uv"].shape[0] < uv.shape[0] and costs.size
