"""PyTorch port, skeletons, distances and meshes: ``ops/skeleton.py``,
``ops/mesh.py`` and ``SkeletonWorkflow``, ``SkeletonEvaluationWorkflow``,
``UpsampleSkeletonsTask``, ``DistanceWorkflow`` and ``MeshWorkflow`` against
the JAX package on the CPU.

Inputs: JAX's two-rod volume plus seeded blobs (several objects per block,
objects across block faces, anisotropic resolutions).  Contract: equal to
JAX's everywhere — skeleton nodes and edges (the port's EDT on the CPU
equals JAX's bit for bit, so the roots and paths are the same), the skeleton
evaluation, the painted skeleton volume, the object distances (with a pixel
pitch) and every mesh file (obj, ply, npz) byte for byte, on the port's
``local`` and ``cuda`` targets."""

import os

import numpy as np
import pytest
from scipy import ndimage

from cluster_tools_tpu.ops import mesh as jmesh
from cluster_tools_tpu.ops import skeleton as jskel
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import distances as jdist
from cluster_tools_tpu.tasks import skeletons as jsk
from cluster_tools_tpu import workflows as jwf
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch import workflows as twf
from cluster_tools_tpu_torch.ops import mesh as tmesh
from cluster_tools_tpu_torch.ops import skeleton as tskel
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks import distances as tdist
from cluster_tools_tpu_torch.tasks import skeletons as tsk
from cluster_tools_tpu_torch.utils import file_reader

BLOCK = [8, 16, 16]


def volume():
    """JAX's two rods along x (a 6-voxel gap in y) and, beside them, seeded
    blobs: scipy's components of a smoothed noise field."""
    shape = (12, 24, 56)
    seg = np.zeros(shape, dtype="uint64")
    seg[4:8, 4:8, 4:36] = 1
    seg[4:8, 14:18, 4:36] = 2
    noise = ndimage.gaussian_filter(np.random.default_rng(0).random((12, 24, 16)), 1.5)
    blobs, n = ndimage.label(noise > np.quantile(noise, 0.6))
    seg[:, :, 40:] = np.where(blobs > 0, blobs + 2, 0).astype("uint64")
    assert n >= 3
    return seg


OBJECTS = {
    "rod": (np.s_[2:5, 2:5, 2:38], (7, 7, 40)),
    "slab": (np.s_[1:4, 1:9, 2:19], (5, 10, 20)),
    "ball": (None, (11, 11, 11)),
}


def make_object(name):
    sl, shape = OBJECTS[name]
    obj = np.zeros(shape, dtype=bool)
    if sl is None:
        zz, yy, xx = np.mgrid[:11, :11, :11]
        obj[(zz - 5) ** 2 + (yy - 5) ** 2 + (xx - 5) ** 2 <= 16] = True
    else:
        obj[sl] = True
    return obj


@pytest.mark.parametrize("resolution", [None, [10.0, 4.0, 4.0]])
@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_skeletonize_matches_jax(name, resolution):
    obj = make_object(name)
    want = jskel.skeletonize(obj, resolution=resolution)
    got = tskel.skeletonize(obj, resolution=resolution, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    vox = np.round(got[0] / (resolution or 1.0)).astype(int)
    assert obj[tuple(vox.T)].all()


@pytest.mark.parametrize("smoothing", [0, 2])
@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_meshes_and_writers_match_jax(name, smoothing, tmp_path):
    obj = make_object(name)
    want = jmesh.marching_cubes(obj, smoothing_iterations=smoothing, resolution=[2.0, 1.0, 1.0])
    got = tmesh.marching_cubes(obj, smoothing_iterations=smoothing, resolution=[2.0, 1.0, 1.0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for writer in ("write_obj", "write_ply", "write_numpy"):
        ext = {"write_obj": "obj", "write_ply": "ply", "write_numpy": "npz"}[writer]
        a, b = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        getattr(tmesh, writer)(a, *got)
        getattr(jmesh, writer)(b, *want)
        if ext == "npz":
            with np.load(a) as fa, np.load(b) as fb:
                assert sorted(fa.files) == sorted(fb.files)
                for k in fa.files:
                    np.testing.assert_array_equal(fa[k], fb[k])
        else:
            assert open(a).read() == open(b).read()
    verts, faces, normals = tmesh.read_obj(str(tmp_path / "t.obj"))
    np.testing.assert_array_equal(faces, got[1])


def run_both(tmp_path, make, target="local", task_configs=None):
    """``make(package, tmp_folder, config_dir, path)`` through both packages
    on one input; returns the two tmp folders and the input path."""
    path = str(tmp_path / "seg.n5")
    file_reader(path).create_dataset("seg", data=volume(), chunks=tuple(BLOCK))
    tmps = {}
    for package, mod, run in (("jax", jax_cfg, jax_build), ("torch", cfg, build)):
        config_dir = str(tmp_path / f"configs_{package}")
        mod.write_global_config(config_dir, {
            "block_shape": BLOCK, "device": "cpu",
            "target": "local" if package == "jax" else target})
        for name, conf in (task_configs or {}).items():
            mod.write_config(config_dir, name, conf)
        tmps[package] = str(tmp_path / f"tmp_{package}")
        assert run(make(package, tmps[package], config_dir, path))
    return tmps, path


def same_skeletons(a, b):
    assert sorted(a) == sorted(b)
    for sid in a:
        for g, w in zip(a[sid], b[sid]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_skeleton_evaluation_workflow_matches_jax(tmp_path, target):
    def make(package, tmp, config_dir, path):
        wf = (jwf if package == "jax" else twf).SkeletonEvaluationWorkflow
        return [wf(tmp, config_dir, input_path=path, input_key="seg", seg_path=path,
                   seg_key="seg")]

    tmps, _ = run_both(tmp_path, make, target, {"skeletonize": {"resolution": [2.0, 1.0, 1.0]},
                                               "skeleton_evaluation": {"resolution": [2.0, 1.0, 1.0]}})
    got, want = tsk.load_skeletons(tmps["torch"]), jsk.load_skeletons(tmps["jax"])
    same_skeletons(got, want)
    assert {1, 2} <= set(got) and len(got) >= 5
    ev_t = tsk.load_skeleton_evaluation(tmps["torch"])
    ev_j = jsk.load_skeleton_evaluation(tmps["jax"])
    assert sorted(ev_t) == sorted(ev_j)
    for k in ev_t:
        np.testing.assert_array_equal(ev_t[k], ev_j[k])
    np.testing.assert_allclose(ev_t["correctness"], 1.0)


def test_skeleton_workflow_size_filter_and_upsampling_match_jax(tmp_path):
    def make(package, tmp, config_dir, path):
        mods = (jwf, jsk) if package == "jax" else (twf, tsk)
        skel = mods[0].SkeletonWorkflow(tmp, config_dir, input_path=path, input_key="seg")
        up = mods[1].UpsampleSkeletonsTask(tmp, config_dir, dependencies=[skel],
                                           input_path=path, input_key="seg",
                                           output_path=path, output_key=f"skel_{package}")
        return [up]

    tmps, path = run_both(tmp_path, make, task_configs={"skeletonize": {"size_threshold": 200}})
    got, want = tsk.load_skeletons(tmps["torch"]), jsk.load_skeletons(tmps["jax"])
    same_skeletons(got, want)
    seg = volume()
    sizes = {int(i): int(n) for i, n in zip(*np.unique(seg, return_counts=True))}
    assert set(got) == {i for i, n in sizes.items() if i and n >= 200}
    f = file_reader(path, "r")
    painted = f["skel_torch"][:]
    np.testing.assert_array_equal(painted, f["skel_jax"][:])
    for sid in (1, 2):  # a straight rod's nodes and edge midpoints lie in it
        sel = painted == sid
        assert sel.sum() >= 2 and (seg[sel] == sid).all()


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_distance_workflow_matches_jax(tmp_path, target):
    def make(package, tmp, config_dir, path):
        wf = (jwf if package == "jax" else twf).DistanceWorkflow
        return [wf(tmp, config_dir, input_path=path, input_key="seg")]

    tmps, _ = run_both(tmp_path, make, target, {"object_distances": {
        "max_distance": 12.0, "resolution": [2.0, 1.0, 1.0]}})
    got = tdist.load_object_distances(tmps["torch"])
    want = jdist.load_object_distances(tmps["jax"])
    assert got == want
    assert abs(got[(1, 2)] - 7.0) < 1e-6  # the rods' gap: 6 voxels, 7 to the far voxel centre
    assert len(got) >= 3


@pytest.mark.parametrize("fmt", ["obj", "ply", "npy"])
def test_mesh_workflow_matches_jax(tmp_path, fmt):
    def make(package, tmp, config_dir, path):
        wf = (jwf if package == "jax" else twf).MeshWorkflow
        return [wf(tmp, config_dir, input_path=path, input_key="seg",
                   output_dir=str(tmp_path / f"meshes_{package}"))]

    run_both(tmp_path, make, "cuda", {"compute_meshes": {
        "output_format": fmt, "resolution": [2.0, 1.0, 1.0], "smoothing_iterations": 1,
        "size_threshold": 20}})
    a, b = str(tmp_path / "meshes_torch"), str(tmp_path / "meshes_jax")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) >= 3
    for name in names:
        if fmt == "npy":
            with np.load(os.path.join(a, name)) as fa, np.load(os.path.join(b, name)) as fb:
                for k in fa.files:
                    np.testing.assert_array_equal(fa[k], fb[k])
        else:
            assert open(os.path.join(a, name)).read() == open(os.path.join(b, name)).read()
