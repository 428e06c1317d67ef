"""PyTorch port, the affinity family: ``ops/affinities.py``,
``ops/watershed.py::fit_to_hmap`` and the three tasks of
``tasks/affinities.py`` against the JAX package on the CPU (the JAX
``tests/test_affinities.py`` cases), inputs made by numpy from a seed.

Contracts: label affinities, masks, dilation, erosion and the refit labels
exactly; the float outputs bitwise too (the port rounds each operation as
the JAX program does on the CPU: fused multiply-adds where XLA fuses a
channel sum, the float32 reciprocal of XLA's mean, correctly rounded square
roots); the uint8 ``InsertAffinitiesTask`` output byte for byte."""

import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops import affinities as jaff
from cluster_tools_tpu.ops.watershed import fit_to_hmap as jax_fit_to_hmap
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import affinities as jtasks
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.ops import affinities as taff
from cluster_tools_tpu_torch.ops.watershed import fit_to_hmap
from cluster_tools_tpu_torch.tasks import affinities as ttasks
from cluster_tools_tpu_torch.utils import file_reader

SHAPE = (16, 32, 32)
BLOCK = [8, 16, 16]
OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
PACKAGES = {"jax": (jax_build, jtasks), "torch": (build, ttasks)}


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("dtype", ["int32", "uint64"])
def test_compute_affinities_equal_jax(dtype):
    labels = np.random.default_rng(0).integers(0, 4, (6, 8, 8)).astype(dtype)
    if dtype == "uint64":
        labels[labels == 3] = np.uint64(2**32 + 1)  # collides with 1 mod 2**32
    offsets = [[-1, 0, 0], [0, -1, 0], [0, 0, -2], [2, 1, -3]]
    want_a, want_m = jaff.compute_affinities(labels, offsets)
    got_a, got_m = taff.compute_affinities(labels, offsets)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(got_m.numpy(), want_m)


@pytest.mark.parametrize("norm", ["l2", "cosine"])
def test_embedding_distances_bitwise(norm):
    emb = np.random.default_rng(1).random((4, 5, 6, 7)).astype(np.float32)
    offsets = [[-1, 0, 0], [0, -1, 0], [0, 0, -3], [1, 2, 0]]
    want = jaff.embedding_distances(emb, offsets, norm)
    got = taff.embedding_distances(torch.from_numpy(emb), offsets, norm).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_dilation_erosion_equal_jax(iterations):
    rng = np.random.default_rng(2)
    x = rng.random((8, 12, 12)) > 0.9
    for in_2d in (False, True):
        want = np.asarray(jaff.binary_dilation(x, iterations, in_2d=in_2d))
        got = taff.binary_dilation(torch.from_numpy(x), iterations, in_2d=in_2d).numpy()
        np.testing.assert_array_equal(got, want)
    y = ndimage.binary_dilation(rng.random((8, 12, 12)) > 0.95, iterations=3)
    want = np.asarray(jaff.binary_erosion(y, iterations))
    got = taff.binary_erosion(torch.from_numpy(y), iterations).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ndimage.binary_erosion(y, iterations=iterations))


def test_gradient_mean_bitwise():
    x = np.random.default_rng(3).random((8, 9, 10)).astype(np.float32)
    want = np.asarray(jaff.gradient_mean(x))
    got = taff.gradient_mean(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _objects(shape=SHAPE):
    objs = np.zeros(shape, dtype="uint64")
    objs[3:13, 6:26, 5:15] = 1
    objs[3:13, 6:26, 17:28] = np.uint64(2**40 + 2)
    objs[5:11, 20:30, 2:12] = 9
    return objs


@pytest.mark.parametrize("erode_by,erode_3d", [(1, True), (3, False)])
def test_fit_to_hmap_equal_jax(erode_by, erode_3d):
    hmap = ndimage.gaussian_filter(np.random.default_rng(4).random(SHAPE), 2).astype(np.float32)
    want = jax_fit_to_hmap(_objects(), hmap.copy(), erode_by, erode_3d)
    got = fit_to_hmap(_objects(), torch.from_numpy(hmap), erode_by, erode_3d)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- the tasks


def _setup(tmp_path, name, **datasets):
    path = str(tmp_path / "d.n5")
    f = jax_reader(path)
    for key, data in datasets.items():
        chunks = ((1,) if data.ndim == 4 else ()) + tuple(BLOCK)
        f.create_dataset(key, data=data, chunks=chunks, compression="gzip")
    config_dir = str(tmp_path / f"configs_{name}")
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu"})
    return path, config_dir


@pytest.mark.parametrize("dtype,conf", [
    ("uint8", {"erode_by": 2, "erode_3d": True}),
    ("uint8", {"erode_by": 0, "erode_3d": False, "zero_objects_list": [9]}),
    ("float32", {"erode_by": 2, "erode_3d": False, "dilate_by": 1}),
], ids=["uint8-refit", "uint8-zero-objects", "float32-refit-2d"])
def test_insert_affinities_equal_jax(tmp_path, dtype, conf):
    rng = np.random.default_rng(5)
    affs = ndimage.gaussian_filter(rng.random((3,) + SHAPE), (0, 1, 2, 2)).astype(np.float32)
    if dtype == "uint8":
        affs = (affs * 255).astype("uint8")
    objs = _objects()
    objs[:, :, 29:] = 0
    objs[:11, :21, 11:] = 0  # block (0, 0, 1) and its halo hold no object: copied
    path, config_dir = _setup(tmp_path, "ins", affs=affs, objs=objs)
    jax_cfg.write_config(config_dir, "insert_affinities", conf)
    out = {}
    for package, (run, tasks) in PACKAGES.items():
        task = tasks.InsertAffinitiesTask(
            str(tmp_path / f"tmp_{package}"), config_dir, input_path=path, input_key="affs",
            output_path=path, output_key=f"out_{package}", objects_path=path,
            objects_key="objs", offsets=OFFSETS,
        )
        assert run([task])
        out[package] = file_reader(path, "r")[f"out_{package}"][:]
    assert out["torch"].dtype == np.dtype(dtype) and out["torch"].shape == affs.shape
    np.testing.assert_array_equal(out["torch"], out["jax"])
    np.testing.assert_array_equal(out["torch"][:, :8, :16, 16:], affs[:, :8, :16, 16:])
    assert (out["torch"] != affs).any()


def test_embedding_distances_task_equal_jax(tmp_path):
    rng = np.random.default_rng(6)
    chans = {f"c{i}": rng.random(SHAPE).astype("float32") for i in range(3)}
    path, config_dir = _setup(tmp_path, "emb", **chans)
    offsets = [[-1, 0, 0], [0, 0, -1], [0, -2, 0]]
    out = {}
    for package, (run, tasks) in PACKAGES.items():
        task = tasks.EmbeddingDistancesTask(
            str(tmp_path / f"tmp_{package}"), config_dir, input_paths=[path] * 3,
            input_keys=list(chans), output_path=path, output_key=f"dist_{package}",
            offsets=offsets,
        )
        assert run([task])
        out[package] = file_reader(path, "r")[f"dist_{package}"][:]
    np.testing.assert_array_equal(out["torch"], out["jax"])


@pytest.mark.parametrize("average", [True, False])
def test_gradients_task_equal_jax(tmp_path, average):
    rng = np.random.default_rng(7)
    chans = {f"x{i}": ndimage.gaussian_filter(rng.random(SHAPE), 2.0).astype("float32") for i in range(2)}
    path, config_dir = _setup(tmp_path, "grad", **chans)
    jax_cfg.write_config(config_dir, "gradients", {"average_gradient": average})
    out = {}
    for package, (run, tasks) in PACKAGES.items():
        task = tasks.GradientsTask(
            str(tmp_path / f"tmp_{package}"), config_dir, input_paths=[path] * 2,
            input_keys=list(chans), output_path=path, output_key=f"grad_{package}",
        )
        assert run([task])
        out[package] = file_reader(path, "r")[f"grad_{package}"][:]
    assert out["torch"].shape == (SHAPE if average else (2,) + SHAPE)
    np.testing.assert_array_equal(out["torch"], out["jax"])
