"""PyTorch port, volume ops: ``CopyVolumeTask``, ``LinearTransformationTask``
(and its workflow), ``BlocksFromMaskTask`` and ``MinfilterTask`` against the
JAX package on the CPU, on a seeded (24, 48, 48) map in blocks of
(12, 24, 24), ragged where the shape is cut.

Contract: every output byte-identical to JAX's — each chunk file and each
attribute of the written datasets, the JSON block list.  The affine step
``a*x + b`` is exact: JAX's XLA program fuses it into one multiply-add on the
CPU, the port rounds the fused result once on every device (``fma32``).  The
port's tasks run on its ``local`` target and, for the batch protocol, on its
``cuda`` target (the CPU device, two blocks per batch); JAX's on ``local``."""

import json
import os

import numpy as np
import pytest

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import copy_volume as jcopy
from cluster_tools_tpu.tasks import masking as jmask
from cluster_tools_tpu.tasks import transformations as jtrafo
from cluster_tools_tpu import workflows as jwf
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch import workflows as twf
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks import copy_volume as tcopy
from cluster_tools_tpu_torch.tasks import masking as tmask
from cluster_tools_tpu_torch.tasks import transformations as ttrafo
from cluster_tools_tpu_torch.utils import file_reader

SHAPE = (24, 44, 48)
BLOCK = [12, 24, 24]


def same_tree(root_a, root_b) -> int:
    """Every file under two directories equal byte for byte (JSON files,
    the attributes, as parsed objects); returns the file count."""
    files = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)  # noqa: E731
                             for r, _, fs in os.walk(d) for f in fs)
    assert files(root_a) == files(root_b)
    for rel in files(root_a):
        with open(os.path.join(root_a, rel), "rb") as fa, open(os.path.join(root_b, rel), "rb") as fb:
            a, b = fa.read(), fb.read()
        if rel.endswith(".json"):
            assert json.loads(a) == json.loads(b), rel
        else:
            assert a == b, rel
    return len(files(root_a))


def same_dataset(path_a, key_a, path_b, key_b):
    """Two n5 datasets equal chunk file for chunk file, attributes
    included; returns the first's array."""
    same_tree(os.path.join(path_a, key_a), os.path.join(path_b, key_b))
    return file_reader(path_a, "r")[key_a][:]


@pytest.fixture
def data(tmp_path):
    rng = np.random.default_rng(0)
    raw = rng.random(SHAPE).astype(np.float32)
    path = str(tmp_path / "in.n5")
    f = file_reader(path)
    ds = f.create_dataset("raw", data=raw, chunks=tuple(BLOCK), compression="gzip")
    ds.attrs["resolution"] = [40, 4, 4]
    f.create_dataset("raw8", data=(raw * 255).astype(np.uint8), chunks=tuple(BLOCK),
                     compression="gzip")
    f.create_dataset("affs", data=rng.random((3,) + SHAPE).astype(np.float32),
                     chunks=(1,) + tuple(BLOCK), compression="gzip")
    labels = rng.integers(0, 5, SHAPE).astype(np.uint64)
    f.create_dataset("labels", data=labels, chunks=tuple(BLOCK), compression="gzip")
    mask = np.zeros(SHAPE, np.uint8)
    mask[2:20, 5:20, 3:30] = 1
    f.create_dataset("mask", data=mask, chunks=tuple(BLOCK), compression="gzip")
    f.create_dataset("mask_half", data=mask[::2, ::2, ::2], chunks=(6, 12, 12),
                     compression="gzip")
    return tmp_path, path, raw


def configs(tmp_path, target="local", **extra):
    """One config dir per package: JAX's on ``local``, the port's on
    ``target``; both with device cpu, two blocks per batch, the global keys
    of ``extra["global"]`` and the task configs of ``extra["tasks"]``."""
    dirs = {}
    for package, mod in (("jax", jax_cfg), ("torch", cfg)):
        d = str(tmp_path / f"configs_{package}")
        mod.write_global_config(d, {
            "block_shape": BLOCK, "target": "local" if package == "jax" else target,
            "device": "cpu", "device_batch_size": 2, **extra.get("global", {})})
        for name, tconf in extra.get("tasks", {}).items():
            mod.write_config(d, name, tconf)
        dirs[package] = d
    return dirs


def run_both(tmp_path, make, target="local", **extra):
    """``make(package, tmp_folder, config_dir, output_path)`` for each
    package; returns the output paths."""
    dirs = configs(tmp_path, target, **extra)
    outs = {}
    for package, run in (("jax", jax_build), ("torch", build)):
        outs[package] = str(tmp_path / f"out_{package}.n5")
        assert run([make(package, str(tmp_path / f"tmp_{package}"), dirs[package],
                         outs[package])])
    return outs


# -- copy ----------------------------------------------------------------------------


def test_cast_type_matches_jax():
    x = np.random.default_rng(1).random((4, 5, 6)).astype(np.float32) * 7 - 2
    for dtype in ("uint8", "uint16", "float64", "float32", "int32"):
        want = jcopy.cast_type(x, dtype)
        got = tcopy.cast_type(x, dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


COPY_CASES = {
    "roi_uint8": dict(key="raw", kw=dict(dtype="uint8", fit_to_roi=True),
                      glob={"roi_begin": [12, 0, 24], "roi_end": [24, 44, 48]}),
    "4d_reduce_max": dict(key="affs", kw={}, tasks={"copy_volume": {"reduce_channels": "max"}}),
    "4d_keep": dict(key="affs", kw=dict(dtype="float64"), tasks={"copy_volume": {"chunks": [6, 12, 12]}}),
    "labels_values_offset": dict(key="labels", kw={}, tasks={"copy_volume": {
        "value_list": [1, 3], "offset": 100, "map_uniform_blocks_to_background": True}}),
}


@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_copy_volume_matches_jax(data, case):
    tmp_path, path, _ = data
    c = COPY_CASES[case]
    tasks = {"jax": jcopy.CopyVolumeTask, "torch": tcopy.CopyVolumeTask}
    outs = run_both(tmp_path, lambda p, tmp, conf, out: tasks[p](
        tmp, conf, input_path=path, input_key=c["key"], output_path=out, output_key="copy",
        **c["kw"]), **{"global": c.get("glob", {}), "tasks": c.get("tasks", {})})
    got = same_dataset(outs["torch"], "copy", outs["jax"], "copy")
    if case == "roi_uint8":
        assert got.shape == (12, 44, 24) and got.dtype == np.uint8
        assert file_reader(outs["torch"], "r")["copy"].attrs["resolution"] == [40, 4, 4]


def test_copy_volume_insert_mode_matches_jax(data):
    tmp_path, path, _ = data
    tasks = {"jax": jcopy.CopyVolumeTask, "torch": tcopy.CopyVolumeTask}
    for package in ("jax", "torch"):
        out = str(tmp_path / f"out_{package}.n5")
        file_reader(out).create_dataset("copy", data=np.full(SHAPE, 7, np.uint64),
                                        chunks=tuple(BLOCK), compression="gzip")
    run_both(tmp_path, lambda p, tmp, conf, out: tasks[p](
        tmp, conf, input_path=path, input_key="labels", output_path=out, output_key="copy"),
        tasks={"copy_volume": {"insert_mode": True, "value_list": [2]}})
    got = same_dataset(str(tmp_path / "out_torch.n5"), "copy", str(tmp_path / "out_jax.n5"), "copy")
    assert set(np.unique(got)) == {2, 7}


# -- linear transformation -------------------------------------------------------------


def write_trafo(tmp_path, per_slice: bool) -> str:
    rng = np.random.default_rng(5)
    if per_slice:
        trafo = {str(z): {"a": float(rng.random() * 3), "b": float(rng.random() * 2 - 1)}
                 for z in range(SHAPE[0])}
    else:
        trafo = {"a": 1.7, "b": -0.3}
    p = str(tmp_path / ("slices.json" if per_slice else "global.json"))
    with open(p, "w") as f:
        json.dump(trafo, f)
    return p


@pytest.mark.parametrize("target", ["local", "cuda"])
@pytest.mark.parametrize("per_slice,masked,key", [
    (False, False, "raw"), (True, True, "raw"), (True, False, "raw8"), (False, True, "raw8")])
def test_linear_transformation_matches_jax(data, target, per_slice, masked, key):
    tmp_path, path, _ = data
    trafo = write_trafo(tmp_path, per_slice)
    tasks = {"jax": jtrafo.LinearTransformationTask, "torch": ttrafo.LinearTransformationTask}
    mask = dict(mask_path=path, mask_key="mask") if masked else {}
    outs = run_both(tmp_path, lambda p, tmp, conf, out: tasks[p](
        tmp, conf, input_path=path, input_key=key, output_path=out, output_key="lin",
        transformation=trafo, **mask), target=target)
    same_dataset(outs["torch"], "lin", outs["jax"], "lin")


def test_load_transformation_checks_slices(tmp_path):
    p = str(tmp_path / "t.json")
    with open(p, "w") as f:
        json.dump({"0": {"a": 1, "b": 0}}, f)
    with pytest.raises(ValueError, match="per-slice"):
        ttrafo.load_transformation(p, 3)
    assert ttrafo.load_transformation(p, 1) == jtrafo.load_transformation(p, 1)


def test_linear_transformation_workflow_in_place_matches_jax(data):
    tmp_path, path, raw = data
    trafo = write_trafo(tmp_path, True)
    dirs = configs(tmp_path, "cuda")
    for package, run, wf in (("jax", jax_build, jwf), ("torch", build, twf)):
        out = str(tmp_path / f"inplace_{package}.n5")
        file_reader(out).create_dataset("raw", data=raw, chunks=tuple(BLOCK), compression="gzip")
        assert run([wf.LinearTransformationWorkflow(
            str(tmp_path / f"tmp_{package}"), dirs[package], input_path=out, input_key="raw",
            transformation=trafo, mask_path=path, mask_key="mask")])
    got = same_dataset(str(tmp_path / "inplace_torch.n5"), "raw",
                       str(tmp_path / "inplace_jax.n5"), "raw")
    assert not np.array_equal(got, raw)


# -- masking -----------------------------------------------------------------------


def test_resize_nearest_matches_jax():
    m = np.random.default_rng(2).random((5, 7, 9)) > 0.5
    for shape in ((10, 14, 18), (11, 13, 20), (5, 7, 9), (3, 4, 5)):
        np.testing.assert_array_equal(tmask.resize_nearest(m, shape), jmask.resize_nearest(m, shape))


@pytest.mark.parametrize("mask_key,shape", [("mask", None), ("mask_half", list(SHAPE))])
def test_blocks_from_mask_matches_jax(data, mask_key, shape):
    tmp_path, path, _ = data
    tasks = {"jax": jmask.BlocksFromMaskTask, "torch": tmask.BlocksFromMaskTask}
    dirs = configs(tmp_path)
    lists = {}
    for package, run in (("jax", jax_build), ("torch", build)):
        out = str(tmp_path / f"blocks_{package}.json")
        assert run([tasks[package](str(tmp_path / f"tmp_{package}"), dirs[package],
                                   mask_path=path, mask_key=mask_key, shape=shape,
                                   output_path=out)])
        with open(out) as f:
            lists[package] = json.load(f)
    assert lists["torch"] == lists["jax"]
    assert 0 < len(lists["torch"]) < 8


@pytest.mark.parametrize("target", ["local", "cuda"])
@pytest.mark.parametrize("filter_shape", [[3, 5, 5], [2, 6, 3]])
def test_minfilter_matches_jax(data, target, filter_shape):
    tmp_path, path, _ = data
    tasks = {"jax": jmask.MinfilterTask, "torch": tmask.MinfilterTask}
    outs = run_both(tmp_path, lambda p, tmp, conf, out: tasks[p](
        tmp, conf, input_path=path, input_key="mask", output_path=out, output_key="min"),
        target=target, tasks={"minfilter": {"filter_shape": filter_shape}})
    got = same_dataset(outs["torch"], "min", outs["jax"], "min")
    assert got.dtype == np.uint8 and 0 < got.sum() < file_reader(path, "r")["mask"][:].sum()
