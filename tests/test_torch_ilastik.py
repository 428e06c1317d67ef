"""PyTorch port, the ilastik seam: ``IlastikPredictionWorkflow`` with a
stand-in executable, ``StackPredictionsTask`` and ``IlastikCarvingWorkflow``
against the JAX package on the CPU.

The stand-in honours the headless command line (reference
prediction.py:137-146): it parses ``--cutout_subregion`` and
``--output_filename_format`` and writes ``n`` channels of a function of the
global coordinates, trailing-channel, as ilastik does.  Contracts: the
merged predictions' chunk files equal JAX's byte for byte (one and two
channels, halo'd blocks cropped back), the stacked volume equals JAX's, and
every dataset and attribute of the carving project equals JAX's except the
two that differ by design (``time``, the creation time, and ``datasetId``,
a fresh UUID)."""

import os
import stat

import h5py
import numpy as np
import pytest

from cluster_tools_tpu import workflows as jwf
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import ilastik as jil
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch import workflows as twf
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks import ilastik as til
from cluster_tools_tpu_torch.utils import file_reader

FAKE = """
import ast, sys
import numpy as np
import h5py

n_channels = {n_channels}
args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
start, stop = ast.literal_eval(args["--cutout_subregion"].replace("None", "0"))
z, y, x = np.meshgrid(*[np.arange(a, b) for a, b in zip(start[:3], stop[:3])], indexing="ij")
data = np.stack([((z + 2 * y + 3 * x + c) % 11).astype("float32") / 11.0
                 for c in range(n_channels)], axis=-1)
with h5py.File(args["--output_filename_format"], "w") as f:
    f.create_dataset("exported_data", data=data)
"""


def fake_ilastik(folder, n_channels):
    os.makedirs(folder, exist_ok=True)
    script = os.path.join(folder, "fake_ilastik.py")
    with open(script, "w") as f:
        f.write(FAKE.format(n_channels=n_channels))
    exe = os.path.join(folder, "run_ilastik.sh")
    with open(exe, "w") as f:
        f.write(f"#!/bin/sh\nexec python3 {script} \"$@\"\n")
    os.chmod(exe, os.stat(exe).st_mode | stat.S_IEXEC)
    return folder


def configs(tmp_path, block, target="local"):
    dirs = {}
    for package, mod in (("jax", jax_cfg), ("torch", cfg)):
        d = str(tmp_path / f"configs_{package}")
        mod.write_global_config(d, {"block_shape": block, "device": "cpu",
                                    "target": "local" if package == "jax" else target})
        dirs[package] = d
    return dirs


def same_files(a, b):
    rel = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)  # noqa: E731
                           for r, _, fs in os.walk(d) for f in fs)
    assert rel(a) == rel(b)
    for name in rel(a):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    return len(rel(a))


@pytest.mark.parametrize("n_channels", [1, 2])
def test_prediction_workflow_matches_jax(tmp_path, n_channels):
    shape, block, halo = (8, 24, 20), [8, 12, 12], [2, 3, 2]  # 4 blocks: a subprocess each
    raw = np.random.default_rng(n_channels).random(shape).astype(np.float32)
    path = str(tmp_path / "d.n5")
    file_reader(path).create_dataset("raw", data=raw, chunks=tuple(block))
    folder = fake_ilastik(str(tmp_path / "ilastik"), n_channels)
    project = str(tmp_path / "proj.ilp")
    open(project, "w").close()
    dirs = configs(tmp_path, block)
    for package, wf_cls, run in (("jax", jwf.IlastikPredictionWorkflow, jax_build),
                                 ("torch", twf.IlastikPredictionWorkflow, build)):
        tmp = str(tmp_path / f"tmp_{package}")
        wf = wf_cls(tmp, dirs[package], input_path=path, input_key="raw", output_path=path,
                    output_key=f"pred_{package}", ilastik_folder=folder,
                    ilastik_project=project, halo=halo, n_channels=n_channels)
        assert run([wf])
        assert not [p for p in os.listdir(tmp) if p.endswith(".h5")]
    assert same_files(os.path.join(path, "pred_torch"), os.path.join(path, "pred_jax")) > 1
    got = file_reader(path, "r")["pred_torch"][:]
    z, y, x = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    want = np.stack([((z + 2 * y + 3 * x + c) % 11).astype("float32") / 11.0
                     for c in range(n_channels)])
    np.testing.assert_array_equal(got, want if n_channels > 1 else want[0])


def test_missing_ilastik_fails_clearly(tmp_path):
    path = str(tmp_path / "d.n5")
    file_reader(path).create_dataset("raw", data=np.zeros((8, 8, 8), np.float32))
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [8, 8, 8], "device": "cpu"})
    task = til.IlastikPredictionTask(str(tmp_path / "tmp"), config_dir, input_path=path,
                                     input_key="raw", ilastik_folder=str(tmp_path / "nope"),
                                     ilastik_project=str(tmp_path / "nope.ilp"))
    with pytest.raises(RuntimeError, match="ilastik"):
        build([task])


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_stack_predictions_matches_jax(tmp_path, dtype):
    shape = (8, 16, 16)
    rng = np.random.default_rng(0)
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("raw", data=rng.random(shape).astype(np.float32), chunks=(8, 8, 8))
    f.create_dataset("pred", data=rng.random((2,) + shape).astype(np.float32),
                     chunks=(1, 8, 8, 8))
    dirs = configs(tmp_path, [8, 8, 8])
    for package, task_cls, run in (("jax", jil.StackPredictionsTask, jax_build),
                                   ("torch", til.StackPredictionsTask, build)):
        assert run([task_cls(str(tmp_path / f"tmp_{package}"), dirs[package],
                             input_path=path, input_key="raw", pred_path=path,
                             pred_key="pred", output_path=path,
                             output_key=f"stacked_{package}", dtype=dtype)])
    same_files(os.path.join(path, "stacked_torch"), os.path.join(path, "stacked_jax"))


def h5_items(path):
    """Every dataset's value and every attribute of an h5 file."""
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = obj[()]
        for k, v in obj.attrs.items():
            out[f"{name}@{k}"] = v

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_carving_project_matches_jax(tmp_path, target):
    shape = (8, 16, 24)
    rng = np.random.default_rng(1)
    seg = np.zeros(shape, dtype=np.uint64)
    seg[:, :8, :] = 1
    seg[:, 8:, :8] = 2
    seg[:, 8:, 8:16] = 3
    seg[:, 8:, 16:] = 5  # id 4 absent: an empty neighbourhood record
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("seg", data=seg, chunks=(8, 8, 8))
    f.create_dataset("bnd", data=rng.random(shape).astype(np.float32), chunks=(8, 8, 8))
    dirs = configs(tmp_path, [8, 8, 8], target)
    items = {}
    for package, wf_cls, run in (("jax", jwf.IlastikCarvingWorkflow, jax_build),
                                 ("torch", twf.IlastikCarvingWorkflow, build)):
        out = str(tmp_path / f"carving_{package}.ilp")
        assert run([wf_cls(str(tmp_path / f"tmp_{package}"), dirs[package],
                           input_path=path, input_key="bnd", watershed_path=path,
                           watershed_key="seg", output_path=out)])
        items[package] = h5_items(out)
    assert set(items["torch"]) == set(items["jax"])
    for name, want in items["jax"].items():
        got = items["torch"][name]
        if name.endswith("time") or name.endswith("datasetId"):
            continue
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name
    ser = items["torch"]["preprocessing/graph/graph"]
    # ids 0..5 (4 absent); edges (1, 2), (1, 3), (1, 5), (2, 3), (3, 5)
    assert tuple(ser[:3]) == (6, 5, 5)
