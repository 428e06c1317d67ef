"""PyTorch port, the whole slice: ``WatershedWorkflow`` against the JAX one.

Both packages run from ONE config dir written by the JAX package's
``write_config`` (plus ``"device": "cpu"``, the port's explicit request for
the host) on the same n5 volume; the port's output volume must be byte
identical to the JAX one (decoded arrays and chunk files) and so must the
per-block ``watershed/max_ids`` side output.

Without padding (block-divisible volume, no halo) the JAX reference is its
default XLA path.  Where blocks are padded — edge blocks of a non-divisible
volume, halo'd blocks at the volume border — it is the JAX workflow routed
through its fused Pallas kernel (interpret mode): edge replication puts
near-ties into the smoothed distances, and there the XLA convolution's
summation order and the fused kernel's (which the port follows) can round a
plateau differently — ROADMAP Queue C records it."""

import functools
import os
import shutil

import numpy as np
import pytest
from scipy import ndimage

import cluster_tools_tpu.ops.pallas_dtws as jax_pallas_dtws
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows.watershed import WatershedWorkflow as JaxWatershedWorkflow
from cluster_tools_tpu_torch import WatershedWorkflow, build
from cluster_tools_tpu_torch.runtime.task import Target
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.utils.blocking import Blocking

BLOCK = [12, 24, 24]


def _volume(tmp_path, shape, seed):
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), (1.0, 2.0, 2.0))
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")
    path = str(tmp_path / "d.n5")
    jax_reader(path).create_dataset("bnd", data=raw, chunks=(12, 24, 24), compression="gzip")
    return path, raw


def _config(tmp_path, halo, name="configs", **gconf):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu", **gconf})
    jax_cfg.write_config(config_dir, "watershed", {"threshold": 0.5, "halo": halo})
    return config_dir


def _run(package, tmp_path, path, config_dir, key, mask_key=None):
    wf_cls, run = (
        (JaxWatershedWorkflow, jax_build) if package == "jax" else (WatershedWorkflow, build)
    )
    wf = wf_cls(
        str(tmp_path / f"tmp_{key}"), config_dir,
        input_path=path, input_key="bnd", output_path=path, output_key=key,
        mask_path=path if mask_key else None, mask_key=mask_key,
    )
    assert run([wf])
    return wf


def _chunk_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_identical(tmp_path, path, shape):
    # each package reads the other's output
    ref = file_reader(path, "r")["ws_jax"][:]
    got = jax_reader(path, "r")["ws_torch"][:]
    assert got.shape == tuple(shape) and got.dtype == np.uint64
    np.testing.assert_array_equal(got, ref)
    assert _chunk_files(os.path.join(path, "ws_torch")) == _chunk_files(
        os.path.join(path, "ws_jax")
    )
    n_blocks = Blocking(shape, BLOCK).n_blocks
    ids_ref = file_reader(str(tmp_path / "tmp_ws_jax" / "data.zarr"), "r")["watershed/max_ids"]
    ids_got = file_reader(str(tmp_path / "tmp_ws_torch" / "data.zarr"), "r")["watershed/max_ids"]
    for bid in range(n_blocks):
        np.testing.assert_array_equal(ids_got.read_chunk((bid,)), ids_ref.read_chunk((bid,)))
    return got


@pytest.mark.parametrize("seed", [42, 7])
def test_workflow_byte_identical_to_jax(tmp_path, seed):
    shape = (24, 48, 48)
    path, raw = _volume(tmp_path, shape, seed)
    config_dir = _config(tmp_path, [0, 0, 0])
    _run("jax", tmp_path, path, config_dir, "ws_jax")
    _run("torch", tmp_path, path, config_dir, "ws_torch")
    got = _assert_identical(tmp_path, path, shape)
    assert (got[raw >= 0.5] == 0).all()  # labels only on the foreground


def test_workflow_with_mask_byte_identical_to_jax(tmp_path):
    shape = (24, 48, 48)
    path, raw = _volume(tmp_path, shape, 11)
    mask = ndimage.gaussian_filter(np.random.default_rng(12).random(shape), 3) > 0.49
    jax_reader(path).create_dataset(
        "mask", data=mask.astype("uint8"), chunks=(12, 24, 24), compression="gzip"
    )
    config_dir = _config(tmp_path, [0, 0, 0])
    _run("jax", tmp_path, path, config_dir, "ws_jax", mask_key="mask")
    _run("torch", tmp_path, path, config_dir, "ws_torch", mask_key="mask")
    got = _assert_identical(tmp_path, path, shape)
    assert (got[~mask] == 0).all() and (got[mask & (raw < 0.5)] > 0).any()


@pytest.fixture
def jax_fused_kernel(monkeypatch):
    """Route the JAX workflow through its fused Pallas DT-watershed kernel,
    interpreted on the CPU.  The gate is read when a program is traced, so
    the jit caches are cleared on the way in and out."""
    import jax

    from cluster_tools_tpu.tasks import watershed as jax_ws_task

    monkeypatch.setattr(jax_pallas_dtws, "pallas_dtws_available", lambda *a, **k: True)
    monkeypatch.setattr(
        jax_pallas_dtws, "pallas_dt_watershed",
        functools.partial(jax_pallas_dtws.pallas_dt_watershed, interpret=True),
    )
    jax_ws_task._fused_ws_kernel.cache_clear()
    jax.clear_caches()
    yield
    jax_ws_task._fused_ws_kernel.cache_clear()
    jax.clear_caches()


@pytest.mark.parametrize("shape,halo", [((20, 41, 37), [0, 0, 0]), ((24, 48, 48), [2, 4, 4])])
def test_workflow_padded_blocks_byte_identical_to_jax_fused_kernel(
    tmp_path, jax_fused_kernel, shape, halo
):
    path, _ = _volume(tmp_path, shape, 42)
    config_dir = _config(tmp_path, halo)
    _run("jax", tmp_path, path, config_dir, "ws_jax")
    _run("torch", tmp_path, path, config_dir, "ws_torch")
    _assert_identical(tmp_path, path, shape)


def test_workflow_batched_target_equals_local(tmp_path):
    """The ``cuda`` target (batched read → compute → write pipeline; here
    computing on the CPU as the config asks) writes what ``local`` writes."""
    shape = (20, 41, 37)
    path, _ = _volume(tmp_path, shape, 3)
    local = _config(tmp_path, [1, 3, 3], "configs_local")
    batched = _config(
        tmp_path, [1, 3, 3], "configs_batched", target="cuda", device_batch_size=4
    )
    _run("torch", tmp_path, path, local, "ws_local")
    _run("torch", tmp_path, path, batched, "ws_batched")
    np.testing.assert_array_equal(
        file_reader(path, "r")["ws_batched"][:], file_reader(path, "r")["ws_local"][:]
    )


def test_workflow_resume_skips_completed_task(tmp_path):
    shape = (24, 48, 48)
    path, _ = _volume(tmp_path, shape, 5)
    config_dir = _config(tmp_path, [0, 0, 0])
    wf = _run("torch", tmp_path, path, config_dir, "ws_torch")
    status_path = wf.output().path
    status = Target(status_path).read()
    assert status["complete"] and len(status["done"]) == Blocking(shape, BLOCK).n_blocks
    # a second build must not touch the task: no new attempt, same output
    before = file_reader(path, "r")["ws_torch"][:]
    shutil.rmtree(os.path.join(path, "bnd"))  # any re-run would now fail
    _run("torch", tmp_path, path, config_dir, "ws_torch")
    assert Target(status_path).read() == status
    np.testing.assert_array_equal(file_reader(path, "r")["ws_torch"][:], before)
