"""PyTorch port, the thresholded-components slice: ``ThresholdedComponentsWorkflow``
against the JAX one.

Both packages run from ONE config dir written by the JAX package's
``write_config`` (plus ``"device": "cpu"``, the port's explicit request for
the host) on the same n5 volume.  Where no block reads past the volume, or
the padding cannot be foreground (``threshold_mode="greater"`` over zero
padding), the port must write what the JAX workflow writes, byte for byte:
the block labels, the merged output (decoded arrays and chunk files), the
per-block max ids and face pairs, the offsets and the assignment table.

Edge blocks are zero-padded to the block shape.  The JAX package thresholds
that padding too; with ``threshold_mode="less"`` it is foreground, so two
components of an edge block that are disjoint in the volume join through it.
The port clears the padding before CC; on that fixture it is held to scipy.
"""

import os

import numpy as np
import pytest
from scipy import ndimage

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows.thresholded_components import (
    ThresholdedComponentsWorkflow as JaxComponentsWorkflow,
)
from cluster_tools_tpu_torch import ThresholdedComponentsWorkflow, build
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks.thresholded_components import (
    ASSIGNMENTS_NAME,
    FACES_KEY,
    MAX_IDS_KEY,
    OFFSETS_NAME,
)
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.utils.blocking import Blocking

BLOCK = [8, 16, 16]


def _volume(tmp_path, shape, seed):
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), (1.0, 2.0, 2.0))
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")
    path = str(tmp_path / "d.n5")
    jax_reader(path).create_dataset("raw", data=raw, chunks=(8, 16, 16), compression="gzip")
    return path, raw


def _config(tmp_path, name="configs", gconf=None, **task):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu", **(gconf or {})})
    jax_cfg.write_config(config_dir, "block_components", {"threshold": 0.5, **task})
    return config_dir


def _run(package, tmp_path, path, config_dir, key, mask_key=None):
    wf_cls, run = (
        (JaxComponentsWorkflow, jax_build) if package == "jax"
        else (ThresholdedComponentsWorkflow, build)
    )
    assert run([wf_cls(
        str(tmp_path / f"tmp_{key}"), config_dir,
        input_path=path, input_key="raw", output_path=path, output_key=key,
        mask_path=path if mask_key else None, mask_key=mask_key,
    )])


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _assert_identical(tmp_path, path, shape):
    # each package reads the other's output
    for ref_key, got_key in (("cc_jax", "cc_torch"), ("cc_jax_blocks", "cc_torch_blocks")):
        ref = file_reader(path, "r")[ref_key][:]
        got = jax_reader(path, "r")[got_key][:]
        assert got.shape == tuple(shape) and got.dtype == np.uint64
        np.testing.assert_array_equal(got, ref)
        assert _files(os.path.join(path, got_key)) == _files(os.path.join(path, ref_key))
    tmp_ref, tmp_got = tmp_path / "tmp_cc_jax", tmp_path / "tmp_cc_torch"
    n_blocks = Blocking(shape, BLOCK).n_blocks
    for key in (MAX_IDS_KEY, FACES_KEY):
        ref = file_reader(str(tmp_ref / "data.zarr"), "r")[key]
        got = file_reader(str(tmp_got / "data.zarr"), "r")[key]
        for bid in range(n_blocks):
            np.testing.assert_array_equal(got.read_chunk((bid,)), ref.read_chunk((bid,)))
    # np.savez stamps the time into the zip: compare the arrays
    with np.load(tmp_ref / OFFSETS_NAME) as ref, np.load(tmp_got / OFFSETS_NAME) as got:
        assert sorted(ref.files) == sorted(got.files)
        for f in ref.files:
            assert got[f].dtype == ref[f].dtype
            np.testing.assert_array_equal(got[f], ref[f])
    assert (tmp_got / ASSIGNMENTS_NAME).read_bytes() == (tmp_ref / ASSIGNMENTS_NAME).read_bytes()
    return _output(path, "cc_torch")


def _output(path, key):
    return file_reader(path, "r")[key][:]


def _assert_scipy_partition(out, fg):
    """``out`` labels ``fg`` with consecutive ids 1..n and the same
    partition as scipy's 6-connected labeling."""
    want, n = ndimage.label(fg)
    assert ((out > 0) == fg).all()
    assert set(np.unique(out[fg]).tolist()) == set(range(1, n + 1))
    pairs = np.unique(np.stack([out[fg], want[fg]], axis=1), axis=0)
    assert len(pairs) == n


@pytest.mark.parametrize("seed", [42, 7])
@pytest.mark.parametrize("task", [{}, {"sigma": 1.0}, {"threshold": 0.4, "threshold_mode": "less"}])
def test_workflow_byte_identical_to_jax(tmp_path, seed, task):
    """Block-divisible volume: nothing is padded."""
    shape = (16, 32, 48)
    path, raw = _volume(tmp_path, shape, seed)
    config_dir = _config(tmp_path, **task)
    _run("jax", tmp_path, path, config_dir, "cc_jax")
    _run("torch", tmp_path, path, config_dir, "cc_torch")
    got = _assert_identical(tmp_path, path, shape)
    if not task:
        _assert_scipy_partition(got, raw > 0.5)


@pytest.mark.parametrize("seed", [3, 5])
def test_ragged_greater_byte_identical_to_jax(tmp_path, seed):
    """Non-divisible volume in mode ``greater``: the zero padding is
    background in both packages."""
    shape = (20, 41, 37)
    path, raw = _volume(tmp_path, shape, seed)
    config_dir = _config(tmp_path)
    _run("jax", tmp_path, path, config_dir, "cc_jax")
    _run("torch", tmp_path, path, config_dir, "cc_torch")
    _assert_scipy_partition(_assert_identical(tmp_path, path, shape), raw > 0.5)


def test_workflow_with_mask_byte_identical_to_jax(tmp_path):
    shape = (16, 32, 48)
    path, raw = _volume(tmp_path, shape, 11)
    mask = ndimage.gaussian_filter(np.random.default_rng(12).random(shape), 3) > 0.49
    jax_reader(path).create_dataset(
        "mask", data=mask.astype("uint8"), chunks=(8, 16, 16), compression="gzip"
    )
    config_dir = _config(tmp_path)
    _run("jax", tmp_path, path, config_dir, "cc_jax", mask_key="mask")
    _run("torch", tmp_path, path, config_dir, "cc_torch", mask_key="mask")
    got = _assert_identical(tmp_path, path, shape)
    assert (got[~mask] == 0).all() and (got[mask & (raw > 0.5)] > 0).all()


def _ragged_less_fixture(tmp_path):
    raw = np.ones((10, 20, 20), np.float32)
    raw[:, 17:, 2:5] = 0
    raw[:, 17:, 10:13] = 0
    path = str(tmp_path / "d.n5")
    jax_reader(path).create_dataset("raw", data=raw, chunks=(8, 16, 16), compression="gzip")
    return path, raw


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_ragged_less_padding_stays_background(tmp_path, target):
    """Two bars of low voxels in the last y-rows of a (10, 20, 20) volume at
    blocks (8, 16, 16): scipy finds 2 components.  The JAX workflow writes 1
    here (its zero padding of the edge blocks is below the threshold and
    joins the bars); the port clears the padding and writes scipy's 2."""
    path, raw = _ragged_less_fixture(tmp_path)
    config_dir = _config(
        tmp_path, gconf={"target": target, "device_batch_size": 3}, threshold_mode="less"
    )
    _run("torch", tmp_path, path, config_dir, "cc_torch")
    out = _output(path, "cc_torch")
    _assert_scipy_partition(out, raw < 0.5)
    assert out.max() == 2


def test_cuda_target_on_cpu_equals_local(tmp_path):
    """The batched ``cuda`` target (read → compute → write pipeline, the
    device merge of the assignments; here computing on the CPU as the config
    asks) writes what ``local`` writes."""
    shape = (20, 41, 37)
    path, raw = _volume(tmp_path, shape, 9)
    outs = {}
    for target in ("local", "cuda"):
        config_dir = _config(
            tmp_path, f"configs_{target}", {"target": target, "device_batch_size": 4},
            threshold=0.45, threshold_mode="less",
        )
        _run("torch", tmp_path, path, config_dir, f"cc_{target}")
        outs[target] = _output(path, f"cc_{target}")
    np.testing.assert_array_equal(outs["cuda"], outs["local"])
    _assert_scipy_partition(outs["cuda"], raw < 0.45)


def test_workflow_config_and_sharded_raises(tmp_path):
    conf = ThresholdedComponentsWorkflow.get_config()
    jax_conf = JaxComponentsWorkflow.get_config()
    # the JAX defaults add its generic per-task keys; the port reads
    # threads_per_job and read_threads with the same defaults
    generic = {"threads_per_job", "read_threads", "time_limit", "mem_limit"}
    assert conf["block_components"] == {
        k: v for k, v in jax_conf["block_components"].items() if k not in generic
    }
    assert cfg.DEFAULT_GLOBAL_CONFIG["device"] == "cuda"
    with pytest.raises(NotImplementedError, match="Queue A 11"):
        ThresholdedComponentsWorkflow(str(tmp_path), sharded=True)
