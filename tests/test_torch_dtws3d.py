"""PyTorch port: the DT-watershed's 3d modes.

The 3d EDT with a pixel pitch, non-maximum suppression, 3d seeds and height
map, ``dt_watershed`` with ``apply_dt_2d`` / ``apply_ws_2d`` in every
combination, and ``WatershedWorkflow`` in the 3d mode with a halo, each held
against the JAX package's XLA path on the same numpy inputs (JAX on the
CPU).  Contracts: the EDT, NMS, seeds and labels exact (non-integral
pitches round as the JAX package does on the CPU: running sums along the
first axis, one FMA per parabola cost); the smoothed height map within a few
float32 ulp of the JAX convolution's, whose summation order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops import watershed as JW
from cluster_tools_tpu.ops.dt import _distance_transform
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows.watershed import WatershedWorkflow as JaxWatershedWorkflow
from cluster_tools_tpu_torch import WatershedWorkflow, build
from cluster_tools_tpu_torch.ops import watershed as W
from cluster_tools_tpu_torch.ops.dt import distance_transform
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.utils.blocking import Blocking

PITCHES = [None, (2.5, 1.3, 0.7), (4.0, 1.0, 1.0)]


def _raw(shape, seed, sigma=(1.0, 2.0, 2.0)):
    raw = ndimage.gaussian_filter(np.random.default_rng(seed).random(shape), sigma)
    return ((raw - raw.min()) / (raw.max() - raw.min())).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("pitch", PITCHES)
def test_edt_3d_exact(pitch):
    fg = np.stack([_raw((10, 23, 19), s) < 0.6 for s in (0, 1)])
    fg[1, :, 0] = True  # a line without background along z saturates
    fg[1, 0, 0, :] = False
    got = distance_transform(_t(fg), pitch).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(_distance_transform(jnp.asarray(fg[b]), pitch)))


@pytest.mark.parametrize("pitch", PITCHES)
@pytest.mark.parametrize("per_slice", [False, True])
def test_suppress_seeds_exact(pitch, per_slice):
    """Raw DT maxima (no smoothing) overlap, so some are covered by a
    stronger neighbour and dropped."""
    fg = _raw((8, 30, 30), 3, 1.0) < 0.7
    dt = np.asarray(_distance_transform(jnp.asarray(fg), pitch))
    lm = (dt > 0) & (ndimage.maximum_filter(dt, (1, 3, 3) if per_slice else 3, mode="nearest") == dt)
    want = np.asarray(JW.suppress_seeds(jnp.asarray(lm), jnp.asarray(dt), per_slice=per_slice,
                                        pixel_pitch=pitch))
    got = W.suppress_seeds(_t(lm)[None], _t(dt)[None], per_slice, pitch)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nms", [False, True])
@pytest.mark.parametrize("per_slice", [False, True])
@pytest.mark.parametrize("sigma", [0.0, 1.5])
def test_dt_seeds_3d_exact(nms, per_slice, sigma):
    fg = _raw((10, 23, 19), 4) < 0.6
    pitch = (2.5, 1.3, 0.7)
    dt = np.asarray(_distance_transform(jnp.asarray(fg), pitch))
    want, nw = JW.dt_seeds(jnp.asarray(dt), sigma, per_slice=per_slice, nms=nms, pixel_pitch=pitch)
    got, n = W.dt_seeds(_t(dt)[None], sigma, per_slice=per_slice, nms=nms, pixel_pitch=pitch)
    assert int(n[0]) == int(nw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_make_hmap_3d_matches_jax():
    """Normalized over the whole block; exact unsmoothed (the blend is one
    FMA on both sides), a few ulp after the 3d gaussian."""
    rng = np.random.default_rng(6)
    x = rng.random((6, 16, 20)).astype(np.float32)
    dt = (rng.random((6, 16, 20)) * 9).astype(np.float32)
    for sigma in (0.0, 2.0):
        want = np.asarray(JW.make_hmap(jnp.asarray(x), jnp.asarray(dt), 0.8, sigma))
        got = W.make_hmap(_t(x)[None], _t(dt)[None], 0.8, sigma)[0].numpy()
        if sigma == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


MODES = [
    dict(apply_dt_2d=False, apply_ws_2d=False),
    dict(apply_dt_2d=False, apply_ws_2d=False, pixel_pitch=(2.5, 1.3, 0.7)),
    dict(apply_dt_2d=False, apply_ws_2d=False, non_maximum_suppression=True, size_filter=0),
    dict(apply_dt_2d=True, apply_ws_2d=False),
    dict(apply_dt_2d=False, apply_ws_2d=True, pixel_pitch=(4.0, 1.0, 1.0)),
    dict(apply_dt_2d=True, apply_ws_2d=True, non_maximum_suppression=True),
]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(f"{k}={v}" for k, v in m.items()))
def test_dt_watershed_modes_exact(mode):
    """Exact labels and seed counts against the JAX XLA path, for a batch
    of two blocks, the second with a mask and a ``valid`` region (a padded
    edge block's real voxels)."""
    x = np.stack([_raw((8, 24, 28), s) for s in (10, 11)])
    mask = np.ones(x.shape, bool)
    mask[1] = _raw((8, 24, 28), 12, 3.0) > 0.3
    valid = np.ones(x.shape, bool)
    valid[1, 6:] = False
    valid[1, :, :, 25:] = False
    kw = {**dict(threshold=0.5, sigma_seeds=1.6, sigma_weights=2.0, size_filter=10), **mode}
    labels, n = W.dt_watershed(_t(x), mask=_t(mask), valid=_t(valid), **kw)
    for b in range(2):
        want, nw = JW.dt_watershed(
            jnp.asarray(x[b]), mask=jnp.asarray(mask[b]), valid=jnp.asarray(valid[b]), **kw)
        assert int(n[b]) == int(nw)
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(want))


def test_dt_watershed_pitch_needs_3d_dt():
    with pytest.raises(ValueError, match="pixel_pitch"):
        W.dt_watershed(torch.zeros(4, 8, 8), pixel_pitch=(1.0, 1.0, 1.0))


def _workflow(package, tmp_path, path, config_dir, key):
    wf_cls, run = (
        (JaxWatershedWorkflow, jax_build) if package == "jax" else (WatershedWorkflow, build)
    )
    assert run([wf_cls(str(tmp_path / f"tmp_{key}"), config_dir, input_path=path,
                       input_key="bnd", output_path=path, output_key=key)])


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_watershed_workflow_3d_halo_byte_identical_to_jax(tmp_path, target):
    """``WatershedWorkflow`` with ``apply_dt_2d`` / ``apply_ws_2d`` False
    and halo [2, 6, 6] (the halo'd blocks re-closed by CC) on a divisible
    volume: output and per-block max ids equal the JAX workflow's; the
    ``cuda`` target (batched, computing on the CPU) writes the same."""
    shape, block = (24, 48, 48), [12, 24, 24]
    raw = _raw(shape, 42)
    path = str(tmp_path / "d.n5")
    jax_reader(path).create_dataset("bnd", data=raw, chunks=tuple(block), compression="gzip")
    config_dir = str(tmp_path / "configs")
    jax_cfg.write_global_config(config_dir, {
        "block_shape": block, "device": "cpu", "target": target, "device_batch_size": 3,
    })
    jax_cfg.write_config(config_dir, "watershed", {
        "threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10, "halo": [2, 6, 6],
        "apply_dt_2d": False, "apply_ws_2d": False,
    })
    jax_cfg.write_global_config(str(tmp_path / "configs_jax"), {"block_shape": block})
    jax_cfg.write_config(str(tmp_path / "configs_jax"), "watershed",
                         jax_cfg.read_config(config_dir, "watershed"))
    _workflow("jax", tmp_path, path, str(tmp_path / "configs_jax"), "ws_jax")
    _workflow("torch", tmp_path, path, config_dir, "ws_torch")
    want = jax_reader(path, "r")["ws_jax"][:]
    got = file_reader(path, "r")["ws_torch"][:]
    np.testing.assert_array_equal(got, want)
    assert (got[raw >= 0.5] == 0).all() and len(np.unique(got)) > 8
    ids = [file_reader(str(tmp_path / f"tmp_{k}" / "data.zarr"), "r")["watershed/max_ids"]
           for k in ("ws_jax", "ws_torch")]
    for bid in range(Blocking(shape, block).n_blocks):
        np.testing.assert_array_equal(ids[1].read_chunk((bid,)), ids[0].read_chunk((bid,)))
