"""PyTorch port: the checkerboard two-pass watershed.

``apply_size_filter(protect_upto=)`` and ``two_pass_flood`` (pass 2's
device part) are held to the JAX functions on the same numpy inputs, JAX on
the CPU, in the 2d and 3d modes, with and without a mask and a ``valid``
region: labels and k exact.  ``WatershedWorkflow(two_pass=True)`` runs from
one config through both packages and must write the same bytes, on the
port's ``local`` target against JAX's and on its batched ``cuda`` target
(computing on the CPU) against JAX's ``tpu`` target at the same blocks per
batch.  The port's ``cuda`` executor must run pass 2 one batch at a time,
read → compute → write, so its output does not depend on
``pipeline_depth``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops import watershed as JW
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows.watershed import WatershedWorkflow as JaxWatershedWorkflow
from cluster_tools_tpu_torch import WatershedWorkflow, build
from cluster_tools_tpu_torch.ops import watershed as W
from cluster_tools_tpu_torch.runtime.executor import CudaExecutor
from cluster_tools_tpu_torch.tasks.watershed import TwoPassWatershedTask
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.utils.blocking import Blocking

BLOCK = [12, 24, 24]
SHAPE = (24, 48, 48)
WS_3D = {"threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10,
         "apply_dt_2d": False, "apply_ws_2d": False}


def _raw(shape, seed):
    raw = ndimage.gaussian_filter(np.random.default_rng(seed).random(shape), (1.0, 2.0, 2.0))
    return ((raw - raw.min()) / (raw.max() - raw.min())).astype(np.float32)


def _written(raw, shell):
    """Pass-1 labels as pass 2 sees them: components of ``raw < 0.5`` in
    the halo shell only (``shell`` voxels deep), compacted to 1..k."""
    lab, _ = ndimage.label(raw < 0.5)
    inner = np.zeros(raw.shape, dtype=bool)
    inner[tuple(slice(s, n - s) for s, n in zip(shell, raw.shape))] = True
    lab[inner] = 0
    _, compact = np.unique(lab, return_inverse=True)
    return compact.reshape(raw.shape).astype(np.int32)


@pytest.mark.parametrize("per_slice", [True, False])
def test_apply_size_filter_protect_upto_exact(per_slice):
    """Per block, labels ≤ that block's bound survive however small; the
    rest are filtered and re-flooded as without a bound."""
    shape = (6, 20, 22)
    hmap = np.stack([_raw(shape, s) for s in (0, 1)])
    rng = np.random.default_rng(2)
    labels = np.stack([ndimage.label(rng.random(shape) < 0.25)[0] for _ in hmap]).astype(np.int32)
    mask = np.stack([h < 0.9 for h in hmap])
    sizes = np.bincount(labels[0].reshape(-1))
    small = [i for i in range(1, sizes.size) if sizes[i] < 12]
    protect = [small[len(small) // 2], 0]  # small labels on both sides of the bound
    nseg = int(labels.max()) + 1
    got = W.apply_size_filter(
        torch.from_numpy(labels), torch.from_numpy(hmap), 12, nseg,
        torch.from_numpy(mask), per_slice=per_slice, protect_upto=torch.tensor(protect),
    ).numpy()
    for b in range(2):
        want = JW.apply_size_filter(
            jnp.asarray(labels[b]), jnp.asarray(hmap[b]), 12, nseg, jnp.asarray(mask[b]),
            per_slice=per_slice, protect_upto=jnp.int32(protect[b]),
        )
        np.testing.assert_array_equal(got[b], np.asarray(want))
    # protected labels too small for the filter survive (where the mask
    # lets them); the others vanish
    for i in small:
        if mask[0][labels[0] == i].any():
            assert (got[0] == i).any() == (i <= protect[0])


@pytest.mark.parametrize("mode", ["2d", "3d"])
@pytest.mark.parametrize("masked", [False, True])
def test_two_pass_flood_exact(mode, masked):
    """A batch of two halo'd blocks with different written label counts
    (so different k), the second padded at its far end (``valid``)."""
    shape = (10, 36, 40)
    raw = np.stack([_raw(shape, s) for s in (3, 4)])
    written = np.stack([_written(raw[0], (2, 6, 6)), _written(raw[1], (2, 8, 8))])
    valid = np.ones(raw.shape, dtype=bool)
    valid[1, -2:] = False
    valid[1, :, -5:] = False
    written[~valid] = 0
    mask = np.stack([_raw(shape, s) < 0.8 for s in (5, 6)]) if masked else None
    params = dict(threshold=0.5, sigma_seeds=1.6, size_filter=10,
                  non_maximum_suppression=True)
    if mode == "3d":
        params.update(apply_dt_2d=False, apply_ws_2d=False)
    got, got_k = W.two_pass_flood(
        torch.from_numpy(raw), torch.from_numpy(written),
        mask=None if mask is None else torch.from_numpy(mask),
        valid=torch.from_numpy(valid), **params,
    )
    assert got_k.tolist() == [int(w.max()) for w in written] and got_k[0] != got_k[1]
    for b in range(2):
        want, k = JW.two_pass_flood(
            jnp.asarray(raw[b]), jnp.asarray(written[b]),
            mask=None if mask is None else jnp.asarray(mask[b]),
            valid=jnp.asarray(valid[b]), **params,
        )
        assert int(k) == int(got_k[b])
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        # written labels continue (inside the mask), own seeds above k
        lab = got[b].numpy()
        cont = (written[b] > 0) & (True if mask is None else mask[b])
        assert (lab[cont] == written[b][cont]).all()
        assert (lab > int(k)).any()
    # one block alone gives what the batch gives
    one, k1 = W.two_pass_flood(
        torch.from_numpy(raw[1]), torch.from_numpy(written[1]),
        mask=None if mask is None else torch.from_numpy(mask[1]),
        valid=torch.from_numpy(valid[1]), **params,
    )
    assert int(k1) == int(got_k[1])
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


def test_two_pass_flood_pitch_needs_3d_dt():
    x = torch.zeros((4, 8, 8))
    with pytest.raises(ValueError, match="pixel_pitch"):
        W.two_pass_flood(x, torch.zeros((4, 8, 8), dtype=torch.int32), pixel_pitch=(1, 1, 1))


def _volume(tmp_path, seed=42):
    raw = _raw(SHAPE, seed)
    path = str(tmp_path / "d.n5")
    jax_reader(path).create_dataset("bnd", data=raw, chunks=tuple(BLOCK), compression="gzip")
    return path, raw


def _configs(tmp_path, conf, target, batch):
    """One two-pass config through both packages: the port's global config
    asks for the CPU (and the ``cuda`` target where JAX's is ``tpu``)."""
    dirs = {}
    for package in ("jax", "torch"):
        gconf = {"block_shape": BLOCK, "device_batch_size": batch}
        if package == "torch":
            gconf.update(device="cpu", target=target)
        else:
            gconf.update(target="tpu" if target == "cuda" else "local", devices=[0])
        d = str(tmp_path / f"configs_{package}_{target}")
        jax_cfg.write_global_config(d, gconf)
        jax_cfg.write_config(d, "two_pass_watershed", conf)
        dirs[package] = d
    return dirs


def _run(package, tmp_path, path, config_dir, key, mask_key=None):
    wf_cls, run = (
        (JaxWatershedWorkflow, jax_build) if package == "jax" else (WatershedWorkflow, build)
    )
    assert run([wf_cls(
        str(tmp_path / f"tmp_{key}"), config_dir, input_path=path, input_key="bnd",
        output_path=path, output_key=key, mask_path=path if mask_key else None,
        mask_key=mask_key, two_pass=True,
    )])
    return file_reader(path, "r")[key][:]


def _cross_boundary_agreement(ws, axis=0):
    """Share of labelled voxel pairs across the block face at the middle of
    ``axis`` that carry one id."""
    mid = ws.shape[axis] // 2
    a, b = np.take(ws, mid - 1, axis), np.take(ws, mid, axis)
    sel = (a > 0) & (b > 0)
    return (a[sel] == b[sel]).sum() / max(sel.sum(), 1)


def _assert_identical(tmp_path, path, key_jax, key_torch):
    want = jax_reader(path, "r")[key_jax][:]
    got = file_reader(path, "r")[key_torch][:]
    assert got.dtype == np.uint64 and got.shape == SHAPE
    np.testing.assert_array_equal(got, want)
    ids = [file_reader(str(tmp_path / f"tmp_{k}" / "data.zarr"), "r")["watershed/max_ids"]
           for k in (key_jax, key_torch)]
    for bid in range(Blocking(SHAPE, BLOCK).n_blocks):
        np.testing.assert_array_equal(ids[1].read_chunk((bid,)), ids[0].read_chunk((bid,)))
    return got


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_two_pass_workflow_3d_byte_identical_to_jax(tmp_path, target):
    """JAX's ``test_two_pass_boundary_consistency`` config (3d mode, halo
    [4, 8, 8]): the port writes JAX's bytes, and its labels continue across
    the z = 12 block face where a single pass never does."""
    path, raw = _volume(tmp_path)
    dirs = _configs(tmp_path, {**WS_3D, "halo": [4, 8, 8]}, target, 2)
    _run("jax", tmp_path, path, dirs["jax"], f"ws_jax_{target}")
    _run("torch", tmp_path, path, dirs["torch"], f"ws_torch_{target}")
    got = _assert_identical(tmp_path, path, f"ws_jax_{target}", f"ws_torch_{target}")
    assert (got[raw < 0.5] > 0).mean() > 0.9 and (got[raw >= 0.5] == 0).all()
    assert _cross_boundary_agreement(got) > 0.5


def test_two_pass_workflow_2d_byte_identical_to_jax(tmp_path):
    """The default 2d mode (NMS on by the task default, kernel 1's flood on
    the card) with halo [2, 8, 8], on the batched target.  The flood runs
    per slice, so labels continue across the in-plane block faces (y, x),
    never across z."""
    path, raw = _volume(tmp_path, seed=7)
    dirs = _configs(tmp_path, {"threshold": 0.5, "halo": [2, 8, 8]}, "cuda", 3)
    _run("jax", tmp_path, path, dirs["jax"], "ws_jax")
    got = _run("torch", tmp_path, path, dirs["torch"], "ws_torch")
    _assert_identical(tmp_path, path, "ws_jax", "ws_torch")
    assert (got[raw >= 0.5] == 0).all()
    assert _cross_boundary_agreement(got, 0) == 0.0
    assert _cross_boundary_agreement(got, 1) > 0.5 and _cross_boundary_agreement(got, 2) > 0.5


def test_two_pass_workflow_with_mask_byte_identical_to_jax(tmp_path):
    """JAX's ``test_two_pass_with_mask``: nothing outside the mask, in
    either pass; the bytes equal JAX's."""
    path, raw = _volume(tmp_path, seed=11)
    mask = np.zeros(SHAPE, dtype="uint8")
    mask[:, :24, :] = 1
    jax_reader(path).create_dataset("mask", data=mask, chunks=tuple(BLOCK), compression="gzip")
    dirs = _configs(tmp_path, {**WS_3D, "halo": [4, 8, 8]}, "cuda", 2)
    _run("jax", tmp_path, path, dirs["jax"], "ws_jax", mask_key="mask")
    got = _run("torch", tmp_path, path, dirs["torch"], "ws_torch", mask_key="mask")
    _assert_identical(tmp_path, path, "ws_jax", "ws_torch")
    assert (got[:, 24:, :] == 0).all()
    assert (got[(raw < 0.5) & (mask > 0)] > 0).mean() > 0.9


def test_two_pass_zero_halo_raises(tmp_path):
    from cluster_tools_tpu_torch.runtime.task import FailedBlocksError

    path, _ = _volume(tmp_path)
    dirs = _configs(tmp_path, {**WS_3D, "halo": [0, 0, 0]}, "local", 1)
    with pytest.raises(FailedBlocksError):
        _run("torch", tmp_path, path, dirs["torch"], "ws_torch")
    log = open(os.path.join(tmp_path, "tmp_ws_torch", "logs", "two_pass_watershed_pass1.log")).read()
    assert "requires a non-zero halo" in log


def test_two_pass_tasks():
    """The passes' identifiers, pipeline safety, NMS default and
    checkerboard block lists."""
    p0, p1 = (TwoPassWatershedTask("t", pass_id=i) for i in (0, 1))
    assert (p0.identifier, p1.identifier) == ("two_pass_watershed_pass0", "two_pass_watershed_pass1")
    assert p0.pipeline_safe and not p1.pipeline_safe and not p1.fusable
    assert TwoPassWatershedTask.default_task_config()["non_maximum_suppression"] is True
    blocking = Blocking(SHAPE, BLOCK)
    gconf = {"block_shape": BLOCK}
    white, black = p0.get_block_list(blocking, gconf), p1.get_block_list(blocking, gconf)
    assert sorted(white + black) == list(range(blocking.n_blocks))
    for a in white:
        for b in white:
            pa, pb = blocking.block_grid_position(a), blocking.block_grid_position(b)
            assert sum(abs(x - y) for x, y in zip(pa, pb)) != 1


def test_pipeline_unsafe_task_runs_one_batch_at_a_time():
    """``pipeline_safe = False``: every batch is read, computed and written
    before the next batch is read, at any ``pipeline_depth``."""
    events = []

    class Unsafe:
        pipeline_safe = False

        def read_batch(self, ids, blocking, config):
            events.append(("read", ids[0]))
            return ids

        def compute_batch(self, ids, blocking, config):
            events.append(("compute", ids[0]))
            return ids

        def write_batch(self, ids, blocking, config):
            events.append(("write", ids[0]))

        def record_timing(self, *args):
            pass

    config = {"device": "cpu", "device_batch_size": 2, "pipeline_depth": 3}
    done, failed, _ = CudaExecutor(config).run_blocks(Unsafe(), None, list(range(8)), config)
    assert sorted(done) == list(range(8)) and not failed
    assert events == [(stage, b) for b in (0, 2, 4, 6) for stage in ("read", "compute", "write")]


def test_two_pass_pipeline_depth_determinism(tmp_path):
    """JAX's ``test_two_pass_watershed_depth_determinism`` on the port's
    ``cuda`` target: equal outputs at ``pipeline_depth`` 1 and 3."""
    path, _ = _volume(tmp_path, seed=3)
    outs = []
    for depth in (1, 3):
        d = str(tmp_path / f"configs_{depth}")
        jax_cfg.write_global_config(d, {
            "block_shape": BLOCK, "device": "cpu", "target": "cuda",
            "device_batch_size": 1, "pipeline_depth": depth,
        })
        jax_cfg.write_config(d, "two_pass_watershed", {**WS_3D, "halo": [4, 8, 8]})
        outs.append(_run("torch", tmp_path, path, d, f"ws_{depth}"))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert _cross_boundary_agreement(outs[0]) > 0.5
