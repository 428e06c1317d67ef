"""PyTorch port, the whole slice: ``MulticutSegmentationWorkflow`` against
the JAX one.

Both packages run from ONE config dir (plus ``"device": "cpu"``, the port's
explicit request for the host) on the same gzip n5 volume: a Voronoi cell
volume with gaussian boundary ridges (the JAX multicut tests' fixture).  The
port's watershed and segmentation volumes must be byte identical to the JAX
ones.  The 2d watershed runs on a block-divisible shape without a halo,
where the JAX reference is its XLA path (ROADMAP Queue C: padded blocks
put near-ties into the smoothed distances).  With ``device_accumulation``
the features' moments are float32 sums in another order than the JAX
program's, so that run is held to the JAX ``device_accumulation`` run by
identical Rand and VoI scores against the ground truth."""

import os

import numpy as np
import pytest

from cluster_tools_tpu.ops.evaluation import evaluate_segmentation
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import MulticutSegmentationWorkflow as JaxMulticutSegmentationWorkflow
from cluster_tools_tpu_torch import MulticutSegmentationWorkflow, build
from cluster_tools_tpu_torch.runtime.task import FailedBlocksError
from cluster_tools_tpu_torch.utils import file_reader

BLOCK = [12, 24, 24]
WS_3D = {"threshold": 0.4, "sigma_seeds": 1.0, "size_filter": 5,
         "apply_dt_2d": False, "apply_ws_2d": False, "halo": [2, 4, 4]}
WS_2D = {"threshold": 0.4}  # the default 2d mode, no halo


def _cells(tmp_path, shape=(24, 48, 48), seed=0, n_cells=30):
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, max(shape), (n_cells, 3)) % np.array(shape)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    d = np.full(shape, 1e9)
    second = np.full(shape, 1e9)
    gt = np.zeros(shape, dtype=np.uint64)
    for i, p in enumerate(pts):
        dist = (zz - p[0]) ** 2 + (yy - p[1]) ** 2 + (xx - p[2]) ** 2
        newmin = dist < d
        second = np.where(newmin, d, np.minimum(second, dist))
        gt = np.where(newmin, i + 1, gt)
        d = np.where(newmin, dist, d)
    bnd = np.exp(-((np.sqrt(second) - np.sqrt(d)) ** 2) / 8.0).astype("float32")
    path = str(tmp_path / "d.n5")
    f = jax_reader(path)
    f.create_dataset("bnd", data=bnd, chunks=(12, 24, 24), compression="gzip")
    f.create_dataset("gt", data=gt, chunks=(12, 24, 24), compression="gzip")
    return path, bnd, gt


def _config(tmp_path, name, ws_conf, features=None, **gconf):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu", **gconf})
    jax_cfg.write_config(config_dir, "watershed", ws_conf)
    if features:
        jax_cfg.write_config(config_dir, "block_edge_features", features)
    return config_dir


def _run(package, tmp_path, path, config_dir, tag, **kw):
    wf_cls, run = (
        (JaxMulticutSegmentationWorkflow, jax_build) if package == "jax"
        else (MulticutSegmentationWorkflow, build)
    )
    kw.setdefault("ws_key", f"ws_{tag}_{package}")
    wf = wf_cls(
        str(tmp_path / f"tmp_{tag}_{package}"), config_dir,
        input_path=path, input_key="bnd", ws_path=path,
        output_path=path, output_key=f"seg_{tag}_{package}", **kw,
    )
    assert run([wf])
    return wf


def _both(tmp_path, path, config_dir, tag, **kw):
    """Run both packages; return (ws, seg) of each, read by the other one."""
    _run("jax", tmp_path, path, config_dir, tag, **kw)
    _run("torch", tmp_path, path, config_dir, tag, **kw)
    ws_key = kw.get("ws_key")
    out = {}
    for package, reader in (("jax", file_reader), ("torch", jax_reader)):
        f = reader(path, "r")
        out[package] = (f[ws_key or f"ws_{tag}_{package}"][:], f[f"seg_{tag}_{package}"][:])
    return out


def _assert_identical(out, ws_identical=True):
    (ws_j, seg_j), (ws_t, seg_t) = out["jax"], out["torch"]
    assert seg_t.dtype == np.uint64 and seg_t.shape == seg_j.shape
    if ws_identical:
        np.testing.assert_array_equal(ws_t, ws_j)
    np.testing.assert_array_equal(seg_t, seg_j)
    # the segmentation coarsens the fragments: each maps to one segment
    fg = ws_t > 0
    n_ws = len(np.unique(ws_t[fg]))
    pairs = np.unique(np.stack([ws_t[fg], seg_t[fg]], axis=1), axis=0)
    n_seg = len(np.unique(seg_t[fg]))
    assert len(pairs) == n_ws and 1 < n_seg < n_ws


@pytest.mark.parametrize("n_scales", [1, 2])
def test_3d_watershed_multicut_byte_identical_to_jax(tmp_path, n_scales):
    path, _, _ = _cells(tmp_path)
    config_dir = _config(tmp_path, "configs", WS_3D)
    _assert_identical(_both(tmp_path, path, config_dir, f"s{n_scales}", n_scales=n_scales))


def test_2d_watershed_multicut_byte_identical_to_jax(tmp_path):
    path, _, _ = _cells(tmp_path, seed=1)
    config_dir = _config(tmp_path, "configs", WS_2D)
    _assert_identical(_both(tmp_path, path, config_dir, "2d"))


def test_cuda_target_equals_jax(tmp_path):
    """The port's ``cuda`` target (batched watershed; here on the CPU as
    the config asks) against the JAX ``local`` run of the same config."""
    path, _, _ = _cells(tmp_path, seed=2)
    jax_dir = _config(tmp_path, "configs_jax", WS_3D)
    port_dir = _config(tmp_path, "configs_port", WS_3D, target="cuda", device_batch_size=2)
    _run("jax", tmp_path, path, jax_dir, "t")
    _run("torch", tmp_path, path, port_dir, "t")
    f = file_reader(path, "r")
    for key in ("ws", "seg"):
        np.testing.assert_array_equal(f[f"{key}_t_torch"][:], f[f"{key}_t_jax"][:])


def test_skip_ws_with_mask_byte_identical_to_jax(tmp_path):
    """A precomputed, masked watershed (``skip_ws=True``) read by both."""
    from scipy import ndimage

    path, bnd, _ = _cells(tmp_path, seed=3)
    mask = ndimage.gaussian_filter(np.random.default_rng(4).random(bnd.shape), 3) > 0.49
    jax_reader(path).create_dataset(
        "mask", data=mask.astype("uint8"), chunks=(12, 24, 24), compression="gzip"
    )
    config_dir = _config(tmp_path, "configs", WS_3D)
    wf = _run("jax", tmp_path, path, config_dir, "ws", mask_path=path, mask_key="mask")
    ws = jax_reader(path, "r")["ws_ws_jax"][:]
    assert (ws[~mask] == 0).all() and (ws[mask] > 0).any()
    out = _both(tmp_path, path, config_dir, "skip", ws_key="ws_ws_jax", skip_ws=True)
    _assert_identical(out)
    assert (out["torch"][1][~mask] == 0).all()
    assert wf.complete()


def test_masked_watershed_multicut_byte_identical_to_jax(tmp_path):
    from scipy import ndimage

    path, bnd, _ = _cells(tmp_path, seed=5)
    mask = ndimage.gaussian_filter(np.random.default_rng(6).random(bnd.shape), 3) > 0.49
    jax_reader(path).create_dataset(
        "mask", data=mask.astype("uint8"), chunks=(12, 24, 24), compression="gzip"
    )
    config_dir = _config(tmp_path, "configs", WS_3D)
    _assert_identical(_both(tmp_path, path, config_dir, "m", mask_path=path, mask_key="mask"))


def test_exact_quantiles_byte_identical_to_jax(tmp_path):
    path, _, _ = _cells(tmp_path, seed=7)
    config_dir = _config(tmp_path, "configs", WS_3D, features={"quantile_mode": "exact"})
    out = _both(tmp_path, path, config_dir, "exact")
    _assert_identical(out)
    for package, reader in (("jax", jax_reader), ("torch", file_reader)):
        store = reader(str(tmp_path / f"tmp_exact_{package}" / "data.zarr"), "r")
        assert "features/samples" in store
    feats = {
        package: reader(str(tmp_path / f"tmp_exact_{package}" / "data.zarr"), "r")["features/edges"][:]
        for package, reader in (("jax", jax_reader), ("torch", file_reader))
    }
    np.testing.assert_array_equal(feats["torch"], feats["jax"])


def test_ragged_volume_byte_identical_to_jax(tmp_path):
    path, _, _ = _cells(tmp_path, shape=(20, 41, 37), seed=8, n_cells=20)
    config_dir = _config(tmp_path, "configs", WS_3D)
    _assert_identical(_both(tmp_path, path, config_dir, "r", n_scales=2))


def test_device_accumulation_same_scores_as_jax(tmp_path):
    path, _, gt = _cells(tmp_path, seed=9)
    config_dir = _config(tmp_path, "configs", WS_3D, features={"device_accumulation": True})
    out = _both(tmp_path, path, config_dir, "dev")
    (ws_j, seg_j), (ws_t, seg_t) = out["jax"], out["torch"]
    np.testing.assert_array_equal(ws_t, ws_j)
    scores = {p: evaluate_segmentation(out[p][1], gt) for p in out}
    assert scores["torch"] == scores["jax"]
    feats = {
        package: reader(str(tmp_path / f"tmp_dev_{package}" / "data.zarr"), "r")["features/edges"][:]
        for package, reader in (("jax", jax_reader), ("torch", file_reader))
    }
    np.testing.assert_array_equal(feats["torch"][:, 9], feats["jax"][:, 9])
    np.testing.assert_allclose(feats["torch"], feats["jax"], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("kw", [
    {"sharded_problem": True}, {"sharded_problem": True, "sharded_ws": True},
], ids=["sharded_problem", "sharded_ws"])
def test_unported_options_raise(tmp_path, kw):
    """The sharded problem paths raise (ROADMAP Queue A 11)."""
    from cluster_tools_tpu_torch.workflows import ProblemWorkflow

    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 11"):
        MulticutSegmentationWorkflow(str(tmp_path), None, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A 11"):
        ProblemWorkflow(str(tmp_path), None, **kw)


def test_sanity_checks_inserts_check_task(tmp_path):
    """``sanity_checks`` puts ``CheckSubGraphsTask`` between the graph and
    the features."""
    from cluster_tools_tpu_torch.tasks import CheckSubGraphsTask
    from cluster_tools_tpu_torch.workflows import EdgeFeaturesWorkflow, ProblemWorkflow

    kw = {"sanity_checks": True}
    problem = ProblemWorkflow(str(tmp_path), None, ws_path="w", ws_key="k", **kw)
    feats = next(t for t in problem.requires()[0].requires() if isinstance(t, EdgeFeaturesWorkflow))
    assert [type(t) for t in feats.dependencies] == [CheckSubGraphsTask]
    assert MulticutSegmentationWorkflow(str(tmp_path), None, **kw).sanity_checks


def test_sharded_ws_without_sharded_problem_is_a_contradiction(tmp_path):
    with pytest.raises(ValueError, match="requires sharded_problem"):
        MulticutSegmentationWorkflow(str(tmp_path), None, sharded_ws=True)


@pytest.mark.parametrize("key,value", [("offsets", [[-1, 0, 0]]), ("filters", ["gaussianSmoothing"])])
def test_feature_paths_run(tmp_path, key, value):
    """The affinity (``offsets``) and filter-bank (``filters``) feature
    paths are ported: the port's workflow runs them (on the CPU, as the
    config asks) and writes 10 feature columns (one offset channel, or one
    filter at one sigma: 9 statistics and the count); with one z offset
    only z-neighbour edges carry samples."""
    path, bnd, _ = _cells(tmp_path, shape=(12, 48, 48), seed=10, n_cells=16)
    jax_reader(path).create_dataset("affs", data=bnd[None], chunks=(1, 12, 24, 24), compression="gzip")
    config_dir = _config(tmp_path, "configs", WS_3D, features={key: value, "sigmas": [1.0]})
    wf = MulticutSegmentationWorkflow(
        str(tmp_path / "tmp_x"), config_dir, input_path=path, input_key="affs",
        ws_path=path, ws_key="ws_x", output_path=path, output_key="seg_x",
    )
    assert build([wf])
    store = file_reader(str(tmp_path / "tmp_x" / "data.zarr"), "r")
    feats = store["features/edges"][:]
    assert feats.shape[1] == 10 and (feats[:, 9] > 0).any()
