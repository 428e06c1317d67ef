"""PyTorch port, region features and the image filter: ``ops/segment.py``'s
reductions, ``RegionFeaturesTask`` + ``MergeRegionFeaturesTask`` and
``ImageFilterTask`` against the JAX package on the CPU (the JAX
``tests/test_learning.py`` cases), inputs made by numpy from a seed.

Contracts: counts, minima and maxima exactly; sums and means within a
float32 tolerance (rtol 1e-6 per segment; ``index_add_`` on the card has no
fixed order); filter responses within ``atol`` 1e-6 (1e-5·max|H| for the
hessian's eigenvalues) of JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops import segment as jseg
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import region_features as jrf
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.ops import segment as tseg
from cluster_tools_tpu_torch.tasks import region_features as trf
from cluster_tools_tpu_torch.utils import file_reader

SHAPE = (16, 32, 32)
BLOCK = [8, 16, 16]
PACKAGES = {"jax": (jax_build, jrf), "torch": (build, trf)}


def test_segment_reductions_match_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 40, 5000).astype(np.int32)
    labels[labels == 13] = 12  # an empty segment
    values = rng.random(5000).astype(np.float32)
    lab_t, val_t = torch.from_numpy(labels.astype(np.int64)), torch.from_numpy(values)
    lab_j, val_j = jnp.asarray(labels), jnp.asarray(values)
    k = 41
    np.testing.assert_array_equal(tseg.segment_count(lab_t, k).numpy(),
                                  np.asarray(jseg.segment_count(lab_j, k)))
    for name in ("segment_min", "segment_max"):
        want = np.asarray(getattr(jseg, name)(lab_j, val_j, k))
        got = getattr(tseg, name)(lab_t, val_t, k).numpy()
        np.testing.assert_array_equal(got, want)
    for name in ("segment_sum", "segment_mean"):
        want = np.asarray(getattr(jseg, name)(lab_j, val_j, k))
        got = getattr(tseg, name)(lab_t, val_t, k).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _setup(tmp_path, **datasets):
    path = str(tmp_path / "d.n5")
    f = jax_reader(path)
    for key, data in datasets.items():
        f.create_dataset(key, data=data, chunks=tuple(BLOCK), compression="gzip")
    config_dir = str(tmp_path / "configs")
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu"})
    return path, config_dir


@pytest.mark.parametrize("raw_dtype", ["float32", "uint8"])
def test_region_features_match_jax_and_numpy(tmp_path, raw_dtype):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 20, SHAPE).astype("uint64")  # 0 = ignored
    values = rng.random(SHAPE).astype("float32")
    if raw_dtype == "uint8":
        values = (values * 255).astype("uint8")
    path, config_dir = _setup(tmp_path, seg=labels, raw=values)
    feats = {}
    for package, (run, rf) in PACKAGES.items():
        tmp = str(tmp_path / f"tmp_{package}")
        block = rf.RegionFeaturesTask(tmp, config_dir, input_path=path, input_key="raw",
                                      labels_path=path, labels_key="seg")
        merge = rf.MergeRegionFeaturesTask(tmp, config_dir, dependencies=[block],
                                           input_path=path, input_key="raw")
        assert run([merge])
        feats[package] = rf.load_region_features(tmp)
    got, want = feats["torch"], feats["jax"]
    assert got.shape == want.shape == (20, 4)
    np.testing.assert_array_equal(got[:, [0, 2, 3]], want[:, [0, 2, 3]])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6, atol=0)
    vals = values.astype(np.float64) / (255.0 if raw_dtype == "uint8" else 1.0)
    for seg_id in range(1, 20):
        sel = labels == seg_id
        assert got[seg_id, 0] == sel.sum()
        assert got[seg_id, 2] == np.float32(vals[sel].min())
        assert got[seg_id, 3] == np.float32(vals[sel].max())
        np.testing.assert_allclose(got[seg_id, 1], vals[sel].mean(), rtol=1e-5)


@pytest.mark.parametrize("name,sigma,in_2d", [
    ("gaussianSmoothing", 1.5, False),
    ("hessianOfGaussianEigenvalues", 1.0, False),
    ("gaussianGradientMagnitude", 1.0, True),
])
def test_image_filter_matches_jax(tmp_path, name, sigma, in_2d):
    raw = np.random.default_rng(2).random(SHAPE).astype("float32")
    path, config_dir = _setup(tmp_path, raw=raw)
    out = {}
    for package, (run, rf) in PACKAGES.items():
        task = rf.ImageFilterTask(
            str(tmp_path / f"tmp_{package}"), config_dir, input_path=path, input_key="raw",
            output_path=path, output_key=f"out_{package}", filter_name=name, sigma=sigma,
            apply_in_2d=in_2d,
        )
        assert run([task])
        out[package] = file_reader(path, "r")[f"out_{package}"][:]
    got, want = out["torch"], out["jax"]
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    atol = 1e-5 * np.abs(want).max() if name.startswith("hessian") else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if name.startswith("hessian"):
        assert got.shape == (3,) + SHAPE and (got[0] >= got[1]).all() and (got[1] >= got[2]).all()
