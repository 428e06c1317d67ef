"""PyTorch port, the affinity and filter-bank edge-feature paths: the ops
``filter_edge_features`` / ``affinity_edge_features`` and the workflows
that run them, against the JAX package on the CPU.

Contracts: the ops equal JAX's bit for bit on the same numpy inputs (both
are the same host numpy); ``MulticutSegmentationWorkflow`` from affinities
(``offsets``, with ``sanity_checks``), ``SubSolutionsWorkflow`` and
``ReducedSolutionWorkflow`` byte-identical to JAX's; with the filter bank
the features within 1e-6 (the port's tap sums run in another order than
XLA's convolution, ROADMAP Queue C) and the segmentation equal."""

import numpy as np
import pytest

from cluster_tools_tpu.ops import rag as jrag
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import MulticutSegmentationWorkflow as JaxMulticut
from cluster_tools_tpu.workflows import ReducedSolutionWorkflow as JaxReduced
from cluster_tools_tpu.workflows import SubSolutionsWorkflow as JaxSubSolutions
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.ops import rag as trag
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.workflows import (
    MulticutSegmentationWorkflow,
    ReducedSolutionWorkflow,
    SubSolutionsWorkflow,
)

SHAPE = (16, 48, 48)
BLOCK = [8, 24, 24]
OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
WS = {"threshold": 0.4, "sigma_seeds": 1.0, "size_filter": 5}


def _cells(seed, shape=SHAPE, n_cells=24):
    """Voronoi cells with gaussian boundary ridges (float32 in [0, 1]) and
    the cells' labels."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, max(shape), (n_cells, 3)) % np.array(shape)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    d = np.full(shape, 1e9)
    second = np.full(shape, 1e9)
    cells = np.zeros(shape, dtype=np.uint64)
    for i, p in enumerate(pts):
        dist = (zz - p[0]) ** 2 + (yy - p[1]) ** 2 + (xx - p[2]) ** 2
        newmin = dist < d
        second = np.where(newmin, d, np.minimum(second, dist))
        cells = np.where(newmin, i + 1, cells)
        d = np.where(newmin, dist, d)
    bnd = np.exp(-((np.sqrt(second) - np.sqrt(d)) ** 2) / 8.0).astype("float32")
    return bnd, cells


def _affinities(bnd):
    """Boundary-convention nearest-neighbour affinities of ``OFFSETS``:
    ``max(b(x), b(x + o))``, ``b(x)`` where ``x + o`` leaves the volume."""
    out = np.repeat(bnd[None], len(OFFSETS), axis=0)
    for c, off in enumerate(OFFSETS):
        ax = int(np.nonzero(off)[0][0])
        sl = [slice(None)] * 3
        sl[ax] = slice(1, None)
        prev = [slice(None)] * 3
        prev[ax] = slice(None, -1)
        out[c][tuple(sl)] = np.maximum(bnd[tuple(sl)], bnd[tuple(prev)])
    return out


# ---------------------------------------------------------------- the ops


def _labels(seed, shape=(6, 12, 12), n=9):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, n, (shape[0], shape[1] // 3, shape[2] // 3)).astype(np.uint64)
    return np.kron(lab, np.ones((1, 3, 3), dtype=np.uint64))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("owner", [None, (4, 9, 9)], ids=["whole", "owner"])
@pytest.mark.parametrize("return_samples", [False, True])
def test_filter_edge_features_bitwise(owner, return_samples):
    lab = _labels(0)
    rng = np.random.default_rng(1)
    responses = [rng.standard_normal(lab.shape) for _ in range(3)]
    kw = {"owner_shape": owner, "return_samples": return_samples}
    _assert_same(trag.filter_edge_features(lab, responses, **kw),
                 jrag.filter_edge_features(lab, responses, **kw))


@pytest.mark.parametrize("offsets", [
    OFFSETS,
    [[-1, 0, 0], [0, -3, 0], [0, 0, -2], [1, 0, 0], [0, 2, 1], [-2, 1, -1]],
], ids=["nearest", "long-and-positive"])
@pytest.mark.parametrize("owner", [None, (4, 9, 9)], ids=["whole", "owner"])
@pytest.mark.parametrize("mode", ["plain", "hist", "samples"])
def test_affinity_edge_features_bitwise(offsets, owner, mode):
    lab = _labels(2)
    affs = np.random.default_rng(3).random((len(offsets),) + lab.shape)
    kw = {"owner_shape": owner, "hist_bins": trag.HIST_BINS if mode == "hist" else 0,
          "return_samples": mode == "samples"}
    _assert_same(trag.affinity_edge_features(lab, affs, offsets, **kw),
                 jrag.affinity_edge_features(lab, affs, offsets, **kw))


def test_affinity_owner_rule_keeps_negative_offset_pairs():
    """The cross-face pair of a negative offset is owned by the lower block
    (the min-corner rule): seen once across two +1-halo'd blocks, as in the
    JAX package's test."""
    labels = np.zeros((1, 1, 4), dtype=np.uint64)
    labels[..., :2] = 1
    labels[..., 2:] = 2
    affs = np.full((1, 1, 1, 4), 0.7)
    counts = 0.0
    for begin in (0, 2):
        end = min(begin + 3, 4)
        args = (labels[..., begin:end], affs[..., begin:end], [[0, 0, -1]])
        got = trag.affinity_edge_features(*args, owner_shape=(1, 1, 2))
        _assert_same(got, jrag.affinity_edge_features(*args, owner_shape=(1, 1, 2)))
        if got[0].shape[0]:
            counts += got[1][0, 9]
    assert counts == 1.0


# ---------------------------------------------------------- the workflows


def _config(tmp_path, name, features, block=BLOCK, **ws):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(config_dir, {"block_shape": block, "device": "cpu"})
    jax_cfg.write_config(config_dir, "watershed", {**WS, **ws})
    jax_cfg.write_config(config_dir, "block_edge_features", features)
    return config_dir


def _multicut_both(tmp_path, path, key, config_dir, tag, **kw):
    for package, cls, run in (("jax", JaxMulticut, jax_build), ("torch", MulticutSegmentationWorkflow, build)):
        wf = cls(
            str(tmp_path / f"tmp_{tag}_{package}"), config_dir,
            input_path=path, input_key=key, ws_path=path, ws_key=f"ws_{tag}_{package}",
            output_path=path, output_key=f"seg_{tag}_{package}", **kw,
        )
        assert run([wf])
    f = file_reader(path, "r")
    return {p: (f[f"ws_{tag}_{p}"][:], f[f"seg_{tag}_{p}"][:]) for p in ("jax", "torch")}


def _features(tmp_path, tag):
    return {
        p: reader(str(tmp_path / f"tmp_{tag}_{p}" / "data.zarr"), "r")["features/edges"][:]
        for p, reader in (("jax", jax_reader), ("torch", file_reader))
    }


def _coarsens(ws, seg):
    fg = ws > 0
    n_ws = len(np.unique(ws[fg]))
    pairs = np.unique(np.stack([ws[fg], seg[fg]], axis=1), axis=0)
    n_seg = len(np.unique(seg[fg]))
    assert len(pairs) == n_ws and 1 < n_seg < n_ws


def test_affinity_multicut_sub_and_reduced_solutions_byte_identical(tmp_path):
    """The multicut from affinities (watershed over channels 0-3, mean;
    ``offsets`` features; ``sanity_checks``), then the sub-solution and
    reduced-solution workflows in its tmp folder (scale 1: the reduce of
    the multicut's solve)."""
    bnd, _ = _cells(0)
    path = str(tmp_path / "a.n5")
    jax_reader(path).create_dataset("affs", data=_affinities(bnd), chunks=(1, 8, 24, 24),
                                    compression="gzip")
    config_dir = _config(tmp_path, "configs", {"offsets": OFFSETS},
                         channel_begin=0, channel_end=3, agglomerate_channels="mean")
    out = _multicut_both(tmp_path, path, "affs", config_dir, "aff", sanity_checks=True)
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    _coarsens(*out["torch"])
    feats = _features(tmp_path, "aff")
    np.testing.assert_array_equal(feats["torch"], feats["jax"])
    for p in ("jax", "torch"):
        status = tmp_path / f"tmp_aff_{p}" / "status" / "check_sub_graphs.status.json"
        assert status.exists()

    for package, sub_cls, red_cls, run in (
        ("jax", JaxSubSolutions, JaxReduced, jax_build),
        ("torch", SubSolutionsWorkflow, ReducedSolutionWorkflow, build),
    ):
        kw = {"ws_path": path, "ws_key": f"ws_aff_{package}", "n_scales": 1}
        tmp = str(tmp_path / f"tmp_aff_{package}")
        assert run([sub_cls(tmp, config_dir, output_path=path, output_key=f"sub_{package}", **kw)])
        assert run([red_cls(tmp, config_dir, output_path=path, output_key=f"red_{package}", **kw)])
    f = file_reader(path, "r")
    ws = f["ws_aff_torch"][:]
    for key in ("sub", "red"):
        np.testing.assert_array_equal(f[f"{key}_torch"][:], f[f"{key}_jax"][:])
    # each fragment maps to one id within a scale-1 block; the reduced
    # labeling coarsens the fragments
    sub = f["sub_torch"][:]
    blk = (slice(0, 16), slice(0, 48), slice(0, 48))
    fg = ws[blk] > 0
    pairs = np.unique(np.stack([ws[blk][fg], sub[blk][fg]], axis=1), axis=0)
    assert len(pairs) == len(np.unique(ws[blk][fg]))
    red = f["red_torch"][:]
    pairs = np.unique(np.stack([ws[ws > 0], red[ws > 0]], axis=1), axis=0)
    assert len(pairs) == len(np.unique(ws[ws > 0]))
    assert 1 < len(np.unique(red[ws > 0])) <= len(np.unique(ws[ws > 0]))


def test_filter_bank_multicut_matches_jax(tmp_path):
    """The gaussian (whose mean the costs read) and the hessian's three
    eigenvalues at sigma 1.6, halo 6 (the radius of sigma 1.6; the upper read adds the +1
    halo), over given fragments (``skip_ws``: the cells, each cut at z = 8)
    in four blocks: features within 1e-6, equal sample counts, the same
    segmentation."""
    bnd, cells = _cells(1)
    frags = cells * 2 + (np.arange(SHAPE[0]) >= 8)[:, None, None].astype(np.uint64)
    path = str(tmp_path / "f.n5")
    f = jax_reader(path)
    f.create_dataset("bnd", data=bnd, chunks=(8, 24, 24), compression="gzip")
    for p in ("jax", "torch"):
        f.create_dataset(f"ws_fb_{p}", data=frags, chunks=(8, 24, 24), compression="gzip")
    features = {"filters": ["gaussianSmoothing", "hessianOfGaussianEigenvalues"],
                "sigmas": [1.6], "halo": [6, 6, 6]}
    config_dir = _config(tmp_path, "configs", features, block=[16, 24, 24])
    out = _multicut_both(tmp_path, path, "bnd", config_dir, "fb", skip_ws=True)
    feats = _features(tmp_path, "fb")
    assert feats["torch"].shape == feats["jax"].shape == (feats["jax"].shape[0], 9 * 4 + 1)
    np.testing.assert_array_equal(feats["torch"][:, -1], feats["jax"][:, -1])
    np.testing.assert_allclose(feats["torch"], feats["jax"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    _coarsens(*out["torch"])


@pytest.mark.parametrize("agglo,in_2d", [("mean", False), ("max", True)])
def test_filter_responses_of_a_4d_input_match_jax(tmp_path, agglo, in_2d):
    """``channel_agglomeration`` of a multi-channel input before the bank,
    3d and ``apply_in_2d``: the task's halo'd responses of one block within
    1e-6 of JAX's (the hessian's within 1e-5·max|H|)."""
    from cluster_tools_tpu.tasks.features import BlockEdgeFeaturesTask as JaxTask
    from cluster_tools_tpu_torch.tasks.features import BlockEdgeFeaturesTask
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    data = np.random.default_rng(4).random((2,) + SHAPE).astype("float32")
    path = str(tmp_path / "m.n5")
    jax_reader(path).create_dataset("affs", data=data, chunks=(1, 8, 24, 24), compression="gzip")
    config = {"filters": ["gaussianSmoothing", "hessianOfGaussianEigenvalues"], "sigmas": [1.0],
              "halo": [4, 4, 4], "apply_in_2d": in_2d, "channel_agglomeration": agglo,
              "device": "cpu"}
    blocking = Blocking(SHAPE, BLOCK)
    got, want = ([cls(str(tmp_path / name), None, input_path=path, input_key="affs")
                  ._filter_responses(blocking, 3, config)]
                 for name, cls in (("t", BlockEdgeFeaturesTask), ("j", JaxTask)))
    got, want = got[0], want[0]
    assert len(got) == len(want) == (3 if in_2d else 4)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float64
        atol = 1e-6 if i == 0 else 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
