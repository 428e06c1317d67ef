"""PyTorch port: ``ops/rag.py`` against the JAX package's.

The host path (numpy in both packages) must be bit-identical: block edges,
per-block features with and without the histogram sketch, raw samples, and
both merges.  The device accumulator (``boundary_edge_features_gpu``, here
on CPU tensors) is held to JAX's ``boundary_edge_features_tpu`` with the
reference's tolerances (``tests/test_workflow_multicut.py``): edges, counts
and histograms equal; minima, maxima and quantiles to ``atol=1e-6``; the
mean to ``rtol=1e-4, atol=1e-5``; the variance to ``rtol=1e-3,
atol=1e-4``."""

import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops import rag as jrag
from cluster_tools_tpu_torch.ops import rag


def _labels(shape, seed, n=25, scale=1, zero=True):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0 if zero else 1, n, shape).astype(np.uint64) * np.uint64(scale)
    values = rng.random(shape).astype(np.float32)
    return labels, values


def _blobs(shape, seed, n=40):
    """Piecewise-constant labels (cubes of 3) — larger faces than noise."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, n, tuple(-(-s // 3) for s in shape)).astype(np.uint64)
    labels = np.kron(small, np.ones((3, 3, 3), np.uint64))[tuple(slice(0, s) for s in shape)]
    return np.ascontiguousarray(labels), rng.random(shape).astype(np.float32)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


CASES = [((10, 10, 10), None), ((9, 17, 17), (8, 16, 16)), ((7, 13, 11), (6, 12, 10))]


@pytest.mark.parametrize("ignore_zero", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_edges_bit_identical(seed, ignore_zero):
    labels, _ = _labels((10, 12, 9), seed, n=7)
    _assert_same(
        (rag.block_edges(labels, ignore_zero),), (jrag.block_edges(labels, ignore_zero),)
    )
    empty = np.zeros((4, 4, 4), np.uint64)
    _assert_same((rag.block_edges(empty),), (jrag.block_edges(empty),))


@pytest.mark.parametrize("dtype,base", [
    (np.uint64, 2**63 + 5), (np.uint64, 0), (np.int32, 2**30), (np.int64, 1),
])
def test_block_edges_bit_identical_wide_ids(dtype, base):
    """Many labels, ids far from 0 and other dtypes: the rows' unique over
    one integer key per row keeps the structured unique's rows, order and
    dtype."""
    labels, _ = _labels((12, 20, 18), 4, n=600)
    labels = np.where(labels > 0, labels + np.uint64(base), 0).astype(dtype)
    _assert_same((rag.block_edges(labels),), (jrag.block_edges(labels),))
    assert rag.block_edges(labels).shape[0] > 1000


@pytest.mark.parametrize("hist_bins", [0, rag.HIST_BINS])
@pytest.mark.parametrize("shape,owner", CASES)
def test_boundary_edge_features_bit_identical(shape, owner, hist_bins):
    for make in (_labels, _blobs):
        labels, values = make(shape, 3)
        values = values.astype(np.float64)
        got = rag.boundary_edge_features(labels, values, hist_bins=hist_bins, owner_shape=owner)
        want = jrag.boundary_edge_features(labels, values, hist_bins=hist_bins, owner_shape=owner)
        _assert_same(got, want)
        got = rag.boundary_edge_features(labels, values, owner_shape=owner, return_samples=True)
        want = jrag.boundary_edge_features(labels, values, owner_shape=owner, return_samples=True)
        _assert_same(got, want)


def test_boundary_edge_features_empty_block_bit_identical():
    labels = np.full((4, 5, 6), 3, np.uint64)
    values = np.zeros((4, 5, 6))
    for kw in ({}, {"hist_bins": rag.HIST_BINS}, {"return_samples": True}):
        _assert_same(rag.boundary_edge_features(labels, values, **kw),
                     jrag.boundary_edge_features(labels, values, **kw))


def _partials(module, labels, values, block, mode):
    """Per-block partials of a blocked volume, mapped to global edge ids as
    ``BlockEdgeFeaturesTask`` maps them."""
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    all_edges = module.block_edges(labels)
    keys = all_edges[:, 0] * np.uint64(2**20) + all_edges[:, 1]
    blocking = Blocking(labels.shape, block)
    ids_l, feats_l, hists_l, samples_l = [], [], [], []
    for bid in range(blocking.n_blocks):
        b = blocking.block(bid)
        end = tuple(min(e + 1, s) for e, s in zip(b.end, labels.shape))
        bb = tuple(slice(s, e) for s, e in zip(b.begin, end))
        out = module.boundary_edge_features(
            labels[bb], values[bb], hist_bins=module.HIST_BINS if mode == "sketch" else 0,
            owner_shape=b.shape, return_samples=mode == "exact",
        )
        edges, feats = out[0], out[1]
        ids = np.searchsorted(keys, edges[:, 0] * np.uint64(2**20) + edges[:, 1]).astype(np.int64)
        ids_l.append(ids)
        feats_l.append(feats)
        hists_l.append(out[2] if mode == "sketch" else None)
        samples_l.append(out[2] if mode == "exact" else None)
    return ids_l, feats_l, hists_l, samples_l, all_edges.shape[0]


@pytest.mark.parametrize("mode", ["sketch", "approx", "exact"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merges_bit_identical(seed, mode):
    labels, values = _blobs((16, 24, 20), seed)
    values = values.astype(np.float64)
    got = _partials(rag, labels, values, (8, 12, 12), mode)
    want = _partials(jrag, labels, values, (8, 12, 12), mode)
    for g, w in zip(got[:4], want[:4]):
        for x, y in zip(g, w):
            if y is None:
                assert x is None
            else:
                _assert_same((x,), (y,))
    ids, feats, hists, samples, n_edges = got
    if mode == "exact":
        _assert_same((rag.merge_edge_features_multi(ids, feats, n_edges, samples),),
                     (jrag.merge_edge_features_multi(ids, feats, n_edges, samples),))
        # exact merge: quantiles equal a single-shot recompute
        _, whole = rag.boundary_edge_features(labels, values)
        np.testing.assert_array_equal(
            rag.merge_edge_features_multi(ids, feats, n_edges, samples)[:, 3:8], whole[:, 3:8]
        )
    else:
        _assert_same((rag.merge_edge_features(ids, feats, n_edges, hists),),
                     (jrag.merge_edge_features(ids, feats, n_edges, hists),))
        _assert_same((rag.merge_edge_features_multi(ids, feats, n_edges),),
                     (jrag.merge_edge_features_multi(ids, feats, n_edges),))


def test_merge_out_of_range_values_fall_back_bit_identical():
    labels = np.zeros((1, 2, 4), dtype=np.uint64)
    labels[:, 0] = 1
    labels[:, 1] = 2
    values = np.zeros((1, 2, 4))
    values[:, 0] = [10.0, 50.0, 100.0, 240.0]
    values[:, 1] = [10.0, 50.0, 100.0, 240.0]
    edges, feats, hists = rag.boundary_edge_features(labels, values, hist_bins=rag.HIST_BINS)
    args = ([np.zeros(len(edges), dtype=np.int64)], [feats], 1, [hists])
    got = rag.merge_edge_features(*args)
    _assert_same((got,), (jrag.merge_edge_features(*args),))
    assert 10.0 < got[0, 5] < 240.0


def _assert_device_close(got, want):
    (ge, gf, gh), (we, wf, wh) = got, want
    _assert_same((ge,), (we,))
    _assert_same((gh,), (wh,))
    np.testing.assert_array_equal(gf[:, 9], wf[:, 9])
    np.testing.assert_allclose(gf[:, 2], wf[:, 2], atol=1e-6)
    np.testing.assert_allclose(gf[:, 8], wf[:, 8], atol=1e-6)
    np.testing.assert_allclose(gf[:, 3:8], wf[:, 3:8], atol=1e-6)
    np.testing.assert_allclose(gf[:, 0], wf[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gf[:, 1], wf[:, 1], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shape,owner", CASES)
@pytest.mark.parametrize("make", [_labels, _blobs], ids=["noise", "blobs"])
def test_device_accumulator_matches_jax_device_and_host(shape, owner, make):
    labels, values = make(shape, 5)
    labels = labels * np.uint64(100)
    got = rag.boundary_edge_features_gpu(
        labels, values, hist_bins=rag.HIST_BINS, owner_shape=owner, device="cpu"
    )
    want = jrag.boundary_edge_features_tpu(labels, values, hist_bins=rag.HIST_BINS, owner_shape=owner)
    _assert_device_close(got, want)
    host = rag.boundary_edge_features(
        labels, values.astype(np.float64), hist_bins=rag.HIST_BINS, owner_shape=owner
    )
    _assert_device_close(got, host)
    edges, feats = rag.boundary_edge_features_gpu(labels, values, owner_shape=owner, device="cpu")
    _assert_same((edges, feats), got[:2])


def test_device_accumulator_uint64_ids_without_background():
    base = np.uint64(2**60)
    rng = np.random.default_rng(2)
    labels = rng.integers(1, 9, (6, 8, 8)).astype(np.uint64) + base
    values = rng.random((6, 8, 8)).astype(np.float32)
    edges, feats = rag.boundary_edge_features_gpu(labels, values, device="cpu")
    want_edges, want = jrag.boundary_edge_features_tpu(labels, values)
    assert edges.dtype == np.uint64 and (edges > base).all()
    _assert_same((edges,), (want_edges,))
    np.testing.assert_array_equal(feats[:, 9], want[:, 9])


def test_device_accumulator_edge_cap_raises():
    labels, values = _labels((8, 16, 16), 4, n=60)
    n = rag.block_edges(labels).shape[0]
    with pytest.raises(ValueError, match="raise max_edges"):
        rag.boundary_edge_features_gpu(labels, values, max_edges=n - 1, device="cpu")
    edges, _ = rag.boundary_edge_features_gpu(labels, values, max_edges=n, device="cpu")
    assert edges.shape[0] == n


def test_device_sample_compaction():
    """Pre-sort compaction (``max_samples``) is invisible in the results,
    reports the true sample count, and drops rows only when the cap is
    deliberately undersized (the JAX test's case)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    labels = rng.integers(0, 20, (8, 16, 16)).astype(np.int32)
    values = rng.random((8, 16, 16)).astype(np.float32)
    n_valid = rag.count_boundary_samples(labels)
    assert n_valid == jrag.count_boundary_samples(labels) > 0
    cap = rag.sample_capacity(n_valid)
    assert cap == jrag.sample_capacity(n_valid) and cap >= n_valid
    lab_t, val_t = torch.from_numpy(labels), torch.from_numpy(values)
    ref = rag.boundary_edge_features_device(lab_t, val_t, max_edges=1024)
    got = rag.boundary_edge_features_device(lab_t, val_t, max_edges=1024, max_samples=cap)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(r.numpy(), g.numpy(), atol=1e-6)
    assert int(got[5]) == n_valid
    small = rag.boundary_edge_features_device(
        lab_t, val_t, max_edges=1024, max_samples=max(n_valid // 2, 1)
    )
    assert int(small[5]) == n_valid > n_valid // 2
    # the same padded outputs as the JAX device program
    jref = jrag.boundary_edge_features_device(jnp.asarray(labels), jnp.asarray(values), max_edges=1024)
    n = int(jref[4])
    assert int(got[4]) == n
    np.testing.assert_array_equal(got[0][:n].numpy(), np.asarray(jref[0][:n]))
    np.testing.assert_array_equal(got[1][:n].numpy(), np.asarray(jref[1][:n]))
    np.testing.assert_array_equal(got[3][:n].numpy(), np.asarray(jref[3][:n]).astype(np.int64))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jref[2]), rtol=1e-4, atol=1e-5)


def test_device_accumulator_counts_only_card_launches():
    labels, values = _labels((4, 8, 8), 8)
    before = rag.boundary_edge_features_device.launches
    rag.boundary_edge_features_gpu(labels, values, device="cpu")
    assert rag.boundary_edge_features_device.launches == before
    with pytest.raises(TypeError, match="int32"):
        rag.boundary_edge_features_device(torch.zeros((2, 2, 2)), torch.zeros((2, 2, 2)))
