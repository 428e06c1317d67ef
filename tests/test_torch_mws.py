"""PyTorch port: the mutex watershed ops against the JAX package's.

``compute_mws_segmentation`` and its seeded variant must be byte identical
to JAX's (native and Python solvers, strides, random strides, noise, a
mask; the seeded one also past ``max_mutex_ids``).  The port's device
formulation, run on CPU tensors, must give JAX ``mutex_watershed_device``'s
labels and ``mutex_watershed_device_rounds``' round counts (chain
contraction on and off) on the graphs of the JAX device tests, and the
partition of the port's native solver.  Device mode asking for a card that
is absent raises."""

import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops import _backend as jax_backend
from cluster_tools_tpu.ops import mws as jax_mws
from cluster_tools_tpu.ops import mws_device as jax_mws_device
from cluster_tools_tpu.ops.affinities import compute_affinities
from cluster_tools_tpu.ops.evaluation import evaluate_segmentation
from cluster_tools_tpu_torch import native
from cluster_tools_tpu_torch.ops import mws
from cluster_tools_tpu_torch.ops import mws_device

OFFSETS = [
    [-1, 0, 0], [0, -1, 0], [0, 0, -1],
    [-2, 0, 0], [0, -3, 0], [0, 0, -3],
    [-1, -3, 0], [0, 3, 3],
]


def _affs(seed, shape, quantized=False):
    rng = np.random.default_rng(seed)
    if quantized:
        # a 1/256 grid: aff and 1 - aff are exact in float32 and float64
        return (rng.integers(0, 257, (len(OFFSETS),) + shape) / 256.0).astype(np.float32)
    return ndimage.gaussian_filter(
        rng.random((len(OFFSETS),) + shape), (0, 1, 2, 2)).astype(np.float32)


def _same_partition(a, b) -> bool:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


SEG_CASES = {
    "plain": dict(),
    "strides": dict(strides=[1, 2, 2]),
    "random-strides": dict(strides=[2, 2, 2], randomize_strides=True, seed=5),
    "noise": dict(noise_level=0.2, seed=3),
    "mask": dict(strides=[1, 2, 2], mask="half"),
    "all": dict(strides=[2, 2, 2], randomize_strides=True, noise_level=0.1, seed=7, mask="half"),
}


def _kw(case, shape):
    kw = dict(SEG_CASES[case])
    if kw.get("mask") == "half":
        mask = np.ones(shape, bool)
        mask[:, : shape[1] // 3] = False
        mask[0, -3:, -3:] = False
        kw["mask"] = mask
    return kw


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segmentation_byte_identical_to_jax(case, use_native):
    shape = (8, 32, 32) if use_native else (4, 16, 16)
    affs = _affs(11, shape)
    kw = _kw(case, shape)
    want = jax_mws.compute_mws_segmentation(affs, OFFSETS, use_native=use_native, **kw)
    got = mws.compute_mws_segmentation(affs, OFFSETS, use_native=use_native, **kw)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert 1 < len(np.unique(got)) < got.size


def test_segmentation_rejects_channel_mismatch():
    with pytest.raises(ValueError, match="affinity channels"):
        mws.compute_mws_segmentation(_affs(0, (2, 8, 8)), OFFSETS[:3])


def _seeds(shape, n_labels, seed):
    rng = np.random.default_rng(seed)
    seeds = np.zeros(shape, np.uint64)
    for i in range(n_labels):
        z, y, x = rng.integers(0, shape[0]), rng.integers(0, shape[1] - 3), rng.integers(0, shape[2] - 3)
        seeds[z, y:y + 3, x:x + 3] = 5 + 3 * i
    return seeds


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("max_mutex_ids,n_labels", [(1024, 2), (1024, 6), (3, 6)],
                         ids=["two", "all-pairs", "chain"])
def test_seeded_segmentation_byte_identical_to_jax(max_mutex_ids, n_labels, use_native):
    shape = (6, 24, 24) if use_native else (4, 16, 16)
    affs = _affs(21, shape)
    seeds = _seeds(shape, n_labels, 4)
    kw = dict(strides=[1, 2, 2], seed=2, max_mutex_ids=max_mutex_ids, use_native=use_native)
    want = jax_mws.compute_mws_segmentation_with_seeds(affs, OFFSETS, seeds, **kw)
    got = mws.compute_mws_segmentation_with_seeds(affs, OFFSETS, seeds, **kw)
    np.testing.assert_array_equal(got, want)
    if n_labels <= max_mutex_ids:
        # all pairs mutexed: seed labels survive verbatim (the chain's
        # mutexes are not transitive, so two seeds may merge there)
        for lab in np.unique(seeds[seeds > 0]):
            assert (got[seeds == lab] == lab).all()
    assert (got[seeds == 0] > seeds.max()).any()  # new ids lie past the seeds


def test_seeded_segmentation_with_mask_byte_identical_to_jax():
    shape = (6, 24, 24)
    affs = _affs(22, shape)
    seeds = _seeds(shape, 4, 9)
    mask = np.ones(shape, bool)
    mask[:, -6:] = False
    kw = dict(noise_level=0.05, seed=8, mask=mask)
    want = jax_mws.compute_mws_segmentation_with_seeds(affs, OFFSETS, seeds, **kw)
    got = mws.compute_mws_segmentation_with_seeds(affs, OFFSETS, seeds, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == 0).all()


# ---- the device formulation on CPU tensors against JAX's ----


def _random_graph(seed, n=220, m=2500, levels=64, p_attr=0.6):
    rng = np.random.default_rng(seed)
    uv = rng.integers(0, n, (m, 2)).astype(np.int64)
    uv = uv[uv[:, 0] != uv[:, 1]]
    w = rng.integers(0, levels, uv.shape[0]) / float(levels)
    attr = (rng.random(uv.shape[0]) < p_attr).astype(np.uint8)
    return n, uv, w, attr


def _chain(n=512):
    uv = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return n, uv, np.linspace(1.0, 0.5, n - 1).astype(np.float32), np.ones(n - 1, bool)


def _chain_weak_repulsive():
    rng = np.random.default_rng(17)
    n = 256
    uv_c = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    w_c = (rng.integers(128, 257, n - 1) / 256.0).astype(np.float32)
    rep = rng.integers(0, n, (300, 2))
    rep = rep[rep[:, 0] != rep[:, 1]]
    w_r = (rng.integers(0, 128, len(rep)) / 256.0).astype(np.float32)
    return (n, np.concatenate([uv_c, rep]), np.concatenate([w_c, w_r]),
            np.concatenate([np.ones(n - 1, bool), np.zeros(len(rep), bool)]))


def _msf_counterexample():
    uv = np.array([
        [24, 21], [11, 8], [23, 11], [24, 8], [33, 3], [31, 23],
        [31, 6], [22, 3], [17, 22], [6, 17], [21, 33],
    ])
    w = np.array([0.875, 0.625, 0.125, 0.75, 0.5, 0.625, 0.25, 0.75, 0.125, 0.25, 0.5])
    attr = np.array([0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 0], np.uint8)
    return 35, uv, w, attr


def _bimodal():
    offsets = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -4, 0], [0, 0, -4]]
    shape = (8, 16, 16)
    affs = ndimage.gaussian_filter(
        np.random.default_rng(1).random((len(offsets),) + shape).astype(np.float32), (0, 1, 2, 2))
    us, vs, ws, att = mws._affinity_edge_lists(
        affs, np.asarray(offsets), [1, 2, 2], False, 0.0, np.random.default_rng(0), 3)
    uv = np.stack([np.concatenate(us), np.concatenate(vs)], axis=1)
    return (int(np.prod(shape)), uv, np.concatenate(ws).astype(np.float32),
            np.concatenate(att).astype(bool))


def _doomed_rows(k=24):
    uv, w, att = [[0, 1], [0, 2]], [0.9, 0.8], [True, False]
    for i in range(k):
        uv.append([1, 2] if i % 2 else [0, 2])
        w.append(0.7 - 0.02 * i)
        att.append(bool(i % 2))
    return 3, np.asarray(uv), np.asarray(w, np.float32), np.asarray(att)


def _all_attractive():
    uv = np.array([[i, i + 1] for i in range(24)] + [[i, i + 1] for i in range(30, 40)])
    w = np.random.default_rng(2).random(uv.shape[0])
    return 50, uv, w, np.ones(uv.shape[0], np.uint8)


GRAPHS = {
    "random": lambda: _random_graph(0),
    "ties": lambda: _random_graph(101, n=200, m=800, levels=32),
    "ties-dense": lambda: _random_graph(105, n=200, m=800, levels=4),
    "msf-counterexample": _msf_counterexample,
    "strong-mutex": lambda: (3, np.array([[0, 1], [1, 2], [0, 2]]), np.array([0.9, 0.8, 0.95]),
                             np.array([1, 1, 0], np.uint8)),
    "monotone-chain": _chain,
    "chain-weak-repulsive": _chain_weak_repulsive,
    "bimodal": _bimodal,
    "doomed-rows": _doomed_rows,
    "all-attractive": _all_attractive,
    "single-edge": lambda: (4, np.array([[1, 3]]), np.array([0.5]), np.array([1], np.uint8)),
    "empty": lambda: (4, np.zeros((0, 2), np.int64), np.zeros(0), np.zeros(0, np.uint8)),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_device_labels_equal_jax(graph):
    n, uv, w, attr = GRAPHS[graph]()
    want = jax_mws_device.mutex_watershed_device(n, uv, w, attr)
    got = mws_device.mutex_watershed_device(n, uv, w, attr, device="cpu")
    np.testing.assert_array_equal(got, want)
    # the partition of the sequential solvers (weights as the device sees them)
    host = native.mutex_watershed(n, uv, np.asarray(w, np.float32), attr)
    assert _same_partition(got, host)
    assert _same_partition(got, mws._mws_python(n, uv, np.asarray(w, np.float32), attr))


@pytest.mark.parametrize("enable_chain", [True, False], ids=["chain", "mutual-only"])
@pytest.mark.parametrize("graph", [g for g in GRAPHS if g != "empty"])
def test_device_rounds_equal_jax(graph, enable_chain):
    n, uv, w, attr = GRAPHS[graph]()
    want = jax_mws_device.mutex_watershed_device_rounds(n, uv, w, attr, enable_chain=enable_chain)
    got = mws_device.mutex_watershed_device_rounds(
        n, uv, w, attr, enable_chain=enable_chain, device="cpu")
    assert got == want


@pytest.mark.parametrize("stop_at", [None, 3], ids=["to-the-end", "stopped"])
def test_device_round_hook(stop_at):
    """``on_round`` sees every round's host read before the round runs (open
    rows falling, the first read all rows) and a true return stops the loop
    there: the rounds done are the hook's last count."""
    n, uv, w, attr = _bimodal()
    seen = []

    def on_round(rounds, n_open, n_live):
        seen.append((rounds, n_open, n_live))
        return rounds == stop_at

    _, rounds = mws_device._mws_parallel_greedy(
        torch.from_numpy(uv.astype(np.int64)), torch.from_numpy(w), torch.from_numpy(attr), n,
        True, on_round)
    full = mws_device.mutex_watershed_device_rounds(n, uv, w, attr, device="cpu")
    assert [r for r, _, _ in seen] == list(range(len(seen)))
    assert seen[0][1] <= seen[0][2] == uv.shape[0]
    assert all(a[1] >= b[1] > 0 for a, b in zip(seen, seen[1:]))
    assert rounds == (full if stop_at is None else stop_at) == len(seen) - (stop_at is not None)


def test_device_round_schedule_bounds():
    """The schedule the three invariants buy: a monotone chain contracts in
    one round (one merge per round without the chain rule), the doomed
    pile of one mutexed pair drains at once, the bimodal graph in tens of
    rounds."""
    rounds = mws_device.mutex_watershed_device_rounds
    assert rounds(*_chain(), device="cpu") <= 2
    assert rounds(*_chain(), enable_chain=False, device="cpu") >= 510
    assert rounds(*_doomed_rows(), device="cpu") <= 4
    assert rounds(*_bimodal(), device="cpu") <= 100
    n, _, _, _ = _doomed_rows()
    assert len(np.unique(mws_device.mutex_watershed_device(*_doomed_rows(), device="cpu"))) == n - 1


@pytest.mark.parametrize("kw", [
    dict(),
    dict(strides=[1, 2, 2], seed=3, mask="half"),
], ids=["plain", "strides-mask"])
def test_device_mode_segmentation_equals_jax_and_native(kw):
    shape = (6, 16, 16)
    affs = _affs(31, shape, quantized=True)
    kw = dict(kw)
    if kw.get("mask") == "half":
        kw["mask"] = np.ones(shape, bool)
        kw["mask"][:, :3] = False
    host = mws.compute_mws_segmentation(affs, OFFSETS, **kw)
    with mws.force_mws_mode("device"):
        got = mws.compute_mws_segmentation(affs, OFFSETS, device="cpu", **kw)
    with jax_backend.force_mws_mode("device"):
        want = jax_mws.compute_mws_segmentation(affs, OFFSETS, **kw)
    np.testing.assert_array_equal(got, want)
    fg = kw["mask"] if "mask" in kw else np.ones(shape, bool)
    assert _same_partition(got[fg], host[fg])
    assert (got[~fg] == 0).all()


def test_device_mode_seeded_equals_jax():
    shape = (4, 16, 16)
    affs = _affs(32, shape, quantized=True)
    seeds = np.zeros(shape, np.uint64)
    seeds[0, :4, :4] = 7
    seeds[3, 10:, 10:] = 9
    with mws.force_mws_mode("device"):
        got = mws.compute_mws_segmentation_with_seeds(affs, OFFSETS, seeds, device="cpu")
    with jax_backend.force_mws_mode("device"):
        want = jax_mws.compute_mws_segmentation_with_seeds(affs, OFFSETS, seeds)
    np.testing.assert_array_equal(got, want)
    assert _same_partition(got, mws.compute_mws_segmentation_with_seeds(affs, OFFSETS, seeds))
    assert (got[seeds == 7] == 7).all() and (got[seeds == 9] == 9).all()


def test_device_mode_continuous_rand_voi():
    """Continuous affinities: float32 device priorities may swap near-ties
    of the float64 host order; the partitions must agree by Rand/VoI."""
    affs = np.random.default_rng(33).random((len(OFFSETS), 6, 16, 16)).astype(np.float32)
    host = mws.compute_mws_segmentation(affs, OFFSETS)
    with mws.force_mws_mode("device"):
        dev = mws.compute_mws_segmentation(affs, OFFSETS, device="cpu")
    scores = evaluate_segmentation(host.ravel(), dev.ravel())
    assert scores["rand_index"] > 0.99
    assert scores["vi_split"] + scores["vi_merge"] < 0.1


def test_device_mode_follows_environment(monkeypatch):
    n, uv, w, attr = _msf_counterexample()
    calls = []
    monkeypatch.setattr(mws_device, "mutex_watershed_device",
                        lambda *a, **k: calls.append(k["device"]) or np.arange(n))
    monkeypatch.delenv("CTT_MWS_MODE", raising=False)
    mws.mutex_watershed_graph(n, uv, w, attr, device="cpu")
    assert calls == []
    monkeypatch.setenv("CTT_MWS_MODE", "device")
    mws.mutex_watershed_graph(n, uv, w, attr, device="cpu")
    assert calls == ["cpu"]
    with mws.force_mws_mode("host"):
        mws.mutex_watershed_graph(n, uv, w, attr, device="cpu")
    assert calls == ["cpu"] and mws.use_mws_device()


def test_device_mode_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n, uv, w, attr = _msf_counterexample()
    with mws.force_mws_mode("device"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mws.mutex_watershed_graph(n, uv, w, attr)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mws.compute_mws_segmentation(_affs(0, (2, 8, 8)), OFFSETS)
    assert not mws.use_mws_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mws_device.mutex_watershed_device(n, uv, w, attr)


def test_device_node_space_limit():
    with pytest.raises(ValueError, match="30 bits"):
        mws_device.mutex_watershed_device(
            mws_device.MAX_NODES, np.zeros((0, 2), np.int64), np.zeros(0), np.zeros(0), device="cpu")


def test_native_binding_checks_and_matches_python():
    n, uv, w, attr = _random_graph(3, n=120, m=900)
    assert _same_partition(native.mutex_watershed(n, uv, w, attr), mws._mws_python(n, uv, w, attr))
    with pytest.raises(ValueError, match="outside"):
        native.mutex_watershed(2, uv, w, attr)
    with pytest.raises(ValueError, match="weights"):
        native.mutex_watershed(n, uv, w[:-1], attr)


def test_gt_affinities_segment_quadrants():
    """Affinities derived from a four-segment ground truth (the JAX package's
    ``compute_affinities``): the port's MWS recovers the segments."""
    shape = (4, 16, 16)
    gt = np.broadcast_to(
        1 + (np.arange(16) >= 8)[:, None] * 2 + (np.arange(16) >= 8)[None, :], shape
    ).astype("uint64")
    affs, _ = compute_affinities(gt, OFFSETS)
    seg = mws.compute_mws_segmentation(affs.astype(np.float32), OFFSETS)
    assert _same_partition(seg, gt)


@pytest.mark.parametrize("case", ["int64", "uint64", "mixed", "large", "negative", "empty"])
def test_contingency_table_equals_jax(case):
    """The port's contingency table (a 1d unique of one key per pair where
    the pairs fit one) equals the JAX package's row unique: rows, order and
    dtypes."""
    from cluster_tools_tpu.ops.segment import contingency_table as jax_table
    from cluster_tools_tpu_torch.ops.segment import contingency_table

    rng = np.random.default_rng(5)
    a = rng.integers(0, 40, 5000)
    b = rng.integers(0, 30, 5000) * 1000
    if case == "uint64":
        a, b = a.astype(np.uint64) + np.uint64(2**40), b.astype(np.uint64)
    elif case == "mixed":
        a, b = a.astype(np.int32), b.astype(np.uint64)
    elif case == "large":
        a, b = a.astype(np.uint64) * np.uint64(2**40), b.astype(np.uint64) * np.uint64(2**30)
    elif case == "negative":
        a = a - 20
    elif case == "empty":
        a, b = a[:0], b[:0]
    got, want = contingency_table(a, b), jax_table(a, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
