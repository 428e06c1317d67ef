"""PyTorch port, postprocessing: ``tasks/postprocess.py`` and the eight
composites of ``workflows/postprocessing.py`` against the JAX package on the
CPU, on one seeded block-wise segmentation of (24, 48, 48) in blocks of
(12, 24, 24), so that every face direction occurs.

Contract: every output volume and assignment table byte-identical to JAX's.
The filling size filter runs the port's plain flood against JAX's
``seeded_watershed``, with ``CTT_FLOOD_TILE`` pinned and unpinned on both
sides; the graph watershed runs on tied weights, where only the heap's tie
order ``(-w, u, v)`` and the adjacency's insertion order decide.

The ``cuda`` cases hold the filling filter on the card (the 3d flood and
kernel 3) against its plain version; they skip without a card and need no
JAX, so on the card they run as
``python -m pytest --noconftest -m cuda tests/test_torch_postprocess.py``."""

import os

import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch import workflows as twf
from cluster_tools_tpu_torch.ops import cuda_flood
from cluster_tools_tpu_torch.tasks import costs as tcosts
from cluster_tools_tpu_torch.tasks import morphology as tmorph
from cluster_tools_tpu_torch.tasks import postprocess as tpp
from cluster_tools_tpu_torch.utils import file_reader
from torch_label_volumes import setup

try:
    from cluster_tools_tpu import workflows as jwf
    from cluster_tools_tpu.runtime import build as jax_build
    from cluster_tools_tpu.tasks import costs as jcosts
    from cluster_tools_tpu.tasks import postprocess as jpp
except ImportError:  # the card's machine has no JAX: only the cuda cases run there
    jwf = jax_build = jcosts = jpp = None

FLOOD_PIN = "4,8,16"


def min_size_of(seg) -> int:
    """The 30th percentile of the fragment sizes: a known share is dropped."""
    sizes = np.bincount(seg.reshape(-1).astype(np.int64))[1:]
    return int(np.percentile(sizes[sizes > 0], 30))


def run_both(tmp_path, make, out_key="out"):
    """``make(wf_module, tmp_folder, output_key)`` for each package; returns
    (torch output, jax output, torch tmp folder, jax tmp folder)."""
    outs, tmps = {}, {}
    for package, run, wf in (("jax", jax_build, jwf), ("torch", build, twf)):
        tmps[package] = str(tmp_path / f"tmp_{package}")
        assert run([make(wf, tmps[package], f"{out_key}_{package}")])
    f = file_reader(str(tmp_path / "d.n5"), "r")
    got, want = f[f"{out_key}_torch"][:], f[f"{out_key}_jax"][:]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got, want, tmps["torch"], tmps["jax"]


def assert_same_npy(tmps, name):
    got, want = (np.load(os.path.join(t, name)) for t in tmps)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


# -- the graph watershed ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_watershed_assignments_on_tied_weights_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 60
    uv = np.unique(np.sort(rng.integers(0, n, (150, 2)), axis=1), axis=0)
    uv = uv[uv[:, 0] != uv[:, 1]]
    rng.shuffle(uv)  # the adjacency's insertion order matters on ties
    weights = rng.integers(-1, 2, uv.shape[0]).astype(np.float64)  # three values: ties
    seeds = np.where(rng.random(n) < 0.3, np.arange(1, n + 1), 0).astype(np.int64)
    want = jpp.graph_watershed_assignments(uv, weights, seeds, n)
    got = tpp.graph_watershed_assignments(uv, weights, seeds, n)
    np.testing.assert_array_equal(got, want)


# -- size filters ----------------------------------------------------------------


def test_size_filter_background_matches_jax(tmp_path):
    path, config_dir, _, seg = setup(tmp_path)
    min_size = min_size_of(seg)
    got, _, tt, tj = run_both(tmp_path, lambda wf, tmp, key: wf.SizeFilterWorkflow(
        tmp, config_dir, input_path=path, input_key="seg", output_path=path,
        output_key=key, min_size=min_size))
    for name in (tpp.SIZE_FILTER_NAME, tpp.SIZE_FILTER_DISCARD_NAME, tmorph.MORPHOLOGY_NAME):
        assert_same_npy((tt, tj), name)
    discard = np.load(os.path.join(tt, tpp.SIZE_FILTER_DISCARD_NAME))
    assert discard.size and not np.isin(got, discard).any()
    kept = (got > 0)
    np.testing.assert_array_equal(got[kept], seg[kept])


@pytest.mark.parametrize("pin", [None, FLOOD_PIN])
def test_size_filter_filling_matches_jax(tmp_path, monkeypatch, pin):
    """Discarded fragments re-flooded over ``raw`` from the kept ones, the
    output relabelled; the flood's warm start pinned on both sides or on
    neither."""
    if pin is None:
        monkeypatch.delenv("CTT_FLOOD_TILE", raising=False)
    else:
        monkeypatch.setenv("CTT_FLOOD_TILE", pin)
    path, config_dir, _, seg = setup(tmp_path)
    min_size = min_size_of(seg)
    launches = cuda_flood.flood_tiles_warm.launches, cuda_flood.flood_volume.launches
    got, _, tt, tj = run_both(tmp_path, lambda wf, tmp, key: wf.SizeFilterWorkflow(
        tmp, config_dir, input_path=path, input_key="seg", output_path=path,
        output_key=key, min_size=min_size, hmap_path=path, hmap_key="raw", relabel=True))
    assert (cuda_flood.flood_tiles_warm.launches, cuda_flood.flood_volume.launches) == launches
    f = file_reader(path, "r")
    np.testing.assert_array_equal(f["out_torch_unrelabeled"][:], f["out_jax_unrelabeled"][:])
    discard = np.load(os.path.join(tt, tpp.SIZE_FILTER_DISCARD_NAME))
    unrelabelled = f["out_torch_unrelabeled"][:]
    assert discard.size and not np.isin(unrelabelled, discard).any()
    kept = seg > 0
    kept[kept] = ~np.isin(seg[kept], discard)
    np.testing.assert_array_equal(unrelabelled[kept], seg[kept])
    ids = np.unique(got)
    np.testing.assert_array_equal(ids, np.arange(ids.size))


def test_size_filter_graph_watershed_on_tied_costs_matches_jax(tmp_path):
    """In a solved problem's tmp folder with every cost replaced by its sign
    (three values: ties everywhere), then relabelled."""
    path, config_dir, raw, seg = setup(tmp_path)
    min_size = min_size_of(seg)
    for package, run, wf, costs in (("jax", jax_build, jwf, jcosts), ("torch", build, twf, tcosts)):
        tmp = str(tmp_path / f"tmp_{package}")
        graph = wf.GraphWorkflow(tmp, config_dir, input_path=path, input_key="seg")
        feats = wf.EdgeFeaturesWorkflow(tmp, config_dir, input_path=path, input_key="raw",
                                        labels_path=path, labels_key="seg", dependencies=[graph])
        assert run([costs.ProbsToCostsTask(tmp, config_dir, dependencies=[feats])])
        name = os.path.join(tmp, costs.COSTS_NAME)
        np.save(name, np.sign(np.round(np.load(name), 1)))
    tmps = (str(tmp_path / "tmp_torch"), str(tmp_path / "tmp_jax"))
    assert (assert_same_npy(tmps, tcosts.COSTS_NAME) == 0).any()
    got, _, tt, tj = run_both(tmp_path, lambda wf, tmp, key: wf.SizeFilterAndGraphWatershedWorkflow(
        tmp, config_dir, input_path=path, input_key="seg", output_path=path,
        output_key=key, min_size=min_size, relabel=True))
    table = assert_same_npy((tt, tj), tpp.GRAPH_WS_NAME)
    discard = np.load(os.path.join(tt, tpp.SIZE_FILTER_DISCARD_NAME))
    moved = np.isin(table[:, 0], discard) & (table[:, 1] > 0)
    assert moved.any()
    ids = np.unique(got)
    np.testing.assert_array_equal(ids, np.arange(ids.size))


# -- id and feature filters, orphans, graph components ---------------------------


def test_filter_labels_and_id_filter_match_jax(tmp_path):
    path, config_dir, _, seg = setup(tmp_path)
    drop = [int(i) for i in np.unique(seg)[1::5]]
    got, _, tt, tj = run_both(tmp_path, lambda wf, tmp, key: wf.FilterLabelsWorkflow(
        tmp, config_dir, input_path=path, input_key="seg", output_path=path,
        output_key=key, filter_labels=drop))
    np.testing.assert_array_equal(got, np.where(np.isin(seg, drop), 0, seg))
    for package, run, wf, pp in (("jax", jax_build, jwf, jpp), ("torch", build, twf, tpp)):
        tmp = str(tmp_path / f"tmp_{package}")
        morpho = wf.MorphologyWorkflow(tmp, config_dir, input_path=path, input_key="seg")
        assert run([pp.IdFilterTask(tmp, config_dir, dependencies=[morpho], filter_ids=drop)])
    table = assert_same_npy((tt, tj), tpp.ID_FILTER_NAME)
    assert not np.isin(table[:, 0], drop).any()


@pytest.mark.parametrize("mode,feature", [("less", "mean"), ("greater", "maximum")])
def test_filter_by_threshold_matches_jax(tmp_path, mode, feature):
    """At the median of the segments' feature: about half are zeroed."""
    path, config_dir, raw, seg = setup(tmp_path)
    ids = np.unique(seg)[1:]
    reduce = np.mean if feature == "mean" else np.max
    threshold = float(np.median([reduce(raw[seg == i]) for i in ids]))
    got, _, _, _ = run_both(tmp_path, lambda wf, tmp, key: wf.FilterByThresholdWorkflow(
        tmp, config_dir, input_path=path, input_key="raw", seg_path=path, seg_key="seg",
        output_path=path, output_key=key, threshold=threshold, threshold_mode=mode,
        feature=feature))
    assert 1 < np.unique(got).size < ids.size


@pytest.mark.parametrize("relabel", [False, True])
def test_filter_orphans_matches_jax(tmp_path, relabel):
    path, config_dir, _, seg = setup(tmp_path)
    got, _, tt, tj = run_both(tmp_path, lambda wf, tmp, key: wf.FilterOrphansWorkflow(
        tmp, config_dir, input_path=path, input_key="seg", output_path=path,
        output_key=key, relabel=relabel))
    table = assert_same_npy((tt, tj), tpp.ORPHANS_NAME)
    assert (table[:, 0] != table[:, 1]).any()


def test_connected_components_workflow_matches_jax(tmp_path):
    """Over the raw graph, then over the edges whose cost exceeds 0 in a
    solved problem's tmp folder."""
    path, config_dir, _, seg = setup(tmp_path)
    got, _, _, _ = run_both(tmp_path, lambda wf, tmp, key: wf.ConnectedComponentsWorkflow(
        tmp, config_dir, input_path=path, input_key="seg", output_path=path, output_key=key))
    np.testing.assert_array_equal(
        got > 0, seg > 0)
    assert np.unique(got).size - 1 == ndimage.label(seg > 0)[1]
    for package, run, wf, costs in (("jax", jax_build, jwf, jcosts), ("torch", build, twf, tcosts)):
        tmp = str(tmp_path / f"tmpc_{package}")
        graph = wf.GraphWorkflow(tmp, config_dir, input_path=path, input_key="seg")
        feats = wf.EdgeFeaturesWorkflow(tmp, config_dir, input_path=path, input_key="raw",
                                        labels_path=path, labels_key="seg", dependencies=[graph])
        assert run([costs.ProbsToCostsTask(tmp, config_dir, dependencies=[feats])])
        assert run([wf.ConnectedComponentsWorkflow(
            tmp, config_dir, input_path=path, input_key="seg", output_path=path,
            output_key=f"cc_{package}", threshold=0.0)])
    f = file_reader(path, "r")
    np.testing.assert_array_equal(f["cc_torch"][:], f["cc_jax"][:])
    assert np.unique(f["cc_torch"][:]).size >= np.unique(got).size


# -- the filling filter on the card ------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card; the cases skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pin", [None, FLOOD_PIN])
def test_filling_filter_on_card_matches_plain(tmp_path, monkeypatch, cuda_device, pin):
    """``FillingSizeFilterTask`` on the card launches the 3d flood (and
    kernel 3 when pinned) and writes what the same task writes on the CPU."""
    if pin is None:
        monkeypatch.delenv("CTT_FLOOD_TILE", raising=False)
    else:
        monkeypatch.setenv("CTT_FLOOD_TILE", pin)
    outs = {}
    for device in ("cuda", "cpu"):
        sub = tmp_path / device
        sub.mkdir()
        path, config_dir, _, seg = setup(sub, device=device)
        before = cuda_flood.flood_tiles_warm.launches, cuda_flood.flood_volume.launches
        assert build([twf.SizeFilterWorkflow(
            str(sub / "tmp"), config_dir, input_path=path, input_key="seg", output_path=path,
            output_key="out", min_size=min_size_of(seg), hmap_path=path, hmap_key="raw")])
        after = cuda_flood.flood_tiles_warm.launches, cuda_flood.flood_volume.launches
        if device == "cuda":
            assert after[1] > before[1] and (after[0] > before[0]) == (pin is not None)
        else:
            assert after == before
        outs[device] = file_reader(path, "r")["out"][:]
    np.testing.assert_array_equal(outs["cuda"], outs["cpu"])


@pytest.mark.parametrize("entry", ["relabel", "threshold", "filling", "stitching"])
def test_slice_entry_points_default_to_card_and_raise_without_one(tmp_path, monkeypatch, entry):
    """No ``device`` key: the block tasks ask for the card; without one the
    build raises instead of computing on the host."""
    from cluster_tools_tpu_torch.tasks.threshold import ThresholdTask

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, config_dir, _, seg = setup(tmp_path, device="cuda")
    tmp = str(tmp_path / "tmp")
    io = {"output_path": path, "output_key": "out"}
    wf = {
        "relabel": lambda: twf.RelabelWorkflow(tmp, config_dir, input_path=path,
                                               input_key="seg", **io),
        "threshold": lambda: ThresholdTask(tmp, config_dir, input_path=path,
                                           input_key="raw", **io),
        "filling": lambda: twf.SizeFilterWorkflow(
            tmp, config_dir, input_path=path, input_key="seg", min_size=min_size_of(seg),
            hmap_path=path, hmap_key="raw", **io),
        "stitching": lambda: twf.SimpleStitchingWorkflow(
            tmp, config_dir, input_path=path, input_key="raw", labels_path=path,
            labels_key="seg", **io),
    }[entry]()
    with pytest.raises(Exception, match="no CUDA device"):
        build([wf])
    assert not wf.complete()
