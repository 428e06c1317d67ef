"""PyTorch port, label bookkeeping: ``ops/relabel.py``, ``ops/evaluation.py``'s
table merge, the relabel and unique workflows, morphology, node labels and
``ThresholdTask`` against the JAX package on the CPU, on one seeded
block-wise segmentation of (24, 48, 48) in blocks of (12, 24, 24), so that
every face direction occurs.

Contracts: every output byte-identical to JAX's (the morphology table as
float64 bits), except ``ThresholdTask`` at sigma > 0, where the mask may
differ only at voxels whose JAX-smoothed value lies within 1e-6 of the
threshold (the gaussian's tap order on edge-replicated padding, ROADMAP
Queue C); on this fixture there is one such voxel."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu import workflows as jwf
from cluster_tools_tpu.ops import evaluation as jeval
from cluster_tools_tpu.ops import filters as jfilters
from cluster_tools_tpu.ops import relabel as jrel
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import node_labels as jnl
from cluster_tools_tpu.tasks import threshold as jthr
from cluster_tools_tpu_torch import build, workflows as twf
from cluster_tools_tpu_torch.ops import evaluation as teval
from cluster_tools_tpu_torch.ops import relabel as trel
from cluster_tools_tpu_torch.tasks import node_labels as tnl
from cluster_tools_tpu_torch.tasks import threshold as tthr
from cluster_tools_tpu_torch.tasks.morphology import load_morphology
from cluster_tools_tpu_torch.utils import file_reader
from torch_label_volumes import BLOCK, SHAPE, make_volumes, setup

PACKAGES = {"jax": (jax_build, jwf), "torch": (build, twf)}


# -- ops -----------------------------------------------------------------------


@pytest.mark.parametrize("keep_zero", [True, False])
@pytest.mark.parametrize("case", ["dense", "sparse_no_zero", "saturated"])
def test_relabel_consecutive_matches_jax(keep_zero, case):
    rng = np.random.default_rng(3)
    if case == "dense":
        labels, max_labels = rng.integers(0, 30, (6, 7, 8)).astype(np.int32), 64
    elif case == "sparse_no_zero":
        labels = rng.choice([5, 17, 900, 12345, 70000], (6, 7, 8)).astype(np.int32)
        max_labels = 8
    else:  # more distinct values than max_labels: the surplus aliases
        labels, max_labels = rng.integers(0, 40, (6, 7, 8)).astype(np.int32), 16
    want, n_want = jrel.relabel_consecutive(jnp.asarray(labels), max_labels, keep_zero=keep_zero)
    got, n_got = trel.relabel_consecutive(torch.from_numpy(labels), max_labels, keep_zero=keep_zero)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(n_got) == int(n_want)
    if case == "saturated":
        assert int(n_got) == max_labels - int(keep_zero)


def test_relabel_consecutive_uint64_checks_the_int64_range():
    labels = np.array([[0, 2**40, 7], [7, 2**62, 0]], np.uint64)
    got, n = trel.relabel_consecutive(torch.from_numpy(labels), 8)
    assert got.dtype == torch.uint64 and int(n) == 3
    np.testing.assert_array_equal(got.view(torch.int64).numpy(), [[0, 2, 1], [1, 3, 0]])
    with pytest.raises(ValueError, match="2\\*\\*63"):
        trel.relabel_consecutive(torch.from_numpy(np.array([2**63], np.uint64)), 4)


def test_apply_mapping_and_host_relabel_match_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 50, (5, 9, 11)).astype(np.int32)
    mapping = rng.integers(0, 1000, 50).astype(np.int32)
    want = np.asarray(jrel.apply_mapping(jnp.asarray(labels), jnp.asarray(mapping)))
    got = trel.apply_mapping(torch.from_numpy(labels), torch.from_numpy(mapping)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(trel.apply_mapping_np(labels, mapping),
                                  jrel.apply_mapping_np(labels, mapping))
    sparse = (labels.astype(np.uint64) * 1000) * (labels % 3 > 0)
    for keep_zero in (True, False):
        for arr in (sparse, sparse + 1):
            want, n_want = jrel.relabel_consecutive_np(arr, keep_zero)
            got, n_got = trel.relabel_consecutive_np(arr, keep_zero)
            assert got.dtype == want.dtype and n_got == n_want
            np.testing.assert_array_equal(got, want)


def test_merge_contingency_tables_and_same_partition_match_jax():
    rng = np.random.default_rng(5)
    tables = [tuple(rng.integers(0, 6, 40) for _ in range(3)) for _ in range(4)]
    for w, g in zip(jeval.merge_contingency_tables(tables), teval.merge_contingency_tables(tables)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _, seg = make_volumes()
    relabelled = np.where(seg > 0, seg * 7 + 3, 0)
    for b in (relabelled, np.where(seg == 1, 2, seg), seg):
        assert teval.same_partition(seg, b) == jeval.same_partition(seg, b)
    assert teval.same_partition(seg, relabelled)


# -- workflows -----------------------------------------------------------------


def test_relabel_and_unique_workflows_match_jax(tmp_path):
    path, config_dir, _, seg = setup(tmp_path)
    for package, (run, wf) in PACKAGES.items():
        assert run([wf.RelabelWorkflow(str(tmp_path / f"tmp_{package}"), config_dir,
                                       input_path=path, input_key="seg",
                                       output_path=path, output_key=f"relabel_{package}")])
        assert run([wf.UniqueWorkflow(str(tmp_path / f"tmpu_{package}"), config_dir,
                                      input_path=path, input_key="seg",
                                      output_path=path, output_key=f"unique_{package}")])
    f = file_reader(path, "r")
    got, want = f["relabel_torch"][:], f["relabel_jax"][:]
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    ids = np.unique(got)
    np.testing.assert_array_equal(ids, np.arange(ids.size))
    assert teval.same_partition(seg, got)
    np.testing.assert_array_equal(f["unique_torch"][:], f["unique_jax"][:])
    np.testing.assert_array_equal(f["unique_torch"][:], np.unique(seg))


def test_morphology_and_region_centers_match_jax(tmp_path):
    path, config_dir, _, seg = setup(tmp_path)
    tables = {}
    for package, (run, wf) in PACKAGES.items():
        tmp = str(tmp_path / f"tmp_{package}")
        assert run([wf.RegionCentersWorkflow(tmp, config_dir, input_path=path, input_key="seg",
                                             output_path=path, output_key=f"centers_{package}",
                                             ignore_label=0)])
        tables[package] = load_morphology(tmp)
    got, want = tables["torch"], tables["jax"]
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
    np.testing.assert_array_equal(got[:, 1], np.bincount(seg.reshape(-1).astype(np.int64))[
        got[:, 0].astype(np.int64)])
    f = file_reader(path, "r")
    np.testing.assert_array_equal(f["centers_torch"][:], f["centers_jax"][:])


@pytest.mark.parametrize("ignore_label", [None, 0])
def test_node_labels_match_jax(tmp_path, ignore_label):
    """Fragments of one block-wise segmentation voted onto a coarser one."""
    raw, seg = make_volumes()
    coarse = ndimage.label(raw < 0.55)[0].astype(np.uint64)
    path, config_dir, _, _ = setup(tmp_path, coarse=coarse)
    out = {}
    for package, nl in (("jax", jnl), ("torch", tnl)):
        run = PACKAGES[package][0]
        tmp = str(tmp_path / f"tmp_{package}")
        block = nl.BlockNodeLabelsTask(tmp, config_dir, input_path=path, input_key="seg",
                                       labels_path=path, labels_key="coarse",
                                       ignore_label=ignore_label)
        merge = nl.MergeNodeLabelsTask(tmp, config_dir, dependencies=[block],
                                       input_path=path, input_key="seg")
        assert run([merge])
        out[package] = (np.load(os.path.join(tmp, nl.NODE_LABELS_NAME)),
                        dict(np.load(os.path.join(tmp, nl.OVERLAPS_MERGED_NAME))))
    (got, got_ov), (want, want_ov) = out["torch"], out["jax"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for key in ("ids_a", "ids_b", "counts"):
        np.testing.assert_array_equal(got_ov[key], want_ov[key])
    # each fragment lies inside one coarse component: its vote is that one
    fg = seg > 0
    lookup = dict(zip(got[:, 0].tolist(), got[:, 1].tolist()))
    assert all(lookup[int(a)] == int(b) for a, b in zip(seg[fg][::97], coarse[fg][::97]))


def _threshold_run(tmp_path, task_conf, tag):
    path, config_dir, raw, _ = setup(tmp_path)
    jax_cfg.write_config(config_dir, "threshold", task_conf)
    outs = {}
    for package, mod in (("jax", jthr), ("torch", tthr)):
        run = PACKAGES[package][0]
        task = mod.ThresholdTask(str(tmp_path / f"tmp_{package}"), config_dir,
                                 input_path=path, input_key="raw",
                                 output_path=path, output_key=f"{tag}_{package}")
        assert run([task])
        outs[package] = file_reader(path, "r")[f"{tag}_{package}"][:]
    return raw, outs["torch"], outs["jax"]


@pytest.mark.parametrize("mode", ["greater", "less"])
def test_threshold_task_sigma0_matches_jax_bytewise(tmp_path, mode):
    raw, got, want = _threshold_run(tmp_path, {"threshold": 0.5, "threshold_mode": mode}, mode)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (raw > 0.5 if mode == "greater" else raw < 0.5))


def test_threshold_task_smoothed_matches_jax_off_near_ties(tmp_path):
    """sigma 1.5: equal except where JAX's smoothed value lies within 1e-6 of
    the threshold; the count of such voxels is asserted (1 here)."""
    sigma, t = 1.5, 0.5
    raw, got, want = _threshold_run(tmp_path, {"threshold": t, "sigma": sigma}, "smooth")
    near = np.zeros(SHAPE, bool)
    for z in range(0, SHAPE[0], BLOCK[0]):
        for y in range(0, SHAPE[1], BLOCK[1]):
            for x in range(0, SHAPE[2], BLOCK[2]):
                bb = np.s_[z:z + BLOCK[0], y:y + BLOCK[1], x:x + BLOCK[2]]
                smooth = np.asarray(jfilters.gaussian(jnp.asarray(raw[bb]), sigma))
                near[bb] = np.abs(smooth - t) <= 1e-6
    assert int(near.sum()) == 1
    np.testing.assert_array_equal(got[~near], want[~near])
    assert 0 < got.mean() < 1
