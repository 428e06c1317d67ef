"""PyTorch port, evaluation: Rand, VoI and object VI (``ops/evaluation.py``)
and ``EvaluationWorkflow`` / ``ObjectViTask`` against the JAX package on
the CPU.

Inputs: seeded segmentations and ground truths with unlabelled (0) voxels,
overlapping partially.  Contract: every score equal to JAX's (the same host
numpy on the same contingency tables, so equal floats); the workflow's
measures JSON and the object-VI JSON equal JAX's, on the port's ``local``
and ``cuda`` targets, and the merged per-block tables score exactly as one
table of the whole volume."""

import json
import os

import numpy as np
import pytest

from cluster_tools_tpu.ops import evaluation as jev
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import evaluation as jtev
from cluster_tools_tpu.workflows import EvaluationWorkflow as JaxEvaluationWorkflow
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.ops import evaluation as tev
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks import evaluation as ttev
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.workflows import EvaluationWorkflow

SHAPE = (12, 20, 24)
BLOCK = [6, 10, 12]


def volumes(seed):
    """A blocky ground truth with unlabelled voxels and a segmentation that
    splits and merges some of its objects."""
    rng = np.random.default_rng(seed)
    gt = np.repeat(np.repeat(rng.integers(0, 7, (4, 5, 6)), 3, 0), 4, 1)
    gt = np.repeat(gt, 4, 2).astype(np.uint64)
    seg = gt * 3 + (rng.random(SHAPE) < 0.1).astype(np.uint64)
    seg[seg == 6] = 9  # merge two objects
    return seg.astype(np.uint64), gt


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ignore", [True, False])
def test_scores_match_jax(seed, ignore):
    seg, gt = volumes(seed)
    assert tev.evaluate_segmentation(seg, gt, ignore) == jev.evaluate_segmentation(seg, gt, ignore)
    assert tev.object_vi(seg, gt, ignore) == jev.object_vi(seg, gt, ignore)
    ia, ib, c = jev.contingency_table(seg, gt)
    assert tev.rand_scores(ia, ib, c) == jev.rand_scores(ia, ib, c)
    assert tev.vi_scores(ia, ib, c) == jev.vi_scores(ia, ib, c)
    assert tev.object_vi_from_contingency(ia, ib, c) == jev.object_vi_from_contingency(ia, ib, c)
    for got, want in zip(tev._marginals(ia, ib, c), jev._marginals(ia, ib, c)):
        np.testing.assert_array_equal(got, want)


def test_identical_segmentations_score_perfectly():
    _, gt = volumes(3)
    s = tev.evaluate_segmentation(gt, gt)
    assert s["rand_index"] == 1.0 and s["adapted_rand_error"] == 0.0
    assert abs(s["vi"]) < 1e-12


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_evaluation_workflow_matches_jax(tmp_path, target):
    seg, gt = volumes(4)
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("seg", data=seg, chunks=tuple(BLOCK))
    f.create_dataset("gt", data=gt, chunks=tuple(BLOCK))
    results = {}
    for package, mod, wf_cls, obj_cls, run in (
            ("jax", jax_cfg, JaxEvaluationWorkflow, jtev.ObjectViTask, jax_build),
            ("torch", cfg, EvaluationWorkflow, ttev.ObjectViTask, build)):
        config_dir = str(tmp_path / f"configs_{package}")
        mod.write_global_config(config_dir, {
            "block_shape": BLOCK, "device": "cpu",
            "target": "local" if package == "jax" else target})
        tmp = str(tmp_path / f"tmp_{package}")
        wf = wf_cls(tmp, config_dir, seg_path=path, seg_key="seg", gt_path=path, gt_key="gt")
        obj = obj_cls(tmp, config_dir, dependencies=[wf])
        assert run([obj])
        with open(os.path.join(tmp, "evaluation_measures.json")) as fh:
            measures = json.load(fh)
        with open(os.path.join(tmp, "object_vi.json")) as fh:
            object_vi = json.load(fh)
        results[package] = (measures, object_vi)
    assert results["torch"] == results["jax"]
    measures = results["torch"][0]
    assert measures == tev.evaluate_segmentation(seg, gt)
    tmp = str(tmp_path / "tmp_torch")
    assert ttev.load_measures(tmp) == measures
    assert ttev.load_object_vi(tmp) == jtev.load_object_vi(str(tmp_path / "tmp_jax"))
