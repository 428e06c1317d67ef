"""PyTorch port: edge labels and the random forest against the JAX package.

``EdgeLabelsTask`` writes JAX's labels byte for byte (with and without the
ground truth's ignore label), ``PredictEdgeProbabilitiesTask`` on a forest
that JAX's ``LearnRFTask`` pickled gives JAX's probabilities exactly, and the
port's own ``LearningWorkflow`` separates the edge classes as the JAX tests
ask.  Without scikit-learn ``LearnRFTask`` raises ``ImportError``."""

import os
import shutil
import sys

import numpy as np
import pytest

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks.learning import PredictEdgeProbabilitiesTask as JaxPredict
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows.learning import LearningWorkflow as JaxLearningWorkflow
from cluster_tools_tpu_torch import LearningWorkflow, build
from cluster_tools_tpu_torch.tasks.costs import ProbsToCostsTask
from cluster_tools_tpu_torch.tasks.learning import (
    EDGE_LABELS_NAME,
    EDGE_PROBS_NAME,
    LearnRFTask,
    PredictEdgeProbabilitiesTask,
)

BLOCK = [8, 16, 16]


@pytest.fixture
def training_volume(tmp_path):
    """Blocky ground truth (four quadrants), a fragment volume that splits
    each quadrant in z and once more where the label is 3, a noisy boundary
    map on the ground truth's faces (the JAX learning tests' recipe), and a
    ground truth with an ignore region of label 0."""
    from conftest import boundary_from_gt

    rng = np.random.default_rng(42)
    shape = (16, 32, 32)
    gt = np.zeros(shape, dtype="uint64")
    gt[:, :16, :16], gt[:, :16, 16:], gt[:, 16:, :16], gt[:, 16:, 16:] = 1, 2, 3, 4
    ws = (gt * 2 + (np.arange(shape[0]) >= 8)[:, None, None]).astype("uint64")
    ws[:, 16:24, :16] += 20
    gt_ignore = gt.copy()
    gt_ignore[:, :16, 16:] = 0
    path = str(tmp_path / "train.n5")
    f = jax_reader(path)
    for key, data in (("gt", gt), ("gt_ignore", gt_ignore), ("ws", ws),
                      ("bnd", boundary_from_gt(gt, rng, noise=0.05))):
        f.create_dataset(key, data=data, chunks=(8, 16, 16), compression="gzip")
    return path


def _config(tmp_path, name, **gconf):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu", **gconf})
    jax_cfg.write_config(config_dir, "learn_rf", {"n_trees": 10})
    return config_dir


def _learning(wf_cls, tmp_path, path, config_dir, tag, gt_key="gt", ignore=False):
    return wf_cls(
        str(tmp_path / f"tmp_{tag}"), config_dir, input_dict={"ds0": (path, "bnd")},
        labels_dict={"ds0": (path, "ws")}, groundtruth_dict={"ds0": (path, gt_key)},
        output_path=str(tmp_path / f"rf_{tag}.pkl"), ignore_label_gt=ignore,
    )


@pytest.mark.parametrize("gt_key,ignore", [("gt", False), ("gt_ignore", True)])
def test_edge_labels_byte_identical_to_jax(tmp_path, training_volume, gt_key, ignore):
    """Both packages' edge-label tasks (the learning workflow's graph,
    features and node votes upstream) write equal ``edge_labels.npy``."""
    config_dir = _config(tmp_path, "configs")
    labels = {}
    for tag, wf_cls, run in (("jax", JaxLearningWorkflow, jax_build),
                             ("torch", LearningWorkflow, build)):
        wf = _learning(wf_cls, tmp_path, training_volume, config_dir, tag, gt_key, ignore)
        assert run(list(wf.requires()[0].dependencies))  # up to EdgeLabelsTask
        with open(os.path.join(str(tmp_path / f"tmp_{tag}"), "ds0", EDGE_LABELS_NAME), "rb") as f:
            labels[tag] = f.read()
    assert labels["torch"] == labels["jax"]
    got = np.load(os.path.join(str(tmp_path / "tmp_torch"), "ds0", EDGE_LABELS_NAME))
    assert got.dtype == np.int8
    want = {-1, 0, 1} if ignore else {0, 1}
    assert set(np.unique(got)) == want


def test_predict_on_a_jax_forest_equals_jax(tmp_path, training_volume):
    pytest.importorskip("sklearn")
    config_dir = _config(tmp_path, "configs")
    assert jax_build([_learning(JaxLearningWorkflow, tmp_path, training_volume, config_dir,
                                "jax")])
    sub = os.path.join(str(tmp_path / "tmp_jax"), "ds0")
    rf_path = str(tmp_path / "rf_jax.pkl")
    probs = {}
    for tag, cls, run in (("jax", JaxPredict, jax_build),
                          ("torch", PredictEdgeProbabilitiesTask, build)):
        folder = str(tmp_path / f"predict_{tag}")
        shutil.copytree(sub, folder)
        assert run([cls(folder, config_dir, rf_path=rf_path)])
        probs[tag] = np.load(os.path.join(folder, EDGE_PROBS_NAME))
    assert probs["torch"].dtype == np.float32
    np.testing.assert_array_equal(probs["torch"], probs["jax"])


def test_learning_workflow_separates_edges(tmp_path, training_volume):
    """The port's whole path: learn, predict, costs from the predictions;
    JAX's thresholds (``tests/test_learning.py``)."""
    pytest.importorskip("sklearn")
    config_dir = _config(tmp_path, "configs", target="cuda", device_batch_size=2)
    assert build([_learning(LearningWorkflow, tmp_path, training_volume, config_dir, "t")])
    sub = os.path.join(str(tmp_path / "tmp_t"), "ds0")
    labels = np.load(os.path.join(sub, EDGE_LABELS_NAME))
    assert set(np.unique(labels)) <= {0, 1} and (labels == 1).any() and (labels == 0).any()
    assert build([PredictEdgeProbabilitiesTask(sub, config_dir, rf_path=str(tmp_path / "rf_t.pkl"))])
    probs = np.load(os.path.join(sub, EDGE_PROBS_NAME))
    assert probs.shape == labels.shape
    assert probs[labels == 1].mean() > 0.7 and probs[labels == 0].mean() < 0.3
    assert build([ProbsToCostsTask(sub, config_dir, probs_path=os.path.join(sub, EDGE_PROBS_NAME))])
    costs = np.load(os.path.join(sub, "costs.npy"))
    assert (costs[labels == 1] < 0).mean() > 0.9 and (costs[labels == 0] > 0).mean() > 0.9


def test_learn_rf_without_scikit_learn_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    task = LearnRFTask(str(tmp_path), _config(tmp_path, "configs"),
                       output_path=str(tmp_path / "rf.pkl"))
    with pytest.raises(ImportError):
        task.run_impl()
