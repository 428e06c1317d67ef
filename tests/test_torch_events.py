"""PyTorch port: event building over detector frames.

``ops.events.build_events`` (on the CPU) is held against the JAX package's
``build_events`` and the scipy oracle ``build_events_np`` on the cases of
JAX's own kernel-parity tests: connectivity 1 and 2, empty frames, one hot
pixel, a blob spanning every frame, ragged non-square frames with an empty
one, a dense stack past JAX's starting cluster capacity, zero frames and a
single 2d frame.  Labels and counts are exact; the property rows are held
within JAX's own tolerance of 1e-4 (rtol and atol) — on these inputs they
equal JAX's bit for bit, and differ from the float64 oracle's by at most
3.8e-6.  ``EventBuildingWorkflow`` is held against JAX's on one config
directory: the labels volume byte-identical, the event tables' frame, size
and bounding-box columns exact, energy and centroids within 1e-4."""

import numpy as np
import pytest
from scipy import ndimage

from cluster_tools_tpu.ops import events as J
from cluster_tools_tpu.runtime import build as jax_build, config as jax_cfg
from cluster_tools_tpu.tasks.events import read_event_tables as jax_read_tables
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import EventBuildingWorkflow as JaxEvents
from cluster_tools_tpu_torch.ops import events as P
from cluster_tools_tpu_torch.runtime import build, config as cfg
from cluster_tools_tpu_torch.tasks.events import read_event_tables
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.workflows import EventBuildingWorkflow


def _frame_stack(rng, n=10, h=24, w=20, density=0.9):
    """``tests/test_events.py``'s detector-like frames: smooth blobs above a
    quantile plus 1% single hot pixels."""
    raw = ndimage.gaussian_filter(rng.random((n, h, w)), (0.0, 1.0, 1.0)).astype("float32")
    frames = np.where(raw > np.quantile(raw, density), raw, 0.0).astype("float32")
    hits = rng.random((n, h, w)) > 0.99
    frames[hits] = (rng.random(int(hits.sum())) + 1.0).astype("float32")
    return frames


def _hot_pixel():
    frames = np.zeros((3, 16, 16), np.float32)
    frames[1, 7, 9] = 2.5
    return frames


def _ragged():
    frames = _frame_stack(np.random.default_rng(3), n=7, h=17, w=33, density=0.85)
    frames[3] = 0.0
    return frames


CASES = {
    "random c1": (lambda: _frame_stack(np.random.default_rng(7)), 1),
    "random c2": (lambda: _frame_stack(np.random.default_rng(7)), 2),
    "empty": (lambda: np.zeros((5, 16, 16), np.float32), 2),
    "hot pixel": (_hot_pixel, 2),
    "spanning blob": (lambda: np.ones((4, 8, 8), np.float32), 2),
    "ragged non-square": (_ragged, 2),
    "dense (capacity)": (lambda: _frame_stack(np.random.default_rng(4), n=4, density=0.8), 2),
    "single 2d frame": (lambda: _frame_stack(np.random.default_rng(5), n=1)[0], 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_events_equals_jax_and_oracle(case):
    make, connectivity = CASES[case]
    frames = make()
    got = P.build_events(frames, connectivity=connectivity, device="cpu")
    want = J.build_events(frames, connectivity=connectivity, max_clusters=2)
    oracle = J.build_events_np(frames, connectivity=connectivity)
    for g, w in zip(P.build_events_np(frames, connectivity=connectivity), oracle):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    for ref in (want, oracle):
        assert got[0].dtype == np.uint32 and got[1].dtype == np.int32 and got[2].dtype == np.float32
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2].shape == ref[2].shape
        for f, k in enumerate(got[1]):
            np.testing.assert_allclose(got[2][f, :k], ref[2][f, :k], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(P.event_table(got[1], got[2]), J.event_table(want[1], want[2]))
    if case == "hot pixel":
        assert got[1].tolist() == [0, 1, 0]
        assert tuple(got[2][1, 0, :4]) == (1.0, 2.5, 7.0, 9.0)
    if case == "spanning blob":
        assert got[1].tolist() == [1, 1, 1, 1] and (got[0] == 1).all()
    if case == "dense (capacity)":
        assert got[1].max() > 16  # past JAX's starting capacity


def test_zero_frames():
    labels, counts, props = P.build_events(np.zeros((0, 8, 8), np.float32), device="cpu")
    assert labels.shape == (0, 8, 8) and counts.size == 0 and props.shape == (0, 0, P.N_PROPS)


def test_negative_threshold_zero_energy_centroid():
    """At a negative threshold zero pixels join clusters; an all-zero
    cluster takes the unweighted mean as its centroid, as in JAX."""
    frames = np.zeros((2, 8, 8), np.float32)
    frames[0, 2:4, 2:4] = 1.0
    got = P.build_events(frames, threshold=-0.5, device="cpu")
    want = J.build_events(frames, threshold=-0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _run(tmp_path, frames, block, tag, jax_side):
    path = str(tmp_path / f"{tag}.n5")
    (jax_reader if jax_side else file_reader)(path).create_dataset(
        "frames", data=frames, chunks=tuple(block))
    config_dir = str(tmp_path / f"cfg_{tag}")
    if jax_side:
        jax_cfg.write_global_config(config_dir, {
            "block_shape": list(block), "target": "tpu", "device_batch_size": 2,
            "devices": [0], "pipeline_depth": 2})
        jax_cfg.write_config(config_dir, "events", {"threshold": 0.0, "connectivity": 2})
        wf = JaxEvents(str(tmp_path / f"tmp_{tag}"), config_dir, input_path=path,
                       input_key="frames", output_path=path, output_key="ev")
        assert jax_build([wf])
        labels = jax_reader(path, "r")["ev"][:]
        return labels, jax_read_tables(path, "ev", -(-frames.shape[0] // block[0]))
    cfg.write_global_config(config_dir, {
        "block_shape": list(block), "target": "cuda", "device": "cpu",
        "device_batch_size": 2, "pipeline_depth": 2})
    cfg.write_config(config_dir, "events", {"threshold": 0.0, "connectivity": 2})
    wf = EventBuildingWorkflow(str(tmp_path / f"tmp_{tag}"), config_dir, input_path=path,
                               input_key="frames", output_path=path, output_key="ev")
    assert build([wf])
    labels = file_reader(path, "r")["ev"][:]
    return labels, read_event_tables(path, "ev", -(-frames.shape[0] // block[0]))


@pytest.mark.parametrize("shape,block", [
    ((10, 16, 16), (2, 16, 16)),
    ((11, 17, 19), (3, 20, 24)),  # ragged frame count, frames padded to the block
])
def test_workflow_equals_jax(tmp_path, shape, block):
    frames = _frame_stack(np.random.default_rng(11), *shape)
    j_labels, j_tab = _run(tmp_path, frames, block, "jax", True)
    p_labels, p_tab = _run(tmp_path, frames, block, "port", False)
    assert p_labels.dtype == j_labels.dtype and p_labels.tobytes() == j_labels.tobytes()
    assert p_tab.shape == j_tab.shape and len(p_tab) > shape[0]
    exact = [0, 1, 5, 6, 7, 8]  # frame, size, ymin, ymax, xmin, xmax
    np.testing.assert_array_equal(p_tab[:, exact], j_tab[:, exact])
    np.testing.assert_allclose(p_tab[:, 2:5], j_tab[:, 2:5], rtol=1e-4, atol=1e-4)
    oracle = J.build_events_np(frames)
    np.testing.assert_array_equal(p_labels, oracle[0])


def test_frames_split_by_the_block_raise(tmp_path):
    frames = _frame_stack(np.random.default_rng(1), 4, 16, 16)
    with pytest.raises(ValueError, match="whole per block"):
        _run(tmp_path, frames, (2, 8, 16), "split", False)
