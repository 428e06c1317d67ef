"""PyTorch port, paintera and bigcat exports: ``ops/label_multiset.py``,
``CreateMultisetTask`` / ``DownscaleMultisetTask``, ``UniqueBlockLabelsTask``,
``LabelBlockMappingTask``, ``LabelMultisetWorkflow``,
``PainteraConversionWorkflow`` and ``BigcatWorkflow`` against the JAX
package on the CPU, on seeded labels of (16, 40, 36) in blocks of
(8, 16, 16), ragged at the far faces.

Contract: byte for byte — the multiset codec's payloads, every varlength
chunk file (multisets, unique labels, the label-to-block mapping), every
attribute, the bigcat container's lookup table and attributes (h5py needed,
skipped without it as JAX's test is)."""

import os

import numpy as np
import pytest

from cluster_tools_tpu import workflows as jwf
from cluster_tools_tpu.ops import label_multiset as jlms
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import label_multisets as jlm_tasks
from cluster_tools_tpu.tasks import paintera as jpaint
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch import workflows as twf
from cluster_tools_tpu_torch.ops import label_multiset as tlms
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks import label_multisets as tlm_tasks
from cluster_tools_tpu_torch.tasks import paintera as tpaint
from cluster_tools_tpu_torch.utils import file_reader
from test_torch_volume_ops import same_tree

SHAPE = (16, 40, 36)
BLOCK = [8, 16, 16]
PACKAGES = {"jax": (jax_build, jwf, jax_cfg), "torch": (build, twf, cfg)}


def labels_of(seed=0, n=40, big=False):
    """Seeded uint64 labels below ``n``; with ``big``, ids past 2**32 and
    paintera's ignore label too (the label-to-block mapping spans every id
    up to the largest, so the workflows get small ids)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n, SHAPE).astype(np.uint64)
    if big:
        labels[labels == 3] = np.uint64(2**45 + 3)
        labels[labels == 4] = np.uint64(18446744073709551615)
    return labels


@pytest.fixture
def data(tmp_path):
    labels = labels_of()
    ignored = np.where(labels == 5, np.uint64(18446744073709551615), labels)  # paintera's
    paths = {}
    for package, (_, _, mod) in PACKAGES.items():
        paths[package] = str(tmp_path / f"{package}.n5")
        for key, vol in (("seg", labels), ("seg_ignore", ignored)):
            ds = file_reader(paths[package]).create_dataset(key, data=vol, chunks=tuple(BLOCK),
                                                            compression="gzip")
            ds.attrs["maxId"] = 39
        mod.write_global_config(str(tmp_path / f"configs_{package}"),
                                {"block_shape": BLOCK, "device": "cpu"})
    return tmp_path, paths, labels


# -- the codec -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("restrict", [-1, 2])
def test_multiset_codec_bytes_match_jax(seed, restrict):
    labels = labels_of(seed, 6, big=True)[:6, :10, :9]
    pays = {}
    for name, lms in (("jax", jlms), ("torch", tlms)):
        m0 = lms.create_multiset_from_labels(labels)
        m1 = lms.downsample_multiset(m0, [2, 3, 2], restrict_set=restrict)
        pays[name] = (lms.serialize_multiset(m0), lms.serialize_multiset(m1))
        back = lms.deserialize_multiset(pays[name][1], m1.shape)
        np.testing.assert_array_equal(back.argmax, m1.argmax)
    for got, want in zip(pays["torch"], pays["jax"]):
        assert got.dtype == want.dtype == np.uint8
        assert got.tobytes() == want.tobytes()


def test_merge_multisets_matches_jax():
    labels = labels_of(2, 5, big=True)[:4, :6, :6]
    parts = {}
    for name, lms in (("jax", jlms), ("torch", tlms)):
        subs = [lms.create_multiset_from_labels(labels[:, :3]),
                lms.create_multiset_from_labels(labels[:, 3:, :4])]
        merged = lms.merge_multisets(subs, [(0, 0, 0), (0, 3, 0)], labels.shape)
        parts[name] = lms.serialize_multiset(merged)
    assert parts["torch"].tobytes() == parts["jax"].tobytes()


# -- tasks and workflows -----------------------------------------------------------


def test_label_multiset_workflow_matches_jax(data):
    tmp_path, paths, labels = data
    for package, (run, wf, _) in PACKAGES.items():
        assert run([wf.LabelMultisetWorkflow(
            str(tmp_path / f"tmp_{package}"), str(tmp_path / f"configs_{package}"),
            input_path=paths[package], input_key="seg_ignore", output_path=paths[package],
            output_prefix="paintera/data", scale_factors=[[1, 2, 2], 2],
            restrict_sets=[-1, 3])])
    n = same_tree(os.path.join(paths["torch"], "paintera"), os.path.join(paths["jax"], "paintera"))
    assert n > 20
    s0 = file_reader(paths["torch"], "r")["paintera/data/s0"]
    m = tlm_tasks.read_multiset_region(s0, tuple(slice(0, s) for s in SHAPE))
    want = np.where(labels == 5, 0, labels)  # the ignore label cannot be encoded
    np.testing.assert_array_equal(m.argmax.reshape(SHAPE), want)
    region = (slice(1, 7), slice(3, 19), slice(5, 30))
    s1 = file_reader(paths["torch"], "r")["paintera/data/s1"]
    got = tlm_tasks.read_multiset_region(s1, region)
    ref = jlm_tasks.read_multiset_region(file_reader(paths["jax"], "r")["paintera/data/s1"], region)
    assert tlms.serialize_multiset(got).tobytes() == jlms.serialize_multiset(ref).tobytes()


def test_paintera_conversion_matches_jax(data):
    tmp_path, paths, labels = data
    for package, (run, wf, _) in PACKAGES.items():
        assert run([wf.PainteraConversionWorkflow(
            str(tmp_path / f"tmp_{package}"), str(tmp_path / f"configs_{package}"),
            input_path=paths[package], input_key="seg", output_path=paths[package],
            label_group="paintera", raw_key="raw", scale_factors=[[1, 2, 2], [1, 2, 2]],
            resolution=[40, 4, 4], offset=[0, 8, 8])])
    same_tree(os.path.join(paths["torch"], "paintera"), os.path.join(paths["jax"], "paintera"))
    same_tree(os.path.join(paths["torch"], "raw"), os.path.join(paths["jax"], "raw"))
    for scale in range(3):
        key = f"paintera/label-to-block-mapping/s{scale}"
        got = tpaint.read_label_block_mapping(paths["torch"], key)
        assert got == jpaint.read_label_block_mapping(paths["jax"], key)
    uniq = file_reader(paths["torch"], "r")["paintera/unique-labels/s0"]
    np.testing.assert_array_equal(uniq.read_chunk_varlen((0, 0, 0)),
                                  np.unique(labels[:8, :16, :16]))
    mapping = tpaint.read_label_block_mapping(paths["torch"], "paintera/label-to-block-mapping/s0")
    assert 0 in mapping[int(labels[0, 0, 0])]
    assert file_reader(paths["torch"], "r")["paintera"].attrs["maxId"] == 39


def test_unique_block_labels_of_a_plain_volume_match_jax(data):
    tmp_path, paths, labels = data
    tasks = {"jax": jpaint.UniqueBlockLabelsTask, "torch": tpaint.UniqueBlockLabelsTask}
    for package, (run, _, _) in PACKAGES.items():
        assert run([tasks[package](
            str(tmp_path / f"tmp_u_{package}"), str(tmp_path / f"configs_{package}"),
            input_path=paths[package], input_key="seg", output_path=paths[package],
            output_key="uniques")])
    same_tree(os.path.join(paths["torch"], "uniques"), os.path.join(paths["jax"], "uniques"))


def test_bigcat_export_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(4)
    n = 50
    assignments = rng.integers(0, 5, n).astype("uint64")
    raw = rng.random((8, 8, 8))
    frags = rng.integers(0, n, (8, 8, 8)).astype("uint64")
    outs = {}
    for package, (run, wf, mod) in PACKAGES.items():
        src = str(tmp_path / f"assign_{package}.n5")
        file_reader(src).create_dataset("assignments", data=assignments, chunks=(n,))
        outs[package] = str(tmp_path / f"bigcat_{package}.h5")
        with h5py.File(outs[package], "w") as f:
            f.create_dataset("volumes/raw", data=raw)
            f.create_dataset("volumes/labels/fragments", data=frags)
        conf = str(tmp_path / f"configs_{package}")
        mod.write_global_config(conf, {"block_shape": [8, 8, 8], "device": "cpu"})
        assert run([wf.BigcatWorkflow(
            str(tmp_path / f"tmp_{package}"), conf, assignment_path=src,
            assignment_key="assignments", output_path=outs[package], resolution=[40, 4, 4],
            offset=[1, 2, 3])])
    with h5py.File(outs["torch"], "r") as ft, h5py.File(outs["jax"], "r") as fj:
        np.testing.assert_array_equal(ft["fragment_segment_lut"][:], fj["fragment_segment_lut"][:])
        assert ft["fragment_segment_lut"].dtype == np.uint64
        assert dict(ft.attrs) == dict(fj.attrs)
        for key in ("volumes/raw", "volumes/labels/fragments"):
            assert {k: list(v) for k, v in ft[key].attrs.items()} == {
                k: list(v) for k, v in fj[key].attrs.items()}
        np.testing.assert_array_equal(ft["fragment_segment_lut"][1], assignments + n)
