"""PyTorch port: the device-buffer cache and the stacked dispatch
(``runtime/hbm.py``, ``runtime/executor.py``).

The cache's LRU, budget, signatures and eviction guard run on CPU tensors
(``"device": "cpu"``, the port's explicit request for the host).  Then
every task whose hooks the port wires — threshold, block components,
watershed, hierarchy blocks, re-segmentation, event building, minimum
filter, linear transformation — runs at ``hbm_stack`` 2
against ``hbm_stack`` 1 and against the JAX package at ``hbm_stack`` 2 on
the same seeded volume, byte for byte, with half the dispatches; and a
back-to-back run on one volume serves every batch from the warm cache and
writes the same bytes."""

import json
import os

import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks.events import EventBuildingTask as JaxEvents
from cluster_tools_tpu.tasks.hier import HierarchyBlocksTask as JaxHierBlocks
from cluster_tools_tpu.tasks.hier import ResegmentTask as JaxResegment
from cluster_tools_tpu.tasks.masking import MinfilterTask as JaxMinfilter
from cluster_tools_tpu.tasks.threshold import ThresholdTask as JaxThreshold
from cluster_tools_tpu.tasks.thresholded_components import BlockComponentsTask as JaxComponents
from cluster_tools_tpu.tasks.transformations import LinearTransformationTask as JaxLinear
from cluster_tools_tpu.tasks.watershed import WatershedTask as JaxWatershed
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu_torch.obs import metrics
from cluster_tools_tpu_torch.parallel.dispatch import BlockBatch, read_block_batch
from cluster_tools_tpu_torch.runtime import build, hbm
from cluster_tools_tpu_torch.tasks.events import EventBuildingTask
from cluster_tools_tpu_torch.ops.hier import load_hierarchy
from cluster_tools_tpu_torch.tasks.hier import (
    HIER_PAIRS_KEY,
    HIER_SADDLES_KEY,
    HierarchyBlocksTask,
    ResegmentTask,
    default_hierarchy_path,
)
from cluster_tools_tpu_torch.tasks.masking import MinfilterTask
from cluster_tools_tpu_torch.tasks.threshold import ThresholdTask
from cluster_tools_tpu_torch.tasks.thresholded_components import BlockComponentsTask
from cluster_tools_tpu_torch.tasks.transformations import LinearTransformationTask
from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
from cluster_tools_tpu_torch.utils import file_reader, store
from cluster_tools_tpu_torch.utils.blocking import Blocking
from cluster_tools_tpu_torch.workflows import HierarchyWorkflow

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _cache_off_after():
    """Each test leaves the process cache at its environment budget (off by
    default), with no entries."""
    yield
    hbm.set_cache_budget(None)


def _entry(nbytes):
    """A cached batch; ``delete`` empties its ``arrays``."""
    return hbm.DeviceBatch(arrays=(torch.zeros(2),), n=1, nbytes=nbytes)


def _src(name, sig=(1,)):
    return hbm.BatchSource(key=(name,), sig=sig)


# -- the cache -------------------------------------------------------------------


def test_cache_lru_eviction_at_budget_edge_and_describe():
    dc = hbm.DeviceBufferCache(100)
    a, b, c = _entry(60), _entry(40), _entry(10)
    dc.put(_src("a"), a)
    dc.put(_src("b"), b)  # exactly at the budget: both resident
    assert dc.get(_src("a")) is a and dc.get(_src("b")) is b
    assert dc.describe() == {"budget_bytes": 100, "bytes": 100, "entries": 2}
    before = metrics.snapshot()
    dc.put(_src("c"), c)  # past the budget: the least recently used goes
    assert dc.get(_src("a")) is None and not a.arrays
    assert dc.get(_src("b")) is b and dc.get(_src("c")) is c
    assert b.arrays and c.arrays
    assert metrics.delta(before, metrics.snapshot())["device.cache_evictions"] == 1
    dc.put(_src("big"), _entry(101))  # larger than the budget: never stored
    assert dc.get(_src("big")) is None and len(dc) == 2
    stale = dc.get(_src("b", sig=(2,)))  # the store was rewritten: a miss
    assert stale is None and not b.arrays and len(dc) == 1
    dc.clear()
    assert not c.arrays and dc.nbytes == 0 and len(dc) == 0


def test_cache_budget_from_environment(monkeypatch):
    monkeypatch.delenv("CTT_HBM_CACHE_MB", raising=False)
    assert hbm.cache_budget_bytes() == 0
    hbm.set_cache_budget(None)
    assert hbm.cache() is None
    monkeypatch.setenv("CTT_HBM_CACHE_MB", "not a number")
    assert hbm.cache_budget_bytes() == 0
    monkeypatch.setenv("CTT_HBM_CACHE_MB", "1.5")
    assert hbm.cache_budget_bytes() == 1572864
    hbm.set_cache_budget(None)
    assert hbm.cache().describe()["budget_bytes"] == 1572864
    assert hbm.set_cache_budget(0) == 1572864 and hbm.cache() is None


def test_guard_defers_deletes_until_the_last_exit():
    dc = hbm.DeviceBufferCache(50)
    a, b = _entry(40), _entry(40)
    dc.put(_src("a"), a)
    before = metrics.snapshot()
    with hbm.use_guard():
        assert dc.get(_src("a")) is a
        with hbm.use_guard():
            dc.put(_src("b"), b)  # evicts a while a dispatch may read it
            assert dc.get(_src("a")) is None and a.arrays
        assert a.arrays, "an inner exit must not drain"
    assert not a.arrays and b.arrays
    assert metrics.delta(before, metrics.snapshot())["device.deferred_deletes"] == 1
    dc.put(_src("a"), _entry(40))  # no guard: b goes at once
    assert not b.arrays


def test_store_rewrite_changes_the_source(tmp_path):
    hbm.set_cache_budget(1 << 20)
    path = str(tmp_path / "v.n5")
    data = np.random.default_rng(0).random((8, 16, 16)).astype("float32")
    file_reader(path).create_dataset("x", data=data, chunks=(4, 8, 8))
    ds = file_reader(path, "a")["x"]
    blocking = Blocking(ds.shape, (4, 8, 8))

    def source():
        return hbm.dataset_source(ds, path, "x", blocking, [0, 1], (0, 0, 0), ("t",), CPU)

    first = source()
    batch = _entry(10)
    hbm.cache().put(first, batch)
    assert hbm.cache().get(source()) is batch
    ds[0:4, 0:8, 0:8] = data[0:4, 0:8, 0:8] * 2.0
    assert source().sig != first.sig and hbm.cache().get(source()) is None and not batch.arrays


def test_stack_split_round_trips(tmp_path):
    path = str(tmp_path / "v.n5")
    data = np.random.default_rng(1).random((8, 20, 16)).astype("float32")
    file_reader(path).create_dataset("x", data=data, chunks=(4, 8, 8))
    ds = file_reader(path, "r")["x"]
    blocking = Blocking(ds.shape, (4, 8, 8))
    parts = [read_block_batch(ds, blocking, ids, np.float32, 1) for ids in ([0, 1, 2], [3, 4])]
    stacked = hbm.stack_block_batches(parts)
    assert stacked.block_ids == [0, 1, 2, 3, 4] and stacked.data.shape == (5, 4, 8, 8)
    for got, want in zip(hbm.split_block_batch(stacked, [3, 2]), parts):
        assert got.block_ids == want.block_ids and got.blocks == want.blocks
        assert got.data.tobytes() == want.data.tobytes()
        np.testing.assert_array_equal(got.valid, want.valid)
    labels = np.arange(5 * 3).reshape(5, 3)
    assert [p.tolist() for p in hbm.split_stacked(labels, [3, 2])] == [
        labels[:3].tolist(), labels[3:].tolist()]
    # batches whose read probe hit concatenate their tensors on the device
    devs = [hbm.DeviceBatch((torch.from_numpy(p.data),), len(p.block_ids), p.data.nbytes)
            for p in parts]
    hits = [BlockBatch(None, p.valid, p.blocks, p.block_ids, device=d) for p, d in zip(parts, devs)]
    got = hbm.stack_block_batches(hits)
    assert got.data is None and got.device.n == 5
    assert got.device.arrays[0].numpy().tobytes() == stacked.data.tobytes()
    # a stack mixing both has neither: its compute raises, the blocks are re-read
    mixed = hbm.stack_block_batches([hits[0], parts[1]])
    with pytest.raises(RuntimeError, match="evicted"):
        hbm.batch_device(mixed, CPU)


# -- stacked dispatch and the warm cache on the wired tasks -------------------------


def _boundaries(tmp_path):
    """A boundary map, detector frames, an intensity transformation and a
    built hierarchy (``seg`` and its artifact) in one n5 container."""
    path = str(tmp_path / "data.n5")
    if not os.path.exists(path):
        rng = np.random.default_rng(42)
        raw = ndimage.gaussian_filter(rng.random((8, 32, 32)), (1.0, 2.0, 2.0))
        raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")
        jax_reader(path).create_dataset("bnd", data=raw, chunks=(4, 16, 16))
        frames = np.where(rng.random((16, 16, 16)) > 0.9, rng.random((16, 16, 16)), 0)
        jax_reader(path).create_dataset("frames", data=frames.astype("float32"),
                                        chunks=(4, 16, 16))
        with open(tmp_path / "trafo.json", "w") as f:
            json.dump({"a": 1.5, "b": -0.1}, f)
        config_dir = str(tmp_path / "configs_hier")
        jax_cfg.write_global_config(config_dir, {"block_shape": [4, 16, 16], "device": "cpu"})
        jax_cfg.write_config(config_dir, "hierarchy_blocks",
                             {"threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10})
        assert build([HierarchyWorkflow(str(tmp_path / "tmp_hier"), config_dir, input_path=path,
                                        input_key="bnd", output_path=path, output_key="seg")])
    return path


def _extra_args(tmp_path, name):
    path = _boundaries(tmp_path)
    if name == "linear":
        return {"transformation": str(tmp_path / "trafo.json")}
    if name == "resegment":
        return {"hierarchy_path": default_hierarchy_path(path, "seg")}
    return {}


def _median_saddle(tmp_path):
    art = load_hierarchy(default_hierarchy_path(_boundaries(tmp_path), "seg"))
    return {"threshold": float(np.quantile(art["saddle"], 0.5))}


MEMBERS = {
    # name: (port class, JAX class, task config, input key, block shape, scratch keys)
    "threshold": (ThresholdTask, JaxThreshold, {"threshold": 0.5}, "bnd", [4, 16, 16], ()),
    "components": (BlockComponentsTask, JaxComponents, {"threshold": 0.5}, "bnd", [4, 16, 16],
                   ("thresholded_components/max_ids",)),
    "watershed": (WatershedTask, JaxWatershed,
                  {"threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10, "halo": [2, 4, 4]},
                  "bnd", [4, 16, 16], ("watershed/max_ids",)),
    "hierarchy_blocks": (HierarchyBlocksTask, JaxHierBlocks,
                         {"threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10}, "bnd",
                         [4, 16, 16], ("hier/max_ids", HIER_PAIRS_KEY, HIER_SADDLES_KEY)),
    "events": (EventBuildingTask, JaxEvents, {"threshold": 0.0}, "frames", [4, 16, 16],
               ()),
    "minfilter": (MinfilterTask, JaxMinfilter, {"filter_shape": [2, 4, 4]}, "bnd",
                  [4, 16, 16], ()),
    "linear": (LinearTransformationTask, JaxLinear, {}, "bnd", [4, 16, 16], ()),
    "resegment": (ResegmentTask, JaxResegment, _median_saddle, "seg", [4, 16, 16], ()),
}


def _run_member(tmp_path, name, tag, package="torch", stack=1):
    cls, jax_cls, conf, key, block, _ = MEMBERS[name]
    config_dir = str(tmp_path / f"configs_{name}_{tag}")
    jax_cfg.write_global_config(config_dir, {
        "block_shape": block, "target": "tpu" if package == "jax" else "cuda",
        "device": "cpu", "devices": [0], "device_batch_size": 1, "pipeline_depth": 3,
        "hbm_stack": stack})
    jax_cfg.write_config(config_dir, cls.task_name, conf(tmp_path) if callable(conf) else conf)
    path = _boundaries(tmp_path)
    task = (jax_cls if package == "jax" else cls)(
        str(tmp_path / f"tmp_{name}_{tag}"), config_dir, input_path=path, input_key=key,
        output_path=path, output_key=f"{name}_{tag}", **_extra_args(tmp_path, name))
    before = metrics.snapshot()
    assert (jax_build if package == "jax" else build)([task])
    return metrics.delta(before, metrics.snapshot())


def _member_bytes(tmp_path, name, tag):
    path = _boundaries(tmp_path)
    f = file_reader(path, "r")
    out = {"volume": f[f"{name}_{tag}"][:]}
    if name == "events":
        events = f[f"{name}_{tag}_events"]
        out.update({f"events/{b}": events.read_chunk((b,)) for b in range(4)})
    scratch = str(tmp_path / f"tmp_{name}_{tag}" / "data.zarr")
    for key in MEMBERS[name][5]:
        ds = file_reader(scratch, "r")[key]
        out.update({f"{key}/{b}": ds.read_chunk((b,)) for b in range(8)})
    return out


@pytest.mark.parametrize("name", sorted(MEMBERS))
def test_stacked_dispatch_equals_unstacked_and_jax(tmp_path, name):
    one = _run_member(tmp_path, name, "one", stack=1)
    two = _run_member(tmp_path, name, "two", stack=2)
    _run_member(tmp_path, name, "jax", package="jax", stack=2)
    want = _member_bytes(tmp_path, name, "jax")
    for tag in ("one", "two"):
        got = _member_bytes(tmp_path, name, tag)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    assert two["device.dispatches"] * 2 == one["device.dispatches"]
    assert two["device.fused_blocks"] == one["device.dispatches"]


@pytest.mark.parametrize("name", ["threshold", "watershed"])
def test_warm_second_run_serves_every_batch_from_the_cache(tmp_path, name):
    """At chunk-cache budget 0, so that the store counters see every read."""
    _boundaries(tmp_path)
    hbm.set_cache_budget(64 << 20)
    prev = store.set_chunk_cache_budget(0)
    try:
        cold = _run_member(tmp_path, name, "cold")
        warm = _run_member(tmp_path, name, "warm")
    finally:
        store.set_chunk_cache_budget(prev)
    assert cold["device.upload_bytes"] > 0 and cold.get("device.uploads_skipped", 0) == 0
    assert warm.get("device.upload_bytes", 0) == 0 and warm["device.uploads_skipped"] == 8
    assert warm.get("store.chunks_read", 0) < cold["store.chunks_read"]
    got, want = _member_bytes(tmp_path, name, "warm"), _member_bytes(tmp_path, name, "cold")
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert hbm.cache().describe()["entries"] == 8
