"""PyTorch port: stream fusion (``runtime/stream.py``,
``workflows/streaming.py``, the fused ``HierarchyWorkflow``).

``StreamingSegmentationWorkflow`` runs through both packages from one
config dir on one seeded (32, 64, 64) volume in (8, 32, 32) blocks: the
port's fused run writes JAX's fused run's bytes (components, watershed,
block labels, the carried max ids, face chunks and offsets), on n5 and
zarr, on ``local`` and on ``cuda`` (against JAX's ``tpu``; the port
computes on the CPU as the config asks).  Then the port against itself:
fused equals ``stream_fusion: false`` with the mask never written, the
fused run reads at most half the store bytes at chunk-cache budget 0 (JAX's
own criterion, ``tests/test_stream_fusion.py::test_store_read_reduction``),
the opt-outs and a resumed run fall back once and give the same bytes, a
failing member is retried inside the chain or falls back, the read cache
serves crops, the components' carry equals JAX's on one result, and the
fused hierarchy equals JAX's and the port's unfused run."""

import os

import numpy as np
import pytest
from scipy import ndimage

from cluster_tools_tpu.parallel.dispatch import BlockBatch as JaxBlockBatch
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks.thresholded_components import BlockComponentsTask as JaxComponents
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.utils import store as jax_store
from cluster_tools_tpu.workflows import HierarchyWorkflow as JaxHier
from cluster_tools_tpu.workflows import StreamingSegmentationWorkflow as JaxStreaming
from cluster_tools_tpu_torch.obs import metrics
from cluster_tools_tpu_torch.parallel.dispatch import BlockBatch, BlockReadCache, CachedDataset
from cluster_tools_tpu_torch.runtime import build
from cluster_tools_tpu_torch.tasks.hier import (
    HIER_FACE_PAIRS_KEY,
    HIER_FACE_SADDLES_KEY,
    HIER_OFFSETS_NAME,
)
from cluster_tools_tpu_torch.tasks.thresholded_components import (
    FACES_KEY,
    MAX_IDS_KEY,
    OFFSETS_NAME,
    BlockComponentsTask,
)
from cluster_tools_tpu_torch.tasks.threshold import ThresholdTask
from cluster_tools_tpu_torch.utils import file_reader, store
from cluster_tools_tpu_torch.utils.blocking import Blocking
from cluster_tools_tpu_torch.workflows import HierarchyWorkflow, StreamingSegmentationWorkflow

SHAPE = (32, 64, 64)
BLOCK = [8, 32, 32]
N_BLOCKS = 16
THRESHOLD = 0.55
WS_CONF = {"threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10, "halo": [2, 4, 4]}


@pytest.fixture(autouse=True)
def _no_chunk_cache():
    """Both stores at chunk-cache budget 0: the byte counters then see what
    crossed the codec boundary."""
    prev, prev_jax = store.set_chunk_cache_budget(0), jax_store.set_chunk_cache_budget(0)
    yield
    store.set_chunk_cache_budget(prev)
    jax_store.set_chunk_cache_budget(prev_jax)


def _stage(tmp_path, ext="n5"):
    rng = np.random.default_rng(7)
    raw = ndimage.gaussian_filter(rng.random(SHAPE), 1.0)
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")
    path = str(tmp_path / f"data.{ext}")
    jax_reader(path).create_dataset("raw", data=raw, chunks=tuple(BLOCK))
    return path


def _config(tmp_path, tag, target, fused=True, **gconf):
    config_dir = str(tmp_path / f"configs_{tag}")
    jax_cfg.write_global_config(config_dir, {
        "block_shape": BLOCK, "target": target, "stream_fusion": fused,
        "device_batch_size": 4, "device": "cpu", **gconf})
    jax_cfg.write_config(config_dir, "threshold", {"threshold": THRESHOLD})
    jax_cfg.write_config(config_dir, "watershed", dict(WS_CONF))
    return config_dir


def _run(tmp_path, path, tag, package="torch", target="cuda", fused=True, watershed=True,
         **gconf):
    """One streaming workflow run; returns the port's counter increments."""
    if package == "jax":
        target = {"cuda": "tpu"}.get(target, target)
    config_dir = _config(tmp_path, tag, target, fused, **gconf)
    wf_cls, run = (JaxStreaming, jax_build) if package == "jax" else (
        StreamingSegmentationWorkflow, build)
    before = metrics.snapshot()
    assert run([wf_cls(str(tmp_path / f"tmp_{tag}"), config_dir, input_path=path,
                       input_key="raw", output_path=path, output_key=f"cc_{tag}",
                       watershed=watershed)])
    return metrics.delta(before, metrics.snapshot())


def _outputs(path, tag, watershed=True):
    f = file_reader(path, "r")
    keys = ["", "_blocks"] + (["_ws"] if watershed else [])
    return {k: f[f"cc_{tag}{k}"][:] for k in keys}


def _scratch(tmp_path, tag):
    """The carried state as the scratch store and the offsets npz hold it."""
    tmp = tmp_path / f"tmp_{tag}"
    scratch = file_reader(str(tmp / "data.zarr"), "r")
    chunks = {key: [scratch[key].read_chunk((b,)) for b in range(N_BLOCKS)]
              for key in (MAX_IDS_KEY, FACES_KEY)}
    with np.load(tmp / OFFSETS_NAME) as f:
        chunks["offsets"] = {k: f[k] for k in f.files}
    return chunks


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def _assert_same_scratch(a: dict, b: dict):
    for key in (MAX_IDS_KEY, FACES_KEY):
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y)
    _assert_same(a["offsets"], b["offsets"])


@pytest.mark.parametrize("target", ["local", "cuda"])
@pytest.mark.parametrize("ext", ["n5", "zarr"])
def test_fused_workflow_byte_identical_to_jax(tmp_path, ext, target):
    path = _stage(tmp_path, ext)
    _run(tmp_path, path, "jax", package="jax", target=target)
    delta = _run(tmp_path, path, "torch", target=target)
    _assert_same(_outputs(path, "torch"), _outputs(path, "jax"))
    _assert_same_scratch(_scratch(tmp_path, "torch"), _scratch(tmp_path, "jax"))
    assert any(c is not None and c.size for c in _scratch(tmp_path, "torch")[FACES_KEY])
    want, n = ndimage.label(file_reader(path, "r")["raw"][:] > THRESHOLD)
    got = _outputs(path, "torch")[""]
    assert n > 3 and len(np.unique(np.stack([got[want > 0], want[want > 0]]), axis=1).T) == n
    assert delta.get("stream.chains") == 1 and delta.get("stream.fallbacks", 0) == 0
    assert delta.get("stream.slabs") == 4 and delta.get("stream.elided_bytes", 0) > 0


def test_fused_equals_unfused_and_reads_half(tmp_path):
    """Fused against ``stream_fusion: false``: the same bytes everywhere, no
    mask dataset after the fused run, at most half the store bytes read and
    fewer written (budget 0)."""
    path = _stage(tmp_path)
    fused = _run(tmp_path, path, "fused")
    assert "cc_fused_mask" not in file_reader(path, "r")
    plain = _run(tmp_path, path, "plain", fused=False)
    assert "cc_plain_mask" in file_reader(path, "r")
    _assert_same(_outputs(path, "fused"), _outputs(path, "plain"))
    _assert_same_scratch(_scratch(tmp_path, "fused"), _scratch(tmp_path, "plain"))
    read_f, read_u = fused["store.bytes_read"], plain["store.bytes_read"]
    assert 0 < 2 * read_f <= read_u, (read_u, read_f)
    assert plain["store.bytes_written"] > fused["store.bytes_written"]
    assert fused.get("stream.chains") == 1 and plain.get("stream.chains", 0) == 0
    assert plain.get("stream.fallbacks") == 1


@pytest.mark.parametrize("how", ["config", "env", "partial"])
def test_opt_outs_and_partial_progress_fall_back(tmp_path, monkeypatch, how):
    """``stream_fusion: false``, ``CTT_STREAM_FUSION=0`` and a member with
    progress of an earlier run: one fallback, no chain, and the bytes of a
    fused run (components only, to keep the test short)."""
    path = _stage(tmp_path)
    _run(tmp_path, path, "ref", watershed=False)
    if how == "partial":
        config_dir = _config(tmp_path, "pre", "cuda")
        assert build([ThresholdTask(str(tmp_path / "tmp_off"), config_dir, input_path=path,
                                    input_key="raw", output_path=path,
                                    output_key="cc_off_mask")])
    if how == "env":
        monkeypatch.setenv("CTT_STREAM_FUSION", "0")
    delta = _run(tmp_path, path, "off", fused=how != "config", watershed=False)
    assert delta.get("stream.fallbacks") == 1 and delta.get("stream.chains", 0) == 0
    assert "cc_off_mask" in file_reader(path, "r")
    _assert_same(_outputs(path, "off", False), _outputs(path, "ref", False))


def test_components_only_chain(tmp_path):
    path = _stage(tmp_path)
    delta = _run(tmp_path, path, "two", watershed=False)
    assert delta.get("stream.chains") == 1 and delta.get("device.dispatches") == 8
    f = file_reader(path, "r")
    assert "cc_two_mask" not in f and "cc_two_ws" not in f
    want, n = ndimage.label(f["raw"][:] > THRESHOLD)
    got = f["cc_two"][:]
    assert ((got > 0) == (want > 0)).all() and np.unique(got[got > 0]).size == n


@pytest.mark.parametrize("retries", [1, 0])
def test_failing_member_retries_in_chain_or_falls_back(tmp_path, monkeypatch, retries):
    """The components' compute raises once.  With ``max_num_retries`` 1 the
    chain re-runs the batch and finishes; with 0 it falls back to the tasks
    one at a time.  Either way the bytes are those of a clean run."""
    path = _stage(tmp_path)
    _run(tmp_path, path, "clean", watershed=False)
    calls = []
    real = BlockComponentsTask.compute_batch

    def flaky(self, payload, blocking, config):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected compute failure")
        return real(self, payload, blocking, config)

    monkeypatch.setattr(BlockComponentsTask, "compute_batch", flaky)
    delta = _run(tmp_path, path, "flaky", watershed=False, max_num_retries=retries)
    if retries:
        assert delta.get("stream.chains") == 1 and delta.get("stream.fallbacks", 0) == 0
        assert delta.get("task.blocks_retried") == 4
    else:
        assert delta.get("stream.fallbacks") == 1
    _assert_same(_outputs(path, "flaky", False), _outputs(path, "clean", False))
    _assert_same_scratch(_scratch(tmp_path, "flaky"), _scratch(tmp_path, "clean"))


def test_block_read_cache_serves_crops(tmp_path):
    path = _stage(tmp_path)
    ds = file_reader(path, "r")["raw"]
    blocking = Blocking(SHAPE, BLOCK)
    cache = BlockReadCache()
    cache.prefetch(ds, path, "raw", blocking, [0, 1, 2, 3], (2, 4, 4))
    wrapped = CachedDataset(ds, cache, path, "raw")
    before = metrics.snapshot()
    got = [wrapped[bb] for bid in (0, 3)
           for bb in (blocking.block_with_halo(bid, (2, 4, 4)).outer.slicing,
                      blocking.block(bid).slicing)]
    assert metrics.delta(before, metrics.snapshot()).get("store.chunks_read", 0) == 0
    want = [ds[bb] for bid in (0, 3)
            for bb in (blocking.block_with_halo(bid, (2, 4, 4)).outer.slicing,
                       blocking.block(bid).slicing)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.tobytes() == w.tobytes()
    # outside the prefetched region, and not a plain box: the store answers
    assert wrapped[20:24].tobytes() == ds[20:24].tobytes()
    assert wrapped[3].tobytes() == ds[3].tobytes()
    assert wrapped.shape == ds.shape and wrapped.dtype == ds.dtype


def test_components_carry_equals_jax():
    """``BlockComponentsTask.fusion_carry_update`` of the port and of the
    JAX package on one batch result, then on the next: the same max ids,
    planes and face pairs."""
    blocking = Blocking((8, 16, 16), (4, 8, 8))
    rng = np.random.default_rng(3)
    labels = ndimage.label(rng.random((8, 16, 16)) > 0.6)[0].astype(np.int32)
    port = BlockComponentsTask("t", None, input_path="x", input_key="x")
    jax_task = JaxComponents("t", None, input_path="x", input_key="x")
    carries = [port.fusion_carry_init(blocking, {}), jax_task.fusion_carry_init(blocking, {})]
    for ids in ([0, 1, 2, 3], [4, 5, 6, 7]):
        blocks = [blocking.block_with_halo(b, (0, 0, 0)) for b in ids]
        labs = np.stack([labels[bh.outer.slicing] for bh in blocks])
        carries[0] = port.fusion_carry_update(
            carries[0], (BlockBatch(None, None, blocks, ids), labs), ids, blocking, {})
        carries[1] = jax_task.fusion_carry_update(
            carries[1], (JaxBlockBatch(None, None, blocks, ids), labs), ids, blocking, {})
        got, want = carries
        np.testing.assert_array_equal(got["max_ids"], want["max_ids"])
        assert sorted(got["planes"]) == sorted(want["planes"])
        for k in want["planes"]:
            np.testing.assert_array_equal(got["planes"][k], want["planes"][k])
        assert {b: sorted(v) for b, v in got["pairs"].items()} == \
            {b: sorted(v) for b, v in want["pairs"].items()}
        for b, per_axis in want["pairs"].items():
            for axis, (lo, hi) in per_axis.items():
                np.testing.assert_array_equal(got["pairs"][b][axis][0], lo)
                np.testing.assert_array_equal(got["pairs"][b][axis][1], hi)
    assert port.fusion_carry_nbytes(carries[0]) == jax_task.fusion_carry_nbytes(carries[1])
    assert carries[0]["pairs"]


def _hier_files(tmp_path, path, tag):
    tmp = tmp_path / f"tmp_{tag}"
    scratch = file_reader(str(tmp / "data.zarr"), "r")
    out = {key: np.concatenate([scratch[key].read_chunk((b,)) for b in range(8)])
           for key in (HIER_FACE_PAIRS_KEY, HIER_FACE_SADDLES_KEY)}
    with np.load(tmp / HIER_OFFSETS_NAME) as f:
        out.update({f"offsets/{k}": f[k] for k in f.files})
    with np.load(os.path.join(path, f"seg_{tag}_hierarchy.npz")) as f:
        out.update({f"artifact/{k}": f[k] for k in f.files})
    f = file_reader(path, "r")
    out.update({"seg": f[f"seg_{tag}"][:], "blocks": f[f"seg_{tag}_blocks"][:]})
    return out


def test_fused_hierarchy_equals_jax_and_unfused(tmp_path):
    """``HierarchyWorkflow`` fused (the default) against JAX's fused run and
    the port's ``stream_fusion: false`` run: labels, block labels, offsets,
    face chunks and the artifact byte for byte."""
    rng = np.random.default_rng(42)
    raw = ndimage.gaussian_filter(rng.random((8, 32, 32)), (1.0, 2.0, 2.0))
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")
    path = str(tmp_path / "h.n5")
    jax_reader(path).create_dataset("raw", data=raw, chunks=(4, 16, 16))
    counts = {}
    for tag, package, fused in (("jax", "jax", True), ("fused", "torch", True),
                                ("plain", "torch", False)):
        config_dir = str(tmp_path / f"configs_{tag}")
        jax_cfg.write_global_config(config_dir, {
            "block_shape": [4, 16, 16], "target": "tpu" if package == "jax" else "cuda",
            "device": "cpu", "device_batch_size": 1, "devices": [0], "stream_fusion": fused})
        jax_cfg.write_config(config_dir, "hierarchy_blocks",
                             {"threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10})
        wf_cls, run = (JaxHier, jax_build) if package == "jax" else (HierarchyWorkflow, build)
        before = metrics.snapshot()
        assert run([wf_cls(str(tmp_path / f"tmp_{tag}"), config_dir, input_path=path,
                           input_key="raw", output_path=path, output_key=f"seg_{tag}")])
        counts[tag] = metrics.delta(before, metrics.snapshot())
    assert counts["fused"].get("stream.chains") == 1 and counts["plain"].get("stream.fallbacks") == 1
    want = _hier_files(tmp_path, path, "jax")
    assert want[HIER_FACE_PAIRS_KEY].size and want["artifact/a"].size > 10
    for tag in ("fused", "plain"):
        _assert_same(_hier_files(tmp_path, path, tag), want)


def test_chunk_at_a_time_with_the_carry_handed_over(tmp_path):
    """``prepare``, ``run_chunk`` for half the batches, the carry exported
    and imported into a fresh runner, the other half, ``finalize``: then the
    rest of the workflow writes the fused run's bytes."""
    from cluster_tools_tpu_torch.runtime import stream

    path = _stage(tmp_path)
    _run(tmp_path, path, "ref", watershed=False)
    wf = StreamingSegmentationWorkflow(
        str(tmp_path / "tmp_chunks"), _config(tmp_path, "chunks", "cuda"), input_path=path,
        input_key="raw", output_path=path, output_key="cc_chunks", watershed=False)
    plan = stream.plan_chain(wf.fused_chains()[0])
    runner = stream._ChainRunner(plan)
    runner.prepare()
    half = len(plan.chunks) // 2
    for chunk in plan.chunks[:half]:
        runner.run_chunk(chunk)
    state = runner.export_carry()
    runner = stream._ChainRunner(plan)
    runner.import_carry(state)
    for chunk in plan.chunks[half:]:
        runner.run_chunk(chunk)
    runner.finalize(0.0)
    assert runner.carry_peak > 0 and build([wf])
    _assert_same(_outputs(path, "chunks", False), _outputs(path, "ref", False))
    _assert_same_scratch(_scratch(tmp_path, "chunks"), _scratch(tmp_path, "ref"))
