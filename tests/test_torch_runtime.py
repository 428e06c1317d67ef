"""PyTorch port, host layers: blocking, store, config, task lifecycle.

The port keeps its own copies of the JAX package's host modules; these
tests hold each against its counterpart (same geometry, same on-disk
bytes, same config files) and check the task protocol: per-block status,
resume, retry of failed blocks and the refusal to retry when at least half
of the blocks failed."""

import os
import threading

import numpy as np
import pytest

from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import blocking as jax_blocking
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu_torch.runtime import build, config as cfg
from cluster_tools_tpu_torch.runtime.executor import resolve_batch_size
from cluster_tools_tpu_torch.runtime.task import BlockTask, FailedBlocksError, Target
from cluster_tools_tpu_torch.tasks.watershed import WatershedTask, kernel_params
from cluster_tools_tpu_torch.utils import blocking, file_reader


@pytest.mark.parametrize("shape,block,halo", [
    ((20, 41, 37), (12, 24, 24), (1, 3, 3)),
    ((125, 1250, 1250), (32, 256, 256), (0, 0, 0)),
])
def test_blocking_matches_jax(shape, block, halo):
    ours = blocking.Blocking(shape, block)
    ref = jax_blocking.Blocking(shape, block)
    assert ours.n_blocks == ref.n_blocks and ours.grid_shape == ref.grid_shape
    for bid in range(ours.n_blocks):
        a, b = ours.block_with_halo(bid, halo), ref.block_with_halo(bid, halo)
        for part in ("outer", "inner", "inner_local"):
            assert getattr(a, part).begin == getattr(b, part).begin
            assert getattr(a, part).end == getattr(b, part).end


@pytest.mark.parametrize("ext", [".n5", ".zarr"])
@pytest.mark.parametrize("compression", ["raw", "gzip"])
def test_store_round_trip_and_jax_bytes(tmp_path, rng, ext, compression):
    data = rng.integers(0, 1000, (13, 30, 21)).astype(np.uint64)
    ours = str(tmp_path / f"ours{ext}")
    theirs = str(tmp_path / f"theirs{ext}")
    file_reader(ours).create_dataset("a/x", data=data, chunks=(8, 16, 16), compression=compression)
    jax_reader(theirs).create_dataset("a/x", data=data, chunks=(8, 16, 16), compression=compression)
    ds = file_reader(ours, "r")["a/x"]
    np.testing.assert_array_equal(ds[:], data)
    np.testing.assert_array_equal(ds[3:11, 5:29, 2:20], data[3:11, 5:29, 2:20])
    np.testing.assert_array_equal(jax_reader(ours, "r")["a/x"][:], data)
    np.testing.assert_array_equal(file_reader(theirs, "r")["a/x"][:], data)
    for grid_pos in [(0, 0, 0), (1, 1, 1)]:
        rel = os.path.join(*map(str, grid_pos[::-1])) if ext == ".n5" else ".".join(map(str, grid_pos))
        with open(os.path.join(ours, "a/x", rel), "rb") as f, \
                open(os.path.join(theirs, "a/x", rel), "rb") as g:
            assert f.read() == g.read()
        np.testing.assert_array_equal(
            ds.read_chunk(grid_pos), jax_reader(theirs, "r")["a/x"].read_chunk(grid_pos)
        )


def test_store_partial_write_and_ragged(tmp_path, rng):
    f = file_reader(str(tmp_path / "s.n5"))
    ds = f.create_dataset("x", shape=(10, 10), dtype="int64", chunks=(4, 4))
    ds[2:7, 3:9] = 5
    want = np.zeros((10, 10), np.int64)
    want[2:7, 3:9] = 5
    np.testing.assert_array_equal(ds[:], want)
    rag = file_reader(str(tmp_path / "t.zarr")).create_ragged_dataset("m", (3,), np.int64)
    rag.write_chunk((1,), np.array([7, 8], np.int64))
    assert rag.read_chunk((0,)) is None
    again = file_reader(str(tmp_path / "t.zarr"), "r")["m"]
    np.testing.assert_array_equal(again.read_chunk((1,)), [7, 8])
    np.testing.assert_array_equal(
        jax_reader(str(tmp_path / "t.zarr"), "r")["m"].read_chunk((1,)), [7, 8]
    )


def test_jax_written_config_drives_port(tmp_path):
    config_dir = str(tmp_path / "configs")
    jax_cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16]})
    jax_cfg.write_config(config_dir, "watershed", {"threshold": 0.3, "size_filter": 9})
    gconf = cfg.global_config(config_dir)
    assert gconf["block_shape"] == [8, 16, 16] and gconf["device"] == "cuda"
    conf = cfg.task_config(config_dir, "watershed", WatershedTask.default_task_config())
    params = kernel_params(conf)
    assert params["threshold"] == 0.3 and params["size_filter"] == 9
    assert params["sigma_seeds"] == 2.0 and params["alpha"] == 0.8


def test_batch_size_resolution():
    assert resolve_batch_size({"device": "cpu"}) == 1
    assert resolve_batch_size({"device": "cpu", "device_batch_size": 5}) == 5


class _Flaky(BlockTask):
    """Fails its ``bad`` blocks on the first attempt only."""

    task_name = "flaky"

    def __init__(self, tmp_folder, config_dir, bad, always=False):
        super().__init__(tmp_folder, config_dir)
        self.bad, self.always, self.calls = set(bad), always, []

    def get_shape(self):
        return (4, 40, 40)

    def process_block(self, block_id, blocking, config):
        self.calls.append(block_id)
        if block_id in self.bad and (self.always or self.calls.count(block_id) == 1):
            raise RuntimeError(f"block {block_id} broke")


def _env(tmp_path, retries):
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(
        config_dir, {"block_shape": [4, 10, 10], "device": "cpu", "max_num_retries": retries}
    )
    return str(tmp_path / "tmp"), config_dir


def test_task_retries_failed_blocks_and_resumes(tmp_path):
    tmp_folder, config_dir = _env(tmp_path, 1)
    task = _Flaky(tmp_folder, config_dir, bad=[3, 7])
    assert build([task])
    assert sorted(task.calls) == sorted(list(range(16)) + [3, 7])
    status = Target(task.output().path).read()
    assert status["complete"] and status["done"] == list(range(16))
    again = _Flaky(tmp_folder, config_dir, bad=[])
    assert build([again]) and again.calls == []  # complete: skipped


def test_task_raises_after_retries_and_keeps_progress(tmp_path):
    tmp_folder, config_dir = _env(tmp_path, 1)
    task = _Flaky(tmp_folder, config_dir, bad=[5], always=True)
    with pytest.raises(FailedBlocksError):
        build([task])
    status = Target(task.output().path).read()
    assert not status["complete"] and status["failed"] == [5]
    assert 5 not in status["done"] and len(status["done"]) == 15
    resumed = _Flaky(tmp_folder, config_dir, bad=[])
    assert build([resumed]) and resumed.calls == [5]  # only the failed block reruns


def test_task_refuses_retry_when_half_the_blocks_fail(tmp_path):
    tmp_folder, config_dir = _env(tmp_path, 3)
    task = _Flaky(tmp_folder, config_dir, bad=range(8))
    with pytest.raises(FailedBlocksError, match="refusing retry"):
        build([task])
    assert sorted(task.calls) == list(range(16))  # no second attempt


def test_launch_counts_survive_concurrent_threads():
    """Block tasks launch kernels from ``max_jobs`` host threads at once:
    every count lands (a bare ``+=`` on the wrapper attribute loses some
    when the interpreter switches threads mid-update)."""
    import sys
    import threading

    from cluster_tools_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.alt_rounds = 0
    n_threads, per_thread = 16, 2000

    def work():
        for _ in range(per_thread):
            _build.count_launch(wrapper, alt_rounds=3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * per_thread
    assert wrapper.alt_rounds == 3 * n_threads * per_thread


# -- the cuda executor's write pool: ``pipeline_depth`` writers ------------


class _BarrierWrites(BlockTask):
    """Split-protocol task whose ``write_batch`` meets a two-party barrier:
    it passes only when two batches write at once."""

    task_name = "barrier_writes"

    def __init__(self, tmp_folder, config_dir, output_path=None):
        super().__init__(tmp_folder, config_dir)
        self.output_path = output_path  # an hdf5 path makes the run one writer
        self.barrier = threading.Barrier(2, timeout=2.0)
        self.outcomes = []

    def get_shape(self):
        return (4, 20, 20)

    def read_batch(self, block_ids, blocking, config):
        return block_ids

    def compute_batch(self, batch, blocking, config):
        return batch

    def write_batch(self, batch, blocking, config):
        try:
            self.barrier.wait()
            self.outcomes.append("passed")
        except threading.BrokenBarrierError:
            self.outcomes.append("broken")

    def process_block(self, block_id, blocking, config):
        raise AssertionError("no block may fall back")


def _barrier_run(tmp_path, depth, output_path=None):
    config_dir = str(tmp_path / f"configs_{depth}_{output_path is not None}")
    cfg.write_global_config(config_dir, {
        "block_shape": [4, 10, 10], "device": "cpu", "target": "cuda",
        "device_batch_size": 2, "pipeline_depth": depth,
    })
    task = _BarrierWrites(str(tmp_path / f"tmp_{depth}_{output_path is not None}"),
                          config_dir, output_path)
    assert build([task])
    return task.outcomes


def test_write_pool_is_pipeline_depth_wide(tmp_path):
    """Two batches of two blocks: at depth 2 both writes wait at the
    barrier together and pass; with one writer the first times out."""
    assert _barrier_run(tmp_path, 2) == ["passed", "passed"]
    assert "broken" in _barrier_run(tmp_path, 1)


def test_write_pool_has_one_writer_for_hdf5(tmp_path):
    assert "broken" in _barrier_run(tmp_path, 2, output_path=str(tmp_path / "out.h5"))


def test_partial_chunk_writes_from_threads_lose_nothing(tmp_path):
    """Sixteen threads, switching every microsecond, each write their own
    column of one chunk, every write a read-modify-write: the chunk lock
    keeps every column."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    ds = file_reader(str(tmp_path / "x.n5")).create_dataset(
        "x", shape=(2, 4, 16), dtype="uint8", chunks=(2, 4, 16), compression="raw")

    def _write(col):
        for rep in range(20):
            ds[:, :, col:col + 1] = col + 1

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(_write, range(16)))
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(ds[:], np.broadcast_to(np.arange(1, 17, dtype=np.uint8), (2, 4, 16)))


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_unaligned_ragged_run_equal_at_depth_1_and_2(tmp_path, rng, sigma):
    """A ragged volume whose output chunks the blocks do not cover whole
    (chunks (3, 7, 7) against blocks (4, 8, 8)): every batch of one block
    writes into chunks its neighbours write too; depth 2 writes the same
    bytes as depth 1."""
    from cluster_tools_tpu_torch.tasks.threshold import ThresholdTask

    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("raw", data=rng.random((10, 27, 29)).astype("float32"), chunks=(4, 8, 8))
    outs = []
    for depth in (1, 2):
        key = f"thr{depth}"
        f.create_dataset(key, shape=(10, 27, 29), dtype="uint8", chunks=(3, 7, 7))
        config_dir = str(tmp_path / f"cfg{depth}")
        cfg.write_global_config(config_dir, {
            "block_shape": [4, 8, 8], "device": "cpu", "target": "cuda",
            "device_batch_size": 1, "pipeline_depth": depth,
        })
        cfg.write_config(config_dir, "threshold", {"threshold": 0.5, "sigma": sigma})
        assert build([ThresholdTask(str(tmp_path / f"tmp{depth}"), config_dir,
                                    input_path=path, input_key="raw",
                                    output_path=path, output_key=key)])
        outs.append(f[key][:])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].any() and not outs[0].all()
