"""PyTorch port: the decoded-chunk LRU of ``utils/store.py``.

The port's counterparts of the JAX package's cache tests
(``tests/test_io_pipeline.py``): hits under overlapping halo reads,
invalidation by ``write_chunk``, freshness across handles and across
writers that bypass this process's cache, budget 0, LRU eviction, reads
with the cache equal to reads without it, and read results that callers
may mutate without touching the cached chunk."""

import sys
import threading

import numpy as np
import pytest

from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu_torch.utils import store


@pytest.fixture(autouse=True)
def fresh_cache():
    """Each test starts from an empty cache at the default budget and
    leaves the budget as it found it."""
    prev = store.set_chunk_cache_budget(None)
    yield
    store.set_chunk_cache_budget(prev)


def _counts_since(before):
    now = store.chunk_cache_counts()
    return {k: now[k] - before[k] for k in now}


def _volume(tmp_path, ext="n5", dtype="uint32", compression="gzip"):
    ds = store.file_reader(str(tmp_path / f"d.{ext}")).create_dataset(
        "x", shape=(8, 16, 16), dtype=dtype, chunks=(4, 8, 8), compression=compression,
    )
    data = np.arange(8 * 16 * 16).astype(dtype).reshape(8, 16, 16)
    ds[:] = data
    return ds, data


def test_default_budget_is_64_mb(monkeypatch):
    monkeypatch.delenv("CTT_CHUNK_CACHE_MB", raising=False)
    store.set_chunk_cache_budget(None)
    assert store.chunk_cache_budget() == 64 * 1024 * 1024
    monkeypatch.setenv("CTT_CHUNK_CACHE_MB", "0.5")
    store.set_chunk_cache_budget(None)
    assert store.chunk_cache_budget() == 512 * 1024
    monkeypatch.setenv("CTT_CHUNK_CACHE_MB", "not a number")
    store.set_chunk_cache_budget(None)
    assert store.chunk_cache_budget() == 64 * 1024 * 1024


def test_hits_under_overlapping_halo_reads(tmp_path):
    ds, data = _volume(tmp_path)
    before = store.chunk_cache_counts()
    # two halo'd reads of neighbouring blocks, each overlapping all eight
    # chunks: the first decodes them, the second hits the cache for each
    a = ds[0:6, 0:12, 0:16]
    b = ds[2:8, 4:16, 0:16]
    np.testing.assert_array_equal(a, data[0:6, 0:12, 0:16])
    np.testing.assert_array_equal(b, data[2:8, 4:16, 0:16])
    assert _counts_since(before) == {"hits": 8, "misses": 8}
    c = ds[0:3, 0:7, 0:7]  # one chunk, already cached
    np.testing.assert_array_equal(c, data[0:3, 0:7, 0:7])
    assert _counts_since(before) == {"hits": 9, "misses": 8}
    # an identical read is served from the cache alone
    before = store.chunk_cache_counts()
    np.testing.assert_array_equal(ds[0:6, 0:12, 0:16], a)
    assert _counts_since(before) == {"hits": 8, "misses": 0}


def test_invalidated_by_write(tmp_path):
    ds = store.file_reader(str(tmp_path / "d.zarr")).create_dataset(
        "x", shape=(4, 8, 8), dtype="uint8", chunks=(4, 8, 8), compression="gzip",
    )
    ds[:] = np.ones((4, 8, 8), dtype="uint8")
    assert int(ds[:].sum()) == 4 * 8 * 8  # populates the cache
    ds.write_chunk((0, 0, 0), np.full((4, 8, 8), 3, "uint8"))
    np.testing.assert_array_equal(ds[:], np.full((4, 8, 8), 3, "uint8"))
    ds[1:3, 2:5, 2:5] = 7  # read-modify-write of a partial chunk
    want = np.full((4, 8, 8), 3, "uint8")
    want[1:3, 2:5, 2:5] = 7
    np.testing.assert_array_equal(ds[:], want)


def test_fresh_across_handles_and_other_writers(tmp_path):
    """A second handle over the same path, and a writer outside this
    process's cache (the JAX package's store, as another process would
    be): the file signature changes, so no reader sees stale content."""
    path = str(tmp_path / "d.n5")
    ds1 = store.file_reader(path).create_dataset(
        "x", shape=(4, 8, 8), dtype="int32", chunks=(4, 8, 8), compression=None,
    )
    ds1[:] = np.full((4, 8, 8), 1, "int32")
    assert int(ds1[0, 0, 0]) == 1
    ds2 = store.file_reader(path)["x"]
    ds2[:] = np.full((4, 8, 8), 2, "int32")
    np.testing.assert_array_equal(ds1[:], np.full((4, 8, 8), 2, "int32"))
    jax_reader(path)["x"][:] = np.full((4, 8, 8), 5, "int32")
    before = store.chunk_cache_counts()
    np.testing.assert_array_equal(ds1[:], np.full((4, 8, 8), 5, "int32"))
    assert _counts_since(before) == {"hits": 0, "misses": 1}


def test_budget_zero_disables(tmp_path):
    ds, data = _volume(tmp_path)
    assert store.set_chunk_cache_budget(0) == 64 * 1024 * 1024
    assert store.chunk_cache_budget() == 0
    before = store.chunk_cache_counts()
    for _ in range(2):
        np.testing.assert_array_equal(ds[:], data)
    assert _counts_since(before) == {"hits": 0, "misses": 0}
    assert len(store._CHUNK_CACHE._entries) == 0


def test_lru_eviction(tmp_path):
    ds, data = _volume(tmp_path)
    chunk_bytes = 4 * 8 * 8 * 4
    store.set_chunk_cache_budget(3 * chunk_bytes)  # three of the eight chunks
    for pos in ((0, 0, 0), (0, 0, 1), (0, 1, 0)):
        ds.read_chunk(pos)
    ds.read_chunk((0, 0, 0))  # now the most recent
    ds.read_chunk((1, 0, 0))  # evicts the least recent: (0, 0, 1)
    assert store._CHUNK_CACHE._bytes == 3 * chunk_bytes
    before = store.chunk_cache_counts()
    for pos in ((0, 0, 0), (0, 1, 0), (1, 0, 0)):
        ds.read_chunk(pos)
    assert _counts_since(before) == {"hits": 3, "misses": 0}
    ds.read_chunk((0, 0, 1))
    assert _counts_since(before) == {"hits": 3, "misses": 1}
    # a chunk over the whole budget is never kept
    store.set_chunk_cache_budget(chunk_bytes - 1)
    ds.read_chunk((0, 0, 0))
    assert len(store._CHUNK_CACHE._entries) == 0


@pytest.mark.parametrize("ext,dtype,compression", [
    ("n5", "uint64", "gzip"), ("n5", "float32", None), ("zarr", "uint16", "gzip"),
    ("zarr", "int64", None),
])
def test_reads_with_cache_equal_reads_without(tmp_path, ext, dtype, compression):
    rng = np.random.default_rng(0)
    ds = store.file_reader(str(tmp_path / f"d.{ext}")).create_dataset(
        "x", shape=(9, 20, 13), dtype=dtype, chunks=(4, 8, 8), compression=compression,
    )
    ds[:] = (rng.random((9, 20, 13)) * 1000).astype(dtype)
    boxes = [tuple(slice(int(a), int(a) + int(n)) for a, n in zip(
        rng.integers(0, (8, 19, 12)), rng.integers(1, (6, 12, 10)))) for _ in range(20)]
    boxes.append((slice(None),) * 3)
    store.set_chunk_cache_budget(0)
    want = [ds[bb] for bb in boxes] + [ds.read_chunk((2, 2, 1))]
    store.set_chunk_cache_budget(None)
    for _ in range(2):  # cold, then warm
        got = [ds[bb] for bb in boxes] + [ds.read_chunk((2, 2, 1))]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_mutated_reads_leave_the_cached_chunk_intact(tmp_path):
    ds, data = _volume(tmp_path)
    chunk = ds.read_chunk((0, 0, 0))
    assert chunk.flags.writeable
    chunk[:] = 0
    region = ds[0:4, 0:8, 0:8]  # exactly one chunk
    assert region.flags.writeable
    region[:] = 0
    cached = ds._decoded_chunk((0, 0, 0))
    assert not cached.flags.writeable
    np.testing.assert_array_equal(cached, data[0:4, 0:8, 0:8])
    np.testing.assert_array_equal(ds.read_chunk((0, 0, 0)), data[0:4, 0:8, 0:8])
    ragged = store.file_reader(str(tmp_path / "r.zarr")).create_ragged_dataset("r", (2,), "int64")
    ragged.write_chunk((0,), np.arange(5))
    got = ragged.read_chunk((0,))
    got[:] = -1
    np.testing.assert_array_equal(ragged.read_chunk((0,)), np.arange(5))


def test_concurrent_readers_and_writer(tmp_path):
    """Readers in more threads than cores against a writer that rewrites
    one chunk: no read is torn or fails, the counts add up, and once the
    readers stop, a write is read back."""
    ds, _ = _volume(tmp_path, dtype="int64")
    ds.write_chunk((0, 0, 0), np.zeros((4, 8, 8), "int64"))
    stop = threading.Event()
    errors = []
    before = store.chunk_cache_counts()
    reads = [0]
    lock = threading.Lock()

    def reader():
        try:
            while not stop.is_set():
                v = ds[0:4, 0:8, 0:8]
                if not (v == v.flat[0]).all() or not 0 <= v.flat[0] < 40:
                    errors.append(f"torn read {np.unique(v)}")
                ds[4:8, 8:16, 0:16]  # two chunks only read
                with lock:
                    reads[0] += 3
        except Exception as e:  # report in the main thread
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for value in range(1, 40):
            ds.write_chunk((0, 0, 0), np.full((4, 8, 8), value, "int64"))
        stop.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    counts = _counts_since(before)
    assert counts["hits"] + counts["misses"] == reads[0] and counts["hits"] > 0
    ds.write_chunk((0, 0, 0), np.full((4, 8, 8), 40, "int64"))
    np.testing.assert_array_equal(ds[0:4, 0:8, 0:8], np.full((4, 8, 8), 40, "int64"))
