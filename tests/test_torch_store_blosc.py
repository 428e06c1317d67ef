"""PyTorch port: blosc chunks in ``.zarr`` and ``.n5`` against the JAX store.

Chunks that either package writes read back in the other, the chunk files
and metadata are byte-equal for equal arrays and parameters (both bind the
system ``libblosc`` with the same header fields), mode-1 (varlength) n5
chunks, a region read-modify-write, a corrupt chunk, and the house codec's
resolution (``"default"``, ``CTT_DEFAULT_COMPRESSION``) with and without the
library.  Every case that needs ``libblosc`` skips where it is missing."""

import os

import numpy as np
import pytest

from cluster_tools_tpu.utils import blosc as jax_blosc
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.utils import store as jax_store
from cluster_tools_tpu_torch.utils import blosc, file_reader, store

SHAPE = (10, 13, 7)
CHUNKS = (4, 8, 4)  # ragged edge chunks on every axis
DTYPES = ["uint8", "uint32", "float32", "uint64"]
CNAMES = ["lz4", "blosclz", "zstd", "zlib"]


@pytest.fixture
def need_blosc():
    if not (blosc.available() and jax_blosc.available()):
        pytest.skip("the system libblosc is not installed")


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.random(SHAPE).astype(dtype)
    # few distinct values, as label volumes have: the codecs find runs
    return rng.integers(0, 50, SHAPE).astype(dtype) * np.dtype(dtype).type(3)


def _files(root):
    """Every file under a dataset directory by relative path, with its bytes."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shuffle", [1, 2], ids=["byte", "bit"])
@pytest.mark.parametrize("cname", CNAMES)
@pytest.mark.parametrize("ext", [".zarr", ".n5"])
def test_blosc_chunks_cross_read_and_equal_bytes(tmp_path, need_blosc, ext, cname, shuffle, dtype):
    data = _data(dtype)
    spec = {"id": "blosc", "cname": cname, "clevel": 5, "shuffle": shuffle, "blocksize": 0}
    jax_path, port_path = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    jax_reader(jax_path).create_dataset("x", data=data, chunks=CHUNKS, compression=dict(spec))
    file_reader(port_path).create_dataset("x", data=data, chunks=CHUNKS, compression=dict(spec))
    # the JAX package's chunks in the port, the port's in the JAX package
    got = file_reader(jax_path, "r")["x"]
    assert got.compression == spec
    np.testing.assert_array_equal(got[:], data)
    np.testing.assert_array_equal(jax_reader(port_path, "r")["x"][:], data)
    np.testing.assert_array_equal(got[3:9, 5:12, 1:6], data[3:9, 5:12, 1:6])
    # equal metadata and chunk bytes for equal input and parameters
    assert _files(os.path.join(port_path, "x")) == _files(os.path.join(jax_path, "x"))


@pytest.mark.parametrize("ext", [".zarr", ".n5"])
def test_default_codec_is_the_jax_house_codec(tmp_path, need_blosc, monkeypatch, ext):
    """``"default"`` (the create default) is blosc-lz4, byte shuffle, as in
    the JAX package: same metadata and chunks."""
    monkeypatch.delenv("CTT_DEFAULT_COMPRESSION", raising=False)
    data = _data("uint64", seed=1)
    jax_reader(str(tmp_path / f"j{ext}")).create_dataset("x", data=data, chunks=CHUNKS)
    ds = file_reader(str(tmp_path / f"t{ext}")).create_dataset("x", data=data, chunks=CHUNKS)
    assert ds.compression == {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                              "blocksize": 0}
    assert _files(str(tmp_path / f"t{ext}" / "x")) == _files(str(tmp_path / f"j{ext}" / "x"))


@pytest.mark.parametrize("compression", ["blosc", "gzip", "raw"])
@pytest.mark.parametrize("dtype", ["uint64", "float32"])
def test_varlen_chunks(tmp_path, need_blosc, compression, dtype):
    """n5 mode-1 chunks of any length: written by one package, read by the
    other, byte-equal; a fixed-shape chunk is not read as one."""
    rng = np.random.default_rng(3)
    payloads = {(0, 0): rng.integers(0, 2**40, 37).astype(dtype),
                (1, 0): rng.integers(0, 9, 1000).astype(dtype), (0, 1): np.zeros(0, dtype)}
    for pkg, reader in (("j", jax_reader), ("t", file_reader)):
        ds = reader(str(tmp_path / f"{pkg}.n5")).create_dataset(
            "v", shape=(8, 8), dtype=dtype, chunks=(4, 4), compression=compression)
        for pos, arr in payloads.items():
            ds.write_chunk_varlen(pos, arr)
    for writer, reader in (("j", file_reader), ("t", jax_reader)):
        ds = reader(str(tmp_path / f"{writer}.n5"), "r")["v"]
        for pos, arr in payloads.items():
            got = ds.read_chunk_varlen(pos)
            assert got.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(got, arr)
        assert ds.read_chunk_varlen((1, 1)) is None
    assert _files(str(tmp_path / "t.n5" / "v")) == _files(str(tmp_path / "j.n5" / "v"))
    with pytest.raises(ValueError, match="not varlength"):
        ds = file_reader(str(tmp_path / "t.n5"))["v"]
        ds.write_chunk((1, 1), np.ones((4, 4), dtype))
        ds.read_chunk_varlen((1, 1))
    with pytest.raises(NotImplementedError, match="n5-only"):
        file_reader(str(tmp_path / "t.zarr")).create_dataset(
            "v", shape=(4,), dtype=dtype, compression=compression).read_chunk_varlen((0,))


@pytest.mark.parametrize("ext", [".zarr", ".n5"])
def test_region_read_modify_write(tmp_path, need_blosc, ext):
    """Partial-chunk writes into a blosc dataset that the JAX package made,
    by both packages on copies: equal content and equal chunk files."""
    data = _data("uint32", seed=4)
    for pkg in ("j", "t"):
        jax_reader(str(tmp_path / f"{pkg}{ext}")).create_dataset(
            "x", data=data, chunks=CHUNKS, compression="blosc")
    patch = np.full((5, 6, 3), 7, np.uint32)
    jax_reader(str(tmp_path / f"j{ext}"))["x"][2:7, 5:11, 3:6] = patch
    file_reader(str(tmp_path / f"t{ext}"))["x"][2:7, 5:11, 3:6] = patch
    want = data.copy()
    want[2:7, 5:11, 3:6] = patch
    np.testing.assert_array_equal(file_reader(str(tmp_path / f"t{ext}"), "r")["x"][:], want)
    np.testing.assert_array_equal(jax_reader(str(tmp_path / f"t{ext}"), "r")["x"][:], want)
    assert _files(str(tmp_path / f"t{ext}" / "x")) == _files(str(tmp_path / f"j{ext}" / "x"))


@pytest.mark.parametrize("ext", [".zarr", ".n5"])
def test_corrupt_chunk_raises(tmp_path, need_blosc, ext):
    ds = file_reader(str(tmp_path / f"c{ext}")).create_dataset(
        "x", data=_data("float32"), chunks=CHUNKS, compression="blosc")
    chunk = ds._chunk_path((0, 0, 0))
    with open(chunk, "rb") as f:
        payload = f.read()
    header = 4 + 4 * 3 if ext == ".n5" else 0
    # a header that claims more bytes than the chunk can hold
    forged = bytearray(payload)
    forged[header + 4: header + 8] = (2**30).to_bytes(4, "little")
    for bad in (payload[: len(payload) // 2], bytes(forged)):
        with open(chunk, "wb") as f:
            f.write(bad)
        store.set_chunk_cache_budget(None)
        with pytest.raises(ValueError, match="blosc"):
            file_reader(str(tmp_path / f"c{ext}"), "r")["x"][:]


def test_blosc_chunks_go_through_the_chunk_cache(tmp_path, need_blosc):
    ds = file_reader(str(tmp_path / "c.zarr")).create_dataset(
        "x", data=_data("uint64"), chunks=CHUNKS, compression="blosc")
    prev = store.set_chunk_cache_budget(1 << 24)
    try:
        ds[0:4, 0:8, 0:4]
        before = store.chunk_cache_counts()
        ds[0:4, 0:8, 0:4]
        after = store.chunk_cache_counts()
    finally:
        store.set_chunk_cache_budget(prev)
    assert after["hits"] == before["hits"] + 1 and after["misses"] == before["misses"]


def test_numcodecs_auto_shuffle_reads_and_writes(tmp_path, need_blosc):
    """A zarr written with numcodecs' shuffle -1: read, then written to,
    with JAX's mapping (byte shuffle above one byte per item)."""
    data = _data("uint32", seed=5)
    path = str(tmp_path / "a.zarr")
    jax_reader(path).create_dataset("x", data=data, chunks=CHUNKS, compression="blosc")
    meta_path = os.path.join(path, "x", ".zarray")
    meta = jax_store._read_json(meta_path)
    meta["compressor"]["shuffle"] = -1
    jax_store._write_json(meta_path, meta)
    ds = file_reader(path)["x"]
    assert ds.compression["shuffle"] == 1
    ds[0:4, 0:8, 0:4] = data[0:4, 0:8, 0:4] + 1
    want = data.copy()
    want[0:4, 0:8, 0:4] += 1
    np.testing.assert_array_equal(jax_reader(path, "r")["x"][:], want)


@pytest.mark.parametrize("has_blosc", [True, False])
@pytest.mark.parametrize("pinned", [None, "gzip", "blosc", "lz4"])
def test_default_compression_resolves_as_in_jax(monkeypatch, pinned, has_blosc):
    if pinned is None:
        monkeypatch.delenv("CTT_DEFAULT_COMPRESSION", raising=False)
    else:
        monkeypatch.setenv("CTT_DEFAULT_COMPRESSION", pinned)
    monkeypatch.setattr(blosc, "available", lambda: has_blosc)
    monkeypatch.setattr(jax_blosc, "available", lambda: has_blosc)
    assert store.default_compression() == jax_store.default_compression()
    want = pinned if pinned in ("gzip", "blosc") else ("blosc" if has_blosc else "gzip")
    assert store.default_compression() == want


@pytest.mark.parametrize("ext", [".zarr", ".n5"])
def test_without_libblosc(tmp_path, monkeypatch, ext):
    """No libblosc: "default" falls back to gzip, an explicit blosc raises
    before an existing dataset is overwritten, and a blosc chunk cannot be
    read — each as in the JAX package."""
    monkeypatch.delenv("CTT_DEFAULT_COMPRESSION", raising=False)
    monkeypatch.setattr(blosc, "_lib", None)
    monkeypatch.setattr(blosc, "_lib_checked", True)
    f = file_reader(str(tmp_path / f"n{ext}"))
    ds = f.create_dataset("x", data=np.arange(12, dtype=np.uint64).reshape(3, 4))
    assert ds.compression in ("gzip", "zlib")
    for compression in ("blosc", {"id": "blosc", "cname": "zstd"}):
        with pytest.raises(RuntimeError, match="libblosc"):
            f.create_dataset("x", data=np.zeros((3, 4), np.uint64), compression=compression,
                             exist_ok=True)
    np.testing.assert_array_equal(f["x"][:], np.arange(12).reshape(3, 4))
    jax_reader(str(tmp_path / f"b{ext}")).create_dataset(
        "x", data=np.ones((3, 4), np.float32), compression="blosc")
    with pytest.raises(RuntimeError, match="libblosc"):
        file_reader(str(tmp_path / f"b{ext}"), "r")["x"][:]


def test_scratch_datasets_take_the_house_codec(tmp_path, need_blosc, monkeypatch):
    """The tasks' rule: scratch datasets (the graph, the merged features)
    take ``"default"``, user-facing outputs stay gzip — as in the JAX
    package."""
    from cluster_tools_tpu_torch import MulticutSegmentationWorkflow, build
    from cluster_tools_tpu_torch.runtime import config as cfg

    monkeypatch.delenv("CTT_DEFAULT_COMPRESSION", raising=False)
    rng = np.random.default_rng(6)
    from scipy import ndimage

    bnd = ndimage.gaussian_filter(rng.random((12, 32, 32)), (1, 3, 3)).astype("float32")
    bnd = (bnd - bnd.min()) / (bnd.max() - bnd.min())
    path = str(tmp_path / "d.n5")
    file_reader(path).create_dataset("bnd", data=bnd, chunks=(12, 16, 16), compression="gzip")
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [12, 16, 16], "device": "cpu"})
    cfg.write_config(config_dir, "watershed", {"threshold": 0.5})
    tmp = str(tmp_path / "tmp")
    assert build([MulticutSegmentationWorkflow(
        tmp, config_dir, input_path=path, input_key="bnd", ws_path=path, ws_key="ws",
        output_path=path, output_key="seg")])
    scratch = file_reader(os.path.join(tmp, "data.zarr"), "r")
    for key in ("graph/nodes", "graph/edges", "features/edges"):
        assert scratch[key].compression["id"] == "blosc", key
    out = file_reader(path, "r")
    for key in ("ws", "seg"):
        assert out[key].compression == "gzip", key
