"""PyTorch port: the hdf5 façade of the store against the JAX one.

The façade cases of the JAX package's store tests (the codec vocabulary on
h5py's, scalar and empty datasets, h5py's dtype and shape rules, the
process-wide handle cache that lets one task read and write the same file,
proxies that survive a reopen, refcounted closes), a ``WatershedWorkflow``
from an ``.h5`` input whose output equals the JAX run's, the same workflow
reading and writing one ``.h5``, and the one-thread rule for tasks that
touch an hdf5 file.  Each package keeps its own handle cache, so a test
releases one package's handles before the other opens the file."""

import os

import numpy as np
import pytest
from scipy import ndimage

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import store as jax_store
from cluster_tools_tpu.workflows.watershed import WatershedWorkflow as JaxWatershedWorkflow
from cluster_tools_tpu_torch import WatershedWorkflow, build
from cluster_tools_tpu_torch.runtime.task import hdf5_single_thread, touches_hdf5
from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
from cluster_tools_tpu_torch.utils import store

BLOCK = [12, 24, 24]


@pytest.fixture(autouse=True)
def h5py():
    """h5py, and no cached handle of either package before or after."""
    mod = pytest.importorskip("h5py")
    store.release_h5_handles()
    jax_store.release_h5_handles()
    yield mod
    store.release_h5_handles()
    jax_store.release_h5_handles()


class TestH5FacadeDatasets:
    def test_compression_vocabulary_and_scalars(self, tmp_path):
        f = store.file_reader(str(tmp_path / "v.h5"), "a")
        f.create_dataset("scalar", data=np.bytes_("meta"))  # no filter on a scalar
        f.create_dataset("empty", shape=(0,), dtype="uint64", chunks=(64,))
        for codec in ("blosc", "default", "zlib", "gzip"):
            d = f.create_dataset(f"c_{codec}", data=np.arange(32.0), compression=codec)
            assert d.compression == "gzip"  # house codecs map onto h5py's gzip
        assert f.create_dataset("raw", data=np.arange(8), compression="raw").compression is None

    def test_str_data_and_shape_with_data(self, tmp_path):
        f = store.file_reader(str(tmp_path / "s.h5"), "a")
        f.create_dataset("s", data="hello")  # a vlen string
        assert f["s"][()] in (b"hello", "hello")
        assert f.create_dataset("r", shape=(2, 2), data=np.arange(4)).shape == (2, 2)

    def test_dtype_with_data_and_reuse_conformance(self, tmp_path):
        f = store.file_reader(str(tmp_path / "d.h5"), "a")
        assert f.create_dataset("typed", data=[1, 2, 3], dtype="uint32").dtype == np.uint32
        f.require_dataset("typed", shape=(3,), dtype="uint32")
        f.require_dataset("typed", shape=(3,), dtype="uint16")  # a safe cast
        with pytest.raises(TypeError, match="dtype"):
            f.require_dataset("typed", shape=(3,), dtype="float64")
        with pytest.raises(ValueError, match="shape"):
            f.require_dataset("typed", shape=(5,), dtype="uint32")

    def test_chunks_clamped_and_both_packages_read(self, tmp_path):
        path = str(tmp_path / "c.h5")
        data = np.random.default_rng(0).random((5, 9, 3)).astype("float32")
        ds = store.file_reader(path, "a").create_dataset("x", data=data, chunks=(8, 8, 8))
        assert ds.chunks == (5, 8, 3)
        store.release_h5_handles()
        np.testing.assert_array_equal(jax_store.file_reader(path, "r")["x"][:], data)
        jax_store.release_h5_handles()
        got = store.file_reader(path, "r")["x"]
        assert isinstance(got, store._H5DatasetProxy)
        np.testing.assert_array_equal(got[1:4, 2:7], data[1:4, 2:7])


class TestH5HandleCache:
    def test_same_file_read_then_write(self, tmp_path):
        path = str(tmp_path / "same.h5")
        store.file_reader(path, "a").create_dataset("in", data=np.arange(8.0))
        r = store.file_reader(path, "r")
        _ = r["in"][:]
        w = store.file_reader(path, "a")  # no "file is already open"
        w.create_dataset("out", data=np.arange(8.0) * 2)
        np.testing.assert_array_equal(w["out"][:], np.arange(8.0) * 2)
        with store.file_reader(path, "r") as fh:  # `with` keeps the shared handle
            np.testing.assert_array_equal(fh["in"][:], np.arange(8.0))
        np.testing.assert_array_equal(r["in"][:], np.arange(8.0))

    def test_read_first_then_write_keeps_datasets_live(self, tmp_path):
        path = str(tmp_path / "order.h5")
        store.file_reader(path, "a").create_dataset("in", data=np.arange(6.0))
        store.release_h5_handles()
        ds = store.file_reader(path, "r")["in"]  # a read-only proxy
        w = store.file_reader(path, "a")  # reopens the file writable
        w.create_dataset("out", data=np.zeros(2))
        np.testing.assert_array_equal(ds[:], np.arange(6.0))

    def test_mode_w_refuses_while_cached(self, tmp_path):
        path = str(tmp_path / "trunc.h5")
        store.file_reader(path, "a").create_dataset("x", data=np.ones(4))
        with pytest.raises(OSError, match="open elsewhere"):
            store.file_reader(path, "w")
        store.release_h5_handles()
        assert "x" not in store.file_reader(path, "w")

    def test_last_close_releases_handle(self, tmp_path):
        path = str(tmp_path / "refs.h5")
        key = os.path.abspath(path)
        with store.file_reader(path, "a") as f:
            f.create_dataset("x", data=np.arange(4.0))
        assert key not in store._H5_HANDLES
        a = store.file_reader(path, "r")
        with store.file_reader(path, "r") as b:
            _ = b["x"][:]
        assert key in store._H5_HANDLES
        a.close()
        assert key not in store._H5_HANDLES
        c, d = store.file_reader(path, "r"), store.file_reader(path, "r")
        c.close()
        c.close()  # a second close of one façade takes no one else's count
        assert key in store._H5_HANDLES
        d.close()
        assert key not in store._H5_HANDLES
        ds = store.file_reader(path, "r")["x"]
        store.release_h5_handles()
        np.testing.assert_array_equal(ds[:], np.arange(4.0))  # the proxy reopens

    def test_exclusive_create_semantics_preserved(self, tmp_path):
        path = str(tmp_path / "excl.h5")
        store.file_reader(path, "a").create_dataset("x", data=np.ones(2))
        with pytest.raises(OSError):
            store.file_reader(path, "w-")  # a cached handle
        store.release_h5_handles()
        with pytest.raises(Exception):
            store.file_reader(path, "w-")  # the file exists: h5py raises

    def test_without_h5py_raises_as_jax(self, tmp_path, monkeypatch):
        monkeypatch.setattr(store, "h5py", None)
        monkeypatch.setattr(jax_store, "h5py", None)
        for reader in (store.file_reader, jax_store.file_reader):
            with pytest.raises(RuntimeError, match="h5py is not available"):
                reader(str(tmp_path / "x.h5"))


def _h5_volume(tmp_path, name="d.h5", shape=(24, 48, 48), seed=0):
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), (1.0, 2.0, 2.0))
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")
    path = str(tmp_path / name)
    with store.file_reader(path, "a") as f:  # CREMI's layout: a group, gzip chunks
        f.create_dataset("volumes/boundaries", data=raw, chunks=(12, 24, 24),
                         compression="gzip")
    return path, raw


def _config(tmp_path, name, **gconf):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu", **gconf})
    jax_cfg.write_config(config_dir, "watershed", {"threshold": 0.5})
    return config_dir


def _watershed(package, tmp_path, config_dir, path, out_path, key):
    wf_cls, run = (JaxWatershedWorkflow, jax_build) if package == "jax" else (WatershedWorkflow, build)
    assert run([wf_cls(str(tmp_path / f"tmp_{key}"), config_dir, input_path=path,
                       input_key="volumes/boundaries", output_path=out_path, output_key=key)])
    (store if package == "torch" else jax_store).release_h5_handles()


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_watershed_from_h5_equals_jax(tmp_path, target):
    """An ``.h5`` boundary map into a gzip n5: the port's output equals the
    JAX run's, byte for byte (the port's ``cuda`` target runs its batched
    pipeline on the CPU, as the config asks)."""
    path, _ = _h5_volume(tmp_path)
    store.release_h5_handles()
    out = str(tmp_path / "out.n5")
    _watershed("jax", tmp_path, _config(tmp_path, "c_jax"), path, out, "ws_jax")
    port_conf = _config(tmp_path, "c_port", target=target, device_batch_size=2)
    _watershed("torch", tmp_path, port_conf, path, out, "ws_torch")
    f = store.file_reader(out, "r")
    np.testing.assert_array_equal(f["ws_torch"][:], f["ws_jax"][:])
    assert f["ws_torch"].compression == "gzip"


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_task_reads_and_writes_the_same_h5(tmp_path, target):
    """Input and output in one ``.h5``, as JAX allows it: the port's output
    in its copy of the file equals the JAX run's in its own."""
    outs = {}
    for package in ("jax", "torch"):
        path, raw = _h5_volume(tmp_path, name=f"{package}.h5")
        store.release_h5_handles()
        conf = _config(tmp_path, f"c_{package}_{target}", target=target if package == "torch"
                       else "local", device_batch_size=2, max_jobs=3)
        _watershed(package, tmp_path, conf, path, path, f"ws_{package}")
        with store.file_reader(path, "r") as f:
            outs[package] = f[f"ws_{package}"][:]
            np.testing.assert_array_equal(f["volumes/boundaries"][:], raw)
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    assert outs["torch"].max() > 0


def test_tasks_touching_hdf5_read_with_one_thread(tmp_path):
    task = WatershedTask(str(tmp_path), None, input_path=str(tmp_path / "a.h5"),
                         input_key="x", output_path=str(tmp_path / "b.n5"), output_key="y")
    assert touches_hdf5(task)
    conf = hdf5_single_thread(task, {"read_threads": 4, "pipeline_depth": 3, "max_jobs": 8})
    assert conf == {"read_threads": 1, "pipeline_depth": 1, "max_jobs": 8}
    plain = WatershedTask(str(tmp_path), None, input_path=str(tmp_path / "a.n5"),
                          input_key="x", output_path=str(tmp_path / "b.zarr"), output_key="y")
    assert not touches_hdf5(plain)
    assert hdf5_single_thread(plain, {"read_threads": 4}) == {"read_threads": 4}
