"""PyTorch port, scale pyramids: ``DownscalingTask``, ``UpscalingTask``,
``ScaleToBoundariesTask``, ``DownscalingWorkflow`` (paintera, ``bdv.n5`` and
``bdv.hdf5``) and ``PainteraToBdvWorkflow`` against the JAX package on the
CPU, on seeded volumes of (24, 44, 48) in blocks of (12, 24, 24).

Contracts: every chunk file, attribute and BigDataViewer XML equal to
JAX's, byte for byte — the uint8 ``mean`` ("skimage") pyramids (sums of
integers are exact), every ``nearest`` label pyramid (uint64 ids past 2**32
included) and the refit of ``ScaleToBoundariesTask`` (its flood pinned and
unpinned).  The float32 ``interpolate`` pyramid lies within 1.5e-6 of JAX's
(``test_torch_resample.py``: XLA rounds a few edge columns of JAX's weight
matrices differently).  The ``.h5`` legs need h5py and skip without it, as
JAX's tests do."""

import os

import numpy as np
import pytest
from scipy import ndimage

from cluster_tools_tpu import workflows as jwf
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import downscaling as jds
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch import workflows as twf
from cluster_tools_tpu_torch.ops import cuda_flood
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks import downscaling as tds
from cluster_tools_tpu_torch.utils import file_reader
from test_torch_volume_ops import same_dataset

SHAPE = (24, 44, 48)
BLOCK = [12, 24, 24]
PACKAGES = {"jax": (jax_build, jwf, jds, jax_cfg), "torch": (build, twf, tds, cfg)}


@pytest.fixture
def data(tmp_path):
    rng = np.random.default_rng(0)
    raw = ndimage.gaussian_filter(rng.random(SHAPE), 1.0)
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype(np.float32)
    path = str(tmp_path / "in.n5")
    f = file_reader(path)
    f.create_dataset("raw", data=raw, chunks=tuple(BLOCK), compression="gzip")
    f.create_dataset("raw8", data=(raw * 255).astype(np.uint8), chunks=tuple(BLOCK),
                     compression="gzip")
    f.create_dataset("raw4d", data=np.stack([raw, 1 - raw]), chunks=(1,) + tuple(BLOCK),
                     compression="gzip")
    labels = rng.integers(1, 60, SHAPE).astype(np.uint64)
    labels[labels == 7] = np.uint64(2**40 + 7)
    labels[labels == 8] = np.uint64(18446744073709550592)
    f.create_dataset("labels", data=labels, chunks=tuple(BLOCK), compression="gzip")
    return tmp_path, path, raw, labels


def config_dirs(tmp_path, tasks=None, tag=""):
    dirs = {}
    for package, (_, _, _, mod) in PACKAGES.items():
        d = str(tmp_path / f"configs{tag}_{package}")
        mod.write_global_config(d, {"block_shape": BLOCK, "device": "cpu"})
        for name, conf in (tasks or {}).items():
            mod.write_config(d, name, conf)
        dirs[package] = d
    return dirs


def run_both(tmp_path, make, tasks=None, tag=""):
    """``make(package, tmp_folder, config_dir, output_path)`` for each
    package; returns the output paths."""
    dirs = config_dirs(tmp_path, tasks, tag)
    outs = {}
    for package, (run, *_) in PACKAGES.items():
        outs[package] = str(tmp_path / f"out{tag}_{package}.n5")
        assert run([make(package, str(tmp_path / f"tmp{tag}_{package}"), dirs[package],
                         outs[package])])
    return outs


def close_datasets(path_a, path_b, key, atol):
    a, b = file_reader(path_a, "r")[key], file_reader(path_b, "r")[key]
    assert a.shape == b.shape and a.dtype == b.dtype and a.chunks == b.chunks
    np.testing.assert_allclose(a[:], b[:], rtol=0, atol=atol)
    return a[:]


# -- tasks -------------------------------------------------------------------------


@pytest.mark.parametrize("key,library,halo", [
    ("raw8", "skimage", []), ("raw8", "skimage", [2, 4, 4]), ("raw4d", "skimage", []),
    ("labels", "vigra", []), ("raw", "interpolate", [2, 4, 4]), ("raw", "interpolate", []),
])
def test_downscaling_task_matches_jax(data, key, library, halo):
    tmp_path, path, *_ = data
    outs = run_both(tmp_path, lambda p, tmp, conf, out: PACKAGES[p][2].DownscalingTask(
        tmp, conf, input_path=path, input_key=key, output_path=out, output_key="s1",
        scale_factor=[1, 2, 2], halo=halo), tasks={"downscaling": {"library": library}})
    if library == "interpolate":
        close_datasets(outs["torch"], outs["jax"], "s1", 1.5e-6)
        return
    got = same_dataset(outs["torch"], "s1", outs["jax"], "s1")
    if key == "labels":  # nearest is forced on labels; ids past 2**32 survive
        np.testing.assert_array_equal(got, data[3][:, ::2, ::2])


@pytest.mark.parametrize("key,kwargs", [
    ("labels", {"order": 0}), ("raw8", None), ("raw", None)])
def test_upscaling_task_matches_jax(data, key, kwargs):
    tmp_path, path, *_ = data
    outs = run_both(tmp_path, lambda p, tmp, conf, out: PACKAGES[p][2].UpscalingTask(
        tmp, conf, input_path=path, input_key=key, output_path=out, output_key="up",
        scale_factor=[1, 2, 2]), tasks={"upscaling": {"library_kwargs": kwargs}})
    if key == "raw":
        close_datasets(outs["torch"], outs["jax"], "up", 1.5e-6)
        return
    got = same_dataset(outs["torch"], "up", outs["jax"], "up")
    if key == "labels":
        np.testing.assert_array_equal(got, np.repeat(np.repeat(data[3], 2, 1), 2, 2))


@pytest.mark.parametrize("pin", [None, "4,8,8"])
def test_scale_to_boundaries_matches_jax(tmp_path, monkeypatch, pin):
    """JAX's own fixture (two slabs split at a boundary ridge, objects at
    half resolution), an offset and a 4d boundary map."""
    if pin is None:
        monkeypatch.delenv("CTT_FLOOD_TILE", raising=False)
    else:
        monkeypatch.setenv("CTT_FLOOD_TILE", pin)
    shape = (16, 32, 32)
    gt = np.zeros(shape, dtype="uint64")
    gt[:, :, :16] = 1
    gt[:, :, 16:] = 2**35
    xx = np.mgrid[: shape[0], : shape[1], : shape[2]][2]
    bnd = np.exp(-((xx - 15.5) ** 2) / 4.0).astype("float32")
    bnd += np.random.default_rng(3).random(shape).astype("float32") * 0.05
    path = str(tmp_path / "s.n5")
    f = file_reader(path)
    f.create_dataset("objs", data=gt[::2, ::2, ::2].copy(), chunks=(8, 16, 16))
    f.create_dataset("bnd", data=np.stack([bnd, bnd]), chunks=(1, 8, 16, 16))
    launches = cuda_flood.flood_volume.launches
    dirs = {}
    for package, (_, _, _, mod) in PACKAGES.items():
        dirs[package] = str(tmp_path / f"configs_{package}")
        mod.write_global_config(dirs[package], {"block_shape": [8, 16, 16], "device": "cpu"})
        mod.write_config(dirs[package], "scale_to_boundaries", {"erode_by": 3, "channel": 1})
    for package, (run, _, mod, _) in PACKAGES.items():
        assert run([mod.ScaleToBoundariesTask(
            str(tmp_path / f"tmp_{package}"), dirs[package], input_path=path, input_key="objs",
            boundaries_path=path, boundaries_key="bnd", output_path=path,
            output_key=f"fitted_{package}", offset=5)])
    assert cuda_flood.flood_volume.launches == launches  # CPU tensors: the plain flood
    got = same_dataset(path, "fitted_torch", path, "fitted_jax")
    for obj in (1, 2**35):
        assert (got[gt == obj] == obj + 5).mean() > 0.8


# -- workflows --------------------------------------------------------------------


def pyramid(package, tmp, conf, out, path, fmt="paintera", key="raw8", scale_offset=0,
            factors=([1, 2, 2], 2)):
    wf = PACKAGES[package][1]
    return wf.DownscalingWorkflow(
        tmp, conf, input_path=path, input_key=key, scale_factors=list(factors),
        metadata_format=fmt, metadata_dict={"resolution": [40.0, 4.0, 4.0], "unit": "nm"},
        output_path=out, output_key_prefix="pyramid" if fmt == "paintera" else "",
        scale_offset=scale_offset)


def test_paintera_pyramid_matches_jax(data):
    tmp_path, path, *_ = data
    outs = run_both(tmp_path, lambda p, tmp, conf, out: pyramid(p, tmp, conf, out, path),
                    tasks={"downscaling": {"library": "skimage"}})
    for scale in range(3):
        same_dataset(outs["torch"], f"pyramid/s{scale}", outs["jax"], f"pyramid/s{scale}")
    g_t, g_j = (file_reader(outs[p], "r")["pyramid"] for p in ("torch", "jax"))
    assert {k: g_t.attrs[k] for k in g_t.attrs.keys()} == {k: g_j.attrs[k] for k in g_j.attrs.keys()}
    assert g_t.attrs["resolution"] == [4.0, 4.0, 40.0] and g_t.attrs["multiScale"] is True
    assert file_reader(outs["torch"], "r")["pyramid/s2"].attrs["downsamplingFactors"] == [4, 4, 2]


def test_interpolated_pyramid_close_to_jax(data):
    tmp_path, path, *_ = data
    outs = run_both(tmp_path, lambda p, tmp, conf, out: pyramid(p, tmp, conf, out, path, key="raw"))
    same_dataset(outs["torch"], "pyramid/s0", outs["jax"], "pyramid/s0")
    for scale in (1, 2):
        close_datasets(outs["torch"], outs["jax"], f"pyramid/s{scale}", 1.5e-6)


def read_xml(out):
    with open(os.path.splitext(out)[0] + ".xml") as f:
        return f.read()


def test_bdv_n5_pyramid_and_extension_match_jax(data):
    tmp_path, path, *_ = data
    outs = run_both(tmp_path, lambda p, tmp, conf, out: pyramid(p, tmp, conf, out, path,
                                                                  fmt="bdv.n5"),
                    tasks={"downscaling": {"library": "skimage"}})
    # extend the pyramid by one level from scale 2
    run_both(tmp_path, lambda p, tmp, conf, _: pyramid(
        p, tmp, conf, outs[p], path, fmt="bdv.n5", scale_offset=2, factors=[2]),
        tasks={"downscaling": {"library": "skimage"}}, tag="_ext")
    for scale in range(4):
        key = twf.downscaling.bdv_scale_key(scale)
        same_dataset(outs["torch"], key, outs["jax"], key)
    s_t, s_j = (file_reader(outs[p], "r")["setup0"] for p in ("torch", "jax"))
    assert s_t.attrs["downsamplingFactors"] == s_j.attrs["downsamplingFactors"] == [
        [1, 1, 1], [2, 2, 1], [4, 4, 2], [8, 8, 4]]
    assert s_t.attrs["dataType"] == s_j.attrs["dataType"] == "uint8"
    assert read_xml(outs["torch"]).replace("out_torch", "out_jax") == read_xml(outs["jax"])


def test_paintera_to_bdv_n5_matches_jax(data):
    tmp_path, path, *_ = data
    outs = run_both(tmp_path, lambda p, tmp, conf, out: pyramid(p, tmp, conf, out, path),
                    tasks={"downscaling": {"library": "skimage"}})
    conv = {}
    for package, (run, wf, _, _) in PACKAGES.items():
        conv[package] = str(tmp_path / f"bdv_{package}.n5")
        assert run([wf.PainteraToBdvWorkflow(
            str(tmp_path / f"tmp_conv_{package}"), str(tmp_path / f"configs_{package}"),
            input_path=outs[package], input_key_prefix="pyramid", output_path=conv[package])])
    for scale in range(3):
        got = same_dataset(conv["torch"], f"setup0/timepoint0/s{scale}",
                           conv["jax"], f"setup0/timepoint0/s{scale}")
        np.testing.assert_array_equal(got, file_reader(outs["torch"], "r")[f"pyramid/s{scale}"][:])
    assert read_xml(conv["torch"]).replace("bdv_torch", "bdv_jax") == read_xml(conv["jax"])
    with pytest.raises(ValueError, match="build the pyramid first"):
        twf.PainteraToBdvWorkflow(str(tmp_path / "t"), None, input_path=conv["torch"],
                                  input_key_prefix="nothing",
                                  output_path=str(tmp_path / "x.n5")).requires()


def test_format_validation_matches_jax(tmp_path):
    for fmt, out, match in (("bdv.hdf5", "x.n5", "needs an .h5"), ("bdv.n5", "x.h5", "n5/zarr"),
                            ("paintera", "x.n5", "output_key_prefix"), ("tiff", "x.n5", "unknown")):
        for wf in (jwf, twf):
            with pytest.raises(ValueError, match=match):
                wf.DownscalingWorkflow(str(tmp_path / "t"), None, input_path="in.n5",
                                       input_key="raw", scale_factors=[2], metadata_format=fmt,
                                       output_path=str(tmp_path / out))


def test_bdv_h5_pyramid_and_conversion_match_jax(data):
    h5py = pytest.importorskip("h5py")
    tmp_path, path, *_ = data
    h5 = {}
    for package, (run, wf, _, _) in PACKAGES.items():
        conf = config_dirs(tmp_path, {"downscaling": {"library": "skimage"}})[package]
        h5[package] = str(tmp_path / f"direct_{package}.h5")
        assert run([pyramid(package, str(tmp_path / f"tmp_h5_{package}"), conf, h5[package],
                            path, fmt="bdv.hdf5", factors=[2, [1, 2, 2]])])
    from cluster_tools_tpu.utils import store as jstore
    from cluster_tools_tpu_torch.utils import store as tstore

    jstore.release_h5_handles() if hasattr(jstore, "release_h5_handles") else None
    tstore.release_h5_handles()
    with h5py.File(h5["torch"], "r") as ft, h5py.File(h5["jax"], "r") as fj:
        for scale in range(3):
            key = f"t00000/s00/{scale}/cells"
            np.testing.assert_array_equal(ft[key][:], fj[key][:])
        for key in ("s00/resolutions", "s00/subdivisions"):
            assert ft[key].dtype == fj[key].dtype
            np.testing.assert_array_equal(ft[key][:], fj[key][:])
    assert read_xml(h5["torch"]).replace("direct_torch", "direct_jax") == read_xml(h5["jax"])
