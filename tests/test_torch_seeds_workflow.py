"""PyTorch port, the seeded-watershed slice: ``ThresholdAndWatershedWorkflow``
against the JAX one.

Both packages run from ONE config dir written by the JAX package's
``write_config`` (plus ``"device": "cpu"``) on the same n5 volume: the
thresholded components become global seeds (``<key>_seeds``) and
``WatershedFromSeedsTask`` floods the smoothed boundary map from them, 3d by
default.  Contract: exact — both outputs equal the JAX workflow's byte for
byte (decoded arrays and chunk files).  The volume is block-divisible, so
the JAX components' zero padding of ragged edge blocks (ROADMAP Queue C)
cannot show; on a ragged shape the port is held to the JAX test's
invariants and to scipy."""

import os

import numpy as np
import pytest
from scipy import ndimage

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import ThresholdAndWatershedWorkflow as JaxSeedsWorkflow
from cluster_tools_tpu_torch import ThresholdAndWatershedWorkflow, build
from cluster_tools_tpu_torch.ops import cuda_flood
from cluster_tools_tpu_torch.utils import file_reader

BLOCK = [12, 24, 24]


def _volume(tmp_path, shape, seed=42):
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), (1.0, 2.0, 2.0))
    raw = ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")
    path = str(tmp_path / "d.n5")
    jax_reader(path).create_dataset("bnd", data=raw, chunks=tuple(BLOCK), compression="gzip")
    return path, raw


def _config(tmp_path, name="configs", gconf=None, **ws):
    config_dir = str(tmp_path / name)
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "device": "cpu", **(gconf or {})})
    jax_cfg.write_config(config_dir, "block_components", {"threshold": 0.4, "threshold_mode": "less"})
    jax_cfg.write_config(
        config_dir, "watershed_from_seeds",
        {"sigma_weights": 1.0, "halo": [2, 6, 6], "apply_ws_2d": False, **ws},
    )
    return config_dir


def _run(package, tmp_path, path, config_dir, key, mask_key=None):
    wf_cls, run = (
        (JaxSeedsWorkflow, jax_build) if package == "jax"
        else (ThresholdAndWatershedWorkflow, build)
    )
    assert run([wf_cls(
        str(tmp_path / f"tmp_{key}"), config_dir,
        input_path=path, input_key="bnd", output_path=path, output_key=key,
        mask_path=path if mask_key else None, mask_key=mask_key,
    )])


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _check_invariants(seeds, seg, covered, filtered=False):
    """The JAX test's invariants: seed ids kept, no id invented or lost
    (with the size filter: none invented), the seeds grown."""
    seed_ids = set(np.unique(seeds[seeds > 0]))
    assert len(seed_ids) > 3
    seg_ids = set(np.unique(seg[seg > 0]))
    if filtered:
        assert seg_ids < seed_ids
    else:
        assert seg_ids == seed_ids
        assert (seg[seeds > 0] == seeds[seeds > 0]).all()
    assert (seg > 0).sum() > (seeds > 0).sum()
    if covered is not None:
        assert (seg[covered] > 0).all()


@pytest.mark.parametrize("case", ["3d", "ws_2d", "mask", "size_filter"])
def test_threshold_and_watershed_byte_identical_to_jax(tmp_path, case):
    """Exact: seeds and segmentation equal the JAX workflow's, decoded and
    as chunk files, in the 3d default, the per-slice flood, with a mask and
    with the size filter's re-flood."""
    shape = (24, 48, 48)
    path, raw = _volume(tmp_path, shape)
    mask_key = None
    ws = {
        "3d": {}, "ws_2d": {"apply_ws_2d": True}, "mask": {}, "size_filter": {"size_filter": 40},
    }[case]
    if case == "mask":
        mask = ndimage.gaussian_filter(np.random.default_rng(12).random(shape), 3) > 0.49
        jax_reader(path).create_dataset(
            "mask", data=mask.astype("uint8"), chunks=tuple(BLOCK), compression="gzip"
        )
        mask_key = "mask"
    config_dir = _config(tmp_path, **ws)
    _run("jax", tmp_path, path, config_dir, "seg_jax", mask_key)
    _run("torch", tmp_path, path, config_dir, "seg_torch", mask_key)
    f = file_reader(path, "r")
    for suffix in ("_seeds", ""):
        want = jax_reader(path, "r")["seg_jax" + suffix][:]
        got = f["seg_torch" + suffix][:]
        assert got.dtype == np.uint64 and got.shape == shape
        np.testing.assert_array_equal(got, want)
        assert _files(os.path.join(path, "seg_torch" + suffix)) == _files(
            os.path.join(path, "seg_jax" + suffix)
        )
    seeds, seg = f["seg_torch_seeds"][:], f["seg_torch"][:]
    _check_invariants(
        seeds, seg, None if case == "mask" else np.ones(shape, bool), case == "size_filter"
    )
    if case == "mask":
        assert (seg[~mask] == 0).all()


def test_ragged_volume_invariants_and_pinned_tile(tmp_path, monkeypatch):
    """A ragged shape (edge blocks cut on every axis) on the ``cuda`` target
    computing on the CPU: seeds have scipy's partition of ``raw < 0.4``, the
    JAX test's invariants hold, and a run with a ``CTT_FLOOD_TILE`` pin (the
    kernel-3 warm start) writes the same bytes as the unpinned run."""
    shape = (20, 41, 37)
    path, raw = _volume(tmp_path, shape, seed=5)
    config_dir = _config(tmp_path, gconf={"target": "cuda", "max_jobs": 3})
    _run("torch", tmp_path, path, config_dir, "seg")
    f = file_reader(path, "r")
    seeds, seg = f["seg_seeds"][:], f["seg"][:]
    ref, n_ref = ndimage.label(raw < 0.4)
    assert int(seeds.max()) == n_ref
    pairs = np.unique(np.stack([seeds[ref > 0], ref[ref > 0]]), axis=1)
    assert pairs.shape[1] == n_ref and (seeds[ref == 0] == 0).all()
    _check_invariants(seeds, seg, None)
    # every block reaches a seed inside its halo here, so the flood covers it
    assert (seg > 0).all()

    calls = cuda_flood.flood_tiles_warm_plain
    used = []
    monkeypatch.setattr(
        cuda_flood, "flood_tiles_warm_plain",
        lambda *a, **k: used.append(a[3]) or calls(*a, **k),
    )
    monkeypatch.setenv("CTT_FLOOD_TILE", "4,8,16")
    _run("torch", tmp_path, path, _config(tmp_path, "configs_pinned"), "seg_pinned")
    assert used and set(used) == {(8, 16)}
    np.testing.assert_array_equal(f["seg_pinned"][:], seg)
    assert _files(os.path.join(path, "seg_pinned")) == _files(os.path.join(path, "seg"))
