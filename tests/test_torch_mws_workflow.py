"""PyTorch port: ``MwsWorkflow`` and ``TwoPassMwsWorkflow`` against the JAX
package's.

One config drives both packages (the port's global config adds
``"device": "cpu"``; its batched ``cuda`` target stands against JAX's
``tpu``).  Inputs are gzip n5 affinities: the fixtures of the JAX MWS
workflow and two-pass tests, then a ragged volume, uint8 affinities (the
task's /255 cast) and a mask.  The output, ``<key>_blocks``, each block's
max id and the stitch table must be byte identical; a second build must
skip every task."""

import os

import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops.affinities import compute_affinities
from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import MwsWorkflow as JaxMwsWorkflow
from cluster_tools_tpu.workflows import TwoPassMwsWorkflow as JaxTwoPassMwsWorkflow
from cluster_tools_tpu_torch import MwsWorkflow, TwoPassMwsWorkflow, build
from cluster_tools_tpu_torch.ops import mws
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks import MAX_IDS_KEY, STITCH_ASSIGNMENTS_NAME, TwoPassMwsTask
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.utils.blocking import Blocking

BLOCK = [8, 16, 16]
HALVES_OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1], [0, -4, 0], [0, 0, -4]]
LONG_OFFSETS = [
    [-1, 0, 0], [0, -1, 0], [0, 0, -1],
    [-2, 0, 0], [0, -3, 0], [0, 0, -3],
    [-3, -3, -3], [-3, 3, 3],
]


def _halves(shape=(16, 32, 32)):
    """JAX's MWS workflow fixture: two halves along y, the boundary cut in
    the attractive channels and repulsive across it in the y channel."""
    affs = np.full((len(HALVES_OFFSETS),) + shape, 0.9, dtype=np.float32)
    mid = shape[1] // 2
    affs[:3, :, mid - 1: mid + 1, :] = 0.05
    affs[3, :, mid: mid + 4, :] = 0.05
    return affs


def _quadrants(shape, offsets, seed):
    """JAX's two-pass fixture: affinities of a four-quadrant ground truth
    plus noise."""
    gt = np.broadcast_to(
        1 + (np.arange(shape[1]) >= shape[1] // 2)[:, None] * 2
        + (np.arange(shape[2]) >= shape[2] // 2)[None, :],
        shape,
    ).astype("uint64")
    affs, _ = compute_affinities(gt, offsets)
    rng = np.random.default_rng(seed)
    return np.clip(affs + 0.05 * rng.standard_normal(affs.shape), 0, 1).astype("float32"), gt


FIXTURES = {
    # name: (affinities, offsets, task config beyond the offsets, mask?)
    "halves": lambda: (_halves(), HALVES_OFFSETS, {"strides": [1, 1, 1], "halo": [2, 4, 4]}, False),
    "quadrants": lambda: (_quadrants((8, 32, 32), HALVES_OFFSETS, 0)[0], HALVES_OFFSETS,
                          {"strides": [1, 2, 2], "halo": [0, 4, 4]}, False),
    "ragged": lambda: (_quadrants((13, 37, 41), LONG_OFFSETS, 1)[0], LONG_OFFSETS,
                       {"halo": [2, 4, 4], "noise_level": 0.05}, False),
    "uint8": lambda: (np.round(255 * _quadrants((12, 28, 36), LONG_OFFSETS, 2)[0]).astype(np.uint8),
                      LONG_OFFSETS, {"strides": [2, 2, 2], "randomize_strides": True}, False),
    "mask": lambda: (_quadrants((12, 32, 32), HALVES_OFFSETS, 3)[0], HALVES_OFFSETS,
                     {"strides": [1, 2, 2], "halo": [2, 4, 4]}, True),
}


def _setup(tmp_path, name, task, target):
    affs, offsets, conf, masked = FIXTURES[name]()
    path = str(tmp_path / "d.n5")
    f = jax_reader(path)
    f.create_dataset("affs", data=affs, chunks=(1,) + tuple(BLOCK), compression="gzip")
    if masked:
        mask = np.ones(affs.shape[1:], dtype="uint8")
        mask[:, :, -9:] = 0
        mask[:4, :10] = 0
        f.create_dataset("mask", data=mask, chunks=tuple(BLOCK), compression="gzip")
    dirs = {}
    for package in ("jax", "torch"):
        gconf = {"block_shape": BLOCK, "max_jobs": 2}
        if package == "torch":
            gconf.update(device="cpu", target=target)
        else:
            gconf.update(target="tpu" if target == "cuda" else "local", devices=[0])
        d = str(tmp_path / f"configs_{package}")
        jax_cfg.write_global_config(d, gconf)
        jax_cfg.write_config(d, task, {"offsets": offsets, **conf})
        dirs[package] = d
    return path, dirs, masked, affs.shape[1:]


def _workflow(package, cls_jax, cls_torch, tmp_path, path, config_dir, key, masked, **kw):
    cls = cls_jax if package == "jax" else cls_torch
    return cls(
        str(tmp_path / f"tmp_{key}"), config_dir, input_path=path, input_key="affs",
        output_path=path, output_key=key, mask_path=path if masked else None,
        mask_key="mask" if masked else None, **kw,
    )


def _assert_same(path, tmp_path, key_jax, key_torch, shape, stitch):
    keys = [(key_jax, key_torch)]
    if stitch:
        keys.append((key_jax + "_blocks", key_torch + "_blocks"))
    for kj, kt in keys:
        want = jax_reader(path, "r")[kj][:]
        got = file_reader(path, "r")[kt][:]
        assert got.dtype == np.uint64 and got.shape == tuple(shape)
        np.testing.assert_array_equal(got, want)
    ids = [file_reader(str(tmp_path / f"tmp_{k}" / "data.zarr"), "r")[MAX_IDS_KEY]
           for k in (key_jax, key_torch)]
    for bid in range(Blocking(shape, BLOCK).n_blocks):
        np.testing.assert_array_equal(ids[1].read_chunk((bid,)), ids[0].read_chunk((bid,)))
    if stitch:
        tables = [np.load(str(tmp_path / f"tmp_{k}" / STITCH_ASSIGNMENTS_NAME))
                  for k in (key_jax, key_torch)]
        assert tables[1].dtype == tables[0].dtype == np.uint64
        np.testing.assert_array_equal(tables[1], tables[0])
        return file_reader(path, "r")[key_torch][:], tables[1]
    return file_reader(path, "r")[key_torch][:], None


@pytest.mark.parametrize("target", ["local", "cuda"])
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_mws_workflow_byte_identical_to_jax(tmp_path, fixture, target):
    path, dirs, masked, shape = _setup(tmp_path, fixture, "mws_blocks", target)
    for package in ("jax", "torch"):
        wf = _workflow(package, JaxMwsWorkflow, MwsWorkflow, tmp_path, path, dirs[package],
                       f"seg_{package}", masked)
        assert (jax_build if package == "jax" else build)([wf])
    seg, table = _assert_same(path, tmp_path, "seg_jax", "seg_torch", shape, stitch=True)
    blocks = file_reader(path, "r")["seg_torch_blocks"][:]
    # the output is the stitch table applied to the blocks' labels, ids in
    # no vote passing through
    lut = dict(zip(table[:, 0].tolist(), table[:, 1].tolist()))
    mapped = np.vectorize(lambda x: lut.get(int(x), int(x)), otypes=[np.uint64])(blocks)
    np.testing.assert_array_equal(seg, mapped)
    if masked:
        mask = file_reader(path, "r")["mask"][:].astype(bool)
        assert (seg[~mask] == 0).all() and (seg[mask] > 0).all()
    else:
        assert (seg > 0).all()
    if fixture == "halves":
        # JAX's own assertions: each half stitched into one dominant
        # segment, the two different
        def dominant(x):
            ids, counts = np.unique(x, return_counts=True)
            return ids[counts.argmax()], counts.max() / x.size

        (top, share_top), (bottom, share_bottom) = dominant(seg[:, :10]), dominant(seg[:, 22:])
        assert top != bottom and share_top > 0.8 and share_bottom > 0.8
        assert table.shape[0] > 0


@pytest.mark.parametrize("target", ["local", "cuda"])
@pytest.mark.parametrize("fixture", ["halves", "ragged"])
def test_mws_workflow_without_stitch_byte_identical_to_jax(tmp_path, fixture, target):
    path, dirs, masked, shape = _setup(tmp_path, fixture, "mws_blocks", target)
    for package in ("jax", "torch"):
        wf = _workflow(package, JaxMwsWorkflow, MwsWorkflow, tmp_path, path, dirs[package],
                       f"seg_{package}", masked, stitch=False)
        assert (jax_build if package == "jax" else build)([wf])
    seg, _ = _assert_same(path, tmp_path, "seg_jax", "seg_torch", shape, stitch=False)
    assert "seg_torch_blocks" not in os.listdir(path)
    # each block's ids lie in its own namespace
    blocking = Blocking(shape, BLOCK)
    unit = int(np.prod([b + 2 * h for b, h in zip(BLOCK, [2, 4, 4])]))
    for bid in range(blocking.n_blocks):
        ids = seg[blocking.block(bid).slicing]
        assert (ids > bid * unit).all() and (ids <= (bid + 1) * unit).all()


@pytest.mark.parametrize("target", ["local", "cuda"])
@pytest.mark.parametrize("fixture", ["quadrants", "ragged", "uint8", "mask"])
def test_two_pass_mws_byte_identical_to_jax(tmp_path, fixture, target):
    path, dirs, masked, shape = _setup(tmp_path, fixture, "two_pass_mws", target)
    for package in ("jax", "torch"):
        wf = _workflow(package, JaxTwoPassMwsWorkflow, TwoPassMwsWorkflow, tmp_path, path,
                       dirs[package], f"mws_{package}", masked)
        assert (jax_build if package == "jax" else build)([wf])
    want = jax_reader(path, "r")["mws_jax"][:]
    got = file_reader(path, "r")["mws_torch"][:]
    assert got.dtype == np.uint64 and got.shape == tuple(shape)
    np.testing.assert_array_equal(got, want)
    if fixture == "quadrants":
        # JAX's own assertions: each quadrant dominated by one segment, few
        # ids overall (labels continue across the pass 0 / pass 1 faces)
        gt = _quadrants((8, 32, 32), HALVES_OFFSETS, 0)[1]
        for q in range(1, 5):
            _, counts = np.unique(got[gt == q], return_counts=True)
            assert counts.max() / (gt == q).sum() > 0.9
        assert len(np.unique(got)) < 30


def _face_seeds(written, inner_local):
    seeds = np.zeros_like(written)
    for axis in range(3):
        for lo, hi in ((0, inner_local[axis].start), (inner_local[axis].stop, written.shape[axis])):
            slab = list(inner_local)
            slab[axis] = slice(lo, hi)
            seeds[tuple(slab)] = written[tuple(slab)]
    return seeds


@pytest.mark.parametrize("fixture", ["quadrants", "ragged"])
def test_two_pass_seeds_survive(tmp_path, fixture):
    """Pass 1 re-run by hand on every black block from the written volume:
    the seeds (pass-0 ids in the halo's face slabs) survive verbatim at
    their voxels, and the inner box, new ids shifted into the block's
    namespace, is what the workflow wrote."""
    from cluster_tools_tpu_torch.ops.mws import compute_mws_segmentation_with_seeds

    path, dirs, _, shape = _setup(tmp_path, fixture, "two_pass_mws", "local")
    wf = _workflow("torch", None, TwoPassMwsWorkflow, tmp_path, path, dirs["torch"], "mws", False)
    assert build([wf])
    f = file_reader(path, "r")
    seg, affs = f["mws"][:], f["affs"][:]
    conf = cfg.task_config(dirs["torch"], "two_pass_mws", TwoPassMwsTask.default_task_config())
    blocking = Blocking(shape, BLOCK)
    black = TwoPassMwsTask(str(tmp_path / "tmp_mws"), dirs["torch"], pass_id=1).get_block_list(
        blocking, {})
    assert black
    n_seeded = 0
    for bid in black:
        bh = blocking.block_with_halo(bid, conf["halo"])
        seeds = _face_seeds(seg[bh.outer.slicing], bh.inner_local.slicing)
        out = compute_mws_segmentation_with_seeds(
            affs[(slice(None),) + bh.outer.slicing], conf["offsets"], seeds,
            strides=conf["strides"], noise_level=conf["noise_level"], seed=bid, device="cpu")
        np.testing.assert_array_equal(out[seeds > 0], seeds[seeds > 0])
        n_seeded += int((seeds > 0).sum())
        seed_max = int(seeds.max())
        unit = np.uint64(bid * int(np.prod([b + 2 * h for b, h in zip(BLOCK, conf["halo"])])))
        out = np.where(out > seed_max, out - np.uint64(seed_max) + unit, out)
        np.testing.assert_array_equal(out[bh.inner_local.slicing], seg[bh.inner.slicing])
    assert n_seeded > 0


def test_mws_resume_skips_done_tasks(tmp_path):
    path, dirs, masked, _ = _setup(tmp_path, "halves", "mws_blocks", "cuda")
    wf = _workflow("torch", None, MwsWorkflow, tmp_path, path, dirs["torch"], "seg", masked)
    assert build([wf])
    status = str(tmp_path / "tmp_seg" / "status")
    before = {n: os.stat(os.path.join(status, n)).st_mtime_ns for n in os.listdir(status)}
    assert {"mws_blocks.status.json", "stitch_faces.status.json",
            "stitch_assignments.status.json", "write_mws_stitch.status.json"} <= set(before)
    assert wf.complete()
    assert build([_workflow("torch", None, MwsWorkflow, tmp_path, path, dirs["torch"], "seg",
                            masked)])
    after = {n: os.stat(os.path.join(status, n)).st_mtime_ns for n in os.listdir(status)}
    assert after == before
    # a workflow whose blocks are done re-runs only what follows them
    os.remove(os.path.join(status, "write_mws_stitch.status.json"))
    assert build([_workflow("torch", None, MwsWorkflow, tmp_path, path, dirs["torch"], "seg",
                            masked)])
    again = {n: os.stat(os.path.join(status, n)).st_mtime_ns for n in os.listdir(status)}
    assert again["mws_blocks.status.json"] == before["mws_blocks.status.json"]
    assert "write_mws_stitch.status.json" in again


def test_device_mode_workflow_equals_host(tmp_path):
    """``CTT_MWS_MODE=device`` through the whole workflow on CPU tensors: on
    quantised affinities (exact in float32) the blocks' partition and the
    stitched one equal the host solver's run (ids are numbered by each
    solver's roots, so they may differ)."""
    path, dirs, _, shape = _setup(tmp_path, "quadrants", "mws_blocks", "cuda")
    q = np.round(jax_reader(path, "r")["affs"][:] * 256) / 256
    jax_reader(path).create_dataset("affs_q", data=q.astype("float32"),
                                    chunks=(1,) + tuple(BLOCK), compression="gzip")
    runs = {}
    for mode in ("host", "device"):
        wf = MwsWorkflow(str(tmp_path / f"tmp_{mode}"), dirs["torch"], input_path=path,
                         input_key="affs_q", output_path=path, output_key=f"seg_{mode}")
        with mws.force_mws_mode(mode):
            assert build([wf])
        f = file_reader(path, "r")
        runs[mode] = (f[f"seg_{mode}_blocks"][:], f[f"seg_{mode}"][:])
    for host, dev in zip(runs["host"], runs["device"]):
        pairs = np.unique(np.stack([host.ravel(), dev.ravel()], axis=1), axis=0)
        assert len(pairs) == len(np.unique(host)) == len(np.unique(dev)) > 1


@pytest.mark.parametrize("workflow", [MwsWorkflow, TwoPassMwsWorkflow])
def test_mws_workflows_ask_for_the_card(tmp_path, monkeypatch, workflow):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "d.n5")
    file_reader(path).create_dataset("affs", data=_halves((8, 16, 16)), chunks=(1, 8, 16, 16),
                                     compression="gzip")
    config_dir = str(tmp_path / "configs")
    jax_cfg.write_global_config(config_dir, {"block_shape": BLOCK, "target": "cuda"})
    wf = workflow(str(tmp_path / "tmp"), config_dir, input_path=path, input_key="affs",
                  output_path=path, output_key="seg")
    with pytest.raises(Exception, match="no CUDA device"):
        build([wf])
    assert not wf.complete()
