"""PyTorch port: the merge hierarchy (``ops/hier.py``, ``tasks/hier.py``,
``workflows/hier.py``).

Every function of the port's ``ops/hier.py`` is held against the JAX
package's on the same seeded inputs, exactly (the device table slot for
slot, the relabel tables array for array, the artifacts key for key, each
package reading the other's).  ``HierarchyWorkflow`` runs on one config
directory through both packages, each in its default fused chain, on ``tests/test_hier.py``'s fixture: the labels volume and
the artifact's ``a``, ``b``, ``saddle`` and ``n_labels`` are
byte-identical, and so are ``ResegmentWorkflow`` at three thresholds and
the table mode's cut npz.  Then the serpentine face fixture, and the
host-relabel downgrade with ``INT32_LIMIT`` patched to 1."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops import hier as J
from cluster_tools_tpu.runtime import build as jax_build, config as jax_cfg
from cluster_tools_tpu.utils import file_reader as jax_reader
from cluster_tools_tpu.workflows import HierarchyWorkflow as JaxHier
from cluster_tools_tpu.workflows import ResegmentWorkflow as JaxReseg
from cluster_tools_tpu_torch.ops import hier as P
from cluster_tools_tpu_torch.ops.cc import serpentine_mask
from cluster_tools_tpu_torch.runtime import build, config as cfg
from cluster_tools_tpu_torch.tasks.hier import ResegmentTask
from cluster_tools_tpu_torch.utils import file_reader
from cluster_tools_tpu_torch.workflows import HierarchyWorkflow, ResegmentWorkflow

BLOCK_SHAPE = [4, 16, 16]
JAX_GCONF = {"block_shape": BLOCK_SHAPE, "target": "tpu", "device_batch_size": 1,
             "devices": [0], "pipeline_depth": 2}
PORT_GCONF = {"block_shape": BLOCK_SHAPE, "target": "cuda", "device": "cpu",
              "device_batch_size": 1, "pipeline_depth": 2}
BLOCKS_CONF = {"threshold": 0.5, "sigma_seeds": 1.6, "size_filter": 10}


def _volume(rng, shape=(8, 32, 32)):
    raw = ndimage.gaussian_filter(rng.random(shape), (1.0, 2.0, 2.0))
    return ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")


def _labels(seed, shape=(4, 8, 8), k=5):
    rng = np.random.default_rng(seed)
    lab = ndimage.zoom(rng.integers(0, k + 1, (2, 3, 3)), np.array(shape) / (2, 3, 3), order=0)
    return lab.astype(np.int32)[: shape[0], : shape[1], : shape[2]], rng.random(shape).astype(np.float32)


# -- ops ----------------------------------------------------------------------


@pytest.mark.parametrize("connectivity,per_slice", [(1, False), (2, False), (3, False), (1, True)])
def test_block_merge_table_equals_jax(connectivity, per_slice):
    lab, h = _labels(0)
    want = J.block_merge_table(jnp.asarray(lab), jnp.asarray(h), connectivity, per_slice)
    got = P.block_merge_table(torch.from_numpy(lab), torch.from_numpy(h), connectivity, per_slice)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] > 0).any()


def test_block_merge_table_of_a_batch_is_per_block():
    labs, hs = zip(*(_labels(s) for s in (1, 2, 3)))
    got = P.block_merge_table(torch.from_numpy(np.stack(labs)), torch.from_numpy(np.stack(hs)))
    for i in range(3):
        want = J.block_merge_table(jnp.asarray(labs[i]), jnp.asarray(hs[i]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_host_table_functions_equal_jax():
    lab, h = _labels(4)
    a, b, s = (np.asarray(c) for c in J.block_merge_table(jnp.asarray(lab), jnp.asarray(h)))
    for normalize in (True, False):
        for g, w in zip(P.reduce_merge_table(b, a, s, normalize), J.reduce_merge_table(b, a, s, normalize)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    lo, hi = lab[1], lab[2]
    for g, w in zip(P.merge_face_pairs(lo, hi, h[1], h[2]), J.merge_face_pairs(lo, hi, h[1], h[2])):
        np.testing.assert_array_equal(g, w)
    pairs, saddles = J.reduce_merge_table(a, b, s)
    for g, w in zip(P.sort_by_saddle(pairs, saddles), J.sort_by_saddle(pairs, saddles)):
        np.testing.assert_array_equal(g, w)


def _artifact(seed=5, n=40, n_labels=30):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, n_labels, n)
    b = rng.integers(1, n_labels + 1, n)
    pairs = np.stack([np.minimum(a, b), np.maximum(a, b)], 1)
    pairs = pairs[pairs[:, 0] < pairs[:, 1]]
    saddles = np.round(rng.random(len(pairs)) * 10).astype(np.float32) / 10
    return J.sort_by_saddle(pairs.astype(np.int64), saddles)


@pytest.mark.parametrize("threshold", [-1.0, 0.2, 0.5, 1.0])
def test_cut_tables_and_recut_equal_jax(threshold):
    pairs, saddles = _artifact()
    a, b = pairs[:, 0], pairs[:, 1]
    for fn_p, fn_j in ((lambda *x: P.cut_table(*x, device="cpu"), J.cut_table),
                       (P.cut_table_np, J.cut_table_np)):
        got, want = fn_p(a, b, saddles, threshold), fn_j(a, b, saddles, threshold)
        if want is None:
            assert got is None
            continue
        for g, w in zip(got, want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
    cut = J.cut_table(a, b, saddles, threshold)
    lab = np.random.default_rng(6).integers(0, 31, (3, 7, 9)).astype(np.int32)
    if cut is not None:
        vals, roots = cut
        want = np.asarray(J.recut_labels(jnp.asarray(lab), jnp.asarray(vals), jnp.asarray(roots)))
        got = P.recut_labels(*(torch.from_numpy(np.array(x)) for x in (lab, vals, roots)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(P.apply_cut_np(lab, vals, roots), J.apply_cut_np(lab, vals, roots))


@pytest.mark.parametrize("connectivity", [1, 2])
def test_resegment_oracle_equals_jax(connectivity):
    lab, h = _labels(7, (6, 12, 10), k=8)
    for t in (0.2, 0.6, 0.95):
        np.testing.assert_array_equal(P.resegment_np(lab, h, t, connectivity),
                                      J.resegment_np(lab, h, t, connectivity))


def test_artifacts_read_both_ways(tmp_path):
    pairs, saddles = _artifact(8)
    pairs = pairs[::-1].copy()  # unsorted: saving sorts
    for save, load, tag in ((P.save_hierarchy, J.load_hierarchy, "p2j"),
                            (J.save_hierarchy, P.load_hierarchy, "j2p")):
        path = str(tmp_path / f"{tag}.npz")
        save(path, pairs, saddles[::-1].copy(), 30, (8, 8, 8), (4, 4, 4))
        art = load(path)
        other = (J if load is P.load_hierarchy else P).load_hierarchy(path)
        for k in ("a", "b", "saddle", "n_labels", "shape", "block_shape", "schema"):
            np.testing.assert_array_equal(art[k], other[k])
            assert art[k].dtype == other[k].dtype
    np.savez(str(tmp_path / "bad.npz"), a=pairs[:, 0], b=pairs[:, 1], saddle=saddles)
    with pytest.raises(ValueError, match="schema"):
        P.load_hierarchy(str(tmp_path / "bad.npz"))
    cut = J.cut_table(pairs[:, 0], pairs[:, 1], np.sort(saddles), 0.5)
    P.save_cut_table(str(tmp_path / "pc.npz"), 0.5, cut, 30)
    J.save_cut_table(str(tmp_path / "jc.npz"), 0.5, cut, 30)
    pc, jc = J.load_cut_table(str(tmp_path / "pc.npz")), P.load_cut_table(str(tmp_path / "jc.npz"))
    assert sorted(pc) == sorted(jc)
    for k in pc:
        np.testing.assert_array_equal(pc[k], jc[k])
        assert pc[k].dtype == jc[k].dtype


# -- workflows ------------------------------------------------------------------


def _build_pair(tmp_path, raw, tag, blocks_conf=BLOCKS_CONF, chunks=tuple(BLOCK_SHAPE)):
    out = {}
    for side, reader, wcfg, wf_cls, run in (
            ("jax", jax_reader, jax_cfg, JaxHier, jax_build),
            ("port", file_reader, cfg, HierarchyWorkflow, build)):
        path = str(tmp_path / f"{tag}_{side}.n5")
        reader(path).create_dataset("bnd", data=raw, chunks=chunks)
        config_dir = str(tmp_path / f"cfg_{tag}_{side}")
        wcfg.write_global_config(config_dir, JAX_GCONF if side == "jax" else PORT_GCONF)
        wcfg.write_config(config_dir, "hierarchy_blocks", blocks_conf)
        assert run([wf_cls(str(tmp_path / f"tmp_{tag}_{side}"), config_dir, input_path=path,
                           input_key="bnd", output_path=path, output_key="seg")])
        out[side] = path
    return out


def _resegment_pair(tmp_path, paths, threshold, tag, write_volume=True):
    out = {}
    for side, reader, wcfg, wf_cls, run in (
            ("jax", jax_reader, jax_cfg, JaxReseg, jax_build),
            ("port", file_reader, cfg, ResegmentWorkflow, build)):
        config_dir = str(tmp_path / f"cfg_rs_{tag}_{side}")
        wcfg.write_global_config(config_dir, JAX_GCONF if side == "jax" else PORT_GCONF)
        wcfg.write_config(config_dir, "resegment", {"threshold": float(threshold),
                                                    "write_volume": write_volume})
        assert run([wf_cls(str(tmp_path / f"tmp_rs_{tag}_{side}"), config_dir,
                           labels_path=paths[side], labels_key="seg",
                           output_path=paths[side], output_key=f"seg_{tag}")])
        out[side] = reader(paths[side], "r")[f"seg_{tag}"][:] if write_volume else None
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("torch_hier")
    raw = _volume(np.random.default_rng(42))
    return tmp_path, _build_pair(tmp_path, raw, "h"), raw


def test_hierarchy_workflow_byte_identical(built):
    _, paths, raw = built
    jseg = jax_reader(paths["jax"], "r")["seg"][:]
    pseg = file_reader(paths["port"], "r")["seg"][:]
    assert pseg.dtype == jseg.dtype and pseg.tobytes() == jseg.tobytes()
    ja = J.load_hierarchy(os.path.join(paths["jax"], "seg_hierarchy.npz"))
    pa = P.load_hierarchy(os.path.join(paths["port"], "seg_hierarchy.npz"))
    for k in ("a", "b", "saddle", "n_labels", "shape", "block_shape"):
        assert pa[k].dtype == ja[k].dtype and pa[k].tobytes() == ja[k].tobytes(), k
    blocks = file_reader(paths["port"], "r")["seg_blocks"][:]
    max_ids = [blocks[z:z + 4, y:y + 16, x:x + 16].max()
               for z in range(0, 8, 4) for y in range(0, 32, 16) for x in range(0, 32, 16)]
    assert int(pa["n_labels"]) == sum(int(m) for m in max_ids) and pa["a"].size > 10


def test_resegment_byte_identical_at_three_thresholds(built, tmp_path):
    _, paths, raw = built
    art = P.load_hierarchy(os.path.join(paths["port"], "seg_hierarchy.npz"))
    seg = file_reader(paths["port"], "r")["seg"][:].astype(np.int64)
    counts = []
    for i, t in enumerate(np.quantile(art["saddle"], [0.15, 0.5, 0.85])):
        out = _resegment_pair(tmp_path, paths, t, f"t{i}")
        assert out["port"].tobytes() == out["jax"].tobytes()
        np.testing.assert_array_equal(out["port"].astype(np.int64), P.resegment_np(seg, raw, float(t)))
        counts.append(np.unique(out["port"]).size)
    assert counts == sorted(counts, reverse=True) and counts[-1] < counts[0]


def test_table_mode_cut_equals_jax(built, tmp_path):
    _, paths, _ = built
    t = float(np.quantile(P.load_hierarchy(os.path.join(paths["port"], "seg_hierarchy.npz"))["saddle"], 0.5))
    _resegment_pair(tmp_path, paths, t, "tm", write_volume=False)
    vol = _resegment_pair(tmp_path, paths, t, "tm_vol")["port"]
    jc = J.load_cut_table(os.path.join(paths["jax"], "seg_tm_cut.npz"))
    pc = P.load_cut_table(os.path.join(paths["port"], "seg_tm_cut.npz"))
    assert not os.path.exists(os.path.join(paths["port"], "seg_tm"))
    assert sorted(pc) == sorted(jc)
    for k in pc:
        assert pc[k].dtype == jc[k].dtype and pc[k].tobytes() == jc[k].tobytes(), k
    seg = file_reader(paths["port"], "r")["seg"][:]
    np.testing.assert_array_equal(P.apply_cut_np(seg, pc["vals"], pc["roots"]).astype(np.uint64), vol)


def test_serpentine_region_merges_across_blocks(tmp_path):
    """A low-boundary corridor snaking through every block: the halo-less
    block floods split it at the block borders, and a cut above the
    corridor's values joins it again through face edges alone."""
    corridor = serpentine_mask((32, 32))
    raw = np.full((4, 32, 32), 0.9, np.float32)
    raw[:, corridor] = 0.1
    paths = _build_pair(tmp_path, raw, "serp", {"threshold": 0.5, "sigma_seeds": 1.0, "size_filter": 0})
    seg = file_reader(paths["port"], "r")["seg"][:]
    assert seg.tobytes() == jax_reader(paths["jax"], "r")["seg"][:].tobytes()
    assert np.unique(seg[seg > 0]).size > 1
    out = _resegment_pair(tmp_path, paths, 0.2, "serp")
    assert out["port"].tobytes() == out["jax"].tobytes()
    assert np.unique(out["port"][out["port"] > 0]).size == 1
    np.testing.assert_array_equal(out["port"] > 0, seg > 0)


def test_host_relabel_downgrade_warns_and_equals_device(built, tmp_path, monkeypatch):
    _, paths, _ = built
    t = float(np.quantile(P.load_hierarchy(os.path.join(paths["port"], "seg_hierarchy.npz"))["saddle"], 0.5))
    ref = _resegment_pair(tmp_path, paths, t, "dev")["port"]
    monkeypatch.setattr(ResegmentTask, "INT32_LIMIT", 1)

    def _no_device_cut(*a, **kw):
        raise AssertionError("the device cut ran on the host path")

    monkeypatch.setattr(P, "cut_table", _no_device_cut)
    config_dir = str(tmp_path / "cfg_host")
    cfg.write_global_config(config_dir, PORT_GCONF)
    cfg.write_config(config_dir, "resegment", {"threshold": t})
    with pytest.warns(RuntimeWarning, match="HOST relabel"):
        assert build([ResegmentWorkflow(str(tmp_path / "tmp_host"), config_dir,
                                        labels_path=paths["port"], labels_key="seg",
                                        output_path=paths["port"], output_key="seg_host")])
    np.testing.assert_array_equal(file_reader(paths["port"], "r")["seg_host"][:], ref)
