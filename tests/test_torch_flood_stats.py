"""PyTorch port: the flood's remaining entry points.

Held against the JAX package on the same seeded inputs (heights quantised
to a few levels, so that ties and plateaus occur, a ~92% mask, point
seeds), on the CPU, exactly:

  * ``flood_with_stats`` flat and tiled, ``per_slice`` off and on: labels,
    altitudes and the three round counters (``flood_tile_iters``,
    ``flood_alt_iters``, ``flood_assign_iters``) equal JAX's;
  * capped floods (``max_iter`` 1, 2, 3) equal ``_seeded_watershed_scan``,
    whose result depends on its sweep schedule;
  * ``connectivity`` 2 and 3, capped and not, equal
    ``_seeded_watershed_sweep``;
  * ``flood_merge_table`` and ``seeded_watershed_hier``: labels and all
    three columns, slot by slot."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops import watershed as JW
from cluster_tools_tpu_torch.ops import watershed as W

SHAPE = (6, 20, 18)


def _fields(seed, shape=SHAPE, n_seeds=8):
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), (0.5, 1.5, 1.5))
    h = (np.round(raw * 8) / 8).astype(np.float32)
    mask = rng.random(shape) < 0.92
    seeds = np.zeros(shape, np.int32)
    seeds.flat[rng.choice(int(np.prod(shape)), n_seeds, replace=False)] = np.arange(1, n_seeds + 1)
    return h, seeds, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("tile", [None, (4, 8, 8)])
@pytest.mark.parametrize("per_slice", [False, True])
def test_flood_with_stats_equals_jax(per_slice, tile):
    h, seeds, mask = _fields(0)
    jl, ja, js = JW.flood_with_stats(*_j(h, seeds, mask), per_slice=per_slice, tile=tile)
    pl, pa, ps = W.flood_with_stats(*_t(h, seeds, mask), per_slice=per_slice, tile=tile)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    assert ps == {k: int(v) for k, v in js.items()}
    if tile is not None:
        assert ps["flood_tile_iters"] > 0


def test_flood_with_stats_ragged_tile():
    """A tile that divides no axis: the tile stack pads every axis."""
    h, seeds, mask = _fields(1, (5, 13, 11), n_seeds=5)
    jl, ja, js = JW.flood_with_stats(*_j(h, seeds, mask), tile=(2, 5, 4))
    pl, pa, ps = W.flood_with_stats(*_t(h, seeds, mask), tile=(2, 5, 4))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    assert ps == {k: int(v) for k, v in js.items()}


@pytest.mark.parametrize("max_iter", [1, 2, 3])
@pytest.mark.parametrize("per_slice", [False, True])
def test_capped_flood_equals_jax(per_slice, max_iter):
    h, seeds, mask = _fields(2)
    want = JW._seeded_watershed_scan(*_j(h, seeds, mask), max_iter=max_iter, per_slice=per_slice)
    got = W.seeded_watershed(*_t(h, seeds, mask), max_iter=max_iter, per_slice=per_slice)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = W.seeded_watershed(*_t(h, seeds, mask), per_slice=per_slice)
    if max_iter == 1:
        assert not torch.equal(got, full)  # the cap stops a flood that goes on


def test_capped_flood_of_a_batch_caps_each_block():
    fields = [_fields(s) for s in (3, 4)]
    h, seeds, mask = (np.stack(a) for a in zip(*fields))
    got = W.seeded_watershed(*_t(h, seeds, mask), max_iter=2)
    for b in range(2):
        want = JW._seeded_watershed_scan(*_j(h[b], seeds[b], mask[b]), max_iter=2)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("max_iter", [0, 2])
@pytest.mark.parametrize("connectivity", [2, 3])
def test_neighbour_sweep_flood_equals_jax(connectivity, max_iter):
    h, seeds, mask = _fields(5)
    want = JW._seeded_watershed_sweep(*_j(h, seeds, mask), connectivity, max_iter, False)
    got = W.seeded_watershed(*_t(h, seeds, mask), connectivity=connectivity, max_iter=max_iter)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_neighbour_sweep_per_slice_equals_jax():
    h, seeds, mask = _fields(6)
    want = JW._seeded_watershed_sweep(*_j(h, seeds, mask), 2, 0, True)
    got = W.seeded_watershed(*_t(h, seeds, mask), connectivity=2, per_slice=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("connectivity,per_slice", [(1, False), (2, False), (1, True), (3, False)])
def test_flood_merge_table_equals_jax(connectivity, per_slice):
    h, seeds, mask = _fields(7)
    labels = np.asarray(JW.seeded_watershed(*_j(h, seeds, mask)))
    tile = (2, 8, 8)
    want = JW.flood_merge_table(jnp.asarray(labels), jnp.asarray(h), tile,
                                connectivity=connectivity, per_slice=per_slice)
    got = W.flood_merge_table(*_t(labels, h), tile, connectivity=connectivity, per_slice=per_slice)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] > 0).any()


@pytest.mark.parametrize("coarse_tile,env", [((2, 8, 8), None), (None, "3,8,16"), (None, None)])
def test_seeded_watershed_hier_equals_jax(coarse_tile, env, monkeypatch):
    """Explicit tile, a ``CTT_CC_TILE`` pin read at call time, and the
    built-in tile (clipped to the volume)."""
    monkeypatch.delenv("CTT_FLOOD_TILE", raising=False)
    if env is None:
        monkeypatch.delenv("CTT_CC_TILE", raising=False)
    else:
        monkeypatch.setenv("CTT_CC_TILE", env)
    h, seeds, mask = _fields(8)
    jl, jt, js = JW.seeded_watershed_hier(*_j(h, seeds, mask), coarse_tile=coarse_tile)
    pl, pt, ps = W.seeded_watershed_hier(*_t(h, seeds, mask), coarse_tile=coarse_tile)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    for g, w in zip(pt, jt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert ps == {k: int(v) for k, v in js.items()}
    np.testing.assert_array_equal(pl.numpy(), W.seeded_watershed(*_t(h, seeds, mask)).numpy())
