"""PyTorch port: the 3d seeded flood and kernel 3 (the tile-local altitude
warm start).

``seeded_watershed`` of the port (on the CPU: ``flood_volume_plain``, and
``flood_tiles_warm_plain`` when a flood tile resolves) is held against the
JAX package's XLA fixpoint ``_seeded_watershed_scan``; kernel 3's plain
version against ``flood_tiles_warm`` in interpret mode.  Contract: exact
label equality (the lexicographic fixpoint is unique) and exact warm
altitudes (they are copies of height values).  The CUDA kernels themselves
are held against the plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops import cc as jax_cc
from cluster_tools_tpu.ops import watershed as JW
from cluster_tools_tpu.ops.pallas_flood import flood_tiles_warm as jax_flood_tiles_warm
from cluster_tools_tpu_torch.ops import cc, cuda_flood
from cluster_tools_tpu_torch.ops import watershed as W

BIG = np.float32(3.0e38)


def _fields(seed, shape=(12, 32, 24), n_seeds=30, masked=True):
    """tests/test_cc_coarse.py's flood fields: smoothed noise, random point
    seeds, a random 92% mask."""
    rng = np.random.default_rng(seed)
    h = ndimage.gaussian_filter(rng.random(shape).astype(np.float32), 1.5).astype(np.float32)
    seeds = np.zeros(shape, np.int32)
    pts = rng.integers(0, np.array(shape), size=(n_seeds, 3))
    for i, p in enumerate(pts):
        seeds[tuple(p)] = i + 1
    mask = rng.random(shape) < 0.92 if masked else np.ones(shape, bool)
    return h, seeds, mask


def _jax(h, seeds, mask, per_slice=False):
    return np.asarray(JW._seeded_watershed_scan(
        jnp.asarray(h), jnp.asarray(seeds), jnp.asarray(mask), per_slice=per_slice
    ))


def _port(h, seeds, mask, **kw):
    return W.seeded_watershed(*(torch.from_numpy(np.array(a)) for a in (h, seeds, mask)), **kw).numpy()


def _serpentine_zx(z, w):
    """A one-voxel corridor snaking through the (z, x) plane: every other
    z-row full, joined at alternating ends — Θ(Z·W) voxels and a bend per
    z-row, so the flood has to turn between z- and x-sweeps Θ(Z) times."""
    mask = np.zeros((z, 3, w), bool)
    mask[:, 1, :] = cc.serpentine_mask((z, w))
    seeds = np.zeros(mask.shape, np.int32)
    seeds[0, 1, 0] = 1
    return np.full(mask.shape, 0.5, np.float32), seeds, mask


@pytest.mark.parametrize("shape,masked,seed", [
    ((12, 32, 24), True, 0),
    ((12, 32, 24), False, 1),
    ((7, 19, 23), True, 2),  # ragged: no axis a multiple of any tile
    ((1, 16, 40), True, 3),  # one slice
])
@pytest.mark.parametrize("per_slice", [False, True])
def test_flood_matches_jax_fixpoint(shape, masked, seed, per_slice):
    h, seeds, mask = _fields(seed, shape, masked=masked)
    want = _jax(h, seeds, mask, per_slice)
    np.testing.assert_array_equal(_port(h, seeds, mask, per_slice=per_slice), want)


def test_flood_batch_blocks_are_independent():
    """A (B, Z, H, W) batch floods each block alone: no sweep crosses from
    one block into the next."""
    fields = [_fields(s, (6, 20, 18), n_seeds=8) for s in (4, 5, 6)]
    h, seeds, mask = (np.stack(a) for a in zip(*fields))
    got = _port(h, seeds, mask)
    for i, f in enumerate(fields):
        np.testing.assert_array_equal(got[i], _jax(*f))


def test_flood_serpentine_corridor_converges():
    """Θ(Z·W) corridor voxels with a bend per z-row: a capped round loop
    would stop short; the fixpoint floods all of it from the one seed."""
    h, seeds, mask = _serpentine_zx(16, 24)
    got = _port(h, seeds, mask)
    np.testing.assert_array_equal(got, _jax(h, seeds, mask))
    assert (got[mask] == 1).all()
    np.testing.assert_array_equal(_port(h, seeds, mask, coarse_tile=(4, 2, 8)), got)


@pytest.fixture
def flood_tile_pin(monkeypatch):
    """Set ``CTT_FLOOD_TILE`` for both packages; the JAX package reads it
    when a program is traced, so its jit caches are cleared around it."""
    def pin(value):
        monkeypatch.setenv("CTT_FLOOD_TILE", value)
        jax.clear_caches()

    yield pin
    monkeypatch.delenv("CTT_FLOOD_TILE", raising=False)
    jax.clear_caches()


@pytest.mark.parametrize("spec", ["4,8,8", "3,5,7", "16"])
def test_flood_tile_pin_keeps_labels(flood_tile_pin, spec):
    """With ``CTT_FLOOD_TILE`` set on both sides (the port then warm-starts
    from kernel 3's plain version), labels equal the unpinned flood's."""
    h, seeds, mask = _fields(7)
    unpinned = _jax(h, seeds, mask)
    calls = []
    plain = cuda_flood.flood_tiles_warm_plain

    def spy(*a):
        calls.append(a[3])
        return plain(*a)

    flood_tile_pin(spec)
    tile = W.resolve_flood_tile(h.shape)
    assert tile == JW.resolve_flood_tile(h.shape)
    np.testing.assert_array_equal(np.asarray(JW.seeded_watershed(
        jnp.asarray(h), jnp.asarray(seeds), jnp.asarray(mask))), unpinned)
    cuda_flood.flood_tiles_warm_plain, saved = spy, plain
    try:
        got = _port(h, seeds, mask)
    finally:
        cuda_flood.flood_tiles_warm_plain = saved
    assert calls == [tile[1:]]
    np.testing.assert_array_equal(got, unpinned)


def test_resolve_flood_tile_precedence(flood_tile_pin):
    """Explicit ``coarse_tile`` > the variable > None, clipped to the shape;
    an invalid variable warns and turns the warm start off."""
    shape = (12, 32, 24)
    assert W.resolve_flood_tile(shape) is None
    assert W.resolve_flood_tile(shape, (4, 64, 8)) == (4, 32, 8)
    assert W.resolve_flood_tile(shape, 5) == (5, 5, 5)
    with pytest.raises(ValueError):
        W.resolve_flood_tile(shape, (4, 8))
    flood_tile_pin("64,128")
    assert W.resolve_flood_tile(shape) == (12, 32, 24) == JW.resolve_flood_tile(shape)
    assert W.resolve_flood_tile(shape, (2, 2, 2)) == (2, 2, 2)
    for bad in ("garbage", "0,8,8", ""):
        flood_tile_pin(bad)
        with pytest.warns(RuntimeWarning, match="CTT_FLOOD_TILE"):
            assert W.resolve_flood_tile(shape) is None


@pytest.mark.parametrize("spec", ["8,64,64", "7", "2,3", "1,2,3,4", "x,1", "-1"])
def test_parse_tile_spec_matches_jax(spec):
    for ndim in (2, 3):
        assert cc.parse_tile_spec(spec, ndim) == jax_cc.parse_tile_spec(spec, ndim)


def test_warm_kernel_plain_equals_jax_pallas_interpret():
    """Exact: the tile-local altitudes of kernel 3's plain version equal the
    JAX Pallas kernel's (interpret mode) on a shape it takes."""
    h, seeds, mask = _fields(8, (3, 16, 256), n_seeds=20)
    want = np.asarray(jax_flood_tiles_warm(
        jnp.asarray(h), jnp.asarray(seeds), jnp.asarray(mask), (8, 128), interpret=True))
    got = cuda_flood.flood_tiles_warm(
        *(torch.from_numpy(a) for a in (h, seeds, mask)), (8, 128)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == BIG).all()


@pytest.mark.parametrize("tile_hw", [(5, 7), (8, 16), (32, 24)])
def test_warm_start_over_approximates_and_keeps_labels(tile_hw):
    """On ragged tiles: the warm altitudes are never below the global
    phase-1 fixpoint (a warm state below it could never be corrected, and
    labels would go wrong silently), equal it on seeds, and the flood from
    them gives the JAX labels."""
    h, seeds, mask = _fields(9)
    labels, alt, _ = JW.flood_with_stats(jnp.asarray(h), jnp.asarray(seeds), jnp.asarray(mask))
    alt = np.asarray(alt)
    t = [torch.from_numpy(a) for a in (h, seeds, mask)]
    warm = cuda_flood.flood_tiles_warm(*t, tile_hw)
    w = warm.numpy()
    assert (w >= alt).all()
    sd = (seeds > 0) & mask
    np.testing.assert_array_equal(w[sd], h[sd])
    assert (w[~mask] == BIG).all()
    assert (w < BIG).sum() > sd.sum()  # the tiles did relax something
    got = cuda_flood.flood_volume(*(a[None] for a in t), warm=warm[None])[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(labels))


def test_flood_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        cuda_flood.flood_volume(torch.zeros(2, 4, 4), torch.zeros(2, 4, 4), torch.ones(2, 4, 4))
    with pytest.raises(ValueError):
        cuda_flood.flood_tiles_warm(
            torch.zeros(2, 4, 4), torch.zeros(2, 4, 5, dtype=torch.int32),
            torch.ones(2, 4, 4, dtype=torch.bool), (2, 2))
    with pytest.raises(ValueError):
        cuda_flood.flood_tiles_warm(
            torch.zeros(2, 4, 4), torch.zeros(2, 4, 4), torch.ones(2, 4, 4), (0, 2))
