"""PyTorch port: the schedule of the tile kernels 3 (``flood_tiles_warm``)
and 5 (``cc_tiles``), ``csrc/tile_scan.cuh``, on the CPU.

Both kernels hold a (th, tw) tile in shared memory and sweep its rows and
columns as warp scans of exact transfers: runs of up to 16 elements per
lane, lines over 512 in segments, and a line of one segment swept both
ways at once (the lesser of its forward sweep and a backward sweep of its
original values).  Kernel 5 holds its labels as tile keys ``r << k | c``
during the rounds.  ``cuda_flood.flood_tiles_warm_scan`` and
``cuda_cc.cc_tiles_scan`` are those schedules in PyTorch; here each is held,
on ragged slices, to the plain version and to the JAX Pallas kernel in
interpret mode (on the slice padded to whole tiles with background)
exactly, and kernel 3's rounds per tile to a sequential-sweep count in the
kernel's order (rows forward, rows backward, columns down, columns up).
The key map is checked to keep the order of the block-flat ids and to be
one-to-one on every tile, and the one-segment shortcut against the JAX
package's sequential sweeps.  The design variants that ``ops/tile_variants``
writes out for timing each change one line of the sources."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops.pallas_cc import _sweep_min
from cluster_tools_tpu.ops.pallas_cc import cc_tiles as jax_cc_tiles
from cluster_tools_tpu.ops.pallas_flood import flood_tiles_warm as jax_flood_tiles_warm
from cluster_tools_tpu.ops.watershed import _sweep_altitude_seq
from cluster_tools_tpu_torch.ops.cc import serpentine_mask
from cluster_tools_tpu_torch.ops.cuda_cc import (
    SENT,
    cc_tiles_plain,
    cc_tiles_scan,
    tile_key_bits,
    tile_key_ids,
)
from cluster_tools_tpu_torch.ops.cuda_flood import (
    BIG,
    alt_transfers,
    flood_tiles_warm_plain,
    flood_tiles_warm_scan,
)
from cluster_tools_tpu_torch.ops.scan import clamp_apply, clamp_compose
from cluster_tools_tpu_torch.ops import tile_variants
from cluster_tools_tpu_torch.ops.tile_scan import TILE_RUN, tile_lanes, tile_line_sweep, tiles_of
from cluster_tools_tpu_torch.ops.tile_variants import VARIANTS

LEVELS = np.float32([0.1, 0.25, 0.4, 0.55, 0.7, 0.85])
# (slice stack, tile): ragged edge tiles along both axes; the last tile's
# rows (600) are longer than one segment (32 lanes x TILE_RUN = 512)
TILES = [((2, 70, 150), (64, 128)), ((2, 13, 17), (5, 7)), ((2, 37, 53), (16, 16)),
         ((1, 11, 650), (8, 600))]
CASES = ["random", "serpentine", "empty", "full"]


def _flood_inputs(case, shape, tile, seed=0):
    """Heights on a few levels (ties), a mask and point seeds; "serpentine"
    is a corridor snaking through every tile from a seed at its corner."""
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), (0, 1.0, 1.0))
    raw = (raw - raw.min()) / (raw.max() - raw.min())
    h = LEVELS[np.minimum((raw * len(LEVELS)).astype(int), len(LEVELS) - 1)]
    seeds = np.zeros(shape, np.int32)
    idx = rng.choice(int(np.prod(shape)), max(2, int(np.prod(shape)) // 300), replace=False)
    seeds.flat[idx] = np.arange(1, len(idx) + 1)
    if case == "random":
        mask = rng.random(shape) < 0.9
    elif case == "serpentine":
        reps = (shape[0], -(-shape[1] // tile[0]), -(-shape[2] // tile[1]))
        mask = np.tile(serpentine_mask(tile), reps)[:, :shape[1], :shape[2]]
        h = np.full(shape, 0.5, np.float32)
        seeds = np.zeros(shape, np.int32)
        seeds[:, ::tile[0], ::tile[1]] = 1
    elif case == "empty":
        mask = np.zeros(shape, bool)
    else:
        mask = np.ones(shape, bool)
    return h.astype(np.float32), seeds, mask


def _cc_mask(case, shape, seed=0):
    if case == "random":
        return np.random.default_rng(seed).random(shape) < 0.6
    if case == "serpentine":
        return serpentine_mask(shape)
    return np.full(shape, case == "full")


def _padded(tile, *arrs):
    """Each (N, H, W) array padded with zeros (background) to whole tiles."""
    n, h, w = arrs[0].shape
    ph, pw = -(-h // tile[0]) * tile[0], -(-w // tile[1]) * tile[1]
    return tuple(np.pad(a, ((0, 0), (0, ph - h), (0, pw - w))) for a in arrs)


def _sequential_rounds(h, seeds, mask, tile):
    """Kernel 3's fixpoint by sequential sweeps, every tile at once (padded
    with elements that pass the carry on as the line's end does): rows
    forward, rows backward, columns down, columns up, until a round changes
    nothing.  Returns the altitudes and the rounds per tile."""
    h, seeds, mask = (torch.from_numpy(a) for a in (h, seeds, mask))
    alt = tiles_of(torch.where((seeds > 0) & mask, h, torch.full_like(h, BIG)), tile, BIG)
    hm = tiles_of(torch.where(mask, h, torch.full_like(h, float("inf"))), tile, float("inf"))
    alt, hm = alt.numpy().copy(), hm.numpy()
    rounds = np.ones(alt.shape[0], np.int32)
    while True:
        changed = np.zeros(alt.shape[0], bool)
        for axis in (2, 1):
            a, hv = np.swapaxes(alt, axis, 2), np.swapaxes(hm, axis, 2)
            for order in (range(a.shape[2]), range(a.shape[2] - 1, -1, -1)):
                carry = np.full(a.shape[:2], BIG, np.float32)
                for k in order:
                    new = np.minimum(a[:, :, k], np.maximum(carry, hv[:, :, k]))
                    changed |= (new < a[:, :, k]).any(1)
                    a[:, :, k] = new
                    carry = new
        if not changed.any():
            return alt, rounds
        rounds += changed


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape,tile", TILES)
def test_flood_tiles_warm_scan_equals_plain_jax_and_sequential_rounds(case, shape, tile):
    """Kernel 3's schedule: the plain version's and the JAX kernel's
    altitudes exactly, and the rounds per tile of the sequential sweeps."""
    h, seeds, mask = _flood_inputs(case, shape, tile)
    got, rounds = flood_tiles_warm_scan(*(torch.from_numpy(a) for a in (h, seeds, mask)), tile)
    want = flood_tiles_warm_plain(*(torch.from_numpy(a) for a in (h, seeds, mask)), tile)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    hp, sp, mp = _padded(tile, h, seeds, mask)
    jax_alt = np.asarray(jax_flood_tiles_warm(jnp.asarray(hp), jnp.asarray(sp), jnp.asarray(mp),
                                              tile, interpret=True))
    np.testing.assert_array_equal(got.numpy(), jax_alt[:, :shape[1], :shape[2]])
    seq_alt, seq_rounds = _sequential_rounds(h, seeds, mask, tile)
    np.testing.assert_array_equal(rounds.numpy(), seq_rounds)
    np.testing.assert_array_equal(
        tiles_of(got, tile, BIG).numpy(),
        np.where(tiles_of(torch.ones(shape, dtype=torch.bool), tile, False).numpy(), seq_alt, BIG))
    if case == "serpentine" and tile[0] >= 16:
        assert int(rounds.max()) > 4  # a round carries the corridor past about one bend


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape,tile", TILES)
def test_cc_tiles_scan_equals_plain_and_jax(case, shape, tile):
    """Kernel 5's schedule (labels as tile keys, the key jump, the decode):
    the plain version's labels and the JAX kernel's ids exactly, for one
    block and for blocks of depth 1."""
    mask = _cc_mask(case, shape)
    n, h, w = shape
    got = cc_tiles_scan(torch.from_numpy(mask), tile)
    torch.testing.assert_close(got, cc_tiles_plain(torch.from_numpy(mask), tile), rtol=0, atol=0)
    (mp,) = _padded(tile, mask)
    ids = np.asarray(jax_cc_tiles(jnp.asarray(mp), tile, interpret=True))[:, :h, :w].astype(np.int64)
    hp, wp = mp.shape[1:]
    z, r, c = ids // (hp * wp), ids // wp % hp, ids % wp
    want = np.where(ids >= 0, (z * h + r) * w + c, -1)
    np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(cc_tiles_scan(torch.from_numpy(mask), tile, depth=1),
                               cc_tiles_plain(torch.from_numpy(mask), tile, 1), rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(6))
def test_tile_keys_keep_id_order_and_are_one_to_one(seed):
    """On every tile, ragged ones included, the key r << k | c of a voxel
    orders the tile's voxels as their block-flat ids do, no two voxels share
    a key, and ``tile_key_ids`` decodes each key to its id."""
    rng = np.random.default_rng(seed)
    depth = int(rng.integers(1, 4))
    n, h, w = depth * int(rng.integers(1, 3)), int(rng.integers(1, 90)), int(rng.integers(1, 300))
    tile = (int(rng.integers(1, h + 8)), int(rng.integers(1, w + 40)))
    k = tile_key_bits(tile[1])
    assert 2**k >= tile[1] and (k == 0 or 2 ** (k - 1) < tile[1])
    s = torch.arange(n)[:, None, None]
    ids = ((s % depth) * h * w + torch.arange(h)[None, :, None] * w
           + torch.arange(w)[None, None, :]).expand(n, h, w)
    tid = tiles_of(ids, tile, -1)
    real = tid >= 0
    r = torch.arange(tile[0])[None, :, None].expand_as(tid)
    c = torch.arange(tile[1])[None, None, :].expand_as(tid)
    keys = torch.where(real, (r << k) | c, SENT)
    for t in range(tid.shape[0]):
        i, kk = tid[t][real[t]], keys[t][real[t]]
        order = torch.argsort(i)
        assert bool((kk[order][1:] > kk[order][:-1]).all())
        assert torch.unique(kk).numel() == kk.numel()
    torch.testing.assert_close(tile_key_ids(keys, (n, h, w), tile, depth),
                               torch.where(real, tid, -1), rtol=0, atol=0)


def _one_segment_lines(seed, n):
    """Random lines of n elements with ties, masks and seeds."""
    rng = np.random.default_rng(100 + seed)
    h = LEVELS[rng.integers(0, len(LEVELS), (12, n))]
    mask = rng.random((12, n)) < 0.85
    seeds = (rng.random((12, n)) < 0.05).astype(np.int32)
    alt = np.where((seeds > 0) & mask, h, BIG).astype(np.float32)
    return h, mask, seeds, alt


@pytest.mark.parametrize("n", [7, 64, 128, 300])
@pytest.mark.parametrize("seed", range(3))
def test_both_sweeps_at_once_equal_sequential_sweeps(seed, n):
    """A line of one segment: the lesser of its forward sweep and a backward
    sweep of its original values equals the forward sweep followed by the
    backward sweep, the JAX package's sequential sweeps (flood phase 1:
    ``_sweep_altitude_seq``; CC with the background as the sentinel:
    ``pallas_cc._sweep_min``)."""
    lanes = tile_lanes(n)
    assert lanes * TILE_RUN >= n  # one segment
    h, mask, seeds, alt = _one_segment_lines(seed, n)
    j = jnp.asarray
    want = np.asarray(_sweep_altitude_seq(j(alt), j(h), j(seeds > 0), j(mask), 1, False))
    want = np.asarray(_sweep_altitude_seq(j(want), j(h), j(seeds > 0), j(mask), 1, True))
    f = alt_transfers(*(torch.from_numpy(a) for a in (alt, h, mask)))
    line = f[0][:, 0]
    ident = (torch.full_like(line, float("inf")), torch.full_like(line, float("-inf")))
    both = [tile_line_sweep(clamp_compose, clamp_apply, ident, f, torch.full_like(line, BIG),
                            lanes, rev) for rev in (False, True)]
    np.testing.assert_array_equal(torch.minimum(*both).numpy(), want)

    lab = np.where(mask, np.arange(12 * n).reshape(12, n), SENT).astype(np.int64)
    m32 = mask.astype(np.int32)
    want = np.asarray(_sweep_min(j(lab), j(m32), 1, False))
    want = np.asarray(_sweep_min(j(want), j(m32), 1, True))
    v = torch.from_numpy(lab)
    lo, hi = torch.iinfo(torch.int64).min, torch.iinfo(torch.int64).max
    f = (v, torch.where(v == SENT, SENT, lo))
    ident = (torch.full((12,), hi), torch.full((12,), lo))
    both = [tile_line_sweep(clamp_compose, clamp_apply, ident, f, torch.full((12,), SENT),
                            lanes, rev) for rev in (False, True)]
    np.testing.assert_array_equal(torch.minimum(*both).numpy(), want)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_tile_variant_changes_one_line(tmp_path, name):
    """Each design variant of the tile kernels (``ops/tile_variants.py``) is
    a checkout whose CUDA sources differ from the package's in one line of
    the named source, where the kept design's text stood once."""
    src, kept, other = VARIANTS[name]
    d = tile_variants.write(str(tmp_path), [name])[name]
    csrc = os.path.join(os.path.dirname(tile_variants.__file__), "..", "csrc")
    for fn in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, fn)) as f:
            old = f.read().splitlines()
        with open(os.path.join(d, "cluster_tools_tpu_torch", "csrc", fn)) as f:
            new = f.read().splitlines()
        changed = [(a, b) for a, b in zip(old, new) if a != b]
        assert len(old) == len(new)
        if fn != src:
            assert not changed
        else:
            assert len(changed) == 1 and kept in changed[0][0] and other in changed[0][1]
