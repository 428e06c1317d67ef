"""PyTorch port: the schedule of the 3d flood kernel and kernel 4's sweep op.

The 3d flood kernel (``csrc/flood3d.cuh``) runs each of a round's six
Gauss-Seidel sweeps as a scan over lanes' runs of at most 17 voxels: x and z
lines over the lanes of a warp (a shuffle scan, backward in reverse lane
order), y lines over the warps of a block (scanned through shared memory);
phase 2 reads a byte of six precomputed edge bits instead of the altitudes.  ``cuda_flood.flood_volume_scan`` is that schedule in
PyTorch; here it is held against the JAX package's ``_flood_scan_impl``
(sequential sweeps) on seeded (B, Z, H, W) batches with masks, height ties
and seeds, warm and cold, with the kernel's run boundaries and with random
ones: labels, altitudes and the round counts of both phases exactly (a
batch's rounds are its slowest block's).  The edge byte is checked against
the altitude test on every voxel and direction.

Kernel 4's cluster route (``csrc/cc_cluster.cuh``) sweeps with ``CttCcOp``,
the background held as the sentinel so that it resets the carry; the same
transfers under ``scan_sweep`` are held against the TPU kernel's sweep
``pallas_cc._sweep_min`` on random lines with random run boundaries, both
directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops.pallas_cc import _sweep_min
from cluster_tools_tpu.ops.watershed import _flood_scan_impl
from cluster_tools_tpu_torch.ops.cc import serpentine_mask
from cluster_tools_tpu_torch.ops.cuda_flood import (
    BIG,
    clamp_apply,
    clamp_compose,
    flood_tiles_warm_plain,
    flood_volume_plain,
    flood_volume_scan,
    kernel_cuts,
    scan_sweep,
    volume_edges,
)

SENT = 2**31 - 2
LEVELS = np.float32([0.1, 0.25, 0.4, 0.55, 0.7, 0.85])


def _batch(seed, shape):
    """(B, Z, H, W) heights quantized to a few levels (ties), a ~90% mask,
    and a few point seeds per block."""
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), (0, 0.8, 1.2, 1.2))
    raw = (raw - raw.min()) / (raw.max() - raw.min())
    h = LEVELS[np.minimum((raw * len(LEVELS)).astype(int), len(LEVELS) - 1)]
    mask = rng.random(shape) < 0.9
    seeds = np.zeros(shape, np.int32)
    for b in range(shape[0]):
        idx = rng.choice(int(np.prod(shape[1:])), 4, replace=False)
        seeds[b].flat[idx] = np.arange(1, 5) + 10 * b
    return h.astype(np.float32), seeds, mask


def _serpentine(z, w):
    """Two blocks of a one-voxel corridor snaking through (z, x), seeded at
    its start: a bend per z-row, so the flood turns between z- and x-sweeps
    in every round."""
    mask = np.zeros((2, z, 3, w), bool)
    mask[:, :, 1, :] = serpentine_mask((z, w))
    seeds = np.zeros(mask.shape, np.int32)
    seeds[0, 0, 1, 0], seeds[1, 0, 1, 0] = 1, 2
    return np.full(mask.shape, 0.5, np.float32), seeds, mask


def _warm(h, seeds, mask, tile=(4, 5)):
    hw = h.shape[-2:]
    flat = [torch.from_numpy(a).reshape((-1,) + hw) for a in (h, seeds, mask)]
    return flood_tiles_warm_plain(*flat, tile).view(h.shape).numpy()


def _jax(h, seeds, mask, warm):
    """The JAX flood of each block alone: labels, altitudes, round counts."""
    out = [_flood_scan_impl(jnp.asarray(h[b]), jnp.asarray(seeds[b]), jnp.asarray(mask[b]), 0,
                            False, None, None if warm is None else jnp.asarray(warm[b]))
           for b in range(h.shape[0])]
    labels = np.stack([np.asarray(o[0]) for o in out])
    alts = np.stack([np.asarray(o[1]) for o in out])
    rounds = (max(int(o[2]["flood_alt_iters"]) for o in out),
              max(int(o[2]["flood_assign_iters"]) for o in out))
    return labels, alts, rounds


def _random_cuts(seed):
    rng = np.random.default_rng(seed)

    def cuts(axis, n, rev):
        k = int(rng.integers(0, n))
        return sorted(int(c) for c in rng.choice(np.arange(1, n), size=min(k, n - 1), replace=False))
    return cuts


CASES = {
    "random": lambda: _batch(0, (2, 5, 13, 11)),
    "ragged": lambda: _batch(1, (2, 3, 17, 7)),
    "one slice": lambda: _batch(2, (2, 1, 9, 14)),
    "serpentine": lambda: _serpentine(6, 9),
}


@pytest.mark.parametrize("cut", ["kernel", "random"])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_scan_schedule_equals_jax_flood(case, warm, cut):
    h, seeds, mask = CASES[case]()
    w = _warm(h, seeds, mask) if warm else None
    want_l, want_a, want_r = _jax(h, seeds, mask, w)
    cuts = kernel_cuts if cut == "kernel" else _random_cuts(7)
    got_l, got_a, got_r = flood_volume_scan(
        *(torch.from_numpy(a) for a in (h, seeds, mask)),
        warm=None if w is None else torch.from_numpy(w), cuts=cuts)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    assert got_r == want_r
    # and the fixpoint is the plain version's
    np.testing.assert_array_equal(
        got_l.numpy(), flood_volume_plain(*(torch.from_numpy(a) for a in (h, seeds, mask))).numpy())
    if case == "serpentine":
        assert (got_l.numpy()[mask] == np.repeat([1, 2], mask[0].sum())).all()
        assert want_r[0] > 2 and want_r[1] > 2  # the corridor needs many rounds


def test_kernel_cuts():
    """z and x lines over the fewest lanes whose runs of 17 cover them, y
    lines over 16 warps; longer lines in tiles of 32 (y: 16) runs; backward
    sweeps cut the same runs, counted from the other end."""
    assert kernel_cuts(0, 36) == [9, 18, 27]
    assert kernel_cuts(0, 36, rev=True) == [9, 18, 27]
    assert kernel_cuts(0, 1) == []
    assert kernel_cuts(2, 272) == kernel_cuts(1, 272) == list(range(17, 272, 17))
    assert kernel_cuts(1, 270) == list(range(17, 270, 17))
    assert kernel_cuts(1, 270, rev=True) == [270 - c for c in range(255, 0, -17)]
    assert kernel_cuts(2, 20) == [10]
    assert kernel_cuts(1, 20) == list(range(2, 20, 2))
    assert kernel_cuts(1, 300) == list(range(17, 300, 17))[:15] + [272] + list(range(274, 300, 2))
    assert kernel_cuts(2, 600) == list(range(17, 544, 17)) + list(range(544, 600, 2))


@pytest.mark.parametrize("seed", range(3))
def test_edge_bits_equal_the_altitude_test(seed):
    """Bit d of the edge byte, on every voxel and direction, is the
    reference's test: in the mask, not a seed, A(p) == max(A(prev), h(p)),
    A(prev) = BIG off the mask and before the line's first voxel."""
    h, seeds, mask = _batch(10 + seed, (2, 3, 5, 6))
    _, alt, _ = _jax(h, seeds, mask, None)
    bits = volume_edges(*(torch.from_numpy(a) for a in (alt, h, mask, seeds))).numpy()
    steps = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    B, Z, H, W = h.shape
    n_set = 0
    for b, z, y, x in np.ndindex(h.shape):
        for d, (dz, dy, dx) in enumerate(steps):
            q = (z + dz, y + dy, x + dx)
            inside = 0 <= q[0] < Z and 0 <= q[1] < H and 0 <= q[2] < W
            prev = alt[(b,) + q] if inside and mask[(b,) + q] else BIG
            want = bool(mask[b, z, y, x] and seeds[b, z, y, x] == 0
                        and alt[b, z, y, x] == np.maximum(np.float32(prev), h[b, z, y, x]))
            assert bool(bits[b, z, y, x] >> d & 1) == want, (b, z, y, x, d)
            n_set += want
    assert n_set > 0


def _cc_lines(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((7, 45)) < 0.75
    labels = rng.permutation(7 * 45).reshape(7, 45).astype(np.int32)
    return np.where(mask, labels, SENT).astype(np.int32), mask


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_cc_background_scan_equals_sweep_min(seed, reverse):
    """CttCcOp with the background as the sentinel: a member holding v is
    c -> min(v, c), the background the constant sentinel (a carry reset);
    scanned over random runs it gives the TPU kernel's sweep exactly."""
    lab, mask = _cc_lines(seed)
    want = np.asarray(_sweep_min(jnp.asarray(lab), jnp.asarray(mask.astype(np.int32)), 1, reverse))
    v = torch.from_numpy(lab.astype(np.int64))
    if reverse:
        v = v.flip(-1)
    n = v.shape[:1]
    lo = torch.iinfo(torch.int64).min
    transfers = (v, torch.where(v == SENT, SENT, lo))
    ident = (torch.full(n, torch.iinfo(torch.int64).max), torch.full(n, lo))
    rng = np.random.default_rng(50 + seed)
    cuts = sorted(int(c) for c in rng.choice(np.arange(1, 45), size=int(rng.integers(0, 12)),
                                             replace=False))
    got = scan_sweep(clamp_compose, clamp_apply, ident, transfers, torch.full(n, SENT), cuts)
    if reverse:
        got = got.flip(-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != lab).any()
