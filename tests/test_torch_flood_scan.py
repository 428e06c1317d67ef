"""PyTorch port: the scan algebra of the cluster route of kernels 1 and 2.

The cluster kernels (``csrc/scan.cuh``) run each Gauss-Seidel line sweep of
the flood as a scan: lanes compose the transfers of their runs, a shuffle
scan composes the runs, bands compose across the cluster, and each lane
applies its prefix to the initial carry.  ``cuda_flood``'s PyTorch copies of
those transfers (``alt_transfers``/``clamp_*`` for phase 1 and the CC,
``assign_*`` for phase 2) and of that schedule (``scan_sweep``) are held
here against the JAX package's sequential sweeps (``_sweep_altitude_seq``,
``_sweep_assign_seq``) on seeded random lines with masks, seeds, ties of the
height, BIG altitudes and unlabelled voxels, in both directions and at
random run boundaries: exact equality.  The composition of the summaries of
a line cut at random points must equal the composition of the whole line:
the property the cross-band column scan relies on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops.watershed import _sweep_altitude_seq, _sweep_assign_seq
from cluster_tools_tpu_torch.ops.cuda_flood import (
    BIG,
    BIG_DIST,
    alt_transfers,
    assign_apply,
    assign_compose,
    assign_edges,
    assign_transfers,
    clamp_apply,
    clamp_compose,
    scan_sweep,
)

LEVELS = np.float32([0.1, 0.25, 0.25, 0.5, 0.75, 0.75])  # heights with ties
SENT = 2**31 - 2


def _lines(seed, n_lines=7, n=45):
    """Flood state on lines that keeps the kernel's invariants: A = BIG off
    the mask, A = h at seeds, label 0 exactly where hops = BIG_DIST."""
    rng = np.random.default_rng(seed)
    shape = (n_lines, n)
    h = rng.choice(LEVELS, shape).astype(np.float32)
    mask = rng.random(shape) < 0.85
    seeds = np.where(mask & (rng.random(shape) < 0.15), rng.integers(1, 6, shape), 0).astype(np.int32)
    alt = np.maximum(h, rng.choice(LEVELS, shape)).astype(np.float32)
    alt = np.where(rng.random(shape) < 0.3, np.float32(BIG), alt)
    alt = np.where(seeds > 0, h, alt)
    alt = np.where(mask, alt, np.float32(BIG)).astype(np.float32)
    reached = mask & (seeds == 0) & (rng.random(shape) < 0.5)
    dist = np.where(seeds > 0, 0, np.where(reached, rng.integers(1, 5, shape), BIG_DIST)).astype(np.int32)
    label = np.where(seeds > 0, seeds, np.where(reached, rng.integers(1, 6, shape), 0)).astype(np.int32)
    return h, mask, seeds, alt, dist, label


def _cuts(seed, n):
    rng = np.random.default_rng(1000 + seed)
    return sorted(int(c) for c in rng.choice(np.arange(1, n), size=int(rng.integers(0, 9)), replace=False))


def _flip(reverse, *arrs):
    return tuple(np.ascontiguousarray(a[:, ::-1]) if reverse else a for a in arrs)


def _alt_sweep(h, mask, alt, reverse, cuts):
    h, mask, alt = (torch.from_numpy(a) for a in _flip(reverse, h, mask, alt))
    ident = (torch.full(h.shape[:1], float("inf")), torch.full(h.shape[:1], float("-inf")))
    out = scan_sweep(clamp_compose, clamp_apply, ident, alt_transfers(alt, h, mask),
                     torch.full(h.shape[:1], BIG), cuts).numpy()
    return _flip(reverse, out)[0]


def _assign_sweep(h, mask, seeds, alt, dist, label, reverse, cuts):
    h, mask, seeds, alt, dist, label = (
        torch.from_numpy(a) for a in _flip(reverse, h, mask, seeds, alt, dist, label))
    f = assign_transfers(dist, label, assign_edges(alt, h, mask, seeds))
    n = h.shape[:1]
    ident = (torch.full(n, BIG_DIST), torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64))
    d, l = scan_sweep(assign_compose, assign_apply, ident, f, ident[:2], cuts)
    return _flip(reverse, d.numpy(), l.numpy())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_altitude_scan_equals_sequential_sweep(seed, reverse):
    h, mask, seeds, alt, _, _ = _lines(seed)
    want = np.asarray(_sweep_altitude_seq(jnp.asarray(alt), jnp.asarray(h), jnp.asarray(seeds > 0),
                                          jnp.asarray(mask), 1, reverse))
    got = _alt_sweep(h, mask, alt, reverse, _cuts(seed, h.shape[1]))
    np.testing.assert_array_equal(got, want)
    assert (want != alt).any()  # the sweep had work to do


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_assign_scan_equals_sequential_sweep(seed, reverse):
    h, mask, seeds, alt, dist, label = _lines(seed)
    want_d, want_l = (np.asarray(a) for a in _sweep_assign_seq(
        jnp.asarray(dist), jnp.asarray(label), jnp.asarray(alt), jnp.asarray(h),
        jnp.asarray(seeds > 0), jnp.asarray(mask), 1, reverse))
    got_d, got_l = _assign_sweep(h, mask, seeds, alt, dist, label, reverse, _cuts(seed, h.shape[1]))
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_l, want_l)
    assert (want_l != label).any()


def _cc_sequential(roots):
    """The sequential min-label sweep of the maxima CC (csrc/dtws.cuh):
    non-members (SENT) reset the carry."""
    out = roots.copy()
    for line in out:
        carry = SENT
        for k in range(line.size):
            if line[k] == SENT:
                carry = SENT
                continue
            line[k] = min(line[k], carry)
            carry = line[k]
    return out


def _cc_roots(seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((7, 45)) < 0.7, rng.integers(0, 50, (7, 45)), SENT).astype(np.int64)


def _cc_transfers(roots):
    v = torch.from_numpy(roots)
    return v, torch.where(v == SENT, SENT, torch.iinfo(torch.int64).min)


@pytest.mark.parametrize("seed", range(4))
def test_cc_scan_equals_sequential_sweep(seed):
    roots = _cc_roots(seed)
    n = roots.shape[:1]
    ident = (torch.full(n, torch.iinfo(torch.int64).max), torch.full(n, torch.iinfo(torch.int64).min))
    got = scan_sweep(clamp_compose, clamp_apply, ident, _cc_transfers(roots),
                     torch.full(n, SENT), _cuts(seed, roots.shape[1])).numpy()
    np.testing.assert_array_equal(got, _cc_sequential(roots))


def _fold(compose, identity, transfers, a, b):
    acc = identity
    for k in range(a, b):
        acc = compose(acc, tuple(t[..., k] for t in transfers))
    return acc


def _family(kind, seed):
    h, mask, seeds, alt, dist, label = (torch.from_numpy(a) for a in _lines(seed))
    n = h.shape[:1]
    if kind == "altitude":
        return clamp_compose, (torch.full(n, float("inf")), torch.full(n, float("-inf"))), \
            alt_transfers(alt, h, mask)
    if kind == "cc":
        return clamp_compose, (torch.full(n, torch.iinfo(torch.int64).max),
                               torch.full(n, torch.iinfo(torch.int64).min)), \
            _cc_transfers(_cc_roots(seed))
    ident = (torch.full(n, BIG_DIST), torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int64))
    return assign_compose, ident, assign_transfers(dist, label, assign_edges(alt, h, mask, seeds))


@pytest.mark.parametrize("kind", ["altitude", "assign", "cc"])
@pytest.mark.parametrize("seed", range(4))
def test_segment_summaries_compose_to_the_whole_line(kind, seed):
    """A line cut at random points: composing the segments' transfers (as
    the column scan composes the bands') gives the whole line's transfer."""
    compose, ident, f = _family(kind, seed)
    n = f[0].shape[-1]
    bounds = [0, *_cuts(seed + 7, n), n]
    whole = _fold(compose, ident, f, 0, n)
    acc = ident
    for a, b in zip(bounds[:-1], bounds[1:]):
        acc = compose(acc, _fold(compose, ident, f, a, b))
    for got, want in zip(acc, whole):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _band_cuts(n, parts, lanes):
    """Run boundaries of a column of ``n`` elements as the cluster route cuts
    it: ``parts`` bands of ceil(n / parts) rows, each band's segment split
    among ``lanes`` lanes."""
    rows = -(-n // parts)
    cuts = set()
    for b0 in range(0, n, rows):
        seg = min(rows, n - b0)
        run = -(-seg // lanes)
        cuts.update(range(b0, b0 + seg, run))
    return sorted(c for c in cuts if 0 < c < n)


@pytest.mark.parametrize("phase", ["altitude", "assign"])
@pytest.mark.parametrize("seed", range(3))
def test_round_of_scans_equals_round_of_sequential_sweeps(phase, seed):
    """One round of the cluster route on an (H, W) slice: rows forward and
    back as warp scans (runs of ceil(W / 32)), then columns down and up as
    two-level scans (8 bands, 4 lanes per band segment), each sweep from the
    state the sweep before it left, equals the same four sequential sweeps
    of the JAX package."""
    h, mask, seeds, alt, dist, label = _lines(seed, n_lines=37, n=70)
    row_cuts = list(range(3, 70, 3))
    col_cuts = _band_cuts(37, 8, 4)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    sweeps = [(1, False, row_cuts), (1, True, row_cuts), (0, False, col_cuts), (0, True, col_cuts)]

    def t(a, axis):
        return np.ascontiguousarray(a.T) if axis == 0 else a

    if phase == "altitude":
        got = want = alt
        for axis, rev, cuts in sweeps:
            want = np.asarray(_sweep_altitude_seq(j(want), j(h), j(seeds > 0), j(mask), axis, rev))
            got = t(_alt_sweep(t(h, axis), t(mask, axis), t(got, axis), rev, cuts), axis)
        assert (want != alt).any()
    else:
        got = want = (dist, label)
        for axis, rev, cuts in sweeps:
            want = tuple(np.asarray(a) for a in _sweep_assign_seq(
                j(want[0]), j(want[1]), j(alt), j(h), j(seeds > 0), j(mask), axis, rev))
            got = tuple(t(a, axis) for a in _assign_sweep(
                *(t(a, axis) for a in (h, mask, seeds, alt, got[0], got[1])), rev, cuts))
        assert (want[1] != label).any()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["altitude", "assign"])
@pytest.mark.parametrize("seed", range(6))
def test_runs_side_by_side_equal_runs_one_at_a_time(kind, seed):
    """The card's ``scan_sweep`` (the runs of one length side by side) gives
    the CPU's values bit for bit, at random and at the 3d flood's cuts."""
    from cluster_tools_tpu_torch.ops.cuda_flood import kernel_cuts
    from cluster_tools_tpu_torch.ops.scan import _scan_sweep_runs, _scan_sweep_voxels

    h, mask, seeds, alt, dist, label = (torch.from_numpy(a) for a in _lines(seed, n=45))
    n = h.shape[:1]
    if kind == "altitude":
        args = (clamp_compose, clamp_apply,
                (torch.full(n, float("inf")), torch.full(n, float("-inf"))),
                alt_transfers(alt, h, mask), torch.full(n, BIG))
    else:
        ident = (torch.full(n, BIG_DIST), torch.zeros(n, dtype=torch.int64),
                 torch.zeros(n, dtype=torch.int64))
        args = (assign_compose, assign_apply, ident,
                assign_transfers(dist, label, assign_edges(alt, h, mask, seeds)), ident[:2])
    for cuts in (_cuts(seed, 45), kernel_cuts(seed % 3, 45), kernel_cuts(1, 45, True), []):
        want = _scan_sweep_voxels(*args, cuts)
        got = _scan_sweep_runs(*args, cuts)
        for g, w in zip(got if kind == "assign" else (got,), want if kind == "assign" else (want,)):
            assert g.dtype == w.dtype
            assert torch.equal(g, w), cuts
