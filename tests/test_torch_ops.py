"""PyTorch port, block operators: filters, 2d EDT, connected components.

Each op of ``cluster_tools_tpu_torch.ops`` is held against its JAX function
on the same numpy inputs (JAX on the CPU).  Contracts: gaussian taps
bitwise, EDT exact (squared distances are integers), CC labels exact (the
minimal-flat-index numbering is schedule-independent)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops import cc as jcc
from cluster_tools_tpu.ops.dt import distance_transform_2d_stack as jax_edt
from cluster_tools_tpu.ops.filters import _gauss_kernel, gaussian as jax_gaussian
from cluster_tools_tpu_torch.ops import cc, filters
from cluster_tools_tpu_torch.ops.dt import distance_transform_2d_stack


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.6, 2.0, 3.3])
def test_gauss_kernel_taps_bitwise(sigma):
    np.testing.assert_array_equal(filters.gauss_kernel(sigma), _gauss_kernel(sigma))


def test_fma32_is_correctly_rounded(rng):
    a, b, c = (rng.standard_normal(400).astype(np.float32) * s for s in (1, 3, 1e3))
    c[:100] = -(a[:100].astype(np.float64) * b[:100]).astype(np.float32)  # cancellation
    got = filters.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(r)) - exact)
        half_ulp = Fraction(float(np.spacing(np.abs(r)))) / 2
        assert err <= half_ulp


@pytest.mark.parametrize("shape,sigma", [((3, 16, 20), 2.0), ((2, 5, 7), 2.5)])
def test_gaussian_symmetric_boundary_matches_jax(shape, sigma, rng):
    """Same taps, numpy "symmetric" boundary — also for a radius longer than
    the axis (10 > 5, 7), where the reflection cycles.  Only the order of the
    float sums differs from the JAX convolution: a few ulp."""
    x = (rng.random(shape) * 20).astype(np.float32)
    want = np.asarray(jax_gaussian(jnp.asarray(x), (0.0, sigma, sigma)))
    got = filters.gaussian(torch.from_numpy(x), (0.0, sigma, sigma)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize(
    "shape,frac", [((3, 16, 128), 0.6), ((2, 33, 17), 0.3), ((2, 8, 9), 1.0)]
)
def test_edt_2d_exact(shape, frac, rng):
    raw = ndimage.gaussian_filter(rng.random(shape), 1.5)
    fg = raw < np.quantile(raw, frac) if frac < 1 else np.ones(shape, bool)
    fg[0, 0, :] = False if frac < 1 else fg[0, 0, :]
    want = np.asarray(jax_edt(jnp.asarray(fg)))
    got = distance_transform_2d_stack(torch.from_numpy(fg)).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_cc(mask, connectivity, partition=None, per_slice=False):
    lab, n = jcc.connected_components(
        jnp.asarray(mask), connectivity=connectivity,
        partition=None if partition is None else jnp.asarray(partition),
        per_slice=per_slice,
    )
    return np.asarray(lab), int(n)


def _masks(rng):
    blob = ndimage.gaussian_filter(rng.random((4, 24, 40)), 1.5)
    return {
        "random": rng.random((3, 20, 30)) < 0.45,
        "blobs": blob > np.quantile(blob, 0.55),
        "serpentine": cc.serpentine_mask((2, 16, 32)),
    }


@pytest.mark.parametrize("name", ["random", "blobs", "serpentine"])
def test_seed_cc_per_slice_8_connected_exact(name, rng):
    mask = _masks(rng)[name]
    want, nw = _jax_cc(mask, 3, per_slice=True)
    got, n = cc.connected_components(torch.from_numpy(mask)[None], 3, per_slice=True)
    assert int(n[0]) == nw
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("name", ["random", "blobs", "serpentine"])
def test_partition_cc_exact(name, rng):
    mask = _masks(rng)[name]
    part = (rng.random(mask.shape) * 3).astype(np.int32) + 1
    labels = np.where(mask, part, 0).astype(np.int32)
    want, nw = _jax_cc(labels > 0, 1, partition=labels)
    got, n = cc.connected_components_labels(torch.from_numpy(labels)[None])
    assert int(n[0]) == nw
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_cc_batch_blocks_are_independent(rng):
    """Blocks of a batch never connect, and each is numbered on its own."""
    masks = [rng.random((2, 12, 14)) < 0.5 for _ in range(3)]
    got, n = cc.connected_components(torch.from_numpy(np.stack(masks)), 1)
    for i, m in enumerate(masks):
        want, nw = _jax_cc(m, 1)
        assert int(n[i]) == nw
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_rank_of_flat_roots_exact(rng):
    size = 500
    flat = np.full(size, -1, np.int32)
    roots = np.sort(rng.choice(size, 40, replace=False))
    flat[roots] = roots
    members = rng.choice(size, 200)
    flat[members] = roots[np.searchsorted(roots, members, side="right") - 1].clip(0)
    flat[roots] = roots
    want_rank, want_n = jcc.rank_of_flat_roots(jnp.asarray(flat), size)
    rank, n = cc.rank_of_flat_roots(torch.from_numpy(flat)[None].long(), size)
    assert int(n[0]) == int(want_n)
    np.testing.assert_array_equal(rank[0].numpy(), np.asarray(want_rank))
    want_lab, _ = jcc.consecutive_from_flat_roots(jnp.asarray(flat), size)
    lab, _ = cc.consecutive_from_flat_roots(torch.from_numpy(flat)[None].long(), size)
    np.testing.assert_array_equal(lab[0].numpy(), np.asarray(want_lab))


@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.0])
def test_dt_seeds_per_slice_matches_jax(sigma):
    from cluster_tools_tpu.ops.watershed import dt_seeds as jax_dt_seeds
    from cluster_tools_tpu_torch.ops.watershed import dt_seeds

    raw = ndimage.gaussian_filter(np.random.default_rng(4).random((3, 16, 64)), 1.5)
    fg = raw < np.quantile(raw, 0.6)
    dt = np.array(jax_edt(jnp.asarray(fg)))
    want, nw = jax_dt_seeds(jnp.asarray(dt), sigma=sigma, per_slice=True)
    got, n = dt_seeds(torch.from_numpy(dt)[None], sigma=sigma, per_slice=True)
    assert int(n[0]) == int(nw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_make_hmap_matches_jax():
    """Same blend (one FMA, as the JAX CPU build contracts it), same
    per-slice normalization; the gaussian's summation order differs from the
    JAX convolution's by a few float32 ulp."""
    from cluster_tools_tpu.ops.watershed import make_hmap as jax_make_hmap
    from cluster_tools_tpu_torch.ops.watershed import make_hmap

    rng = np.random.default_rng(6)
    x = rng.random((3, 16, 64)).astype(np.float32)
    dt = (rng.random((3, 16, 64)) * 9).astype(np.float32)
    for sigma in (0.0, 2.0):
        want = np.asarray(jax_make_hmap(jnp.asarray(x), jnp.asarray(dt), 0.8, sigma, per_slice=True))
        got = make_hmap(
            torch.from_numpy(x)[None], torch.from_numpy(dt)[None], 0.8, sigma, per_slice=True
        )[0].numpy()
        if sigma == 0.0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
