"""PyTorch port, resampling: ``ops/resample.py`` against the JAX package's
``ops/resample.py`` on the CPU, on seeded inputs in [0, 1] of ragged shapes.

Contracts, on float32:
  * ``nearest`` equal bit for bit;
  * ``mean`` within 1e-6 absolute (the window is summed in
    ``lax.reduce_window``'s order, which XLA may reassociate by an ulp);
  * ``interpolate`` (``jax.image.resize``, linear, antialiased) within
    1.5e-6 absolute: the port builds JAX's weight matrices and folds their
    constants as XLA does, but XLA's fused loop rounds a few edge columns
    differently (the matrices differ by up to 1.7e-6, ``test_weights``);
  * uint8 through ``cast_resampled``: ``mean`` equal (sums of integers are
    exact), ``interpolate`` equal except where JAX's float value lies within
    1e-4 of a .5 rounding boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops import resample as jr
from cluster_tools_tpu_torch.ops import resample as tr

SHAPES = [(17, 33, 35), (8, 17, 19)]
FACTORS = [2, [1, 2, 2], [2, 3, 3]]
TOL = {"nearest": 0.0, "mean": 1e-6, "interpolate": 1.5e-6}


def volume(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_shapes_and_factors():
    assert tr.downscale_shape((33, 64, 65), 2) == jr.downscale_shape((33, 64, 65), 2) == (17, 32, 33)
    assert tr.downscale_shape((10, 64, 64), [1, 2, 2]) == (10, 32, 32)
    assert tr.per_axis_factor(3, 3) == (3, 3, 3)
    with pytest.raises(ValueError, match="does not match"):
        tr.per_axis_factor([1, 2], 3)
    with pytest.raises(ValueError, match="unknown downscaling"):
        tr.downscale(torch.zeros(4, 4, 4), 2, "cubic")
    with pytest.raises(ValueError, match="unknown upscaling"):
        tr.upscale(torch.zeros(4, 4, 4), (8, 8, 8), "cubic")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("factor", FACTORS, ids=str)
@pytest.mark.parametrize("method", ["nearest", "mean", "interpolate", "vigra", "skimage"])
def test_downscale_matches_jax(shape, factor, method):
    x = volume(shape)
    want = np.asarray(jr.downscale(jnp.asarray(x), factor, method))
    got = tr.downscale(torch.from_numpy(x), factor, method)
    assert tuple(got.shape) == want.shape == jr.downscale_shape(shape, factor)
    tol = TOL[jr.METHOD_ALIASES.get(method, method)]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("factor", FACTORS, ids=str)
@pytest.mark.parametrize("method", ["nearest", "interpolate", "mean"])
def test_upscale_matches_jax(shape, factor, method):
    x = volume(shape, 1)
    out = tuple(s * f for s, f in zip(shape, jr.per_axis_factor(factor, 3)))
    want = np.asarray(jr.upscale(jnp.asarray(x), out, method))
    got = tr.upscale(torch.from_numpy(x), out, method).numpy()
    assert got.shape == want.shape == out
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["interpolate"] if method != "nearest" else 0)


def test_upscale_nearest_keeps_integer_ids():
    labels = np.random.default_rng(2).integers(0, 2**40, (5, 7, 6)).astype(np.int64)
    want = np.asarray(jr.upscale(jnp.asarray(labels.astype(np.int32)), (10, 21, 18), "nearest"))
    got = tr.upscale(torch.from_numpy(labels), (10, 21, 18), "nearest")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy()[::2, ::3, ::3], labels)
    # the index rule is JAX's: compare on ids that fit its int32
    small = tr.upscale(torch.from_numpy(labels % 1000), (10, 21, 18), "nearest").numpy()
    np.testing.assert_array_equal(small, np.asarray(
        jr.upscale(jnp.asarray((labels % 1000).astype(np.int32)), (10, 21, 18), "nearest")))
    assert want.shape == got.shape


@pytest.mark.parametrize("factor", FACTORS, ids=str)
@pytest.mark.parametrize("method", ["mean", "interpolate"])
def test_uint8_cast_matches_jax_off_rounding_ties(factor, method):
    x = (volume((17, 33, 35), 3) * 255).astype(np.uint8)
    ref = np.asarray(jr.downscale(jnp.asarray(x), factor, method))
    want = jr.cast_resampled(ref, np.uint8)
    got = tr.cast_resampled(tr.downscale(torch.from_numpy(x), factor, method), np.uint8)
    assert got.dtype == np.uint8 and got.shape == want.shape
    if method == "mean":  # sums of integers: exact, ties included
        np.testing.assert_array_equal(got, want)
        return
    near_tie = np.abs(ref - np.floor(ref) - 0.5) < 1e-4
    np.testing.assert_array_equal(got[~near_tie], want[~near_tie])
    assert near_tie.mean() < 0.01


def test_cast_resampled_rounds_half_to_even_and_clips():
    vals = np.array([-3.0, 0.5, 1.5, 2.5, 254.5, 255.6, 70000.0], np.float32)
    for dtype in (np.uint8, np.uint16):
        want = jr.cast_resampled(vals, dtype)
        np.testing.assert_array_equal(tr.cast_resampled(torch.from_numpy(vals), dtype), want)
        np.testing.assert_array_equal(tr.cast_resampled(vals, dtype), want)
    np.testing.assert_array_equal(tr.cast_resampled(vals, np.float32), vals)


@pytest.mark.parametrize("n_in,n_out", [(17, 9), (33, 17), (35, 18), (35, 12), (9, 27), (625, 313)])
def test_weights(n_in, n_out):
    """Each output's taps sum to 1 within 2 ulp, and the matrix agrees with
    JAX's (read back through an identity resize) within 1.7e-6."""
    import jax

    w = tr.weight_matrix(n_in, n_out).numpy()
    np.testing.assert_allclose(w.sum(0), 1.0, rtol=0, atol=2.4e-7)
    want = np.asarray(jax.image.resize(np.eye(n_in, dtype=np.float32), (n_in, n_out), "linear"))
    np.testing.assert_allclose(w, want, rtol=0, atol=1.7e-6)


def test_mean_is_the_window_mean_on_divisible_shapes():
    x = volume((8, 16, 16), 4)
    got = tr.downscale(torch.from_numpy(x), [2, 2, 2], "mean")
    lib = torch.nn.functional.avg_pool3d(torch.from_numpy(x)[None, None], 2)[0, 0]
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=0, atol=1e-6)
