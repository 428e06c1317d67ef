"""PyTorch port, the filter bank: ``ops/filters.py`` against the JAX one.

Same numpy inputs (made from a seed) through both packages on the CPU.
Contracts: the derivative taps bitwise (float64 recipe, then the cast);
every filter response within ``atol`` 1e-6 of JAX's — the tap sums run in
another order than XLA's convolution (ROADMAP Queue C), inputs in [0, 1] —
and the hessian's eigenvalues within 1e-5·max|H|; min/max window filters
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops import filters as jf
from cluster_tools_tpu_torch.ops import filters as tf

SHAPE = (8, 16, 18)
NAMES = list(jf.FILTERS)


def _volume(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("sigma", [0.7, 1.0, 1.6, 2.5])
def test_taps_bitwise(sigma, order):
    np.testing.assert_array_equal(tf.gauss_kernel(sigma, order=order), jf._gauss_kernel(sigma, order))


@pytest.mark.parametrize("apply_in_2d", [False, True], ids=["3d", "2d"])
@pytest.mark.parametrize("sigma", [1.0, 1.6])
@pytest.mark.parametrize("name", NAMES)
def test_filter_matches_jax(name, sigma, apply_in_2d):
    x = _volume(1)
    want = np.asarray(jf.apply_filter(jnp.asarray(x), name, sigma, apply_in_2d=apply_in_2d))
    got = tf.apply_filter(torch.from_numpy(x), name, sigma, apply_in_2d=apply_in_2d).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    atol = 1e-5 * np.abs(want).max() if name == "hessianOfGaussianEigenvalues" else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if name == "hessianOfGaussianEigenvalues":
        assert (np.diff(got, axis=-1) <= 0).all()  # descending, as JAX's


@pytest.mark.parametrize("sigma", [(0.5, 1.6, 1.6), (1.0, 2.0, 1.3)])
def test_anisotropic_gaussian_matches_jax(sigma):
    """Per-axis sigmas (the anisotropic volumes' ``(sigma/aniso, sigma,
    sigma)``); JAX's other filters take one sigma."""
    x = _volume(2)
    want = np.asarray(jf.apply_filter(jnp.asarray(x), "gaussianSmoothing", sigma))
    got = tf.apply_filter(torch.from_numpy(x), "gaussianSmoothing", sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("apply_in_2d", [False, True])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_filter_channels_equal(name, ndim, apply_in_2d):
    assert tf.filter_channels(name, ndim, apply_in_2d) == jf.filter_channels(name, ndim, apply_in_2d)


def test_gaussian_derivative_matches_jax():
    x = _volume(3)
    for axis in range(3):
        want = np.asarray(jf.gaussian_derivative(jnp.asarray(x), 1.6, axis=axis))
        got = tf.gaussian_derivative(torch.from_numpy(x), 1.6, axis=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [3, (1, 7, 7), (13, 3, 1)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_min_max_filters_exact(size, dtype):
    rng = np.random.default_rng(4)
    x = (rng.integers(0, 50, (9, 14, 12)) if dtype == np.int32 else rng.random((9, 14, 12))).astype(dtype)
    for jfn, tfn in ((jf.minimum_filter, tf.minimum_filter), (jf.maximum_filter, tf.maximum_filter)):
        want = np.asarray(jfn(jnp.asarray(x), size))
        got = tfn(torch.from_numpy(x), size).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["uint8", "uint16", "float32"])
def test_normalize_input_matches_jax(kind):
    rng = np.random.default_rng(5)
    if kind == "float32":
        x = (rng.random((6, 8, 8)) * 7 - 2).astype(np.float32)
    else:
        x = rng.integers(0, np.iinfo(kind).max, (6, 8, 8)).astype(kind)
    want = np.asarray(jf.normalize_input(jnp.asarray(x)))
    got = tf.normalize_input(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
