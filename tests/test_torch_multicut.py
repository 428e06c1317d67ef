"""PyTorch port: ``ops/multicut.py`` and the native solver library against
the JAX package's.

Cost transforms, node-label overrides and edge contraction are host numpy
in both packages and must be bit-identical; the GAEC solver (the port's own
build of ``native/solvers.cpp`` and the pure-Python fallback) and the
agglomerative clustering must give the JAX package's labels on seeded
graphs, and ``multicut_energy`` its energies."""

import os

import numpy as np
import pytest

from cluster_tools_tpu import native as jnative
from cluster_tools_tpu.ops import multicut as jmc
from cluster_tools_tpu_torch import native
from cluster_tools_tpu_torch.ops import multicut as mc


def _graph(seed, n_nodes=60, n_edges=200):
    rng = np.random.default_rng(seed)
    uv = rng.integers(0, n_nodes, (n_edges, 2))
    uv = uv[uv[:, 0] != uv[:, 1]]
    uv = np.unique(np.sort(uv, axis=1), axis=0)
    costs = rng.normal(0.2, 1.0, uv.shape[0])
    return n_nodes, uv.astype(np.int64), costs


def test_native_library_builds_outside_the_tree():
    assert native.available(), native.load_error
    path = native.library_path()
    assert os.path.exists(path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == os.path.join(repo, "build", "native")
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(native.SOURCE)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_transform_bit_identical(seed):
    rng = np.random.default_rng(seed)
    probs = rng.random(100)
    probs[:3] = [0.0, 1.0, 0.5]
    sizes = rng.integers(1, 50, 100).astype(np.float64)
    for kw in ({}, {"beta": 0.3}, {"edge_sizes": sizes}, {"edge_sizes": sizes, "weighting_exponent": 0.5}):
        np.testing.assert_array_equal(
            mc.transform_probabilities_to_costs(probs, **kw),
            jmc.transform_probabilities_to_costs(probs, **kw),
        )


@pytest.mark.parametrize("mode", mc.NODE_LABEL_MODES)
def test_node_label_costs_bit_identical(mode):
    rng = np.random.default_rng(3)
    costs = rng.normal(size=50)
    lab = rng.integers(0, 3, (50, 2))
    np.testing.assert_array_equal(
        mc.apply_node_label_costs(costs, lab, mode, -10.0, 10.0),
        jmc.apply_node_label_costs(costs, lab, mode, -10.0, 10.0),
    )
    with pytest.raises(ValueError):
        mc.apply_node_label_costs(costs, lab[:10], mode, -10.0, 10.0)


def test_node_label_costs_rejects_unknown_mode():
    with pytest.raises(ValueError, match="invalid node-label mode"):
        mc.apply_node_label_costs(np.zeros(1), np.zeros((1, 2)), "merge", -1.0, 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_contract_edges_bit_identical(seed):
    rng = np.random.default_rng(seed)
    new_u = rng.integers(0, 20, 300)
    new_v = rng.integers(0, 20, 300)
    values = rng.normal(size=300)
    got = mc.contract_edges(new_u, new_v, values)
    want = jmc.contract_edges(new_u, new_v, values)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    same = np.arange(5)
    for g, w in zip(mc.contract_edges(same, same, np.ones(5)), jmc.contract_edges(same, same, np.ones(5))):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_gaec_equals_jax_native_and_python(seed):
    n, uv, costs = _graph(seed)
    want = jmc.solve_multicut(n, uv, costs)
    got_native = mc.solve_multicut(n, uv, costs)
    got_python = mc.solve_multicut(n, uv, costs, use_native=False)
    np.testing.assert_array_equal(got_native, want)
    np.testing.assert_array_equal(got_python, jmc.solve_multicut(n, uv, costs, use_native=False))
    np.testing.assert_array_equal(
        native.gaec_multicut(n, uv, costs), jnative.gaec_multicut(n, uv, costs)
    )
    np.testing.assert_array_equal(
        mc._gaec_python(n, uv, costs), jmc._gaec_python(n, uv, costs)
    )
    e = mc.multicut_energy(uv, costs, got_native)
    assert e == jmc.multicut_energy(uv, costs, want)
    assert e <= mc.multicut_energy(uv, costs, np.arange(n))  # no worse than all cut
    assert 1 < got_native.max() + 1 < n


@pytest.mark.parametrize("seed", range(3))
def test_agglomerative_clustering_equals_jax(seed):
    n, uv, _ = _graph(seed)
    rng = np.random.default_rng(seed + 10)
    weights = rng.random(uv.shape[0])
    sizes = rng.integers(1, 20, uv.shape[0]).astype(np.float64)
    for kw in ({}, {"edge_sizes": sizes}):
        for use_native in (True, False):
            np.testing.assert_array_equal(
                mc.agglomerative_clustering(n, uv, weights, 0.4, use_native=use_native, **kw),
                jmc.agglomerative_clustering(n, uv, weights, 0.4, use_native=use_native, **kw),
            )


def test_solvers_without_edges():
    empty = np.zeros((0, 2), np.int64)
    np.testing.assert_array_equal(mc.solve_multicut(4, empty, np.zeros(0)), np.arange(4))
    np.testing.assert_array_equal(
        mc.agglomerative_clustering(3, empty, np.zeros(0), 0.5), np.arange(3)
    )


def test_native_rejects_bad_inputs():
    with pytest.raises(ValueError, match="endpoints"):
        native.gaec_multicut(3, np.array([[0, 3]]), np.ones(1))
    with pytest.raises(ValueError, match="costs"):
        native.gaec_multicut(3, np.array([[0, 1]]), np.ones(2))
