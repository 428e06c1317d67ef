"""PyTorch port: kernels 4-5 (per-slice and per-tile CC) and the merges
behind them, against the JAX package on the CPU.

The JAX Pallas kernels run in interpret mode, as the JAX package's own tests
run them; the port's wrappers take their plain versions for CPU tensors.
Contract: exact equality of labels — the min-label fixpoint is unique, and
both packages number components 1..n in minimal-flat-index order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops import cc as jax_cc
from cluster_tools_tpu.ops import pallas_cc as jax_pallas_cc
from cluster_tools_tpu.ops import unionfind as jax_uf
from cluster_tools_tpu_torch.ops import cc, cuda_cc, unionfind


def _mask(shape, p, seed=0):
    return np.random.default_rng(seed).random(shape) < p


def _case(kind, shape):
    if kind == "empty":
        return np.zeros(shape, bool)
    if kind == "full":
        return np.ones(shape, bool)
    if kind == "serpentine":
        return cc.serpentine_mask(shape)
    return _mask(shape, float(kind), seed=len(kind))


CASES = ["0.3", "0.6", "0.9", "empty", "full", "serpentine"]


@pytest.mark.parametrize("kind", CASES)
def test_cc_slices_plain_equals_jax_kernel(kind):
    mask = _case(kind, (3, 8, 128))
    want = np.asarray(jax_pallas_cc.cc_slices(jnp.asarray(mask), interpret=True))
    got = cuda_cc.cc_slices(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", CASES)
def test_cc_tiles_plain_equals_jax_kernel(kind):
    mask = _case(kind, (3, 16, 256))
    want = np.asarray(jax_pallas_cc.cc_tiles(jnp.asarray(mask), (8, 128), interpret=True))
    got = cuda_cc.cc_tiles(torch.from_numpy(mask), (8, 128))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tiled", [False, True])
def test_block_flat_ids_restart_per_block(tiled):
    """A (B·Z, H, W) stack with ``depth=Z`` labels each block as the JAX
    kernel labels that block alone."""
    mask = _mask((3, 4, 16, 256), 0.55, seed=4)
    stack = torch.from_numpy(mask.reshape(12, 16, 256))
    if tiled:
        got = cuda_cc.cc_tiles(stack, (8, 128), depth=4).view(mask.shape)
        want = [jax_pallas_cc.cc_tiles(jnp.asarray(m), (8, 128), interpret=True) for m in mask]
    else:
        got = cuda_cc.cc_slices(stack, depth=4).view(mask.shape)
        want = [jax_pallas_cc.cc_slices(jnp.asarray(m), interpret=True) for m in mask]
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(w) for w in want]))


@pytest.mark.parametrize("kind", CASES)
def test_connected_components_equals_jax_and_pallas_paths(kind):
    """The port's routed CC (kernel 4 + z-merge) on a batch of two blocks
    equals, per block, the JAX XLA CC, the JAX Pallas whole-slice path and
    the JAX Pallas tiled path."""
    blocks = np.stack([_case(kind, (4, 16, 128)), _mask((4, 16, 128), 0.5, seed=9)])
    got, n = cc.connected_components(torch.from_numpy(blocks))
    for i, m in enumerate(blocks):
        want, n_want = jax_cc.connected_components(jnp.asarray(m), connectivity=1)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        assert int(n[i]) == int(n_want)
        for other, n_other in (
            jax_pallas_cc.pallas_connected_components(jnp.asarray(m), interpret=True),
            jax_pallas_cc.pallas_connected_components_tiled(
                jnp.asarray(m), (8, 128), interpret=True
            ),
        ):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(other))
            assert int(n_other) == int(n[i])


@pytest.mark.parametrize("tile", [(5, 7), (16, 16), (3, 128), (64, 128)])
@pytest.mark.parametrize("kind", ["0.6", "serpentine"])
def test_merge_tiled_labels_does_not_depend_on_tile(tile, kind):
    """Kernel 5's plain version plus ``merge_tiled_labels`` at tiles that do
    and do not divide the slice equal the JAX CC."""
    blocks = np.stack([_case(kind, (3, 20, 45)), _mask((3, 20, 45), 0.7, seed=2)])
    t = torch.from_numpy(blocks)
    tiled = cuda_cc.cc_tiles(t.reshape(6, 20, 45), tile, depth=3).view(t.shape)
    got, n = cc.merge_tiled_labels(t, tiled, (1,) + tile)
    for i, m in enumerate(blocks):
        want, n_want = jax_cc.connected_components(jnp.asarray(m), connectivity=1)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        assert int(n[i]) == int(n_want)


def test_slices_over_the_whole_slice_limit_take_the_tiled_route(monkeypatch):
    """640 x 640 slices exceed ``WHOLE_SLICE_MAX``: ``connected_components``
    goes through ``cc_tiles`` and still equals the JAX CC."""
    calls = []
    real = cuda_cc.cc_tiles
    monkeypatch.setattr(cuda_cc, "cc_tiles", lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    mask = _mask((1, 2, 640, 640), 0.6, seed=5)
    assert 640 * 640 > cuda_cc.WHOLE_SLICE_MAX
    got, n = cc.connected_components(torch.from_numpy(mask))
    assert calls == [cuda_cc.default_tile(640, 640)]
    want, n_want = jax_cc.connected_components(jnp.asarray(mask[0]), connectivity=1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert int(n[0]) == int(n_want)


def test_other_connectivities_keep_plain_propagation(monkeypatch):
    """Connectivity 2-3, ``partition=`` and ``per_slice`` never reach the
    kernels (the watershed path's calls)."""
    def boom(*a, **k):
        raise AssertionError("kernel route taken")

    monkeypatch.setattr(cuda_cc, "cc_slices", boom)
    monkeypatch.setattr(cuda_cc, "cc_tiles", boom)
    m = torch.from_numpy(_mask((1, 3, 8, 16), 0.6, seed=1))
    for conn in (2, 3):
        want, _ = jax_cc.connected_components(jnp.asarray(m[0].numpy()), connectivity=conn)
        np.testing.assert_array_equal(cc.connected_components(m, conn)[0][0].numpy(), np.asarray(want))
    cc.connected_components(m, 1, per_slice=True)
    cc.connected_components_labels(m.int())


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        cuda_cc.cc_slices(torch.zeros(2, 3, 4, 4, dtype=torch.bool))
    with pytest.raises(ValueError):
        cuda_cc.cc_slices(torch.zeros(6, 4, 4, dtype=torch.bool), depth=4)
    with pytest.raises(ValueError):
        cuda_cc.cc_tiles(torch.zeros(2, 4, 4, dtype=torch.bool), (0, 4))
    # a tensor that is neither on the CPU nor on the card is refused, not
    # quietly computed by the plain version
    for fn in (lambda m: cuda_cc.cc_slices(m), lambda m: cuda_cc.cc_tiles(m, (2, 2))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros(2, 4, 4, dtype=torch.bool, device="meta"))


# -- union-find -------------------------------------------------------------


def _edges(n, m, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2)).astype(np.int32)
    e[: m // 4, 1] = e[: m // 4, 0]  # self-loops, as the JAX package pads with
    return e


@pytest.mark.parametrize("n,m", [(1, 1), (50, 20), (400, 350), (1000, 3000)])
def test_merge_labels_device_equals_jax(n, m):
    edges = _edges(n, m, n + m)
    want = np.asarray(jax_uf.merge_labels_device(jnp.arange(n, dtype=jnp.int32), jnp.asarray(edges)))
    got = unionfind.merge_labels_device(torch.arange(n), torch.from_numpy(edges))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 40, 500])
def test_merge_value_table_and_apply_equal_jax(m):
    rng = np.random.default_rng(m)
    a = rng.integers(0, 10_000, m).astype(np.int32)
    b = np.where(rng.random(m) < 0.5, a, rng.integers(0, 10_000, m)).astype(np.int32)
    vals_w, roots_w = jax_uf.merge_value_table(jnp.asarray(a), jnp.asarray(b))
    vals, roots = unionfind.merge_value_table(torch.from_numpy(a).long(), torch.from_numpy(b).long())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_w))
    np.testing.assert_array_equal(roots.numpy(), np.asarray(roots_w))
    x = rng.integers(0, 10_000, (7, 9)).astype(np.int32)
    x.flat[:m] = a[: x.size]
    want = jax_uf.apply_value_roots(jnp.asarray(x), vals_w, roots_w)
    got = unionfind.apply_value_roots(torch.from_numpy(x).long(), vals, roots)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("consecutive", [True, False])
@pytest.mark.parametrize("m", [0, 30, 600])
def test_merge_assignments_equal_jax(m, consecutive):
    n = 500
    pairs = _edges(n, m, 7 + m).astype(np.int64).reshape(-1, 2)
    want_np = jax_uf.merge_assignments_np(n, pairs, consecutive)
    want_dev = jax_uf.merge_assignments_device(n, pairs, consecutive)
    for got in (
        unionfind.merge_assignments_np(n, pairs, consecutive),
        unionfind.merge_assignments_device(n, pairs, consecutive, device="cpu"),
    ):
        for w in (want_np, want_dev):
            np.testing.assert_array_equal(got[0], w[0])
            assert got[0].dtype == w[0].dtype and got[1] == w[1]
