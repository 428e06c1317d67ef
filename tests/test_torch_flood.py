"""PyTorch port, kernel 1: the per-slice seeded flood.

``flood_slices_plain`` (what ``flood_slices`` runs for CPU tensors) is held
against the JAX package's XLA fixpoint (``_seeded_watershed_scan`` with
``per_slice=True``) and its Pallas kernel in interpret mode, with exact label
equality: all three compute the unique lexicographic (pass height, hops,
label) fixpoint.  The CUDA kernel itself is held against the plain version
on the card by ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops.dt import distance_transform_2d_stack
from cluster_tools_tpu.ops.pallas_flood import flood_slices as jax_flood_pallas
from cluster_tools_tpu.ops.watershed import _seeded_watershed_scan, dt_seeds
from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices


def _volume(shape, seed):
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), (0.5, 2.0, 2.0))
    return ((raw - raw.min()) / (raw.max() - raw.min())).astype(np.float32)


def _serpentine(h, w):
    mask = np.zeros((1, h, w), dtype=bool)
    for c in range(0, w - 2, 2):
        mask[0, :, c] = True
        mask[0, 0 if (c // 2) % 2 else h - 1, c + 1] = True
    seeds = np.zeros((1, h, w), dtype=np.int32)
    seeds[0, 0, 0] = 1
    return np.full((1, h, w), 0.5, dtype=np.float32), seeds, mask


def _empty_slices():
    hmap = np.ones((3, 16, 128), dtype=np.float32) * 0.5
    seeds = np.zeros((3, 16, 128), dtype=np.int32)
    mask = np.ones((3, 16, 128), dtype=bool)
    seeds[0, 2, 3] = 1
    seeds[0, 12, 100] = 2
    mask[1] = False  # fully masked slice
    seeds[2, 3, 10] = 5
    seeds[2, 3, 90] = 4
    mask[2, :, 60:64] = False  # a wall splits slice 2
    return hmap, seeds, mask


def _jax_xla(hmap, seeds, mask):
    return np.asarray(_seeded_watershed_scan(
        jnp.asarray(hmap), jnp.asarray(seeds), jnp.asarray(mask), per_slice=True
    ))


def _port(hmap, seeds, mask):
    return flood_slices(
        *(torch.from_numpy(np.array(a)) for a in (hmap, seeds, mask))
    ).numpy()


@pytest.mark.parametrize("shape,seed", [((3, 16, 128), 0), ((2, 32, 128), 5), ((2, 21, 37), 3)])
def test_flood_matches_jax_xla_fixpoint(shape, seed):
    hmap = _volume(shape, seed)
    fg = hmap < 0.6
    seeds, _ = dt_seeds(distance_transform_2d_stack(jnp.asarray(fg)), sigma=1.0, per_slice=True)
    seeds = np.asarray(seeds)
    np.testing.assert_array_equal(_port(hmap, seeds, fg), _jax_xla(hmap, seeds, fg))


@pytest.mark.parametrize("shape,seed", [((3, 16, 128), 0), ((2, 32, 128), 5)])
def test_flood_matches_jax_pallas_interpret(shape, seed):
    hmap = _volume(shape, seed)
    fg = hmap < 0.6
    seeds, _ = dt_seeds(distance_transform_2d_stack(jnp.asarray(fg)), sigma=1.0, per_slice=True)
    want = np.asarray(jax_flood_pallas(jnp.asarray(hmap), seeds, jnp.asarray(fg), interpret=True))
    np.testing.assert_array_equal(_port(hmap, np.asarray(seeds), fg), want)


def test_flood_mask_and_empty_slices():
    hmap, seeds, mask = _empty_slices()
    got = _port(hmap, seeds, mask)
    np.testing.assert_array_equal(got, _jax_xla(hmap, seeds, mask))
    want = np.asarray(jax_flood_pallas(
        jnp.asarray(hmap), jnp.asarray(seeds), jnp.asarray(mask), interpret=True
    ))
    np.testing.assert_array_equal(got, want)
    assert (got[1] == 0).all()
    assert (got[2, :, 64:][got[2, :, 64:] > 0] == 4).all()


def test_flood_serpentine_corridor_converges():
    """Θ(H·W) bends: a capped round loop would stop short of the corridor's
    end; the fixpoint floods all of it from the one seed."""
    hmap, seeds, mask = _serpentine(16, 128)
    got = _port(hmap, seeds, mask)
    np.testing.assert_array_equal(got, _jax_xla(hmap, seeds, mask))
    assert (got[mask] == 1).all()


def test_flood_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        flood_slices(torch.zeros(2, 4, 4), torch.zeros(2, 4, 5, dtype=torch.int32),
                     torch.ones(2, 4, 4, dtype=torch.bool))
