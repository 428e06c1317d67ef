"""PyTorch port, kernel 2: the fused per-slice DT-watershed.

The plain version of the port's kernel (``dtws_slices_plain``, what
``dtws_slices`` runs for CPU tensors) is held against the JAX package's
Pallas kernel in interpret mode: labels and seed roots exactly; the height
map within 1e-6 absolute, because the JAX kernel rounds ``1 - alpha`` in
float32 (the port rounds it from float64, as the JAX XLA path does) and its
tap sums are contracted by the CPU compiler in its own way — a few 1e-7.
The port's ``dt_watershed`` on the CPU (kernel 2's plain version, seed
ranking, size filter with kernel 1's plain version) is held against the JAX
``dt_watershed`` (XLA) on the configurations of the JAX package's own kernel
test: labels and seed counts exactly.  The CUDA kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu.ops.pallas_dtws import dtws_slices as jax_dtws_pallas
from cluster_tools_tpu.ops.watershed import dt_watershed as jax_dt_watershed
from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
from cluster_tools_tpu_torch.ops.watershed import dt_watershed


def _volume(seed, shape=(3, 16, 128), sigma=1.0):
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), sigma)
    return ((raw - raw.min()) / (raw.max() - raw.min())).astype("float32")


CONFIGS = [
    (0, dict(threshold=0.6, size_filter=5)),
    (1, dict(threshold=0.45, sigma_seeds=1.0, sigma_weights=0.0, alpha=0.9, size_filter=0)),
    (2, dict(threshold=0.55, sigma_seeds=0.0, size_filter=10, invert_input=True)),
]


def _kernel_kw(kw):
    out = {k: kw[k] for k in ("threshold", "sigma_seeds", "sigma_weights", "alpha") if k in kw}
    out["invert"] = kw.get("invert_input", False)
    return out


@pytest.mark.parametrize("seed,kw", CONFIGS)
def test_dtws_plain_matches_jax_pallas_interpret(seed, kw):
    raw = _volume(seed)
    ones = np.ones(raw.shape, np.int32)
    want_lab, want_roots, want_hmap = (np.asarray(a) for a in jax_dtws_pallas(
        jnp.asarray(raw), jnp.asarray(ones), jnp.asarray(ones), interpret=True,
        **_kernel_kw(kw),
    ))
    x = torch.from_numpy(raw)[None]
    m = torch.ones(x.shape, dtype=torch.bool)
    lab, roots, hmap = dtws_slices(x, m, m, **_kernel_kw(kw))
    np.testing.assert_array_equal(lab[0].numpy(), want_lab)
    np.testing.assert_array_equal(roots[0].numpy(), want_roots)
    np.testing.assert_allclose(hmap[0].numpy(), want_hmap, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,kw", CONFIGS)
def test_dt_watershed_matches_jax(seed, kw):
    raw = _volume(seed)
    want, nw = jax_dt_watershed(jnp.asarray(raw), **kw)
    got, ng = dt_watershed(torch.from_numpy(raw), **kw)
    assert int(ng) == int(nw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dt_watershed_mask_and_valid_matches_jax(rng):
    raw = _volume(7, (2, 8, 128))
    mask = rng.random(raw.shape) < 0.9
    valid = np.ones(raw.shape, bool)
    valid[:, -2:, :] = False  # padded batch-edge extent
    want, nw = jax_dt_watershed(
        jnp.asarray(raw), mask=jnp.asarray(mask), threshold=0.6, size_filter=4,
        valid=jnp.asarray(valid),
    )
    got, ng = dt_watershed(
        torch.from_numpy(raw), mask=torch.from_numpy(mask), threshold=0.6,
        size_filter=4, valid=torch.from_numpy(valid),
    )
    assert int(ng) == int(nw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[~valid] == 0).all()


def test_dt_watershed_batch_numbers_each_block_alone():
    """A (B, Z, H, W) batch equals its blocks run one by one: seed roots,
    ranks and the size filter's segment bound are per block."""
    raws = [_volume(s, (2, 20, 30)) for s in (3, 4, 5)]
    batch, n = dt_watershed(torch.from_numpy(np.stack(raws)), threshold=0.5, size_filter=8)
    for i, raw in enumerate(raws):
        one, n1 = dt_watershed(torch.from_numpy(raw), threshold=0.5, size_filter=8)
        assert int(n[i]) == int(n1)
        np.testing.assert_array_equal(batch[i].numpy(), one.numpy())


def test_dt_watershed_unported_modes_raise():
    """The 3d and NMS modes are ported (``tests/test_torch_dtws3d.py`` holds
    them against the JAX package) and run, and so are the flood's
    connectivity > 1 and capped floods (``tests/test_torch_flood_stats.py``
    holds them against the JAX package; here they equal JAX's on one more
    input); a pitch with the 2d EDT is refused, as in the JAX package."""
    from cluster_tools_tpu.ops.watershed import seeded_watershed as jax_seeded_watershed
    from cluster_tools_tpu_torch.ops.watershed import seeded_watershed

    x = torch.rand(2, 8, 8)
    for kw in ({"apply_dt_2d": False}, {"non_maximum_suppression": True}):
        labels, _ = dt_watershed(x, **kw)
        assert labels.shape == x.shape and labels.dtype == torch.int32
    with pytest.raises(ValueError, match="pixel_pitch"):
        dt_watershed(x, pixel_pitch=(1.0, 1.0, 1.0))
    seeds = torch.zeros(x.shape, dtype=torch.int32)
    seeds[0, 1, 1], seeds[1, 6, 5] = 1, 2
    for kw in ({"connectivity": 2}, {"max_iter": 4}):
        got = seeded_watershed(x, seeds, **kw)
        want = jax_seeded_watershed(jnp.asarray(x.numpy()), jnp.asarray(seeds.numpy()), **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
