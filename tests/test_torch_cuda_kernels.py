"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the workflow on the card against the same workflow on the CPU.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)
and skips without one.  The file imports neither JAX nor the JAX package, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Contract: labels, seed roots and the height map equal the plain version bit
for bit (both round every float operation the same way); the CC kernels'
labels, kernel 3's warm altitudes and the 3d flood's labels equal their
plain versions exactly (each fixpoint is unique); the 3d flood's round
counts equal those of its schedule in PyTorch (``flood_volume_scan``, held
against the JAX package's sequential sweeps on the CPU), and the cluster
routes of kernels 1, 2 and 4 give the global routes' labels."""

import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu_torch import (
    ThresholdAndWatershedWorkflow,
    ThresholdedComponentsWorkflow,
    WatershedWorkflow,
    build,
)
from cluster_tools_tpu_torch.ops.cc import connected_components, serpentine_mask
from cluster_tools_tpu_torch.ops.cuda_cc import (
    cc_route,
    cc_slices,
    cc_slices_plain,
    cc_tiles,
    cc_tiles_plain,
)
from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_route, dtws_slices, dtws_slices_plain
from cluster_tools_tpu_torch.ops.cuda_flood import (
    flood_route,
    flood_slices,
    flood_slices_plain,
    flood_tiles_warm,
    flood_tiles_warm_plain,
    flood_tiles_warm_scan,
    flood_volume,
    flood_volume_plain,
    flood_volume_scan,
)
from cluster_tools_tpu_torch.ops.watershed import dt_watershed, seeded_watershed
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.utils import file_reader


@pytest.fixture
def cuda_device():
    """The card; the tests skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _volume(shape, seed, sigma):
    rng = np.random.default_rng(seed)
    raw = ndimage.gaussian_filter(rng.random(shape), sigma)
    return ((raw - raw.min()) / (raw.max() - raw.min())).astype(np.float32)


def _flood_case(case):
    if case == "random":
        hmap = _volume((4, 40, 70), 1, (0.5, 2.0, 2.0))
        mask = hmap < 0.6
        seeds = np.zeros(hmap.shape, np.int32)
        idx = np.random.default_rng(1).choice(hmap.size, 60, replace=False)
        seeds.flat[idx] = np.arange(1, 61)
    elif case == "empty":
        hmap = np.full((3, 16, 128), 0.5, np.float32)
        seeds = np.zeros(hmap.shape, np.int32)
        mask = np.ones(hmap.shape, bool)
        seeds[0, 2, 3], seeds[0, 12, 100] = 1, 2
        mask[1] = False
        seeds[2, 3, 10], seeds[2, 3, 90] = 5, 4
        mask[2, :, 60:64] = False
    else:
        mask = serpentine_mask((1, 32, 64))
        hmap = np.full(mask.shape, 0.5, np.float32)
        seeds = np.zeros(mask.shape, np.int32)
        seeds[0, 0, 0] = 1
    return hmap, seeds, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "empty", "serpentine"])
def test_flood_kernel_equals_plain(case, cuda_device):
    args = [torch.from_numpy(a).to(cuda_device) for a in _flood_case(case)]
    before = flood_slices.launches
    got = flood_slices(*args)
    assert flood_slices.launches == before + 1
    torch.testing.assert_close(got, flood_slices_plain(*args), rtol=0, atol=0)
    if case == "serpentine":
        assert bool((got[args[2]] == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 16, 128), (1, 4, 37, 53)])
@pytest.mark.parametrize("invert", [False, True])
def test_dtws_kernel_equals_plain(shape, invert, cuda_device):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_volume(shape, 11, (0, 0.5, 2.0, 2.0))).to(cuda_device)
    m = torch.from_numpy(rng.random(shape) < 0.95).to(cuda_device)
    v = torch.ones_like(m)
    v[..., -3:, :] = False
    before = dtws_slices.launches
    got = dtws_slices(x, m, v, threshold=0.5, invert=invert)
    assert dtws_slices.launches == before + 1
    want = dtws_slices_plain(x, m, v, threshold=0.5, invert=invert)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _band_serpentine(transpose):
    """A 256 x 256 corridor that crosses every band border of the cluster
    route along columns (runs every 8 rows) or, transposed, along rows."""
    m = serpentine_mask((256, 256), 8)
    return np.ascontiguousarray(m.T) if transpose else m


CLUSTER_CASES = ["serpentine rows", "serpentine columns", "ragged", "empty", "full",
                 "above the size rule"]


def _cluster_flood_case(case):
    if case.startswith("serpentine"):
        mask = _band_serpentine(case.endswith("columns"))[None]
        seeds = np.zeros(mask.shape, np.int32)
        seeds[0, 0, 0] = 1
        return np.full(mask.shape, 0.5, np.float32), seeds, mask
    shape = {"ragged": (29, 226, 226), "above the size rule": (2, 384, 384)}.get(case, (2, 256, 256))
    hmap = _volume(shape, 5, (0, 2.0, 2.0))
    mask = {"empty": np.zeros(shape, bool), "full": np.ones(shape, bool)}.get(case, hmap < 0.6)
    rng = np.random.default_rng(5)
    seeds = np.zeros(shape, np.int32)
    for z in range(shape[0]):
        idx = rng.choice(shape[1] * shape[2], 40, replace=False)
        seeds[z].flat[idx] = np.arange(1, 41)
    return hmap, seeds, mask


@pytest.mark.cuda
@pytest.mark.parametrize("hw,flood,dtws", [
    ((256, 256), "cluster", "cluster"),   # the main path's slices
    ((226, 226), "cluster", "cluster"),   # ragged edge blocks
    ((16, 128), "cluster", "cluster"),    # two rows per CTA
    ((362, 362), "cluster", "global"),
    ((384, 384), "global", "global"),     # above the size rule: one block per slice
])
def test_size_rule_routes(hw, flood, dtws, cuda_device):
    """The cluster routes take a slice when its band fits one CTA's 232,448 B
    of shared memory (kernel 1: 13 B per band element, kernel 2: 17 B); the
    rule is the kernels' own (``ctt_*_cluster_smem``)."""
    from cluster_tools_tpu_torch.ops import _build

    assert flood_route(*hw) == flood
    assert dtws_route(*hw, 17) == dtws
    assert _build.cluster_smem("flood", 256, 256) == 116896
    assert _build.cluster_smem("dtws", 256, 256, 17) == 152320
    assert _build.cluster_smem("flood", 384, 384) == _build.cluster_smem("dtws", 384, 384, 17) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_flood_kernel_routes_and_rounds(case, cuda_device):
    """Kernel 1 equals its plain version on both routes; slices that fit
    take the cluster route in the same rounds as the global route."""
    hmap, seeds, mask = (torch.from_numpy(a).to(cuda_device) for a in _cluster_flood_case(case))
    route = "global" if case == "above the size rule" else "cluster"
    assert flood_route(*hmap.shape[1:]) == route
    before = dict(flood_slices.launches_by_route)
    rounds = torch.zeros((hmap.shape[0], 2), dtype=torch.int32, device=cuda_device)
    got = flood_slices(hmap, seeds, mask, rounds=rounds)
    assert flood_slices.launches_by_route[route] == before[route] + 1
    torch.testing.assert_close(got, flood_slices_plain(hmap, seeds, mask), rtol=0, atol=0)
    if case.startswith("serpentine"):
        assert bool((got[mask] == 1).all())
    if route == "cluster":
        parent = torch.zeros_like(rounds)
        torch.testing.assert_close(flood_slices(hmap, seeds, mask, rounds=parent, force_global=True),
                                   got, rtol=0, atol=0)
        assert flood_slices.launches_by_route["global"] == before["global"] + 1
        torch.testing.assert_close(parent, rounds, rtol=0, atol=0)


def _cluster_dtws_case(case):
    if case.startswith("serpentine"):
        m = _band_serpentine(case.endswith("columns"))
        x = np.where(m, 0.2, 0.9).astype(np.float32)[None, None]
        return x, np.ones(x.shape, bool), np.ones(x.shape, bool)
    shape = {"ragged": (1, 29, 226, 226), "above the size rule": (1, 2, 384, 384)}.get(case, (1, 3, 256, 256))
    x = _volume(shape, 6, (0, 0.5, 2.0, 2.0))
    if case == "full":
        x = np.full(shape, 0.2, np.float32)  # all foreground: one plateau of maxima
    mask = np.zeros(shape, bool) if case == "empty" else np.ones(shape, bool)
    valid = np.ones(shape, bool)
    valid[..., -5:, :] = False
    return x, mask, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_dtws_kernel_routes_and_rounds(case, cuda_device):
    """Kernel 2 equals its plain version bit for bit on both routes; slices
    that fit take the cluster route, whose flood takes the same rounds as
    the global route's (the CC's diagonal pass may take others)."""
    x, m, v = (torch.from_numpy(a).to(cuda_device) for a in _cluster_dtws_case(case))
    route = "global" if case == "above the size rule" else "cluster"
    assert dtws_route(*x.shape[2:], 17) == route
    before = dict(dtws_slices.launches_by_route)
    rounds = torch.zeros((x.shape[0] * x.shape[1], 3), dtype=torch.int32, device=cuda_device)
    got = dtws_slices(x, m, v, threshold=0.5, rounds=rounds)
    assert dtws_slices.launches_by_route[route] == before[route] + 1
    for g, w in zip(got, dtws_slices_plain(x, m, v, threshold=0.5)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if route == "cluster":
        parent = torch.zeros_like(rounds)
        for g, w in zip(dtws_slices(x, m, v, threshold=0.5, rounds=parent, force_global=True), got):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert dtws_slices.launches_by_route["global"] == before["global"] + 1
        torch.testing.assert_close(parent[:, 1:], rounds[:, 1:], rtol=0, atol=0)
        assert int(rounds[:, 0].min()) >= 1


@pytest.mark.cuda
def test_dt_watershed_on_card_launches_both_kernels_and_equals_cpu(cuda_device):
    raw = torch.from_numpy(_volume((3, 16, 128), 0, 1.0))
    d0, f0 = dtws_slices.launches, flood_slices.launches
    got, n = dt_watershed(raw.to(cuda_device), threshold=0.6, size_filter=5)
    assert dtws_slices.launches == d0 + 1 and flood_slices.launches == f0 + 1
    want, nw = dt_watershed(raw, threshold=0.6, size_filter=5)
    assert int(n) == int(nw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_input(cuda_device):
    with pytest.raises(ValueError):
        flood_slices(torch.zeros(2, 4, 4, device=cuda_device),
                     torch.zeros(2, 4, 4, dtype=torch.int32),
                     torch.ones(2, 4, 4, dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):
        dtws_slices(torch.zeros(2, 4, 4, device=cuda_device),
                    torch.ones(2, 4, 4, dtype=torch.bool, device=cuda_device),
                    torch.ones(2, 4, 4, dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):
        flood_slices(torch.zeros(2, 4, 4, device=cuda_device),
                     torch.zeros(2, 4, 4, dtype=torch.int32, device=cuda_device),
                     torch.ones(2, 4, 4, dtype=torch.bool, device=cuda_device),
                     stamps=torch.zeros(2, 3, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        dtws_slices(torch.zeros(1, 2, 4, 4, device=cuda_device),
                    torch.ones(1, 2, 4, 4, dtype=torch.bool, device=cuda_device),
                    torch.ones(1, 2, 4, 4, dtype=torch.bool, device=cuda_device),
                    stamps=torch.zeros(2, 11, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        cc_slices(torch.ones(2, 4, 4, dtype=torch.bool, device=cuda_device),
                  rounds=torch.zeros(3, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        cc_tiles(torch.ones(2, 4, 4, dtype=torch.bool, device=cuda_device), (256, 256))
    with pytest.raises(ValueError):
        cc_tiles(torch.ones(2, 4, 4, dtype=torch.bool, device=cuda_device), (4, 4),
                 stamps=torch.zeros(2, 4, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        flood_tiles_warm(torch.zeros(2, 4, 4, device=cuda_device),
                         torch.zeros(2, 4, 4, dtype=torch.int32, device=cuda_device),
                         torch.ones(2, 4, 4, dtype=torch.bool, device=cuda_device), (4, 4),
                         stamps=torch.zeros(2, 5, dtype=torch.int32, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [[0, 0, 0], [2, 4, 4]])
def test_workflow_on_card_equals_cpu(tmp_path, halo, cuda_device):
    """The whole slice on the card (``cuda`` target, halo crop + CC re-close
    included) writes what the same config writes on the CPU."""
    path = str(tmp_path / "d.n5")
    raw = _volume((20, 41, 37), 3, (1.0, 2.0, 2.0))
    file_reader(path).create_dataset("bnd", data=raw, chunks=(12, 24, 24), compression="raw")
    for device in ("cuda", "cpu"):
        config_dir = str(tmp_path / f"configs_{device}")
        cfg.write_global_config(config_dir, {
            "block_shape": [12, 24, 24], "target": "cuda", "device": device,
            "device_batch_size": 4,
        })
        cfg.write_config(config_dir, "watershed", {"threshold": 0.5, "halo": halo})
        assert build([WatershedWorkflow(
            str(tmp_path / f"tmp_{device}"), config_dir, input_path=path, input_key="bnd",
            output_path=path, output_key=f"ws_{device}",
        )])
    out = file_reader(path, "r")
    np.testing.assert_array_equal(out["ws_cuda"][:], out["ws_cpu"][:])


def _cc_case(case):
    if case == "tall":
        return np.random.default_rng(4).random((2, 600, 70)) < 0.6
    if case == "long":
        return np.random.default_rng(5).random((2, 24, 1100)) < 0.6
    if case == "random":
        return np.random.default_rng(2).random((6, 37, 53)) < 0.6
    if case == "sparse":
        return np.random.default_rng(3).random((4, 70, 300)) < 0.3
    if case == "serpentine":
        return serpentine_mask((2, 64, 96))
    if case == "empty":
        return np.zeros((2, 16, 16), bool)
    return np.ones((2, 16, 16), bool)


CC_CASES = ["random", "sparse", "serpentine", "empty", "full"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CC_CASES)
def test_cc_slices_kernel_equals_plain(case, cuda_device):
    mask = torch.from_numpy(_cc_case(case)).to(cuda_device)
    for depth in (None, 2):
        rounds = torch.zeros(mask.shape[0], dtype=torch.int32, device=cuda_device)
        before = cc_slices.launches
        got = cc_slices(mask, depth=depth, rounds=rounds)
        assert cc_slices.launches == before + 1
        torch.testing.assert_close(got, cc_slices_plain(mask, depth), rtol=0, atol=0)
        assert int(rounds.min()) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", CC_CASES + ["tall", "long"])
@pytest.mark.parametrize("tile", [(64, 128), (5, 7), (16, 16), (32, 320), (192, 32), (8, 640),
                                  (640, 8)])
def test_cc_tiles_kernel_equals_plain(case, tile, cuda_device):
    """Tiles wider or taller than 128; lines over 512 ("tall" is 600 high,
    "long" 1100 wide, at tiles (640, 8) and (8, 640)) are swept in
    segments."""
    mask = torch.from_numpy(_cc_case(case)).to(cuda_device)
    before = cc_tiles.launches
    got = cc_tiles(mask, tile, depth=2)
    assert cc_tiles.launches == before + 1
    torch.testing.assert_close(got, cc_tiles_plain(mask, tile, 2), rtol=0, atol=0)


@pytest.mark.cuda
def test_tile_kernel_stamps(cuda_device):
    """Kernels 3 and 5 report each tile's ns per phase (``TILE_PHASES``,
    the card's clock): summed over the tiles, load, rows, columns and
    store take time; kernel 3 has no jump."""
    from cluster_tools_tpu_torch.ops.tile_scan import TILE_PHASES

    m = torch.from_numpy(_cc_case("sparse")).to(cuda_device)
    tiles = m.shape[0] * 2 * 3
    st = torch.zeros((tiles, len(TILE_PHASES)), dtype=torch.int64, device=cuda_device)
    got = cc_tiles(m, (64, 128), depth=2, stamps=st)
    torch.testing.assert_close(got, cc_tiles_plain(m, (64, 128), 2), rtol=0, atol=0)
    assert bool((st >= 0).all()) and bool((st.sum(0) > 0).all())
    h = torch.rand(m.shape, device=cuda_device)
    s = torch.zeros(m.shape, dtype=torch.int32, device=cuda_device)
    s[:, ::16, ::16] = 1
    st.zero_()
    got = flood_tiles_warm(h, s, m, (64, 128), stamps=st)
    torch.testing.assert_close(got, flood_tiles_warm_plain(h, s, m, (64, 128)), rtol=0, atol=0)
    jump = TILE_PHASES.index("jump")
    assert bool((st[:, jump] == 0).all()) and bool((st >= 0).all())
    assert bool((torch.cat([st[:, :jump], st[:, jump + 1:]], 1).sum(0) > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 5, 64, 96), (1, 2, 640, 640)])
def test_connected_components_on_card_equals_cpu(shape, cuda_device):
    """Both routes (kernel 4 + z-merge, kernel 5 + tile-face merge) on the
    card give the CPU's labels."""
    mask = torch.from_numpy(np.random.default_rng(5).random(shape) < 0.6)
    s0, t0 = cc_slices.launches, cc_tiles.launches
    got, n = connected_components(mask.to(cuda_device))
    assert (cc_slices.launches - s0, cc_tiles.launches - t0) == (
        (1, 0) if shape[-1] < 640 else (0, 1)
    )
    want, nw = connected_components(mask)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(n.cpu().numpy(), nw.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["less", "greater"])
def test_components_workflow_on_card_equals_cpu(tmp_path, mode, cuda_device):
    """The thresholded-components slice on the card (``cuda`` target:
    kernel 4, device merge of the assignments) writes what the same config
    writes on the CPU, and scipy's partition."""
    path = str(tmp_path / "d.n5")
    raw = _volume((20, 41, 37), 4, (1.0, 2.0, 2.0))
    file_reader(path).create_dataset("raw", data=raw, chunks=(12, 24, 24), compression="raw")
    for device in ("cuda", "cpu"):
        config_dir = str(tmp_path / f"configs_{device}")
        cfg.write_global_config(config_dir, {
            "block_shape": [12, 24, 24], "target": "cuda", "device": device,
            "device_batch_size": 4,
        })
        cfg.write_config(config_dir, "block_components", {"threshold": 0.5, "threshold_mode": mode})
        before = cc_slices.launches
        assert build([ThresholdedComponentsWorkflow(
            str(tmp_path / f"tmp_{device}"), config_dir, input_path=path, input_key="raw",
            output_path=path, output_key=f"cc_{device}",
        )])
        assert (cc_slices.launches > before) == (device == "cuda")
    out = file_reader(path, "r")
    got = out["cc_cuda"][:]
    np.testing.assert_array_equal(got, out["cc_cpu"][:])
    fg = raw < 0.5 if mode == "less" else raw > 0.5
    want, n = ndimage.label(fg)
    assert got.max() == n and ((got > 0) == fg).all()
    assert len(np.unique(np.stack([got[fg], want[fg]], axis=1), axis=0)) == n


def _flood3d_case(case):
    """(B, Z, H, W) height map, seeds and mask."""
    if case == "random":
        rng = np.random.default_rng(7)
        hmap = np.stack([_volume((9, 37, 70), s, (1.0, 2.0, 2.0)) for s in (7, 8)])
        seeds = np.zeros(hmap.shape, np.int32)
        idx = rng.choice(hmap.size, 80, replace=False)
        seeds.flat[idx] = np.arange(1, 81)
        mask = rng.random(hmap.shape) < 0.9
    elif case == "serpentine":
        # a corridor snaking through the (z, x) plane: a bend per z-row
        mask = np.zeros((1, 24, 3, 40), bool)
        mask[0, :, 1, :] = serpentine_mask((24, 40))
        hmap = np.full(mask.shape, 0.5, np.float32)
        seeds = np.zeros(mask.shape, np.int32)
        seeds[0, 0, 1, 0] = 1
    elif case == "large":  # slices over 512 along both axes
        hmap = _volume((1, 2, 600, 700), 9, (0, 1.0, 2.0, 2.0))
        seeds = np.zeros(hmap.shape, np.int32)
        idx = np.random.default_rng(9).choice(hmap.size, 40, replace=False)
        seeds.flat[idx] = np.arange(1, 41)
        mask = hmap < 0.7
    else:  # in-plane serpentine in every slice, one seed per slice
        mask = serpentine_mask((2, 4, 32, 64))
        hmap = np.full(mask.shape, 0.5, np.float32)
        seeds = np.zeros(mask.shape, np.int32)
        seeds[:, :, 0, 0] = np.arange(1, 9).reshape(2, 4)
    return hmap, seeds, mask


FLOOD3D_CASES = ["random", "serpentine", "serpentine_slices"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLOOD3D_CASES + ["large"])
@pytest.mark.parametrize("tile", [(64, 128), (5, 7), (16, 16), (32, 320), (192, 32), (8, 640),
                                  (640, 8)])
def test_flood_tiles_warm_kernel_equals_plain(case, tile, cuda_device):
    """Altitudes of the plain version, and the rounds per tile of the
    kernel's schedule in PyTorch (``flood_tiles_warm_scan``); "large"
    slices (600 x 700) sweep lines over 512 in segments."""
    h, s, m = (torch.from_numpy(a).to(cuda_device) for a in _flood3d_case(case))
    h, s, m = (t.reshape((-1,) + t.shape[-2:]) for t in (h, s, m))
    n_tiles = h.shape[0] * -(-h.shape[1] // min(tile[0], h.shape[1])) * -(-h.shape[2] // min(tile[1], h.shape[2]))
    rounds = torch.zeros(n_tiles, dtype=torch.int32, device=cuda_device)
    before = flood_tiles_warm.launches
    got = flood_tiles_warm(h, s, m, tile, rounds=rounds)
    assert flood_tiles_warm.launches == before + 1
    torch.testing.assert_close(got, flood_tiles_warm_plain(h, s, m, tile), rtol=0, atol=0)
    assert int(rounds.min()) >= 1
    torch.testing.assert_close(rounds, flood_tiles_warm_scan(h, s, m, tile)[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLOOD3D_CASES)
@pytest.mark.parametrize("warm", [False, True])
def test_flood_volume_kernel_equals_plain(case, warm, cuda_device):
    h, s, m = (torch.from_numpy(a).to(cuda_device) for a in _flood3d_case(case))
    w = None
    if warm:
        hw = h.shape[-2:]
        w = flood_tiles_warm(h.reshape((-1,) + hw), s.reshape((-1,) + hw),
                             m.reshape((-1,) + hw), (16, 32)).view(h.shape)
    stats = {}
    before = flood_volume.launches
    got = flood_volume(h, s, m, warm=w, stats=stats)
    assert flood_volume.launches == before + 1
    torch.testing.assert_close(got, flood_volume_plain(h, s, m, warm=w), rtol=0, atol=0)
    assert stats["flood_alt_iters"] >= 1 and stats["flood_assign_iters"] >= 1
    if case == "serpentine":
        assert bool((got[m] == 1).all())


def _random_batch(shape, seed, mask_frac=0.9):
    rng = np.random.default_rng(seed)
    hmap = _volume(shape, seed, (0, 1.0, 2.0, 2.0))
    seeds = np.zeros(shape, np.int32)
    for b in range(shape[0]):
        idx = rng.choice(int(np.prod(shape[1:])), 12, replace=False)
        seeds[b].flat[idx] = np.arange(1, 13) + 100 * b
    mask = rng.random(shape) < mask_frac
    return hmap, seeds, mask


def _corridor(mask):
    """A corridor mask with a seed at the first voxel of each block."""
    seeds = np.zeros(mask.shape, np.int32)
    for b in range(mask.shape[0]):
        seeds[(b,) + tuple(int(i[0]) for i in np.nonzero(mask[b]))] = b + 1
    return np.full(mask.shape, 0.5, np.float32), seeds, mask


def _flood3d_round_case(case):
    """(B, Z, H, W) cases of the 3d flood's schedule: corridors along each
    axis pair (in-plane ones crossing the y sweep's 32-column strips and
    row segments and the x sweep's lane runs), batches, one slice, ragged
    and uniform masks."""
    if case == "serpentine zx":
        mask = np.zeros((1, 24, 3, 40), bool)
        mask[0, :, 1, :] = serpentine_mask((24, 40))
    elif case == "serpentine zy":
        mask = np.zeros((1, 24, 40, 3), bool)
        mask[0, :, :, 1] = serpentine_mask((24, 40))
    elif case == "serpentine rows":  # along x, bends along y
        mask = serpentine_mask((1, 2, 40, 70))
    elif case == "serpentine columns":  # along y, bends along x across strips
        mask = np.ascontiguousarray(np.swapaxes(serpentine_mask((1, 2, 70, 40)), -1, -2))
    elif case == "batch of 8":
        return _random_batch((8, 4, 40, 45), 21)
    elif case == "batch of 2":
        return _random_batch((2, 9, 37, 70), 22)
    elif case == "one slice":
        return _random_batch((2, 1, 50, 70), 23)
    elif case == "ragged":
        return _random_batch((1, 7, 37, 53), 24)
    elif case == "two-block kernel":  # 8.4 M voxels: the kernel for large batches
        hmap, _, mask = _random_batch((2, 64, 256, 256), 27)
        rng = np.random.default_rng(27)  # dense seeds: few rounds, quick plain versions
        seeds = np.where(rng.random(hmap.shape) < 0.3, rng.integers(1, 1000, hmap.shape), 0)
        return hmap, seeds.astype(np.int32), mask
    elif case.startswith("long"):  # lines over a tile of runs: the carry passed on
        return _random_batch({"long z": (1, 560, 2, 3), "long y": (1, 2, 300, 40),
                              "long x": (1, 2, 3, 560)}[case], 26)
    else:
        hmap, seeds, mask = _random_batch((2, 4, 33, 65), 25)
        return hmap, seeds, np.full(mask.shape, case == "full")
    return _corridor(mask)


FLOOD3D_ROUND_CASES = ["serpentine zx", "serpentine zy", "serpentine rows", "serpentine columns",
                       "batch of 8", "batch of 2", "one slice", "ragged", "long z", "long y",
                       "long x", "two-block kernel", "empty", "full"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLOOD3D_ROUND_CASES)
@pytest.mark.parametrize("warm", [False, True])
def test_flood_volume_rounds_equal_schedule(case, warm, cuda_device):
    """The kernel's labels equal the plain version's and its rounds of both
    phases those of the sequential-sweep round loop (``flood_volume_scan``,
    the same counts as the JAX package's)."""
    h, s, m = (torch.from_numpy(a).to(cuda_device) for a in _flood3d_round_case(case))
    w = None
    if warm:
        hw = h.shape[-2:]
        w = flood_tiles_warm(h.reshape((-1,) + hw), s.reshape((-1,) + hw),
                             m.reshape((-1,) + hw), (8, 16)).view(h.shape)
    stats = {}
    got = flood_volume(h, s, m, warm=w, stats=stats)
    torch.testing.assert_close(got, flood_volume_plain(h, s, m, warm=w), rtol=0, atol=0)
    want_l, _, rounds = flood_volume_scan(h, s, m, warm=w)
    torch.testing.assert_close(got, want_l, rtol=0, atol=0)
    assert (stats["flood_alt_iters"], stats["flood_assign_iters"]) == rounds
    if case.startswith("serpentine"):
        assert bool((got[m] == torch.arange(1, m.shape[0] + 1, device=cuda_device)
                     .view(-1, 1, 1, 1).expand_as(got)[m]).all())
        assert min(rounds) > 2
    if case == "empty":
        assert not bool(got.any())


CC_CLUSTER_CASES = ["serpentine rows", "serpentine columns", "ragged", "empty", "full",
                    "above the size rule"]


def _cc_cluster_case(case):
    if case.startswith("serpentine"):
        return _band_serpentine(case.endswith("columns"))[None], 1
    shape = {"ragged": (29, 226, 226), "above the size rule": (2, 700, 700)}.get(case, (4, 256, 256))
    if case in ("empty", "full"):
        return np.full(shape, case == "full"), 2
    return np.random.default_rng(8).random(shape) < 0.6, shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CC_CLUSTER_CASES)
def test_cc_slices_routes(case, cuda_device):
    """Kernel 4 equals its plain version on both routes; slices that fit
    take the cluster route (40,576 B per CTA at 256 x 256, the rule of
    ``ctt_cc_cluster_smem``), and ``force_global`` the parent design."""
    from cluster_tools_tpu_torch.ops import _build

    mask_np, depth = _cc_cluster_case(case)
    mask = torch.from_numpy(mask_np).to(cuda_device)
    route = "global" if case == "above the size rule" else "cluster"
    assert cc_route(*mask.shape[1:]) == route
    assert _build.cluster_smem("cc", 256, 256) == 40576
    want = cc_slices_plain(mask, depth)
    rounds = torch.zeros(mask.shape[0], dtype=torch.int32, device=cuda_device)
    before = dict(cc_slices.launches_by_route)
    got = cc_slices(mask, depth=depth, rounds=rounds)
    assert cc_slices.launches_by_route[route] == before[route] + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(rounds.min()) >= 1
    if case.startswith("serpentine"):
        assert bool((got[mask] == 0).all())
    parent = cc_slices(mask, depth=depth, force_global=True)
    assert cc_slices.launches_by_route["global"] == before["global"] + 1 + (route == "global")
    torch.testing.assert_close(parent, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_seeded_watershed_on_card_equals_cpu(cuda_device, monkeypatch):
    """The dispatch on the card: the 3d flood (warm-started by kernel 3 when
    CTT_FLOOD_TILE is set) and the per-slice flood give the CPU's labels."""
    h, s, m = (torch.from_numpy(a) for a in _flood3d_case("random"))
    want = seeded_watershed(h, s, m)
    for pin in (None, "4,16,32"):
        if pin:
            monkeypatch.setenv("CTT_FLOOD_TILE", pin)
        k0, v0 = flood_tiles_warm.launches, flood_volume.launches
        got = seeded_watershed(h.to(cuda_device), s.to(cuda_device), m.to(cuda_device))
        assert (flood_tiles_warm.launches - k0, flood_volume.launches - v0) == (1 if pin else 0, 1)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    got = seeded_watershed(h.to(cuda_device), s.to(cuda_device), m.to(cuda_device), per_slice=True)
    np.testing.assert_array_equal(got.cpu().numpy(), seeded_watershed(h, s, m, per_slice=True).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [(False, False), (True, False), (False, True)])
def test_dt_watershed_3d_modes_on_card_equal_cpu(mode, cuda_device):
    raw = torch.from_numpy(np.stack([_volume((8, 24, 28), s, (1.0, 2.0, 2.0)) for s in (1, 2)]))
    kw = dict(threshold=0.5, apply_dt_2d=mode[0], apply_ws_2d=mode[1], size_filter=10,
              pixel_pitch=None if mode[0] else (2.5, 1.3, 0.7))
    got, n = dt_watershed(raw.to(cuda_device), **kw)
    want, nw = dt_watershed(raw, **kw)
    np.testing.assert_array_equal(n.cpu().numpy(), nw.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_seeds_workflow_on_card_equals_cpu(tmp_path, cuda_device, monkeypatch):
    """``ThresholdAndWatershedWorkflow`` on the card (``cuda`` target, a
    flood tile pinned) writes what the same config writes on the CPU."""
    monkeypatch.setenv("CTT_FLOOD_TILE", "4,16,16")
    path = str(tmp_path / "d.n5")
    raw = _volume((20, 41, 37), 5, (1.0, 2.0, 2.0))
    file_reader(path).create_dataset("bnd", data=raw, chunks=(12, 24, 24), compression="raw")
    for device in ("cuda", "cpu"):
        config_dir = str(tmp_path / f"configs_{device}")
        cfg.write_global_config(config_dir, {
            "block_shape": [12, 24, 24], "target": "cuda", "device": device, "max_jobs": 4,
        })
        cfg.write_config(config_dir, "block_components", {"threshold": 0.4, "threshold_mode": "less"})
        cfg.write_config(config_dir, "watershed_from_seeds", {"sigma_weights": 1.0, "halo": [2, 6, 6]})
        k0, v0 = flood_tiles_warm.launches, flood_volume.launches
        assert build([ThresholdAndWatershedWorkflow(
            str(tmp_path / f"tmp_{device}"), config_dir, input_path=path, input_key="bnd",
            output_path=path, output_key=f"seg_{device}",
        )])
        n_blocks = 2 * 2 * 2
        expect = n_blocks if device == "cuda" else 0
        assert (flood_tiles_warm.launches - k0, flood_volume.launches - v0) == (expect, expect)
    out = file_reader(path, "r")
    for key in ("seg_{}_seeds", "seg_{}"):
        np.testing.assert_array_equal(out[key.format("cuda")][:], out[key.format("cpu")][:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,owner", [((12, 40, 40), None), ((9, 33, 33), (8, 32, 32))])
def test_rag_accumulator_on_card_equals_cpu(shape, owner, cuda_device):
    """The device RAG accumulator (plain PyTorch) on the card against the
    same function on CPU tensors: edges, counts, histograms, minima, maxima
    and quantiles equal; the float32 moments (atomic sums on the card) to
    the reference's tolerances.  One call on the card counts one launch."""
    from cluster_tools_tpu_torch.ops import rag

    rng = np.random.default_rng(11)
    labels = rng.integers(0, 30, shape).astype(np.uint64) * np.uint64(1000)
    values = rng.random(shape).astype(np.float32)
    before = rag.boundary_edge_features_device.launches
    got = rag.boundary_edge_features_gpu(
        labels, values, hist_bins=rag.HIST_BINS, owner_shape=owner, device=cuda_device
    )
    assert rag.boundary_edge_features_device.launches == before + 1
    want = rag.boundary_edge_features_gpu(
        labels, values, hist_bins=rag.HIST_BINS, owner_shape=owner, device="cpu"
    )
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1][:, 2:], want[1][:, 2:])
    np.testing.assert_allclose(got[1][:, 0], want[1][:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1][:, 1], want[1][:, 1], rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_multicut_workflow_on_card_equals_cpu(tmp_path, cuda_device):
    """``MulticutSegmentationWorkflow`` on the card (the 2d watershed's
    kernels, host features) writes what it writes on the CPU."""
    from cluster_tools_tpu_torch import MulticutSegmentationWorkflow

    path = str(tmp_path / "d.n5")
    raw = _volume((24, 48, 48), 5, (1.0, 2.0, 2.0))
    file_reader(path).create_dataset("bnd", data=raw, chunks=(12, 24, 24), compression="raw")
    for device in ("cuda", "cpu"):
        config_dir = str(tmp_path / f"configs_{device}")
        cfg.write_global_config(config_dir, {
            "block_shape": [12, 24, 24], "target": "cuda", "device": device,
            "device_batch_size": 4,
        })
        cfg.write_config(config_dir, "watershed", {"threshold": 0.5})
        assert build([MulticutSegmentationWorkflow(
            str(tmp_path / f"tmp_{device}"), config_dir, input_path=path, input_key="bnd",
            ws_path=path, ws_key=f"ws_{device}", output_path=path, output_key=f"seg_{device}",
        )])
    out = file_reader(path, "r")
    np.testing.assert_array_equal(out["ws_cuda"][:], out["ws_cpu"][:])
    np.testing.assert_array_equal(out["seg_cuda"][:], out["seg_cpu"][:])


def _mws_graph(case):
    """Graphs for the device mutex watershed: a tie-heavy random graph, a
    smoothed affinity grid (the workflow's kind of problem) and a monotone
    chain (one round with chain contraction, one per merge without)."""
    from cluster_tools_tpu_torch.ops.mws import _affinity_edge_lists

    rng = np.random.default_rng(7)
    if case == "random":
        n = 4000
        uv = rng.integers(0, n, (40000, 2))
        uv = uv[uv[:, 0] != uv[:, 1]]
        return n, uv, rng.integers(0, 32, len(uv)) / 32.0, rng.random(len(uv)) < 0.6
    if case == "grid":
        offsets = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, -1], [-2, 0, 0], [0, -3, 0],
                            [0, 0, -3], [-3, -3, -3], [-3, 3, 3]])
        shape = (6, 24, 24)  # smooth affinities take ~n**0.8 rounds: keep the CPU run short
        affs = ndimage.gaussian_filter(rng.random((8,) + shape), (0, 1, 2, 2))
        affs = (np.round(affs * 256) / 256).astype(np.float32)
        us, vs, ws, att = _affinity_edge_lists(affs, offsets, None, False, 0.0, rng, 3)
        uv = np.stack([np.concatenate(us), np.concatenate(vs)], axis=1)
        return int(np.prod(shape)), uv, np.concatenate(ws), np.concatenate(att)
    n = 2048
    uv = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return n, uv, np.linspace(1.0, 0.5, n - 1), np.ones(n - 1, bool)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "grid", "chain"])
def test_device_mws_on_card_equals_cpu(case, cuda_device):
    """The device MWS (plain PyTorch) on the card against the same function
    on CPU tensors: the same labels and the same rounds, with chain
    contraction on and off; the partition of the native solver.  One call
    on the card counts one launch."""
    from cluster_tools_tpu_torch import native
    from cluster_tools_tpu_torch.ops import mws_device

    n, uv, w, att = _mws_graph(case)
    before = mws_device.mutex_watershed_device.launches
    got = mws_device.mutex_watershed_device(n, uv, w, att, device=cuda_device)
    assert mws_device.mutex_watershed_device.launches == before + 1
    np.testing.assert_array_equal(got, mws_device.mutex_watershed_device(n, uv, w, att, device="cpu"))
    for chain in (True, False):
        assert mws_device.mutex_watershed_device_rounds(
            n, uv, w, att, enable_chain=chain, device=cuda_device,
        ) == mws_device.mutex_watershed_device_rounds(n, uv, w, att, enable_chain=chain, device="cpu")
    host = native.mutex_watershed(n, uv, np.asarray(w, np.float32), att)
    pairs = np.unique(np.stack([got, host], axis=1), axis=0)
    assert len(pairs) == len(np.unique(got)) == len(np.unique(host))


@pytest.mark.cuda
def test_mws_workflow_device_mode_on_card_equals_cpu(tmp_path, cuda_device):
    """``MwsWorkflow`` with ``CTT_MWS_MODE=device`` on the card writes what
    it writes with the device formulation on the CPU."""
    from cluster_tools_tpu_torch import MwsWorkflow
    from cluster_tools_tpu_torch.ops.mws import force_mws_mode

    affs = np.random.default_rng(3).random((8, 16, 48, 48))
    path = str(tmp_path / "d.n5")
    file_reader(path).create_dataset("affs", data=np.round(255 * affs).astype(np.uint8),
                                     chunks=(1, 8, 24, 24), compression="raw")
    for device in ("cuda", "cpu"):
        config_dir = str(tmp_path / f"configs_{device}")
        cfg.write_global_config(config_dir, {
            "block_shape": [8, 24, 24], "target": "cuda", "device": device, "max_jobs": 2,
        })
        with force_mws_mode("device"):
            assert build([MwsWorkflow(
                str(tmp_path / f"tmp_{device}"), config_dir, input_path=path, input_key="affs",
                output_path=path, output_key=f"seg_{device}",
            )])
    out = file_reader(path, "r")
    np.testing.assert_array_equal(out["seg_cuda"][:], out["seg_cpu"][:])
    np.testing.assert_array_equal(out["seg_cuda_blocks"][:], out["seg_cpu_blocks"][:])


@pytest.mark.cuda
def test_first_linalg_calls_from_eight_threads(cuda_device):
    """The filter bank's eigenvalues from 8 threads at once as the first
    linear algebra of a fresh process (the threaded block tasks do this):
    PyTorch loads its CUDA linalg library lazily and refuses two concurrent
    first calls, so ``eigenvalues_descending`` makes its first call under a
    lock.  Every thread's eigenvalues equal the CPU's within 1e-5."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from concurrent.futures import ThreadPoolExecutor\n"
        "from cluster_tools_tpu_torch.ops.filters import eigenvalues_descending\n"
        "g = torch.Generator().manual_seed(0)\n"
        "hs = [torch.rand(4096, 3, 3, generator=g) for _ in range(8)]\n"
        "hs = [h + h.transpose(1, 2) for h in hs]\n"
        "with ThreadPoolExecutor(8) as pool:\n"
        "    got = list(pool.map(lambda h: eigenvalues_descending(h.cuda()).cpu(), hs))\n"
        "for h, e in zip(hs, got):\n"
        "    torch.testing.assert_close(e, eigenvalues_descending(h), rtol=0, atol=1e-5)\n"
        "print('ok')\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root, env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
