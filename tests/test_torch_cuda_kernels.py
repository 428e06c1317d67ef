"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the workflow on the card against the same workflow on the CPU.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)
and skips without one.  The file imports neither JAX nor the JAX package, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Contract: labels, seed roots and the height map equal the plain version bit
for bit (both round every float operation the same way)."""

import numpy as np
import pytest
import torch
from scipy import ndimage

from cluster_tools_tpu_torch import WatershedWorkflow, build
from cluster_tools_tpu_torch.ops.cc import serpentine_mask
from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices, dtws_slices_plain
from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices, flood_slices_plain
from cluster_tools_tpu_torch.ops.watershed import dt_watershed
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
