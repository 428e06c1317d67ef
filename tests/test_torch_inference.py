"""PyTorch port, block-wise inference: ``InferenceTask``,
``MultiscaleInferenceTask``, the predictors and mirror TTA against the JAX
package on the CPU.

Inputs: a seeded (16, 32, 32) float32 map in blocks of (8, 16, 16) and a
U-Net checkpoint (depth 2, [1, 2, 2], 3 channels, the float32 compute
dtype) written by the port and read by both packages.  Contracts:

  * float32 outputs (channel ranges, halo [2, 4, 4], mask, channel
    accumulation, TTA) within 1e-5 of JAX's: the two frameworks' float32
    convolutions sum in other orders (measured: at most 2.8e-6);
  * uint8 outputs byte for byte equal to JAX's except at rounding ties:
    voxels whose JAX value × 255 lies within 1e-4 of a half, counted and
    printed (3 of 16,384 in each dataset on this input);
  * masked-out blocks stay zero in both;
  * each run on the port's ``local`` and ``cuda`` targets (the CPU device,
    two blocks per dispatch, the read → compute → write pipeline);
  * every ``PytorchPredictor`` checkpoint flavour of the JAX tests gives
    JAX's ``PytorchPredictor``'s output within 1e-6 (both run the same torch
    model on the CPU);
  * the multiscale task's centre alignment with a stub predictor as in
    JAX's test, and its output equal to JAX's.
"""

import numpy as np
import pytest
import torch

from cluster_tools_tpu.runtime import build as jax_build
from cluster_tools_tpu.runtime import config as jax_cfg
from cluster_tools_tpu.tasks import frameworks as jfw
from cluster_tools_tpu.tasks import inference as jinf
from cluster_tools_tpu.tasks import multiscale_inference as jms
from cluster_tools_tpu_torch import build
from cluster_tools_tpu_torch.models import unet as U
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.tasks import frameworks as tfw
from cluster_tools_tpu_torch.tasks import inference as tinf
from cluster_tools_tpu_torch.tasks import multiscale_inference as tms
from cluster_tools_tpu_torch.utils import file_reader

SHAPE = (16, 32, 32)
BLOCK = [8, 16, 16]
HALO = [2, 4, 4]
CPU = {"device": "cpu"}
MODEL = {"model": "UNet3D", "out_channels": 3, "initial_features": 4, "depth": 2,
         "scale_factors": [[1, 2, 2]], "in_channels": 1, "dtype": "float32"}
# task config, output keys and halo of each run; every run but "u8" writes float32
RUNS = {
    "channels": dict(conf={"dtype": "float32"}, keys={"affs": [0, 2], "bmap": [0, 1]},
                     halo=HALO),
    "u8": dict(conf={}, keys={"affs": [0, 2], "bmap": [0, 1]}, halo=HALO),
    "mask": dict(conf={"dtype": "float32"}, keys={"pred": [0, 1]}, halo=[0, 0, 0], mask=True),
    "accumulate": dict(conf={"dtype": "float32", "channel_accumulation": "max"},
                       keys={"acc": [0, 3]}, halo=[1, 2, 2]),
    "tta": dict(conf={"dtype": "float32", "augmentation_mode": "all"},
                keys={"bmap": [0, 1]}, halo=[0, 0, 0]),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The input n5, the checkpoint and JAX's output of every run."""
    root = tmp_path_factory.mktemp("inference")
    rng = np.random.default_rng(0)
    raw = rng.random(SHAPE).astype(np.float32)
    path = str(root / "in.n5")
    f = file_reader(path)
    f.create_dataset("raw", data=raw, chunks=tuple(BLOCK))
    mask = np.zeros(SHAPE, np.uint8)
    mask[:8, :, 3:20] = 1  # blocks 0 and 1 (of 8) hold mask voxels
    f.create_dataset("mask", data=mask, chunks=tuple(BLOCK))
    ckpt = str(root / "unet")
    model = U.init_flax_like(U.model_from_config(MODEL), torch.Generator().manual_seed(3))
    U.save_checkpoint(ckpt, model, MODEL)
    jax_out = {name: run_task("jax", name, root, path, ckpt) for name in RUNS}
    return root, path, ckpt, raw, jax_out


def run_task(package, name, root, path, ckpt, target="local"):
    """One ``RUNS`` entry through ``package``'s ``InferenceTask``; returns
    the output path."""
    run = RUNS[name]
    tag = f"{package}_{name}_{target}"
    mod = jax_cfg if package == "jax" else cfg
    config_dir = str(root / f"configs_{tag}")
    mod.write_global_config(config_dir, {"block_shape": BLOCK, "target": target,
                                         "device_batch_size": 2, **CPU})
    mod.write_config(config_dir, "inference", run["conf"])
    out = str(root / f"out_{tag}.n5")
    task_cls = jinf.InferenceTask if package == "jax" else tinf.InferenceTask
    mask = {"mask_path": path, "mask_key": "mask"} if run.get("mask") else {}
    task = task_cls(str(root / f"tmp_{tag}"), config_dir, input_path=path, input_key="raw",
                    output_path=out, output_key=run["keys"], checkpoint_path=ckpt,
                    halo=run["halo"], framework="jax", **mask)
    assert (jax_build if package == "jax" else build)([task])
    return out


def near_ties(values: np.ndarray) -> np.ndarray:
    """Where ``round(255 * v)`` is a rounding tie to within 1e-4."""
    scaled = values.astype(np.float64) * 255
    return np.abs(scaled - np.floor(scaled) - 0.5) < 1e-4


@pytest.mark.parametrize("target", ["local", "cuda"])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_inference_task_matches_jax(setup, name, target):
    root, path, ckpt, raw, jax_out = setup
    out = run_task("torch", name, root, path, ckpt, target)
    for key in RUNS[name]["keys"]:
        got = file_reader(out, "r")[key][:]
        want = file_reader(jax_out[name], "r")[key][:]
        assert got.shape == want.shape and got.dtype == want.dtype
        if name != "u8":
            print(f"{name} {key}: max abs difference {np.abs(got - want).max()}")
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            continue
        # JAX's float values of the same channels (the "channels" run)
        ref = file_reader(jax_out["channels"], "r")[key][:]
        differ = got != want
        print(f"{key}: {int(differ.sum())} voxels differ from JAX's bytes")
        assert near_ties(ref)[differ].all()
    if name == "mask":
        pred = file_reader(out, "r")["pred"][:]
        assert (pred[8:] == 0).all() and (pred[:8] != 0).any()
    if name == "accumulate":
        assert file_reader(out, "r")["acc"].shape == SHAPE


def test_predictor_tta_matches_manual_average(setup):
    """``augmentation_mode="all"``: one batched forward of the 8 mirrored
    variants (flipped on the device) equals the average of 8 separate
    forwards, each mirrored back, in ``mirror_flip_sets``' order."""
    _, _, ckpt, raw, _ = setup
    x = raw[:8, :16, :16]
    plain = tfw.JaxPredictor(ckpt, [0, 0, 0], config=CPU)
    tta = tfw.JaxPredictor(ckpt, [0, 0, 0], augmentation_mode="all", config=CPU)
    got = tta(x)
    acc = None
    for axes in tfw.mirror_flip_sets(3):
        out = plain(np.ascontiguousarray(np.flip(x, axes) if axes else x))
        out = np.flip(out, axes) if axes else out
        acc = out.astype("float32") if acc is None else acc + out
    np.testing.assert_allclose(got, acc / 8, rtol=1e-5, atol=1e-6)
    jax_tta = jfw.JaxPredictor(ckpt, [0, 0, 0], augmentation_mode="all")
    np.testing.assert_allclose(got, jax_tta(x), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_mirror_tta_on_tensors_matches_jax(dim):
    """The port's TTA on tensors against JAX's on arrays, with a forward that
    depends on absolute position (so every flip matters)."""
    rng = np.random.default_rng(dim)
    x = rng.random((2, 1, 3, 5, 4)).astype(np.float32)
    w = rng.random((3, 5, 4)).astype(np.float32)
    want = jfw.mirror_tta(lambda d: d * w + d ** 2, dim)(x)
    wt = torch.from_numpy(w)
    got = tfw.mirror_tta(lambda d: d * wt + d ** 2, dim)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tfw.mirror_flip_sets(dim) == jfw.mirror_flip_sets(dim)


def test_invalid_modes_and_frameworks_raise(setup):
    _, _, ckpt, _, _ = setup
    with pytest.raises(ValueError, match="augmentation_mode"):
        tfw.JaxPredictor(ckpt, [0, 0, 0], augmentation_mode="offsets", config=CPU)
    with pytest.raises(NotImplementedError):
        tfw.get_predictor("tensorflow")("x", [0, 0, 0])


@pytest.mark.parametrize("shape,begin,halo", [
    ((16, 32, 32), (0, 0, 0), (2, 4, 4)),
    ((16, 32, 32), (8, 16, 16), (3, 5, 5)),
    ((2, 16, 30, 31), (8, 16, 16), (2, 4, 4)),
])
def test_halo_reads_and_quantisation_match_jax(shape, begin, halo):
    rng = np.random.default_rng(len(shape))
    data = rng.random(shape).astype(np.float32)
    want = jinf.load_input_with_halo(data, begin, (8, 16, 16), halo)
    got = tinf.load_input_with_halo(data, begin, (8, 16, 16), halo)
    np.testing.assert_array_equal(got, want)
    for rng_ in ((0.0, 1.0), (-1.0, 1.0)):
        for safe in (True, False):
            np.testing.assert_array_equal(tinf.to_uint8(want, rng_, safe),
                                          jinf.to_uint8(want, rng_, safe))
    for name in ("zero_mean_unit_variance", "to_01", "none"):
        np.testing.assert_array_equal(tfw.get_preprocessor(name)(want),
                                      jfw.get_preprocessor(name)(want))


# -- multiscale -------------------------------------------------------------------------


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_multiscale_center_alignment_matches_jax(tmp_path, monkeypatch, target):
    """JAX's stub-predictor test through both packages: the identity head
    writes the fine input, the coarse centre sees the fine centre's physical
    x, and the two packages see the same centres and write the same bytes."""
    vol = np.broadcast_to(np.arange(SHAPE[2], dtype="float32"), SHAPE).copy()
    path = str(tmp_path / "ms.n5")
    f = file_reader(path)
    f.create_dataset("s0", data=vol, chunks=tuple(BLOCK))
    f.create_dataset("s1", data=vol[::2, ::2, ::2].copy(), chunks=tuple(BLOCK))
    centers = {"jax": [], "torch": []}

    def stub(package):
        class Stub:
            def __init__(self, checkpoint_path, halo, **kw):
                self.halo = list(halo)

            def __call__(self, data):
                fine, coarse = data
                fc = fine[tuple(s // 2 for s in fine.shape)]
                cc = coarse[tuple(s // 2 for s in coarse.shape)]
                centers[package].append((float(fc), float(cc)))
                crop = tuple(slice(h, s - h if h else None)
                             for h, s in zip(self.halo, fine.shape))
                return fine[crop][None]
        return Stub

    monkeypatch.setitem(jfw.PREDICTORS, "stub", stub("jax"))
    monkeypatch.setitem(tfw.PREDICTORS, "stub", stub("torch"))
    outs = {}
    for package, mod, task_cls, run in (("jax", jax_cfg, jms.MultiscaleInferenceTask, jax_build),
                                        ("torch", cfg, tms.MultiscaleInferenceTask, build)):
        config_dir = str(tmp_path / f"configs_{package}")
        mod.write_global_config(config_dir, {"block_shape": BLOCK, "device_batch_size": 2,
                                             "target": "local" if package == "jax" else target,
                                             **CPU})
        mod.write_config(config_dir, "multiscale_inference", {"dtype": "float32", "preprocess": "none"})
        task = task_cls(str(tmp_path / f"tmp_{package}"), config_dir,
                        input_paths=[path, path], input_keys=["s0", "s1"],
                        scale_factors=[[1, 1, 1], [2, 2, 2]], halos=[[2, 4, 4], [1, 2, 2]],
                        output_path=path, output_key={f"out_{package}": [0, 1]},
                        checkpoint_path="unused", halo=[2, 4, 4], framework="stub")
        assert run([task])
        outs[package] = file_reader(path, "r")[f"out_{package}"][:]
    np.testing.assert_allclose(outs["torch"], vol, rtol=1e-6)
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    assert centers["torch"] and sorted(centers["torch"]) == sorted(centers["jax"])
    for fc, cc in centers["torch"]:
        assert abs(fc - cc) <= 2.0, (fc, cc)
    for offset in ((0, 0, 0), (8, 16, 16), (3, 7, 30)):
        assert tms.center_align_offset(offset, (8, 16, 16), SHAPE, (2, 2, 2)) == \
            jms.center_align_offset(offset, (8, 16, 16), SHAPE, (2, 2, 2))


# -- foreign torch checkpoints (JAX's TestPytorchCompat / TestEagerTorchCheckpoints) -----


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(1, 2, 3, padding=1)
        self.out_channels = 2

    def forward(self, x):
        return self.conv(x)


class _Wrapper(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.unet = _Tiny()

    def forward(self, x):  # a trainer wrapper does something else
        raise AssertionError("surgery should bypass the wrapper")


class _Scripted(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(1, 2, 3, padding=1)

    def forward(self, x):
        return torch.sigmoid(self.conv(x))


def _flavour(name, tmp_path):
    """(checkpoint path, predictor kwargs, input shape) of one flavour."""
    torch.manual_seed(0)
    if name == "torchscript":
        p = str(tmp_path / "tiny.pt")
        torch.jit.script(_Scripted()).save(p)
        return p, {"halo": [1, 1, 1]}, (8, 12, 12)
    if name == "torchscript_add_sigmoid":
        p = str(tmp_path / "tiny.pt")
        torch.jit.script(_Tiny()).save(p)
        return p, {"halo": [0, 0, 0], "prep_model": "add_sigmoid"}, (4, 8, 8)
    if name == "state_dict_dotted_class":
        p = str(tmp_path / "sd.pt")
        torch.save(torch.nn.Conv3d(1, 2, 3, padding=1).state_dict(), p)
        return p, {"halo": [0, 0, 0], "model_class": "torch.nn.Conv3d", "model_kwargs": {
            "in_channels": 1, "out_channels": 2, "kernel_size": 3, "padding": 1}}, (4, 8, 8)
    if name == "nested_state_dict_add_sigmoid_mixed_precision":
        p = str(tmp_path / "nested.pt")
        torch.save({"model_state_dict": _Tiny().state_dict()}, p)
        return p, {"halo": [0, 0, 0], "model_class": _Tiny, "prep_model": "add_sigmoid",
                   "mixed_precision": True}, (4, 8, 8)
    if name == "pickled_module_extract_unet":
        p = str(tmp_path / "wrapped.pt")
        torch.save(_Wrapper(), p)
        return p, {"halo": [0, 0, 0], "prep_model": "extract_unet"}, (4, 8, 8)
    wdir = tmp_path / "ckpt" / "Weights"
    wdir.mkdir(parents=True)
    torch.save({"model": _Tiny()}, str(wdir / "best_checkpoint.pytorch"))
    torch.save({"model": _Tiny()}, str(wdir / "checkpoint.pytorch"))
    return str(tmp_path / "ckpt"), {"halo": [0, 0, 0], "use_best": name == "inferno_best"}, (4, 8, 8)


@pytest.mark.parametrize("name", [
    "torchscript", "torchscript_add_sigmoid", "state_dict_dotted_class",
    "nested_state_dict_add_sigmoid_mixed_precision", "pickled_module_extract_unet",
    "inferno_best", "inferno_last",
])
def test_pytorch_predictor_flavours_match_jax(name, tmp_path):
    ckpt, kw, shape = _flavour(name, tmp_path)
    x = np.random.default_rng(0).random(shape).astype("float32")
    want = jfw.PytorchPredictor(ckpt, **kw)(x)
    got = tfw.PytorchPredictor(ckpt, **kw, config=CPU)(x)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_state_dict_without_model_class_raises(tmp_path):
    ckpt = str(tmp_path / "bare.pt")
    torch.save(torch.nn.Conv3d(1, 1, 3).state_dict(), ckpt)
    with pytest.raises(ValueError, match="model_class"):
        tfw.PytorchPredictor(ckpt, halo=[0, 0, 0], config=CPU)


BF16_MODEL = {**MODEL, "dtype": "bfloat16"}


@pytest.fixture(scope="module")
def bf16_runs(setup):
    """Both packages' ``InferenceTask`` on a bfloat16 checkpoint (the
    U-Net's default compute dtype), float32 and uint8 outputs."""
    root, path, _, _, _ = setup
    ckpt = str(root / "unet_bf16")
    model = U.init_flax_like(U.model_from_config(BF16_MODEL), torch.Generator().manual_seed(3))
    U.save_checkpoint(ckpt, model, BF16_MODEL)
    outs = {}
    for package in ("jax", "torch"):
        for dtype in ("float32", "uint8"):
            tag = f"bf16_{package}_{dtype}"
            mod = jax_cfg if package == "jax" else cfg
            config_dir = str(root / f"configs_{tag}")
            mod.write_global_config(config_dir, {"block_shape": BLOCK, "target": "local", **CPU})
            mod.write_config(config_dir, "inference", {"dtype": dtype})
            out = str(root / f"out_{tag}.n5")
            task_cls = jinf.InferenceTask if package == "jax" else tinf.InferenceTask
            task = task_cls(str(root / f"tmp_{tag}"), config_dir, input_path=path, input_key="raw",
                            output_path=out, output_key={"bmap": [0, 1], "affs": [1, 3]},
                            checkpoint_path=ckpt, halo=HALO, framework="jax")
            assert (jax_build if package == "jax" else build)([task])
            outs[package, dtype] = {k: file_reader(out, "r")[k][:] for k in ("bmap", "affs")}
    return outs


def test_bf16_inference_matches_jax(bf16_runs):
    """At bfloat16 the port's forward rounds the group norms' float32 sums
    in another order than XLA, about one bf16 step: float outputs within
    JAX's own bf16 tolerance of 5e-2 (``tests/test_inference.py::
    TestMixedPrecision``).  The uint8 bytes that differ are counted and
    printed; each lies within the float tolerance's 13 steps.  Measured on
    this input: floats within 2.8e-3 (bmap) and 3.3e-3 (affs); 250 of 16,384
    and 367 of 32,768 bytes differ, each by one step and none at a rounding
    tie (ROADMAP Queue C records the input)."""
    for key in ("bmap", "affs"):
        got, want = bf16_runs["torch", "float32"][key], bf16_runs["jax", "float32"][key]
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        diff = np.abs(got - want)
        print(f"bf16 {key}: max abs difference {diff.max():.3e}, mean {diff.mean():.3e}")
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
        g8, w8 = bf16_runs["torch", "uint8"][key], bf16_runs["jax", "uint8"][key]
        assert g8.dtype == w8.dtype == np.uint8
        d8 = np.abs(g8.astype(int) - w8.astype(int))
        ties = near_ties(want)
        print(f"bf16 {key}: {int((d8 > 0).sum())} of {d8.size} uint8 bytes differ, "
              f"{int(((d8 > 0) & ~ties).sum())} of them off rounding ties, at most {d8.max()} steps")
        assert d8.max() <= int(np.ceil(255 * 5e-2))
