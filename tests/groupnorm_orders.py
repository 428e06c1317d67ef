"""Which float32 summation order does XLA's CPU group norm use?

Not a test (pytest collects ``test_*.py`` only); run it from the
repository root on the CPU:

    JAX_PLATFORMS=cpu python tests/groupnorm_orders.py

Part 1 holds the mean and the mean of squares of flax's ``GroupNorm``
statistics, jitted by the JAX package's XLA on the CPU, against float32
sums of the same group in six orders — sequential in flax's layout order
(voxel-major, the group's channels minor), the same with each square added
by one fused multiply-add, pairwise, and partial sums of vector width 4, 8
and 16 combined in order — on seeded inputs of the shapes the bf16
inference test's U-Net normalises, and prints the largest difference of
each in units in the last place.  Part 2 runs that test's bf16
``InferenceTask`` through both packages twice: with the port's own group
norm, and with the port's group norm replaced by the standalone jitted
flax ``GroupNorm``; it prints the uint8 bytes that differ from JAX's.
"""

import os
import sys
import tempfile
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# flax's group-norm inputs in the bf16 inference test: halo'd blocks of
# (12, 24, 24) with 4 channels in 4 groups, and the coarser level's 8 in 8
SHAPES = (((1, 12, 24, 24, 4), 4), ((1, 6, 12, 12, 8), 8), ((1, 6, 12, 12, 8), 4))


def _f32(fr: Fraction) -> np.float32:
    """``fr`` rounded once to the nearest float32 (ties to even)."""
    c = np.float32(float(fr))
    cands = [c, np.nextafter(c, np.float32(np.inf)), np.nextafter(c, np.float32(-np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - fr),
                                     int(np.float32(v).view(np.int32)) & 1))


def sequential(v, fma=False):
    s = np.float32(0)
    for e in v:
        s = _f32(Fraction(float(s)) + Fraction(float(e)) ** 2) if fma else np.float32(s + e)
    return s


def pairwise(v):
    if v.size == 1:
        return v[0]
    h = v.size // 2
    return np.float32(pairwise(v[:h]) + pairwise(v[h:]))


def lanes(v, k):
    acc = np.zeros(k, np.float32)
    full = v.size // k * k
    for i in range(0, full, k):
        acc = (acc + v[i:i + k]).astype(np.float32)
    return sequential(np.concatenate([acc, v[full:]]))


ORDERS = {
    "sequential": sequential,
    "sequential, squares by fma": None,  # the mean as sequential, the squares fused
    "pairwise": pairwise,
    "width 4": lambda v: lanes(v, 4),
    "width 8": lambda v: lanes(v, 8),
    "width 16": lambda v: lanes(v, 16),
}


def ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


def part1():
    rng = np.random.default_rng(0)
    worst = {name: [0, 0] for name in ORDERS}
    for shape, groups in SHAPES:
        x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
        xr = x.reshape(shape[:-1] + (groups, shape[-1] // groups))
        axes = (1, 2, 3, 5)
        mean, mean2 = (np.asarray(a) for a in jax.jit(
            lambda a: (a.mean(axes), (a * a).mean(axes)))(jnp.asarray(xr)))
        for g in range(groups):
            v = np.moveaxis(xr[0], -2, 0)[g].reshape(-1)  # flax's layout order
            inv = np.float32(1.0 / v.size)
            sq = (v * v).astype(np.float32)
            for name, fn in ORDERS.items():
                if fn is None:
                    s, s2 = sequential(v), sequential(v, fma=True)
                else:
                    s, s2 = fn(v), fn(sq)
                worst[name][0] = max(worst[name][0], ulps(np.float32(s * inv), mean[0, g]))
                worst[name][1] = max(worst[name][1], ulps(np.float32(s2 * inv), mean2[0, g]))
    print("largest difference from XLA's jitted statistics (ulp): mean, mean of squares")
    for name, (m, m2) in worst.items():
        print(f"  {name:28s} {m:4d} {m2:4d}")


def _inference_bytes(root, path):
    """The bf16 ``InferenceTask`` of both packages (uint8), as
    ``tests/test_torch_inference.py::bf16_runs`` runs it."""
    from cluster_tools_tpu.runtime import build as jax_build
    from cluster_tools_tpu.runtime import config as jax_cfg
    from cluster_tools_tpu.tasks import inference as jinf
    from cluster_tools_tpu_torch import build
    from cluster_tools_tpu_torch.models import unet as U
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import inference as tinf
    from cluster_tools_tpu_torch.utils import file_reader

    model_conf = {"model": "UNet3D", "out_channels": 3, "initial_features": 4, "depth": 2,
                  "scale_factors": [[1, 2, 2]], "in_channels": 1, "dtype": "bfloat16"}
    ckpt = os.path.join(root, "unet_bf16")
    if not os.path.exists(ckpt):
        model = U.init_flax_like(U.model_from_config(model_conf),
                                 torch.Generator().manual_seed(3))
        U.save_checkpoint(ckpt, model, model_conf)
    outs = {}
    for package in ("jax", "torch"):
        tag = f"{package}_{len(os.listdir(root))}"
        mod = jax_cfg if package == "jax" else cfg
        config_dir = os.path.join(root, f"configs_{tag}")
        mod.write_global_config(config_dir, {"block_shape": [8, 16, 16], "target": "local",
                                             "device": "cpu"})
        mod.write_config(config_dir, "inference", {"dtype": "uint8"})
        out = os.path.join(root, f"out_{tag}.n5")
        task_cls = jinf.InferenceTask if package == "jax" else tinf.InferenceTask
        task = task_cls(os.path.join(root, f"tmp_{tag}"), config_dir, input_path=path,
                        input_key="raw", output_path=out,
                        output_key={"bmap": [0, 1], "affs": [1, 3]}, checkpoint_path=ckpt,
                        halo=[2, 4, 4], framework="jax")
        assert (jax_build if package == "jax" else build)([task])
        outs[package] = {k: file_reader(out, "r")[k][:] for k in ("bmap", "affs")}
    return {k: int((outs["jax"][k] != outs["torch"][k]).sum()) for k in ("bmap", "affs")}


def part2():
    import flax.linen as fnn

    from cluster_tools_tpu.utils import file_reader as jax_reader
    from cluster_tools_tpu_torch.models import unet as U

    with tempfile.TemporaryDirectory() as root:
        raw = np.random.default_rng(0).random((16, 32, 32)).astype(np.float32)
        path = os.path.join(root, "d.n5")
        jax_reader(path).create_dataset("raw", data=raw, chunks=(8, 16, 16))
        print("uint8 bytes that differ from JAX's bf16 InferenceTask:")
        print("  the port's group norm:", _inference_bytes(root, path))
        forward, cache = U.GroupNorm.forward, {}

        def standalone(self, x):
            key = (self.num_groups, self.eps)
            if key not in cache:
                cache[key] = jax.jit(fnn.GroupNorm(num_groups=self.num_groups,
                                                   dtype=jnp.float32, epsilon=self.eps).apply)
            params = {"params": {"scale": jnp.asarray(self.weight.detach().float().numpy()),
                                 "bias": jnp.asarray(self.bias.detach().float().numpy())}}
            y = cache[key](params, jnp.asarray(np.moveaxis(x.detach().numpy(), 1, -1)))
            return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(y), -1, 1)))

        U.GroupNorm.forward = standalone
        try:
            print("  XLA's standalone jitted GroupNorm in its place:",
                  _inference_bytes(root, path))
        finally:
            U.GroupNorm.forward = forward


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    part1()
    part2()
