"""The port's U-Net (``cluster_tools_tpu_torch/models/unet.py``) against the
JAX package's flax module on the CPU, and the checkpoint directory format
both packages share.

Contracts: the forward within 1e-5 of flax at float32; at bfloat16 within
the JAX package's own bf16 tolerance, 5e-2 (``tests/test_inference.py::
TestMixedPrecision``), and within 5e-3 on average.  Each bf16 convolution
with its bias rounds as XLA's, bit for bit; the float32 group norms' sums
round in another order, and where that moves a bf16 rounding the difference
propagates (measured: at float32 maxima below 2.9e-6, means below 2.5e-7; at
bfloat16 maxima 1.8e-2, 1.3e-2 and 2.3e-2 over the three cases, means
1.4e-3 to 2.0e-3, about one bf16 step at the outputs' values).  At
depths 2 and 3, both heads, on shapes the pooling does not divide (so the
nearest-exact upsampling is exercised), with group-norm scales and biases
and convolution biases away from flax's initial 1 and 0; a checkpoint
written by either package loads in the other and gives the same forward,
and the port writes ``params.msgpack`` byte for byte as flax does.  The
flax forward is jitted (eager flax initialisation costs seconds per op
shape on the CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_tools_tpu.models import UNet3D as FlaxUNet3D
from cluster_tools_tpu.models import load_checkpoint as jax_load_checkpoint
from cluster_tools_tpu.models import save_checkpoint as jax_save_checkpoint
from cluster_tools_tpu_torch.models import unet as U
from cluster_tools_tpu_torch.utils import msgpack_lite

CASES = [
    # depth, scale factors, head, input shape (z, y, x)
    (3, [[1, 2, 2], [1, 2, 2]], "sigmoid", (5, 21, 19)),
    (2, [2], "softmax", (7, 11, 13)),
    (3, [2, [1, 2, 2]], "softmax", (9, 18, 23)),
]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MEAN_TOL = {"float32": 1e-6, "bfloat16": 5e-3}


def _models(case, dtype):
    """The port's model with seeded weights (flax's initialisation, then the
    norms' and biases' 1 and 0 perturbed), its flax tree, the flax module
    and the ``model.json`` dict."""
    depth, sf, head, shape = CASES[case]
    conf = dict(out_channels=3, initial_features=8, depth=depth, scale_factors=sf,
                final_activation=head)
    gen = torch.Generator().manual_seed(case)
    port = U.init_flax_like(U.UNet3D(**conf, dtype=dtype), gen)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if not (name.endswith("weight") and p.dim() == 5):
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    flax_model = FlaxUNet3D(**conf, dtype=jnp.dtype(dtype))
    model_json = {"model": "UNet3D", **conf, "in_channels": 1, "dtype": dtype}
    return port, U.params_to_flax(port), flax_model, model_json


def _input(case, batch=2):
    shape = CASES[case][3]
    return np.random.default_rng(case).standard_normal((batch, 1) + shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_forward_matches_flax(case, dtype, tmp_path):
    """JAX save → port load; the port's forward against flax's."""
    _, tree, flax_model, model_json = _models(case, dtype)
    jax_save_checkpoint(str(tmp_path), tree, model_json)
    port = U.load_checkpoint(str(tmp_path))
    assert port.dtype == getattr(torch, dtype)
    x = _input(case)
    want = np.asarray(jax.jit(flax_model.apply)(tree, x))
    got = U.unet_forward(port, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3) + CASES[case][3]
    err = np.abs(got - want)
    assert err.max() <= TOL[dtype] and err.mean() <= MEAN_TOL[dtype], (err.max(), err.mean())
    if CASES[case][2] == "softmax":
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_checkpoint_bytes_equal_flax(case, tmp_path):
    """The port writes the bytes flax writes for the same tree, and reads
    them back to the same weights."""
    port, tree, _, model_json = _models(case, "float32")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save_checkpoint(jax_dir, tree, model_json)
    U.save_checkpoint(port_dir, port, model_json)
    with open(os.path.join(jax_dir, "params.msgpack"), "rb") as a, \
            open(os.path.join(port_dir, "params.msgpack"), "rb") as b:
        assert a.read() == b.read()
    back = U.load_checkpoint(port_dir)
    for (name, p), q in zip(port.state_dict().items(), back.state_dict().values()):
        assert torch.equal(p, q), name


def test_port_checkpoint_loads_in_jax(tmp_path):
    """Port save → JAX ``load_checkpoint`` (which rebuilds flax's template
    by an eager init: one case only, the cheapest); the forwards agree."""
    port, _, _, model_json = _models(1, "float32")
    U.save_checkpoint(str(tmp_path), port, model_json)
    jmodel, jparams = jax_load_checkpoint(str(tmp_path))
    x = _input(1, batch=1)
    want = np.asarray(jax.jit(jmodel.apply)(jparams, x))
    got = U.unet_forward(port, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL["float32"]
    assert sum(p.numel() for p in port.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(jparams))


def test_full_width_parameters_and_flops():
    """The JAX class's full width at depth 3 has 322,003 parameters; one
    forward of a (40, 320, 320) block with CREMI's anisotropy costs the
    convolutions' 578.6 GFLOP."""
    m = U.UNet3D(out_channels=3, initial_features=16, depth=3,
                 scale_factors=[[1, 2, 2], [1, 2, 2]])
    assert sum(p.numel() for p in m.parameters()) == 322003
    vox = [40 * 320 * 320, 40 * 160 * 160, 40 * 80 * 80]
    per_voxel = [2 * (27 * (1 * 16 + 16 * 16 + 32 * 16 + 16 * 16) + 32 * 16 + 16 * 3),
                 2 * (27 * (16 * 32 + 32 * 32 + 64 * 32 + 32 * 32) + 64 * 32),
                 2 * 27 * (32 * 64 + 64 * 64)]
    assert m.flops((40, 320, 320)) == sum(v * p for v, p in zip(vox, per_voxel)) == 578551808000


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, 1.5, -0.0,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000, b"", b"x" * 255,
    b"y" * 256, b"z" * 70000, [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {str(i): i for i in range(15)}, {str(i): [i, str(i)] for i in range(16)},
    {"nested": {"a": [1, {"b": b"c"}]}},
])
def test_msgpack_matches_the_package(value):
    """The codec writes the bytes the msgpack package writes and reads them
    back (every header width of every covered type)."""
    import msgpack

    packed = msgpack.packb(value, use_bin_type=True)
    assert msgpack_lite.packb(value) == packed
    assert msgpack_lite.unpackb(packed) == msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 3, 300, 70000])
def test_msgpack_ext_and_ndarrays(n):
    """Ext headers of every size, and flax's ndarray leaves (bfloat16
    included) both ways."""
    import msgpack
    from flax import serialization

    ext = msgpack.ExtType(5, b"q" * n)
    assert msgpack_lite.packb(msgpack_lite.ExtType(5, b"q" * n)) == msgpack.packb(ext)
    got = msgpack_lite.unpackb(msgpack.packb(ext))
    assert (got.code, got.data) == (5, b"q" * n)
    arr = np.random.default_rng(n).standard_normal((n % 7 + 1, 3)).astype(np.float32)
    tree = {"a": arr, "b": {"c": arr.astype(np.int64)}}
    assert msgpack_lite.packb(tree) == serialization.to_bytes(tree)
    bf = jnp.asarray(arr, jnp.bfloat16)
    back = msgpack_lite.unpackb(serialization.to_bytes({"w": bf}))["w"]
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(bf, np.float32))
    restored = serialization.msgpack_restore(msgpack_lite.packb({"w": back}))["w"]
    np.testing.assert_array_equal(np.asarray(restored, np.float32), np.asarray(bf, np.float32))
