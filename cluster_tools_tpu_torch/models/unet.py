"""3D U-Net in PyTorch with the JAX package's flax arithmetic and checkpoints.

Port of ``cluster_tools_tpu/models/unet.py``, channels first throughout
(NCDHW; no transposes):

  * ``ConvBlock``: two 3x3x3 convolutions padded by 1 (flax's ``SAME``), the
    inputs, kernels and biases cast to the compute dtype, the bias added after
    the convolution's result is rounded to that dtype, as XLA does; each
    followed by a group norm in float32 (``min(8, f)`` groups, flax's epsilon
    1e-6 and its variance E[x²] − E[x]², clipped at 0) and a ReLU, the result
    cast back to the compute dtype;
  * pooling: max over window = stride = the level's factor, floor mode;
  * upsampling: nearest to the skip's shape with ``jax.image.resize``'s
    half-pixel rule (``F.interpolate(mode="nearest-exact")``; ``"nearest"``
    differs where the skip is not twice the coarse shape), then a 1x1x1
    convolution, then ``concat([skip, x])``, then a ``ConvBlock``;
  * the head: a 1x1x1 convolution in float32, then ``sigmoid`` or
    ``softmax`` over the channels.

The compute dtype is bfloat16 by default with float32 parameters, or float32
(``"dtype"`` in ``model.json``).  Checkpoints are the JAX package's directory
format, ``model.json`` plus ``params.msgpack`` (flax's MessagePack of the
parameter tree, read and written by ``utils/msgpack_lite.py``), so a
checkpoint written by either package loads in the other.  flax names the
submodules in creation order: the encoder's and the bottleneck's
``ConvBlock_0`` … ``ConvBlock_{depth-1}``, then per decoder level, deepest
first, its 1x1x1 ``Conv_i`` and its ``ConvBlock``, and the head last.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops._build import count_on_card
from ..utils import msgpack_lite

GROUP_NORM_EPS = 1e-6  # flax's default; torch's nn.GroupNorm uses 1e-5


def _scale3(sf) -> Tuple[int, int, int]:
    return (sf,) * 3 if isinstance(sf, int) else tuple(int(s) for s in sf)


def _dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"U-Net compute dtype must be bfloat16 or float32, got {name!r}")
    return dt


def conv_same(x: torch.Tensor, conv: nn.Conv3d, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv`` with ``padding="SAME"`` at ``dtype``: inputs, kernel
    and bias cast, the bias added to the rounded convolution."""
    pad = conv.kernel_size[0] // 2
    y = F.conv3d(x.to(dtype), conv.weight.to(dtype), None, padding=pad)
    return y + conv.bias.to(dtype).view(1, -1, 1, 1, 1)


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm`` in float32: statistics per sample and group
    over the group's channels and all voxels, ``y = (x - mean) * (rsqrt(var
    + eps) * scale) + bias``."""

    def __init__(self, num_groups: int, channels: int, eps: float = GROUP_NORM_EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xg = x.reshape(b, g, -1)
        mean = xg.mean(dim=2)
        var = torch.clamp((xg * xg).mean(dim=2) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(c // g, dim=1) * self.weight.float()
        view = (b, c) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(c // g, dim=1)
        return (x - mean.view(view)) * mul.view(view) + self.bias.float().view((1,) + view[1:])


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv3d(in_channels, features, 3, padding=1),
                                    nn.Conv3d(features, features, 3, padding=1)])
        self.norms = nn.ModuleList([GroupNorm(min(8, features), features) for _ in range(2)])

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for conv, norm in zip(self.convs, self.norms):
            x = conv_same(x, conv, dtype)
            x = torch.relu(norm(x.float())).to(dtype)
        return x


class UNet3D(nn.Module):
    """Encoder/decoder with skip connections; input and output
    [batch, channel, z, y, x].  ``blocks`` and ``ups`` hold the submodules in
    flax's creation order (see the module docstring)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 3, initial_features: int = 16,
                 depth: int = 3, scale_factors: Optional[Sequence] = None,
                 final_activation: Optional[str] = "sigmoid", dtype="bfloat16"):
        super().__init__()
        scales = list(scale_factors or [2] * (depth - 1))
        if len(scales) != depth - 1:
            raise ValueError("need depth-1 scale factors")
        if final_activation not in (None, "sigmoid", "softmax"):
            raise ValueError(f"unknown final_activation {final_activation!r}")
        self.scales = [_scale3(s) for s in scales]
        self.depth = depth
        self.final_activation = final_activation
        self.dtype = _dtype(dtype)
        feats = [initial_features * 2 ** i for i in range(depth)]
        self.features = feats
        blocks = [ConvBlock(in_channels, feats[0])]
        blocks += [ConvBlock(feats[i - 1], feats[i]) for i in range(1, depth)]
        ups = []
        for level in reversed(range(depth - 1)):
            ups.append(nn.Conv3d(feats[level + 1], feats[level], 1))
            blocks.append(ConvBlock(2 * feats[level], feats[level]))
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.head = nn.Conv3d(feats[0], out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        skips = []
        for level in range(self.depth - 1):
            x = self.blocks[level](x, dt)
            skips.append(x)
            sf = self.scales[level]
            x = F.max_pool3d(x, kernel_size=sf, stride=sf)
        x = self.blocks[self.depth - 1](x, dt)
        for i, level in enumerate(reversed(range(self.depth - 1))):
            target = skips[level]
            x = F.interpolate(x, size=tuple(target.shape[2:]), mode="nearest-exact")
            x = conv_same(x, self.ups[i], dt)
            x = torch.cat([target, x], dim=1)
            x = self.blocks[self.depth + i](x, dt)
        x = conv_same(x.float(), self.head, torch.float32)
        if self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        elif self.final_activation == "softmax":
            x = torch.softmax(x, dim=1)
        return x

    def flops(self, spatial: Sequence[int], batch: int = 1) -> int:
        """Multiply-adds × 2 of one forward at input shape ``spatial``: every
        convolution's taps × in × out channels per output voxel."""
        shapes = [tuple(int(s) for s in spatial)]
        for sf in self.scales:
            shapes.append(tuple(s // f for s, f in zip(shapes[-1], sf)))
        vox = [int(np.prod(s)) for s in shapes]
        total = 0
        for level, block in enumerate(self.blocks):
            at = level if level < self.depth else 2 * self.depth - 2 - level
            for conv in block.convs:
                total += 2 * 27 * conv.in_channels * conv.out_channels * vox[at]
        for i, up in enumerate(self.ups):
            at = self.depth - 2 - i
            total += 2 * up.in_channels * up.out_channels * vox[at]
        total += 2 * self.head.in_channels * self.head.out_channels * vox[0]
        return batch * total


def unet_forward(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` without autograd; counts one launch where ``x`` lies on a
    card (the U-Net's device function)."""
    count_on_card(unet_forward, x)
    with torch.inference_mode():
        return model(x)


unet_forward.launches = 0  # forwards on a card


MODEL_REGISTRY = {"UNet3D": UNet3D}


# -- flax parameter tree <-> state dict -----------------------------------------


def _flax_layout(model: UNet3D) -> List[Tuple[str, nn.Module]]:
    """(flax path, submodule) pairs in flax's creation order."""
    out = []
    n_enc = model.depth
    for i in range(n_enc):
        out.append((f"ConvBlock_{i}", model.blocks[i]))
    for i in range(model.depth - 1):
        out.append((f"Conv_{i}", model.ups[i]))
        out.append((f"ConvBlock_{n_enc + i}", model.blocks[n_enc + i]))
    out.append((f"Conv_{model.depth - 1}", model.head))
    return out


def _conv_to_flax(conv: nn.Conv3d) -> Dict[str, np.ndarray]:
    kernel = conv.weight.detach().float().cpu().permute(2, 3, 4, 1, 0).contiguous().numpy()
    return {"kernel": kernel, "bias": conv.bias.detach().float().cpu().numpy()}


def params_to_flax(model: UNet3D) -> Dict[str, Any]:
    """The flax parameter tree ``{"params": ...}`` of ``model`` (numpy
    float32 leaves, kernels (kz, ky, kx, in, out))."""
    tree: Dict[str, Any] = {}
    for name, mod in _flax_layout(model):
        if isinstance(mod, ConvBlock):
            sub = {}
            for j, (conv, norm) in enumerate(zip(mod.convs, mod.norms)):
                sub[f"Conv_{j}"] = _conv_to_flax(conv)
                sub[f"GroupNorm_{j}"] = {"scale": norm.weight.detach().float().cpu().numpy(),
                                         "bias": norm.bias.detach().float().cpu().numpy()}
            tree[name] = sub
        else:
            tree[name] = _conv_to_flax(mod)
    return {"params": tree}


def _leaf(value) -> torch.Tensor:
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
    return t.float()


def params_from_flax(tree: Dict[str, Any], model: UNet3D) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` holding the flax parameter tree ``tree``
    (with or without its top-level ``"params"`` key)."""
    tree = tree.get("params", tree)
    prefix = {id(m): n for n, m in model.named_modules()}
    state: Dict[str, torch.Tensor] = {}

    def conv(dst: nn.Conv3d, src) -> None:
        p = prefix[id(dst)]
        state[f"{p}.weight"] = _leaf(src["kernel"]).permute(4, 3, 0, 1, 2).contiguous()
        state[f"{p}.bias"] = _leaf(src["bias"])

    expected = {name for name, _ in _flax_layout(model)}
    if set(tree) != expected:
        raise ValueError(f"flax tree has modules {sorted(tree)}, the model needs {sorted(expected)}")
    for name, mod in _flax_layout(model):
        if isinstance(mod, ConvBlock):
            for j, (c, n) in enumerate(zip(mod.convs, mod.norms)):
                conv(c, tree[name][f"Conv_{j}"])
                p = prefix[id(n)]
                state[f"{p}.weight"] = _leaf(tree[name][f"GroupNorm_{j}"]["scale"])
                state[f"{p}.bias"] = _leaf(tree[name][f"GroupNorm_{j}"]["bias"])
        else:
            conv(mod, tree[name])
    return state


def init_flax_like(model: UNet3D, generator: torch.Generator) -> UNet3D:
    """flax's default initialisation, drawn from ``generator``: convolution
    kernels LeCun-normal (a normal truncated at ±2 with standard deviation
    sqrt(1 / fan_in) / 0.8796), biases 0, group-norm scales 1 and biases 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv3d):
                fan_in = mod.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                mod.weight.copy_(w * std)
                mod.bias.zero_()
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model


def model_from_config(conf: Dict[str, Any]) -> UNet3D:
    """The model ``model.json``'s dict describes (``"model"``, constructor
    arguments, ``"in_channels"`` and ``"dtype"`` optional)."""
    conf = dict(conf)
    name = conf.pop("model", "UNet3D")
    return MODEL_REGISTRY[name](**conf)


def save_checkpoint(path: str, model: UNet3D, model_config: Dict[str, Any]) -> None:
    """Checkpoint = flax MessagePack params + JSON model config sidecar (the
    JAX package's layout)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(msgpack_lite.packb(params_to_flax(model)))
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump(model_config, f, indent=2)


def load_checkpoint(path: str, device="cpu") -> UNet3D:
    """The model of a checkpoint directory written by either package, with
    its weights, on ``device``, in eval mode.  (The JAX package returns
    ``(model, params)``; here the module holds its parameters.)"""
    with open(os.path.join(path, "model.json")) as f:
        model = model_from_config(json.load(f))
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        tree = msgpack_lite.unpackb(f.read())
    model.load_state_dict(params_from_flax(tree, model))
    return model.to(device).eval()
