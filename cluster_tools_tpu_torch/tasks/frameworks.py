"""Predictor/preprocessor registry for block-wise NN inference (port of
``cluster_tools_tpu/tasks/frameworks.py``; reference inference/frameworks.py:
38-166).

Every predictor runs its model on one device, the task's (the global
config's ``device``: the card by default, raising without one).  The
framework names are checkpoint formats:

  * ``"jax"`` — a checkpoint directory of the JAX package's format
    (``model.json`` + flax ``params.msgpack``) loaded into the port's U-Net
    (``models/unet.py``); the batch is one forward on the device (JAX's
    ``put_sharded`` over several devices waits for ROADMAP Queue A 11);
  * ``"pytorch"`` / ``"inferno"`` — a TorchScript archive, a pickled module,
    a state dict or an inferno checkpoint directory, loaded onto the device;
    ``mixed_precision`` runs under ``torch.autocast(device, bfloat16)``;
    the model is shared behind a lock as in the reference;
  * ``"tensorflow"`` raises, as in the reference.

Mirror test-time augmentation flips on the device and runs every variant
in one batched forward.  Preprocessing is host numpy, as in JAX.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..runtime.device import resolve_device


# -- preprocessing ------------------------------------------------------------


def preprocess_zero_mean_unit_variance(data: np.ndarray, eps: float = 1e-6):
    data = data.astype("float32")
    return (data - data.mean()) / (data.std() + eps)


def preprocess_to_01(data: np.ndarray, eps: float = 1e-6):
    data = data.astype("float32")
    lo, hi = data.min(), data.max()
    return (data - lo) / max(hi - lo, eps)


PREPROCESSORS = {
    "zero_mean_unit_variance": preprocess_zero_mean_unit_variance,
    "to_01": preprocess_to_01,
    "none": lambda data: data.astype("float32"),
}


def get_preprocessor(name: str = "zero_mean_unit_variance") -> Callable:
    return PREPROCESSORS[name]


# -- model surgery hooks (reference inference/prep_model.py:9-23) -------------


def prep_add_sigmoid(forward):
    """Wrap a forward (tensor → tensor) with a sigmoid."""

    def wrapped(x):
        return torch.sigmoid(forward(x))

    return wrapped


PREP_MODELS = {"add_sigmoid": prep_add_sigmoid, None: lambda f: f}


# torch-side surgery on nn.Module objects (the reference's hooks mutate the
# module graph, prep_model.py:9-23)
def _torch_extract_unet(model):
    return model.unet


def _torch_add_sigmoid(model):
    import torch.nn as nn

    wrapped = nn.Sequential(model, nn.Sigmoid())
    # keep channel introspection working through the wrapper (only when the
    # wrapped model exposes it — don't materialize a None attribute)
    if hasattr(model, "out_channels"):
        wrapped.out_channels = model.out_channels
    return wrapped


TORCH_PREP_MODELS = {
    "extract_unet": _torch_extract_unet,
    "add_sigmoid": _torch_add_sigmoid,
    None: lambda m: m,
}


# -- test-time augmentation ---------------------------------------------------


def mirror_flip_sets(dim: int = 3):
    """All axis-flip subsets over the trailing ``dim`` spatial axes:
    8 variants for 3d, 4 for 2d (per-slice)."""
    if dim not in (2, 3):
        raise ValueError(f"augmentation_dim must be 2 or 3, got {dim}")
    axes = (-2, -1) if dim == 2 else (-3, -2, -1)
    sets = [()]
    for ax in axes:
        sets += [s + (ax,) for s in sets]
    return sets


AUGMENTATION_MODES = (None, "all")


def mirror_tta(forward: Callable, dim: int = 3) -> Callable:
    """Mirror test-time augmentation (reference frameworks.py:103-131 via
    neurofire's TestTimeAugmenter): run the forward under every spatial
    mirror, invert the mirror on the output, average in float32 in the
    order of ``mirror_flip_sets``.  Assumes flip-equivariant output channels.

    ``forward`` maps a [B, C, z, y, x] tensor to a tensor on the same
    device; the variants are flipped there and stacked along the batch axis,
    so the forward runs once."""

    def augmented(data: torch.Tensor) -> torch.Tensor:
        sets = mirror_flip_sets(dim)
        b = data.shape[0]
        stack = torch.cat([torch.flip(data, axes) if axes else data for axes in sets], dim=0)
        out = forward(stack)
        acc = torch.zeros_like(out[:b], dtype=torch.float32)
        for i, axes in enumerate(sets):
            part = out[i * b:(i + 1) * b]
            acc += torch.flip(part, axes) if axes else part
        return acc / len(sets)

    return augmented


def build_augmented_forward(
    forward: Callable,
    augmentation_mode: Optional[str],
    augmentation_dim,
) -> Callable:
    """TTA seam shared by the predictors: validates the mode instead of
    truthiness-enabling on arbitrary strings."""
    if augmentation_mode not in AUGMENTATION_MODES:
        raise ValueError(
            f"augmentation_mode must be one of {AUGMENTATION_MODES}, "
            f"got {augmentation_mode!r}"
        )
    if augmentation_mode is None:
        return forward
    return mirror_tta(forward, dim=int(augmentation_dim or 3))


# -- predictors ---------------------------------------------------------------


class BasePredictor:
    """Shared predictor shell: batch-shape normalisation, the validated TTA
    seam around ``_forward_raw``, and the final halo crop (reference
    frameworks.py:87-101).  Subclasses implement ``_forward_raw([B, C, z, y,
    x] tensor on ``self.device``) → [B, C_out, z, y, x] tensor``.

    ``predict`` keeps the result on the device; calling the predictor
    returns a float32 numpy array, as the JAX package's predictors do."""

    def _init_base(self, halo, augmentation_mode, augmentation_dim, config):
        self.halo = list(halo)
        self.device = resolve_device(config or {})
        self._forward = build_augmented_forward(
            self._forward_raw, augmentation_mode, augmentation_dim
        )

    def _forward_raw(self, data: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def predict(self, data) -> torch.Tensor:
        """[B, C?, z, y, x] (or one [C?, z, y, x] block) → the halo-cropped
        output on the device."""
        x = data if isinstance(data, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(data))
        squeeze_batch = x.dim() in (3, 4)
        if x.dim() == 3:
            x = x[None, None]
        elif x.dim() == 4:
            x = x[None]
        out = self._forward(x.to(self.device))
        ha = self.halo
        if any(ha):
            crop = tuple(
                slice(h, s - h if h else None)
                for h, s in zip(ha, out.shape[-3:])
            )
            out = out[(Ellipsis,) + crop]
        return out[0] if squeeze_batch else out

    def __call__(self, data) -> np.ndarray:
        return self.predict(data).float().cpu().numpy()


class JaxPredictor(BasePredictor):
    """Batched forward of a checkpoint in the JAX package's format (the
    framework key names the format), in the port's U-Net on the task's
    device.  ``prep_model`` "add_sigmoid" wraps the forward."""

    def __init__(self, checkpoint_path: str, halo, prep_model: Optional[str] = None,
                 config: Optional[dict] = None,
                 augmentation_mode: Optional[str] = None,
                 augmentation_dim: int = 3, **_unused):
        from ..models.unet import load_checkpoint, unet_forward

        self._init_base(halo, augmentation_mode, augmentation_dim, config)
        self.model = load_checkpoint(checkpoint_path, self.device)
        self._apply = PREP_MODELS[prep_model](lambda x: unet_forward(self.model, x))

    def _forward_raw(self, data: torch.Tensor) -> torch.Tensor:
        return self._apply(data)


def _import_dotted(path: str):
    """Resolve ``package.module.Attr`` to the attribute object."""
    import importlib

    mod_name, _, attr = path.rpartition(".")
    if not mod_name:
        raise ValueError(f"model_class must be a dotted path, got {path!r}")
    return getattr(importlib.import_module(mod_name), attr)


def _load_torch_model(checkpoint_path, use_best, model_class, model_kwargs, device="cpu"):
    """Every checkpoint flavor the reference stack produces, one loader,
    tensors mapped onto ``device``:

      * TorchScript archive → ``torch.jit.load`` (no class import needed);
      * pickled eager ``nn.Module`` → ``torch.load`` (reference
        PytorchPredicter, frameworks.py:76: ``torch.load(model_path)``);
      * state-dict checkpoint (bare state dict or a dict nesting it under
        ``state_dict``/``model_state_dict``/``model``/``_model``) →
        construct ``model_class(**model_kwargs)`` and load the weights —
        the loader the reference left as a TODO (frameworks.py:37);
      * inferno ``Trainer`` checkpoint DIRECTORY → pick
        ``Weights/best_checkpoint.pytorch`` (``use_best``) or
        ``Weights/checkpoint.pytorch`` and recurse (reference
        InfernoPredicter, frameworks.py:145 ``Trainer().load(best=...)``).
    """
    import os

    if os.path.isdir(checkpoint_path):
        name = "best_checkpoint.pytorch" if use_best else "checkpoint.pytorch"
        for sub in (os.path.join("Weights", name), name):
            p = os.path.join(checkpoint_path, sub)
            if os.path.exists(p):
                return _load_torch_model(p, use_best, model_class, model_kwargs, device)
        raise FileNotFoundError(
            f"no {name} under inferno checkpoint directory {checkpoint_path}"
        )
    try:
        return torch.jit.load(checkpoint_path, map_location=device)
    except RuntimeError:
        pass
    obj = torch.load(checkpoint_path, map_location=device, weights_only=False)
    if isinstance(obj, torch.nn.Module):
        return obj.to(device)
    if isinstance(obj, dict):
        state = obj
        for key in ("state_dict", "model_state_dict", "model", "_model"):
            if key in obj:
                state = obj[key]
                break
        if isinstance(state, torch.nn.Module):  # e.g. {'model': module}
            return state.to(device)
        if model_class is None:
            raise ValueError(
                f"{checkpoint_path} holds a state dict; pass model_class="
                "'pkg.module.Class' (+ model_kwargs) so the module can be "
                "constructed to receive the weights"
            )
        cls = (
            _import_dotted(model_class)
            if isinstance(model_class, str) else model_class
        )
        model = cls(**(model_kwargs or {}))
        model.load_state_dict(state)
        return model.to(device)
    raise TypeError(
        f"unsupported torch checkpoint content {type(obj).__name__} "
        f"in {checkpoint_path}"
    )


class PytorchPredictor(BasePredictor):
    """Forward of a foreign torch checkpoint on the task's device (the model
    is shared across threads behind a lock like the reference's,
    frameworks.py:63,88).

    Accepts every reference checkpoint flavor (see ``_load_torch_model``)
    plus ``prep_model`` surgery on the loaded module ('extract_unet',
    'add_sigmoid' — reference prep_model.py:9-23).  ``mixed_precision`` runs
    the forward under bf16 autocast on the device (the reference's apex O1
    mode, frameworks.py:55-57)."""

    def __init__(self, checkpoint_path: str, halo, use_best: bool = True,
                 prep_model: Optional[str] = None,
                 model_class: Optional[str] = None,
                 model_kwargs: Optional[dict] = None,
                 mixed_precision: bool = False,
                 augmentation_mode: Optional[str] = None,
                 augmentation_dim: int = 3, config: Optional[dict] = None, **_unused):
        self._init_base(halo, augmentation_mode, augmentation_dim, config)
        self.model = _load_torch_model(
            checkpoint_path, use_best, model_class, model_kwargs, self.device
        )
        self._post = None
        if prep_model is not None:
            if prep_model not in TORCH_PREP_MODELS:
                raise ValueError(
                    f"prep_model must be one of "
                    f"{sorted(k for k in TORCH_PREP_MODELS if k)}, "
                    f"got {prep_model!r}"
                )
            if isinstance(self.model, torch.jit.ScriptModule):
                if prep_model == "add_sigmoid":
                    # scripted graphs cannot be rewritten; compose outside
                    self._post = torch.nn.Sigmoid()
                else:
                    raise ValueError(
                        f"prep_model={prep_model!r} cannot rewrite a "
                        "TorchScript archive; apply it before scripting"
                    )
            else:
                self.model = TORCH_PREP_MODELS[prep_model](self.model)
        self.model.eval()
        self.mixed_precision = bool(mixed_precision)
        self.lock = threading.Lock()

    def _forward_raw(self, data: torch.Tensor) -> torch.Tensor:
        with self.lock, torch.inference_mode():
            if self.mixed_precision:
                with torch.autocast(self.device.type, dtype=torch.bfloat16):
                    out = self.model(data)
                out = out.float()
            else:
                out = self.model(data)
            if self._post is not None:
                out = self._post(out)
        return out


def _tensorflow_stub(*args, **kwargs):
    raise NotImplementedError(
        "tensorflow inference is not implemented (stub in the reference too, "
        "frameworks.py:150-151)"
    )


PREDICTORS: Dict[str, Any] = {
    "jax": JaxPredictor,
    "pytorch": PytorchPredictor,
    "inferno": PytorchPredictor,  # inferno trainers export torch models
    "tensorflow": _tensorflow_stub,
}


def get_predictor(framework: str) -> Callable:
    return PREDICTORS[framework]
