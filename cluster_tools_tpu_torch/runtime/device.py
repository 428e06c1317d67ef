"""Device resolution: the card by default, the CPU only when asked.

The global config's ``device`` key is ``"cuda"`` unless the caller writes
``"cpu"``.  With ``"cuda"`` and no usable card, entry points raise — there is
no silent fallback to the host.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def resolve_device(config: Dict[str, Any]) -> torch.device:
    """The torch device named by ``config["device"]`` (default ``"cuda"``);
    raises when a CUDA device is named and none is available."""
    name = str(config.get("device") or "cuda")
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but no CUDA device is available; "
                "set \"device\": \"cpu\" in the global config to run on the host"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r}: only {torch.cuda.device_count()} cards")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    return dev


def device_count(config: Dict[str, Any]) -> int:
    """Cards a dispatch spreads over: ``torch.cuda.device_count()`` for
    ``"cuda"``, 1 for one named card or the CPU."""
    dev = resolve_device(config)
    if dev.type == "cuda" and dev.index is None:
        return torch.cuda.device_count()
    return 1
