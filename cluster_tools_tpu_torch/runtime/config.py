"""Two-level JSON configuration: ``global.config`` plus ``<task>.config``.

The same files and layout as ``cluster_tools_tpu/runtime/config.py``, so one
config dir drives both packages.  The port adds one global key, ``device``:
``"cuda"`` (the default — entry points run on the card, and raise when there
is none) or ``"cpu"``, an explicit request to compute on the host.  Targets:
``local`` (host loop over blocks) and ``cuda`` (batched dispatch with the
read → compute → write pipeline).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from ..utils.store import atomic_write_bytes

DEFAULT_GLOBAL_CONFIG: Dict[str, Any] = {
    "block_shape": [50, 512, 512],
    "roi_begin": None,
    "roi_end": None,
    "block_list_path": None,
    "target": "local",
    "max_jobs": 1,
    "max_num_retries": 0,
    "retry_failure_fraction": 0.5,
    # blocks per dispatch on the cuda target, per card; None = 8 per card
    # (1 when the device is the CPU)
    "device_batch_size": None,
    # batches in flight per host stage (read, write) on the cuda target
    "pipeline_depth": 2,
    "device": "cuda",
}

def _config_path(config_dir: str, name: str) -> str:
    return os.path.join(config_dir, f"{name}.config")


def write_config(config_dir: str, name: str, conf: Dict[str, Any]) -> str:
    os.makedirs(config_dir, exist_ok=True)
    path = _config_path(config_dir, name)
    atomic_write_bytes(path, json.dumps(conf, indent=2, sort_keys=True).encode())
    return path


def write_global_config(config_dir: str, conf: Optional[Dict[str, Any]] = None) -> str:
    merged = dict(DEFAULT_GLOBAL_CONFIG)
    if conf:
        merged.update(conf)
    return write_config(config_dir, "global", merged)


def read_config(config_dir: Optional[str], name: str) -> Dict[str, Any]:
    if config_dir is None:
        return {}
    try:
        with open(_config_path(config_dir, name)) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def global_config(config_dir: Optional[str]) -> Dict[str, Any]:
    conf = dict(DEFAULT_GLOBAL_CONFIG)
    conf.update(read_config(config_dir, "global"))
    return conf


def task_config(
    config_dir: Optional[str], task_name: str, defaults: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    conf = dict(defaults or {})
    conf.update(read_config(config_dir, task_name))
    return conf
