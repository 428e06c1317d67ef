"""PyTorch port: import isolation and the device contract.

The port imports ``torch`` and never ``jax`` or anything of the JAX package;
its entry points compute on the card unless the config asks for the CPU,
and raise — never fall back — when a card is asked for and none exists."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch import WatershedWorkflow, build
from cluster_tools_tpu_torch.runtime import config as cfg
from cluster_tools_tpu_torch.runtime.device import resolve_device
from cluster_tools_tpu_torch.utils import file_reader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "entry", ["package", "chip_smoke.py", "tests/test_torch_cuda_kernels.py"]
)
def test_port_imports_no_jax(entry):
    """Import every submodule of the port (or the chip smoke script, or the
    card tests that run where JAX is absent) in a fresh interpreter and list
    what came along."""
    if entry == "package":
        body = """
            import importlib, pkgutil
            import cluster_tools_tpu_torch as pkg
            for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
                importlib.import_module(m.name)
        """
    else:
        body = f"""
            import importlib.util
            spec = importlib.util.spec_from_file_location("entry", {entry!r})
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        """
    code = "import sys\nbefore = set(sys.modules)\n" + textwrap.dedent(body) + textwrap.dedent("""
        bad = sorted(m for m in set(sys.modules) - before
                     if m.split(".")[0] in ("jax", "jaxlib", "cluster_tools_tpu"))
        print("BAD", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device({"device": "cuda"})
    assert resolve_device({"device": "cpu"}) == torch.device("cpu")


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_workflow_defaults_to_card_and_raises_without_one(tmp_path, monkeypatch, target):
    """No ``device`` key: the workflow asks for the card; without one the
    build raises instead of computing on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "d.n5")
    file_reader(path).create_dataset(
        "bnd", data=np.random.default_rng(0).random((8, 16, 16)).astype("float32"),
        chunks=(8, 16, 16),
    )
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "target": target})
    assert cfg.global_config(config_dir)["device"] == "cuda"
    wf = WatershedWorkflow(
        str(tmp_path / "tmp"), config_dir, input_path=path, input_key="bnd",
        output_path=path, output_key="ws",
    )
    with pytest.raises(Exception, match="no CUDA device"):
        build([wf])
    assert not wf.complete()


def test_unported_workflow_branches_raise(tmp_path):
    for kw in ({"two_pass": True}, {"agglomeration": True}, {"sharded": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            WatershedWorkflow(str(tmp_path), None, **kw)
