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

from cluster_tools_tpu_torch import ThresholdAndWatershedWorkflow, WatershedWorkflow, build
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
            from cluster_tools_tpu_torch import ThresholdAndWatershedWorkflow
            from cluster_tools_tpu_torch.ops.cuda_flood import flood_tiles_warm, flood_volume
            from cluster_tools_tpu_torch.tasks import WatershedFromSeedsTask
            from cluster_tools_tpu_torch import MulticutSegmentationWorkflow, native
            from cluster_tools_tpu_torch.ops.rag import boundary_edge_features_gpu
            from cluster_tools_tpu_torch.ops.multicut import solve_multicut
            from cluster_tools_tpu_torch import AgglomerativeClusteringWorkflow
            from cluster_tools_tpu_torch.tasks import AgglomerateTask, AgglomerativeClusteringTask
            from cluster_tools_tpu_torch.tasks import TwoPassWatershedTask
            from cluster_tools_tpu_torch.ops.watershed import two_pass_flood
            from cluster_tools_tpu_torch import MwsWorkflow, TwoPassMwsWorkflow
            from cluster_tools_tpu_torch.tasks import MwsBlocksTask, StitchFacesTask, TwoPassMwsTask
            from cluster_tools_tpu_torch.ops.mws_device import mutex_watershed_device
            from cluster_tools_tpu_torch.ops.mws import compute_mws_segmentation
            assert native.available(), native.load_error
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


def test_native_solvers_are_the_ports_own():
    """The solver library is built from the port's copy of the source, into
    the repository's build directory, not from or into the JAX package."""
    from cluster_tools_tpu_torch import native

    assert os.path.dirname(native.SOURCE) == os.path.join(REPO, "cluster_tools_tpu_torch", "native")
    assert native.library_path().startswith(os.path.join(REPO, "build", "native") + os.sep)
    assert native.available(), native.load_error


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device({"device": "cuda"})
    assert resolve_device({"device": "cpu"}) == torch.device("cpu")


@pytest.mark.parametrize("target,workflow", [
    pytest.param("local", WatershedWorkflow, id="local"),
    pytest.param("cuda", WatershedWorkflow, id="cuda"),
    pytest.param("local", ThresholdAndWatershedWorkflow, id="local-seeds"),
    pytest.param("cuda", ThresholdAndWatershedWorkflow, id="cuda-seeds"),
])
def test_workflow_defaults_to_card_and_raises_without_one(tmp_path, monkeypatch, target, workflow):
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
    wf = workflow(
        str(tmp_path / "tmp"), config_dir, input_path=path, input_key="bnd",
        output_path=path, output_key="ws",
    )
    with pytest.raises(Exception, match="no CUDA device"):
        build([wf])
    assert not wf.complete()


@pytest.mark.parametrize("target", ["local", "cuda"])
def test_multicut_workflow_defaults_to_card_and_raises_without_one(tmp_path, monkeypatch, target):
    from cluster_tools_tpu_torch import MulticutSegmentationWorkflow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "d.n5")
    file_reader(path).create_dataset(
        "bnd", data=np.random.default_rng(0).random((8, 16, 16)).astype("float32"),
        chunks=(8, 16, 16),
    )
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "target": target})
    wf = MulticutSegmentationWorkflow(
        str(tmp_path / "tmp"), config_dir, input_path=path, input_key="bnd",
        ws_path=path, ws_key="ws", output_path=path, output_key="seg",
    )
    with pytest.raises(Exception, match="no CUDA device"):
        build([wf])
    assert not wf.complete()


def test_unported_workflow_branches_raise(tmp_path):
    for kw in ({"sharded": True},):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A 11"):
            WatershedWorkflow(str(tmp_path), None, **kw)


@pytest.mark.parametrize("kw", [{"two_pass": True}, {"agglomeration": True}, "clustering"])
def test_watershed_branches_and_clustering_raise_without_card(tmp_path, monkeypatch, kw):
    """The two-pass and agglomerating watersheds and the global clustering
    ask for the card by default; without one the build raises."""
    from cluster_tools_tpu_torch import AgglomerativeClusteringWorkflow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "d.n5")
    file_reader(path).create_dataset(
        "bnd", data=np.random.default_rng(0).random((8, 16, 16)).astype("float32"),
        chunks=(8, 16, 16),
    )
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "target": "cuda"})
    if kw == "clustering":
        file_reader(path).create_dataset("ws", shape=(8, 16, 16), dtype="uint64", chunks=(8, 16, 16))
        wf = AgglomerativeClusteringWorkflow(
            str(tmp_path / "tmp"), config_dir, input_path=path, input_key="bnd",
            ws_path=path, ws_key="ws", output_path=path, output_key="seg",
        )
    else:
        wf = WatershedWorkflow(
            str(tmp_path / "tmp"), config_dir, input_path=path, input_key="bnd",
            output_path=path, output_key="ws", **kw,
        )
    with pytest.raises(Exception, match="no CUDA device"):
        build([wf])
    assert not wf.complete()
