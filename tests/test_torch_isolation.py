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
from cluster_tools_tpu_torch.workflows import StreamingSegmentationWorkflow

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
            from cluster_tools_tpu_torch.ops import affinities, filters, segment
            from cluster_tools_tpu_torch.ops.filters import apply_filter, hessian_of_gaussian_eigenvalues
            from cluster_tools_tpu_torch.ops.rag import affinity_edge_features, filter_edge_features
            from cluster_tools_tpu_torch.ops.watershed import fit_to_hmap
            from cluster_tools_tpu_torch.tasks import debugging, region_features
            from cluster_tools_tpu_torch.tasks import affinities as affinity_tasks
            from cluster_tools_tpu_torch.tasks import (
                CheckComponentsTask, CheckSubGraphsTask, EmbeddingDistancesTask, GradientsTask,
                ImageFilterTask, InsertAffinitiesTask, MergeRegionFeaturesTask,
                ReducedAssignmentsTask, RegionFeaturesTask, SubSolutionsTask,
            )
            from cluster_tools_tpu_torch.workflows import debugging as debugging_workflows
            from cluster_tools_tpu_torch.workflows import (
                CheckComponentsWorkflow, CheckSubGraphsWorkflow, ReducedSolutionWorkflow,
                SubSolutionsWorkflow,
            )
            from cluster_tools_tpu_torch.ops import evaluation, relabel
            from cluster_tools_tpu_torch.ops.relabel import apply_mapping, relabel_consecutive
            from cluster_tools_tpu_torch.tasks import morphology, node_labels, postprocess
            from cluster_tools_tpu_torch.tasks import threshold
            from cluster_tools_tpu_torch.tasks import (
                BackgroundSizeFilterTask, BlockMorphologyTask, BlockNodeLabelsTask,
                FillingSizeFilterTask, FilterBlocksTask, FindLabelingTask, FindUniquesTask,
                GraphConnectedComponentsTask, GraphWatershedAssignmentsTask, IdFilterTask,
                MergeMorphologyTask, MergeNodeLabelsTask, MergeUniquesTask,
                OrphanAssignmentsTask, RegionCentersTask, SimpleStitchAssignmentsTask,
                SimpleStitchEdgesTask, SizeFilterTask, StitchingMulticutTask, ThresholdTask,
            )
            from cluster_tools_tpu_torch.workflows import (
                ConnectedComponentsWorkflow, FilterByThresholdWorkflow, FilterLabelsWorkflow,
                FilterOrphansWorkflow, MorphologyWorkflow, MulticutStitchingWorkflow,
                RegionCentersWorkflow, RelabelWorkflow, SimpleStitchingWorkflow,
                SizeFilterAndGraphWatershedWorkflow, SizeFilterWorkflow, UniqueWorkflow,
            )
            from cluster_tools_tpu_torch.workflows import postprocessing, relabel, stitching
            from cluster_tools_tpu_torch.utils import blosc, store
            from cluster_tools_tpu_torch.utils.store import default_compression, release_h5_handles
            from cluster_tools_tpu_torch.ops.lifted import lifted_neighborhood, solve_lifted_multicut
            from cluster_tools_tpu_torch.tasks import (
                ClearLiftedEdgesFromLabelsTask, EdgeLabelsTask, LearnRFTask,
                LiftedCostsFromNodeLabelsTask, MergeLiftedProblemsTask,
                PredictEdgeProbabilitiesTask, ReduceLiftedProblemTask, SolveLiftedGlobalTask,
                SolveLiftedSubproblemsTask, SparseLiftedNeighborhoodTask,
            )
            from cluster_tools_tpu_torch.workflows import (
                LearningWorkflow, LiftedFeaturesFromNodeLabelsWorkflow,
                LiftedMulticutSegmentationWorkflow, LiftedMulticutWorkflow,
            )
            from cluster_tools_tpu_torch.workflows import learning, lifted_multicut
            from cluster_tools_tpu_torch.ops import label_multiset, resample
            from cluster_tools_tpu_torch.tasks import (
                copy_volume, downscaling, label_multisets, masking, paintera, transformations,
            )
            from cluster_tools_tpu_torch.workflows import bigcat
            from cluster_tools_tpu_torch.workflows import downscaling as downscaling_workflows
            from cluster_tools_tpu_torch.workflows import paintera as paintera_workflows
            from cluster_tools_tpu_torch.workflows import transformations as trafo_workflows
            from cluster_tools_tpu_torch.tasks import (
                BlocksFromMaskTask, CopyVolumeTask, CreateMultisetTask, DownscaleMultisetTask,
                DownscalingTask, LabelBlockMappingTask, LinearTransformationTask, MinfilterTask,
                ScaleToBoundariesTask, UniqueBlockLabelsTask, UpscalingTask,
            )
            from cluster_tools_tpu_torch.workflows import (
                BigcatWorkflow, DownscalingWorkflow, LabelMultisetWorkflow,
                LinearTransformationWorkflow, PainteraConversionWorkflow, PainteraToBdvWorkflow,
            )
            from cluster_tools_tpu_torch.models import UNet3D, load_checkpoint, save_checkpoint
            from cluster_tools_tpu_torch.ops import mesh, skeleton
            from cluster_tools_tpu_torch.tasks import (
                distances, evaluation as evaluation_tasks, frameworks, ilastik, inference,
                meshes, multiscale_inference, skeletons,
            )
            from cluster_tools_tpu_torch.tasks import (
                ComputeMeshesTask, IlastikPredictionTask, InferenceTask, MeasuresTask,
                MergeObjectDistancesTask, MergePredictionsTask, MultiscaleInferenceTask,
                ObjectDistancesTask, ObjectViTask, SkeletonEvaluationTask, SkeletonizeTask,
                StackPredictionsTask, UpsampleSkeletonsTask, WriteCarvingTask,
            )
            from cluster_tools_tpu_torch.workflows import (
                DistanceWorkflow, EvaluationWorkflow, IlastikCarvingWorkflow,
                IlastikPredictionWorkflow, MeshWorkflow, SkeletonEvaluationWorkflow,
                SkeletonWorkflow,
            )
            from cluster_tools_tpu_torch.workflows import evaluation as evaluation_workflows
            from cluster_tools_tpu_torch.workflows import ilastik as ilastik_workflows
            from cluster_tools_tpu_torch.workflows import skeletons as skeleton_workflows
            from cluster_tools_tpu_torch.utils import msgpack_lite
            from cluster_tools_tpu_torch.ops import events, hier
            from cluster_tools_tpu_torch.ops.watershed import (
                flood_merge_table, flood_with_stats, seeded_watershed_hier,
            )
            from cluster_tools_tpu_torch.tasks import events as event_tasks, hier as hier_tasks
            from cluster_tools_tpu_torch.tasks import (
                BuildHierarchyTask, EventBuildingTask, HierarchyBlocksTask, HierarchyFacesTask,
                HierarchyOffsetsTask, ResegmentTask,
            )
            from cluster_tools_tpu_torch.workflows import (
                EventBuildingWorkflow, HierarchyWorkflow, ResegmentWorkflow,
            )
            from cluster_tools_tpu_torch.workflows import events as event_workflows
            from cluster_tools_tpu_torch.workflows import hier as hier_workflows
            from cluster_tools_tpu_torch.obs import metrics
            from cluster_tools_tpu_torch.parallel.dispatch import (
                BlockBatch, BlockReadCache, CachedDataset, read_block_batch,
            )
            from cluster_tools_tpu_torch.runtime import hbm, stream
            from cluster_tools_tpu_torch.runtime.executor import stacked_dispatch
            from cluster_tools_tpu_torch.runtime.stream import FusedChain, try_run_chain
            from cluster_tools_tpu_torch.workflows import StreamingSegmentationWorkflow
            from cluster_tools_tpu_torch.workflows import streaming
            assert native.available(), native.load_error
            assert hasattr(native, "lifted_gaec")
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
                     if m.split(".")[0] in ("jax", "jaxlib", "cluster_tools_tpu", "flax", "msgpack"))
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
    pytest.param("local", StreamingSegmentationWorkflow, id="local-streaming"),
    pytest.param("cuda", StreamingSegmentationWorkflow, id="cuda-streaming"),
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


def _new_task_roots(kind, tmp, config_dir, path):
    """The slice's tasks and workflows over small inputs in ``path``."""
    from cluster_tools_tpu_torch import tasks as t
    from cluster_tools_tpu_torch import workflows as w

    io = {"input_path": path, "input_key": "bnd"}
    if kind == "insert_affinities":
        return [t.InsertAffinitiesTask(tmp, config_dir, input_path=path, input_key="affs",
                                       output_path=path, output_key="out", objects_path=path,
                                       objects_key="objs")]
    if kind == "embedding_distances":
        return [t.EmbeddingDistancesTask(tmp, config_dir, input_paths=[path] * 2,
                                         input_keys=["bnd", "bnd"], output_path=path,
                                         output_key="out")]
    if kind == "gradients":
        return [t.GradientsTask(tmp, config_dir, input_paths=[path], input_keys=["bnd"],
                                output_path=path, output_key="out")]
    if kind == "region_features":
        block = t.RegionFeaturesTask(tmp, config_dir, **io, labels_path=path, labels_key="ws")
        return [t.MergeRegionFeaturesTask(tmp, config_dir, dependencies=[block], **io)]
    if kind == "image_filter":
        return [t.ImageFilterTask(tmp, config_dir, **io, output_path=path, output_key="out",
                                  filter_name="hessianOfGaussianEigenvalues", sigma=1.0)]
    if kind == "check_components":
        return [t.CheckComponentsTask(tmp, config_dir, input_path=path, input_key="ws")]
    if kind == "check_sub_graphs":
        return [w.CheckSubGraphsWorkflow(tmp, config_dir, ws_path=path, ws_key="ws")]
    problem = w.ProblemWorkflow(tmp, config_dir, **io, ws_path=path, ws_key="ws",
                                sanity_checks=True)
    cls = w.SubSolutionsWorkflow if kind == "sub_solutions" else w.ReducedSolutionWorkflow
    return [cls(tmp, config_dir, ws_path=path, ws_key="ws", output_path=path, output_key="out",
                n_scales=1, dependencies=[problem])]


@pytest.mark.parametrize("kind", [
    "insert_affinities", "embedding_distances", "gradients", "region_features", "image_filter",
    "check_components", "check_sub_graphs", "sub_solutions", "reduced_solution",
])
def test_new_tasks_default_to_card_and_run_on_cpu(tmp_path, monkeypatch, kind):
    """Each task and workflow of the affinity / filter-bank slice asks for the
    card by default and raises without one; with ``"device": "cpu"`` in the
    global config the same build runs on the host."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("bnd", data=rng.random((8, 16, 16)).astype("float32"), chunks=(8, 16, 16))
    f.create_dataset("ws", data=rng.integers(1, 6, (8, 16, 16)).astype("uint64"), chunks=(8, 16, 16))
    f.create_dataset("affs", data=rng.integers(0, 256, (3, 8, 16, 16)).astype("uint8"),
                     chunks=(1, 8, 16, 16))
    objs = np.zeros((8, 16, 16), dtype="uint64")
    objs[1:7, 3:13, 3:13] = 4
    f.create_dataset("objs", data=objs, chunks=(8, 16, 16))
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16]})
    cfg.write_config(config_dir, "insert_affinities", {"erode_by": 1})
    assert cfg.global_config(config_dir)["device"] == "cuda"
    tmp = str(tmp_path / "tmp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    roots = _new_task_roots(kind, tmp, config_dir, path)
    with pytest.raises(Exception, match="no CUDA device"):
        build(roots)
    assert not roots[0].complete()
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "device": "cpu"})
    roots = _new_task_roots(kind, tmp, config_dir, path)
    assert build(roots)
    assert roots[0].complete()


@pytest.mark.parametrize("workflow", ["lifted_segmentation", "lifted_features", "lifted_solve",
                                      "learning"])
def test_lifted_and_learning_workflows_raise_without_card(tmp_path, monkeypatch, workflow):
    """The lifted multicut's and the learning workflow's entry points ask
    for the card by default; without one the build raises."""
    from cluster_tools_tpu_torch.workflows import (
        LearningWorkflow, LiftedFeaturesFromNodeLabelsWorkflow,
        LiftedMulticutSegmentationWorkflow, LiftedMulticutWorkflow,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("bnd", data=np.random.default_rng(0).random((8, 16, 16)).astype("float32"),
                     chunks=(8, 16, 16))
    f.create_dataset("ws", shape=(8, 16, 16), dtype="uint64", chunks=(8, 16, 16))
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "target": "cuda"})
    tmp = str(tmp_path / "tmp")
    wf = {
        "lifted_segmentation": lambda: LiftedMulticutSegmentationWorkflow(
            tmp, config_dir, input_path=path, input_key="bnd", ws_path=path, ws_key="ws2",
            labels_path=path, labels_key="ws", output_path=path, output_key="seg"),
        "lifted_features": lambda: LiftedFeaturesFromNodeLabelsWorkflow(
            tmp, config_dir, ws_path=path, ws_key="ws", labels_path=path, labels_key="ws"),
        "lifted_solve": lambda: LiftedMulticutWorkflow(
            tmp, config_dir, input_path=path, input_key="ws"),
        "learning": lambda: LearningWorkflow(
            tmp, config_dir, input_dict={"a": (path, "bnd")}, labels_dict={"a": (path, "ws")},
            groundtruth_dict={"a": (path, "ws")}, output_path=str(tmp_path / "rf.pkl")),
    }[workflow]()
    with pytest.raises(Exception, match="no CUDA device"):
        build([wf])
    assert not wf.complete()


def _volume_roots(kind, tmp, config_dir, path):
    """The volume-ops and export slice's tasks and workflows over small
    inputs in ``path``."""
    from cluster_tools_tpu_torch import tasks as t
    from cluster_tools_tpu_torch import workflows as w

    io = {"input_path": path, "input_key": "bnd", "output_path": path, "output_key": "out"}
    if kind == "copy_volume":
        return [t.CopyVolumeTask(tmp, config_dir, **io, dtype="uint8")]
    if kind == "downscaling":
        return [w.DownscalingWorkflow(tmp, config_dir, input_path=path, input_key="bnd",
                                      scale_factors=[[1, 2, 2]], output_key_prefix="pyr")]
    if kind == "upscaling":
        return [t.UpscalingTask(tmp, config_dir, **io, scale_factor=[1, 2, 2])]
    if kind == "scale_to_boundaries":
        return [t.ScaleToBoundariesTask(tmp, config_dir, input_path=path, input_key="objs",
                                        output_path=path, output_key="out",
                                        boundaries_path=path, boundaries_key="bnd")]
    if kind == "minfilter":
        return [t.MinfilterTask(tmp, config_dir, **{**io, "input_key": "mask"})]
    if kind == "linear":
        trafo = os.path.join(os.path.dirname(path), "trafo.json")
        with open(trafo, "w") as f:
            f.write('{"a": 2.0, "b": 1.0}')
        return [w.LinearTransformationWorkflow(tmp, config_dir, input_path=path, input_key="bnd",
                                               output_path=path, output_key="out",
                                               transformation=trafo)]
    return [w.PainteraConversionWorkflow(tmp, config_dir, input_path=path, input_key="ws",
                                         output_path=path, scale_factors=[[1, 2, 2]])]


@pytest.mark.parametrize("kind", ["copy_volume", "downscaling", "upscaling",
                                  "scale_to_boundaries", "minfilter", "linear", "paintera"])
def test_volume_tasks_default_to_card_and_run_on_cpu(tmp_path, monkeypatch, kind):
    """Each entry point of the volume-ops and export slice asks for the card
    by default and raises without one; with ``"device": "cpu"`` the same
    build runs on the host."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("bnd", data=rng.random((8, 16, 16)).astype("float32"), chunks=(8, 16, 16))
    f.create_dataset("ws", data=rng.integers(1, 6, (8, 16, 16)).astype("uint64"),
                     chunks=(8, 16, 16))
    f.create_dataset("mask", data=(rng.random((8, 16, 16)) > 0.2).astype("uint8"),
                     chunks=(8, 16, 16))
    objs = np.zeros((4, 8, 8), dtype="uint64")
    objs[1:3, 2:6, 2:6] = 4
    f.create_dataset("objs", data=objs, chunks=(4, 8, 8))
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16]})
    cfg.write_config(config_dir, "scale_to_boundaries", {"erode_by": 1})
    cfg.write_config(config_dir, "minfilter", {"filter_shape": [3, 3, 3]})
    tmp = str(tmp_path / "tmp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    roots = _volume_roots(kind, tmp, config_dir, path)
    with pytest.raises(Exception, match="no CUDA device"):
        build(roots)
    assert not roots[0].complete()
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "device": "cpu"})
    roots = _volume_roots(kind, tmp, config_dir, path)
    assert build(roots)
    assert roots[0].complete()


def _inference_roots(kind, tmp, config_dir, path):
    """The inference and analysis slice's tasks and workflows over small
    inputs in ``path`` (a U-Net checkpoint beside it)."""
    from cluster_tools_tpu_torch import tasks as t
    from cluster_tools_tpu_torch import workflows as w

    seg = {"input_path": path, "input_key": "ws"}
    if kind == "inference":
        return [t.InferenceTask(tmp, config_dir, input_path=path, input_key="bnd",
                                output_path=path, output_key={"pred": [0, 1]},
                                checkpoint_path=os.path.join(os.path.dirname(path), "unet"),
                                halo=[1, 2, 2])]
    if kind == "evaluation":
        return [w.EvaluationWorkflow(tmp, config_dir, seg_path=path, seg_key="ws",
                                     gt_path=path, gt_key="objs")]
    if kind == "skeletons":
        return [w.SkeletonEvaluationWorkflow(tmp, config_dir, **seg, seg_path=path,
                                             seg_key="objs")]
    if kind == "distances":
        return [w.DistanceWorkflow(tmp, config_dir, **seg)]
    if kind == "meshes":
        return [w.MeshWorkflow(tmp, config_dir, **seg,
                               output_dir=os.path.join(os.path.dirname(path), "meshes"))]
    return [w.IlastikCarvingWorkflow(tmp, config_dir, input_path=path, input_key="bnd",
                                     watershed_path=path, watershed_key="ws",
                                     output_path=os.path.join(os.path.dirname(path), "c.ilp"))]


@pytest.mark.parametrize("kind", ["inference", "evaluation", "skeletons", "distances", "meshes",
                                  "carving"])
def test_inference_and_analysis_default_to_card_and_run_on_cpu(tmp_path, monkeypatch, kind):
    """Each entry point of the inference and analysis slice asks for the
    card by default and raises without one; with ``"device": "cpu"`` the
    same build runs on the host."""
    from cluster_tools_tpu_torch.models import unet

    rng = np.random.default_rng(0)
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("bnd", data=rng.random((8, 16, 16)).astype("float32"), chunks=(8, 16, 16))
    f.create_dataset("ws", data=rng.integers(1, 6, (8, 16, 16)).astype("uint64"),
                     chunks=(8, 16, 16))
    objs = np.zeros((8, 16, 16), dtype="uint64")
    objs[1:7, 3:13, 3:13] = 4
    f.create_dataset("objs", data=objs, chunks=(8, 16, 16))
    conf = {"model": "UNet3D", "out_channels": 1, "initial_features": 2, "depth": 2,
            "scale_factors": [[1, 2, 2]]}
    unet.save_checkpoint(str(tmp_path / "unet"), unet.model_from_config(conf), conf)
    config_dir = str(tmp_path / "configs")
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16]})
    tmp = str(tmp_path / "tmp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    roots = _inference_roots(kind, tmp, config_dir, path)
    with pytest.raises(Exception, match="no CUDA device"):
        build(roots)
    assert not roots[0].complete()
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "device": "cpu"})
    roots = _inference_roots(kind, tmp, config_dir, path)
    assert build(roots)
    assert roots[0].complete()


@pytest.mark.parametrize("framework", ["jax", "pytorch"])
def test_predictors_default_to_card(tmp_path, monkeypatch, framework):
    """A predictor built without a config names the card and raises without
    one, before it loads anything."""
    from cluster_tools_tpu_torch.tasks.frameworks import get_predictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_predictor(framework)(str(tmp_path / "missing"), [0, 0, 0])


def _slice16_roots(kind, tmp, config_dir, path):
    from cluster_tools_tpu_torch import workflows as w

    if kind == "events":
        return [w.EventBuildingWorkflow(tmp, config_dir, input_path=path, input_key="frames",
                                        output_path=path, output_key="ev")]
    if kind == "hierarchy":
        return [w.HierarchyWorkflow(tmp, config_dir, input_path=path, input_key="bnd",
                                    output_path=path, output_key="seg")]
    return [w.ResegmentWorkflow(tmp, config_dir, labels_path=path, labels_key="seg",
                                output_path=path, output_key="seg_cut")]


@pytest.mark.parametrize("kind", ["events", "hierarchy", "resegment"])
def test_events_and_hierarchy_default_to_card_and_run_on_cpu(tmp_path, monkeypatch, kind):
    """Event building, the hierarchy build and its re-cut ask for the card
    by default and raise without one; with ``"device": "cpu"`` the same
    build runs on the host."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "d.n5")
    f = file_reader(path)
    f.create_dataset("bnd", data=rng.random((8, 16, 16)).astype("float32"), chunks=(8, 16, 16))
    f.create_dataset("frames", data=(rng.random((8, 16, 16)) > 0.9).astype("float32"),
                     chunks=(8, 16, 16))
    config_dir = str(tmp_path / "configs")
    tmp = str(tmp_path / "tmp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if kind == "resegment":  # a hierarchy to re-cut, built on the host
        cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "device": "cpu"})
        assert build(_slice16_roots("hierarchy", str(tmp_path / "tmp_h"), config_dir, path))
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16]})
    roots = _slice16_roots(kind, tmp, config_dir, path)
    with pytest.raises(Exception, match="no CUDA device"):
        build(roots)
    assert not roots[0].complete()
    cfg.write_global_config(config_dir, {"block_shape": [8, 16, 16], "device": "cpu"})
    roots = _slice16_roots(kind, tmp, config_dir, path)
    assert build(roots)
    assert roots[0].complete()


def test_event_and_cut_ops_default_to_card(monkeypatch):
    from cluster_tools_tpu_torch.ops import events, hier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        events.build_events(np.ones((2, 4, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hier.cut_table(np.array([1]), np.array([2]), np.array([0.1], np.float32), 0.5)
