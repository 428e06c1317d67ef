"""PyTorch/CUDA port of cluster_tools_tpu.

A second package beside the JAX one, which stays the reference.  Ported so
far: the per-block DT-watershed behind ``WatershedWorkflow`` (default
branch, every mode), the block pipeline of ``ThresholdedComponentsWorkflow``
and ``ThresholdAndWatershedWorkflow`` with the 3d seeded flood, and
``MulticutSegmentationWorkflow`` (watershed → RAG graph → edge features →
costs → hierarchical GAEC multicut → write), the two-pass and agglomerating
branches of ``WatershedWorkflow``, ``AgglomerativeClusteringWorkflow``, and the
mutex watershed's ``MwsWorkflow`` (blockwise MWS, face stitching) and
``TwoPassMwsWorkflow``; all five TPU kernels are
hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first use,
the multicut and mutex-watershed solvers C++ built with ``g++`` at first
use (``native/``), the device MWS plain PyTorch (``ops/mws_device.py``).
Entry points compute on the card unless the global config asks for
``"device": "cpu"``.
"""

from .runtime import config
from .runtime.workflow import WorkflowBase, build
from .workflows.thresholded_components import (
    ThresholdAndWatershedWorkflow,
    ThresholdedComponentsWorkflow,
)
from .workflows.agglomerative_clustering import AgglomerativeClusteringWorkflow
from .workflows.multicut import MulticutSegmentationWorkflow
from .workflows.mws import MwsWorkflow, TwoPassMwsWorkflow
from .workflows.watershed import WatershedWorkflow

__all__ = [
    "config", "build", "WorkflowBase", "AgglomerativeClusteringWorkflow",
    "MulticutSegmentationWorkflow", "MwsWorkflow",
    "ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow", "TwoPassMwsWorkflow",
    "WatershedWorkflow",
]
