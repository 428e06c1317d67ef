"""PyTorch/CUDA port of cluster_tools_tpu.

A second package beside the JAX one, which stays the reference.  Ported so
far: the per-block DT-watershed behind ``WatershedWorkflow`` (default
branch, every mode), the block pipeline of ``ThresholdedComponentsWorkflow``
and ``ThresholdAndWatershedWorkflow`` with the 3d seeded flood, and
``MulticutSegmentationWorkflow`` (watershed → RAG graph → edge features →
costs → hierarchical GAEC multicut → write), the two-pass and agglomerating
branches of ``WatershedWorkflow``, ``AgglomerativeClusteringWorkflow``, and the
mutex watershed's ``MwsWorkflow`` (blockwise MWS, face stitching) and
``TwoPassMwsWorkflow``, and the label bookkeeping, postprocessing and graph
stitching workflows (``workflows/relabel.py``, ``morphology.py``,
``postprocessing.py``, ``stitching.py``), the lifted multicut
(``LiftedMulticutSegmentationWorkflow``), the edge-classifier
``LearningWorkflow`` and the volume ops and exports (scale pyramids in the
paintera and BigDataViewer layouts, copies, masks, intensity
transformations, label multisets, paintera and bigcat containers:
``workflows/downscaling.py``, ``transformations.py``, ``paintera.py``,
``bigcat.py``); the store reads and writes raw, gzip and blosc chunks
in n5 and zarr and opens hdf5 files; all five TPU kernels are
hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first use,
the multicut and mutex-watershed solvers C++ built with ``g++`` at first
use (``native/``), the device MWS plain PyTorch (``ops/mws_device.py``).
Workflows may run chains of their tasks as one streaming pass
(``runtime/stream.py``; ``StreamingSegmentationWorkflow``, the hierarchy's
blocks), and batch uploads may stay resident in a device-buffer cache
(``runtime/hbm.py``).
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
from .workflows.learning import LearningWorkflow
from .workflows.lifted_multicut import LiftedMulticutSegmentationWorkflow
from .workflows.multicut import MulticutSegmentationWorkflow
from .workflows.mws import MwsWorkflow, TwoPassMwsWorkflow
from .workflows.watershed import WatershedWorkflow

__all__ = [
    "config", "build", "WorkflowBase", "AgglomerativeClusteringWorkflow",
    "LearningWorkflow", "LiftedMulticutSegmentationWorkflow",
    "MulticutSegmentationWorkflow", "MwsWorkflow",
    "ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow", "TwoPassMwsWorkflow",
    "WatershedWorkflow",
]
