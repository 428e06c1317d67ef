"""PyTorch/CUDA port of cluster_tools_tpu.

A second package beside the JAX one, which stays the reference.  Ported so
far: the per-block 2d DT-watershed behind ``WatershedWorkflow`` and the
block pipeline of ``ThresholdedComponentsWorkflow``; their four TPU kernels
are hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first
use.  Entry points compute on the card unless the global config
asks for ``"device": "cpu"``.
"""

from .runtime import config
from .runtime.workflow import WorkflowBase, build
from .workflows.thresholded_components import ThresholdedComponentsWorkflow
from .workflows.watershed import WatershedWorkflow

__all__ = ["config", "build", "WorkflowBase", "ThresholdedComponentsWorkflow", "WatershedWorkflow"]
