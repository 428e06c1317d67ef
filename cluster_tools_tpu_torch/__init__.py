"""PyTorch/CUDA port of cluster_tools_tpu.

A second package beside the JAX one, which stays the reference.  This slice
ports the per-block 2d DT-watershed behind ``WatershedWorkflow``; its two
TPU kernels are hand-written CUDA for Hopper (``csrc/``), built with ``nvcc``
at first use.  Entry points compute on the card unless the global config
asks for ``"device": "cpu"``.
"""

from .runtime import config
from .runtime.workflow import WorkflowBase, build
from .workflows.watershed import WatershedWorkflow

__all__ = ["config", "build", "WorkflowBase", "WatershedWorkflow"]
