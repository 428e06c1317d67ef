from .multicut import (
    EdgeFeaturesWorkflow,
    GraphWorkflow,
    MulticutSegmentationWorkflow,
    MulticutWorkflow,
    ProblemWorkflow,
)
from .thresholded_components import ThresholdAndWatershedWorkflow, ThresholdedComponentsWorkflow
from .watershed import WatershedWorkflow

__all__ = [
    "EdgeFeaturesWorkflow", "GraphWorkflow", "MulticutSegmentationWorkflow", "MulticutWorkflow",
    "ProblemWorkflow", "ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow",
    "WatershedWorkflow",
]
