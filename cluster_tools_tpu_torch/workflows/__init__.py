from .agglomerative_clustering import AgglomerativeClusteringWorkflow
from .multicut import (
    EdgeFeaturesWorkflow,
    GraphWorkflow,
    MulticutSegmentationWorkflow,
    MulticutWorkflow,
    ProblemWorkflow,
)
from .mws import MwsWorkflow, TwoPassMwsWorkflow
from .thresholded_components import ThresholdAndWatershedWorkflow, ThresholdedComponentsWorkflow
from .watershed import WatershedWorkflow

__all__ = [
    "AgglomerativeClusteringWorkflow", "EdgeFeaturesWorkflow", "GraphWorkflow",
    "MulticutSegmentationWorkflow", "MulticutWorkflow", "MwsWorkflow", "ProblemWorkflow",
    "ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow", "TwoPassMwsWorkflow",
    "WatershedWorkflow",
]
