from .agglomerative_clustering import AgglomerativeClusteringWorkflow
from .debugging import CheckComponentsWorkflow, CheckSubGraphsWorkflow
from .multicut import (
    EdgeFeaturesWorkflow,
    GraphWorkflow,
    MulticutSegmentationWorkflow,
    MulticutWorkflow,
    ProblemWorkflow,
    ReducedSolutionWorkflow,
    SubSolutionsWorkflow,
)
from .mws import MwsWorkflow, TwoPassMwsWorkflow
from .thresholded_components import ThresholdAndWatershedWorkflow, ThresholdedComponentsWorkflow
from .watershed import WatershedWorkflow

__all__ = [
    "AgglomerativeClusteringWorkflow", "CheckComponentsWorkflow", "CheckSubGraphsWorkflow",
    "EdgeFeaturesWorkflow", "GraphWorkflow",
    "MulticutSegmentationWorkflow", "MulticutWorkflow", "MwsWorkflow", "ProblemWorkflow",
    "ReducedSolutionWorkflow", "SubSolutionsWorkflow",
    "ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow", "TwoPassMwsWorkflow",
    "WatershedWorkflow",
]
