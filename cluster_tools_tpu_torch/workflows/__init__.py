from .agglomerative_clustering import AgglomerativeClusteringWorkflow
from .debugging import CheckComponentsWorkflow, CheckSubGraphsWorkflow
from .learning import LearningWorkflow
from .lifted_multicut import (
    LiftedFeaturesFromNodeLabelsWorkflow,
    LiftedMulticutSegmentationWorkflow,
    LiftedMulticutWorkflow,
)
from .multicut import (
    EdgeFeaturesWorkflow,
    GraphWorkflow,
    MulticutSegmentationWorkflow,
    MulticutWorkflow,
    ProblemWorkflow,
    ReducedSolutionWorkflow,
    SubSolutionsWorkflow,
)
from .morphology import MorphologyWorkflow, RegionCentersWorkflow
from .mws import MwsWorkflow, TwoPassMwsWorkflow
from .postprocessing import (
    ConnectedComponentsWorkflow,
    FilterByThresholdWorkflow,
    FilterLabelsWorkflow,
    FilterOrphansWorkflow,
    SizeFilterAndGraphWatershedWorkflow,
    SizeFilterWorkflow,
)
from .relabel import RelabelWorkflow, UniqueWorkflow
from .stitching import MulticutStitchingWorkflow, SimpleStitchingWorkflow
from .thresholded_components import ThresholdAndWatershedWorkflow, ThresholdedComponentsWorkflow
from .watershed import WatershedWorkflow

__all__ = [
    "AgglomerativeClusteringWorkflow", "CheckComponentsWorkflow", "CheckSubGraphsWorkflow",
    "ConnectedComponentsWorkflow", "EdgeFeaturesWorkflow", "FilterByThresholdWorkflow",
    "FilterLabelsWorkflow", "FilterOrphansWorkflow", "GraphWorkflow", "LearningWorkflow",
    "LiftedFeaturesFromNodeLabelsWorkflow", "LiftedMulticutSegmentationWorkflow",
    "LiftedMulticutWorkflow", "MorphologyWorkflow",
    "MulticutSegmentationWorkflow", "MulticutStitchingWorkflow", "MulticutWorkflow",
    "MwsWorkflow", "ProblemWorkflow", "ReducedSolutionWorkflow", "RegionCentersWorkflow",
    "RelabelWorkflow", "SimpleStitchingWorkflow", "SizeFilterAndGraphWatershedWorkflow",
    "SizeFilterWorkflow", "SubSolutionsWorkflow",
    "ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow", "TwoPassMwsWorkflow",
    "UniqueWorkflow", "WatershedWorkflow",
]
