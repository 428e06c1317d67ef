from .agglomerative_clustering import AgglomerativeClusteringWorkflow
from .bigcat import BigcatWorkflow
from .debugging import CheckComponentsWorkflow, CheckSubGraphsWorkflow
from .downscaling import DownscalingWorkflow, PainteraToBdvWorkflow
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
from .paintera import LabelMultisetWorkflow, PainteraConversionWorkflow
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
from .transformations import LinearTransformationWorkflow
from .watershed import WatershedWorkflow

__all__ = [
    "AgglomerativeClusteringWorkflow", "BigcatWorkflow", "CheckComponentsWorkflow",
    "CheckSubGraphsWorkflow", "ConnectedComponentsWorkflow", "DownscalingWorkflow",
    "EdgeFeaturesWorkflow", "FilterByThresholdWorkflow", "FilterLabelsWorkflow",
    "FilterOrphansWorkflow", "GraphWorkflow", "LabelMultisetWorkflow", "LearningWorkflow",
    "LiftedFeaturesFromNodeLabelsWorkflow", "LiftedMulticutSegmentationWorkflow",
    "LiftedMulticutWorkflow", "LinearTransformationWorkflow", "MorphologyWorkflow",
    "MulticutSegmentationWorkflow", "MulticutStitchingWorkflow", "MulticutWorkflow",
    "MwsWorkflow", "PainteraConversionWorkflow", "PainteraToBdvWorkflow", "ProblemWorkflow",
    "ReducedSolutionWorkflow", "RegionCentersWorkflow", "RelabelWorkflow",
    "SimpleStitchingWorkflow", "SizeFilterAndGraphWatershedWorkflow", "SizeFilterWorkflow",
    "SubSolutionsWorkflow", "ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow",
    "TwoPassMwsWorkflow", "UniqueWorkflow", "WatershedWorkflow",
]
