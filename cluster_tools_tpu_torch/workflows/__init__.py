from .agglomerative_clustering import AgglomerativeClusteringWorkflow
from .bigcat import BigcatWorkflow
from .debugging import CheckComponentsWorkflow, CheckSubGraphsWorkflow
from .downscaling import DownscalingWorkflow, PainteraToBdvWorkflow
from .evaluation import EvaluationWorkflow
from .events import EventBuildingWorkflow
from .hier import HierarchyWorkflow, ResegmentWorkflow
from .ilastik import IlastikCarvingWorkflow, IlastikPredictionWorkflow
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
from .skeletons import (
    DistanceWorkflow,
    MeshWorkflow,
    SkeletonEvaluationWorkflow,
    SkeletonWorkflow,
)
from .stitching import MulticutStitchingWorkflow, SimpleStitchingWorkflow
from .streaming import StreamingSegmentationWorkflow
from .thresholded_components import ThresholdAndWatershedWorkflow, ThresholdedComponentsWorkflow
from .transformations import LinearTransformationWorkflow
from .watershed import WatershedWorkflow

__all__ = [
    "EventBuildingWorkflow", "HierarchyWorkflow", "ResegmentWorkflow",
    "AgglomerativeClusteringWorkflow", "BigcatWorkflow", "CheckComponentsWorkflow",
    "CheckSubGraphsWorkflow", "ConnectedComponentsWorkflow", "DistanceWorkflow",
    "DownscalingWorkflow", "EdgeFeaturesWorkflow", "EvaluationWorkflow",
    "FilterByThresholdWorkflow", "FilterLabelsWorkflow", "FilterOrphansWorkflow",
    "GraphWorkflow", "IlastikCarvingWorkflow", "IlastikPredictionWorkflow",
    "LabelMultisetWorkflow", "LearningWorkflow", "LiftedFeaturesFromNodeLabelsWorkflow",
    "LiftedMulticutSegmentationWorkflow", "LiftedMulticutWorkflow",
    "LinearTransformationWorkflow", "MeshWorkflow", "MorphologyWorkflow",
    "MulticutSegmentationWorkflow", "MulticutStitchingWorkflow", "MulticutWorkflow",
    "MwsWorkflow", "PainteraConversionWorkflow", "PainteraToBdvWorkflow", "ProblemWorkflow",
    "ReducedSolutionWorkflow", "RegionCentersWorkflow", "RelabelWorkflow",
    "SimpleStitchingWorkflow", "SizeFilterAndGraphWatershedWorkflow", "SizeFilterWorkflow",
    "StreamingSegmentationWorkflow",
    "SkeletonEvaluationWorkflow", "SkeletonWorkflow", "SubSolutionsWorkflow",
    "ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow", "TwoPassMwsWorkflow",
    "UniqueWorkflow", "WatershedWorkflow",
]
