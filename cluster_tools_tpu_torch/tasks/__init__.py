from .affinities import EmbeddingDistancesTask, GradientsTask, InsertAffinitiesTask
from .agglomerative_clustering import AGGLO_ASSIGNMENTS_NAME, AgglomerativeClusteringTask
from .copy_volume import CopyVolumeTask
from .costs import ProbsToCostsTask
from .debugging import CheckComponentsTask, CheckSubGraphsTask
from .distances import MergeObjectDistancesTask, ObjectDistancesTask
from .downscaling import DownscalingTask, ScaleToBoundariesTask, UpscalingTask
from .evaluation import MeasuresTask, ObjectViTask
from .events import EVENTS_SUFFIX, EventBuildingTask, read_event_tables
from .features import BlockEdgeFeaturesTask, MergeEdgeFeaturesTask
from .hier import (
    BuildHierarchyTask,
    HierarchyBlocksTask,
    HierarchyFacesTask,
    HierarchyOffsetsTask,
    ResegmentTask,
    default_hierarchy_path,
    load_hier_offsets,
)
from .graph import InitialSubGraphsTask, MapEdgeIdsTask, MergeScaleSubGraphsTask, MergeSubGraphsTask
from .ilastik import (
    IlastikPredictionTask,
    MergePredictionsTask,
    StackPredictionsTask,
    WriteCarvingTask,
)
from .inference import InferenceTask
from .label_multisets import CreateMultisetTask, DownscaleMultisetTask
from .learning import EdgeLabelsTask, LearnRFTask, PredictEdgeProbabilitiesTask
from .lifted_features import (
    ClearLiftedEdgesFromLabelsTask,
    LiftedCostsFromNodeLabelsTask,
    MergeLiftedProblemsTask,
    SparseLiftedNeighborhoodTask,
)
from .lifted_multicut import (
    LIFTED_ASSIGNMENTS_NAME,
    ReduceLiftedProblemTask,
    SolveLiftedGlobalTask,
    SolveLiftedSubproblemsTask,
)
from .masking import BlocksFromMaskTask, MinfilterTask
from .meshes import ComputeMeshesTask
from .multicut import (
    ReduceProblemTask,
    ReducedAssignmentsTask,
    SolveGlobalTask,
    SolveSubproblemsTask,
    SubSolutionsTask,
)
from .morphology import BlockMorphologyTask, MergeMorphologyTask, RegionCentersTask
from .multiscale_inference import MultiscaleInferenceTask
from .mws import MwsBlocksTask, TwoPassMwsTask
from .node_labels import BlockNodeLabelsTask, MergeNodeLabelsTask
from .paintera import LabelBlockMappingTask, UniqueBlockLabelsTask
from .postprocess import (
    BackgroundSizeFilterTask,
    FillingSizeFilterTask,
    FilterBlocksTask,
    GraphConnectedComponentsTask,
    GraphWatershedAssignmentsTask,
    IdFilterTask,
    OrphanAssignmentsTask,
    SizeFilterTask,
)
from .region_features import ImageFilterTask, MergeRegionFeaturesTask, RegionFeaturesTask
from .relabel import FindLabelingTask, FindUniquesTask, MergeUniquesTask
from .skeletons import SkeletonEvaluationTask, SkeletonizeTask, UpsampleSkeletonsTask
from .stitching import (
    STITCH_ASSIGNMENTS_NAME,
    SimpleStitchAssignmentsTask,
    SimpleStitchEdgesTask,
    StitchAssignmentsTask,
    StitchFacesTask,
    StitchingMulticutTask,
)
from .threshold import ThresholdTask
from .transformations import LinearTransformationTask
from .thresholded_components import (
    BlockComponentsTask,
    BlockFacesTask,
    MergeAssignmentsTask,
    MergeOffsetsTask,
)
from .watershed import (
    MAX_IDS_KEY,
    AgglomerateTask,
    TwoPassWatershedTask,
    WatershedFromSeedsTask,
    WatershedTask,
    kernel_params,
)
from .write import WriteTask

__all__ = [
    "BuildHierarchyTask", "EVENTS_SUFFIX", "EventBuildingTask", "HierarchyBlocksTask",
    "HierarchyFacesTask", "HierarchyOffsetsTask", "ResegmentTask", "default_hierarchy_path",
    "load_hier_offsets", "read_event_tables",
    "AGGLO_ASSIGNMENTS_NAME", "AgglomerateTask", "AgglomerativeClusteringTask",
    "BackgroundSizeFilterTask", "BlockComponentsTask", "BlockEdgeFeaturesTask",
    "BlockFacesTask", "BlockMorphologyTask", "BlockNodeLabelsTask", "BlocksFromMaskTask",
    "CheckComponentsTask", "CheckSubGraphsTask", "ClearLiftedEdgesFromLabelsTask",
    "ComputeMeshesTask", "CopyVolumeTask", "CreateMultisetTask", "DownscaleMultisetTask",
    "DownscalingTask", "EdgeLabelsTask", "EmbeddingDistancesTask", "FillingSizeFilterTask",
    "FilterBlocksTask", "FindLabelingTask", "FindUniquesTask", "GradientsTask",
    "GraphConnectedComponentsTask", "GraphWatershedAssignmentsTask", "IdFilterTask",
    "IlastikPredictionTask", "ImageFilterTask", "InferenceTask", "InitialSubGraphsTask",
    "InsertAffinitiesTask", "kernel_params", "LabelBlockMappingTask", "LearnRFTask",
    "LIFTED_ASSIGNMENTS_NAME", "LiftedCostsFromNodeLabelsTask", "LinearTransformationTask",
    "MapEdgeIdsTask", "MAX_IDS_KEY", "MeasuresTask", "MergeAssignmentsTask",
    "MergeEdgeFeaturesTask", "MergeLiftedProblemsTask", "MergeMorphologyTask",
    "MergeNodeLabelsTask", "MergeObjectDistancesTask", "MergeOffsetsTask",
    "MergePredictionsTask", "MergeRegionFeaturesTask", "MergeScaleSubGraphsTask",
    "MergeSubGraphsTask", "MergeUniquesTask", "MinfilterTask", "MultiscaleInferenceTask",
    "MwsBlocksTask", "ObjectDistancesTask", "ObjectViTask", "OrphanAssignmentsTask",
    "PredictEdgeProbabilitiesTask", "ProbsToCostsTask", "ReducedAssignmentsTask",
    "ReduceLiftedProblemTask", "ReduceProblemTask", "RegionCentersTask", "RegionFeaturesTask",
    "ScaleToBoundariesTask", "SimpleStitchAssignmentsTask", "SimpleStitchEdgesTask",
    "SizeFilterTask", "SkeletonEvaluationTask", "SkeletonizeTask", "SolveGlobalTask",
    "SolveLiftedGlobalTask", "SolveLiftedSubproblemsTask", "SolveSubproblemsTask",
    "SparseLiftedNeighborhoodTask", "StackPredictionsTask", "STITCH_ASSIGNMENTS_NAME",
    "StitchAssignmentsTask", "StitchFacesTask", "StitchingMulticutTask", "SubSolutionsTask",
    "ThresholdTask", "TwoPassMwsTask", "TwoPassWatershedTask", "UniqueBlockLabelsTask",
    "UpsampleSkeletonsTask", "UpscalingTask", "WatershedFromSeedsTask", "WatershedTask",
    "WriteCarvingTask", "WriteTask",
]
