from .affinities import EmbeddingDistancesTask, GradientsTask, InsertAffinitiesTask
from .agglomerative_clustering import AGGLO_ASSIGNMENTS_NAME, AgglomerativeClusteringTask
from .costs import ProbsToCostsTask
from .debugging import CheckComponentsTask, CheckSubGraphsTask
from .features import BlockEdgeFeaturesTask, MergeEdgeFeaturesTask
from .graph import InitialSubGraphsTask, MapEdgeIdsTask, MergeScaleSubGraphsTask, MergeSubGraphsTask
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
from .multicut import (
    ReduceProblemTask,
    ReducedAssignmentsTask,
    SolveGlobalTask,
    SolveSubproblemsTask,
    SubSolutionsTask,
)
from .morphology import BlockMorphologyTask, MergeMorphologyTask, RegionCentersTask
from .mws import MwsBlocksTask, TwoPassMwsTask
from .node_labels import BlockNodeLabelsTask, MergeNodeLabelsTask
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
from .stitching import (
    STITCH_ASSIGNMENTS_NAME,
    SimpleStitchAssignmentsTask,
    SimpleStitchEdgesTask,
    StitchAssignmentsTask,
    StitchFacesTask,
    StitchingMulticutTask,
)
from .threshold import ThresholdTask
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
    "AGGLO_ASSIGNMENTS_NAME", "AgglomerateTask", "AgglomerativeClusteringTask",
    "BackgroundSizeFilterTask", "BlockComponentsTask", "BlockEdgeFeaturesTask",
    "BlockFacesTask", "BlockMorphologyTask", "BlockNodeLabelsTask", "CheckComponentsTask",
    "CheckSubGraphsTask", "ClearLiftedEdgesFromLabelsTask", "EdgeLabelsTask",
    "EmbeddingDistancesTask", "FillingSizeFilterTask",
    "FilterBlocksTask", "FindLabelingTask", "FindUniquesTask", "GradientsTask",
    "GraphConnectedComponentsTask", "GraphWatershedAssignmentsTask", "IdFilterTask",
    "ImageFilterTask", "InitialSubGraphsTask", "InsertAffinitiesTask",
    "LIFTED_ASSIGNMENTS_NAME", "LearnRFTask", "LiftedCostsFromNodeLabelsTask",
    "MAX_IDS_KEY", "MapEdgeIdsTask", "MergeAssignmentsTask", "MergeEdgeFeaturesTask",
    "MergeLiftedProblemsTask", "MergeMorphologyTask", "MergeNodeLabelsTask", "MergeOffsetsTask",
    "MergeRegionFeaturesTask", "MergeScaleSubGraphsTask", "MergeSubGraphsTask",
    "MergeUniquesTask", "MwsBlocksTask", "OrphanAssignmentsTask",
    "PredictEdgeProbabilitiesTask", "ProbsToCostsTask", "ReduceLiftedProblemTask",
    "ReduceProblemTask", "ReducedAssignmentsTask", "RegionCentersTask",
    "RegionFeaturesTask", "STITCH_ASSIGNMENTS_NAME", "SimpleStitchAssignmentsTask",
    "SimpleStitchEdgesTask", "SizeFilterTask", "SolveGlobalTask", "SolveLiftedGlobalTask",
    "SolveLiftedSubproblemsTask", "SolveSubproblemsTask", "SparseLiftedNeighborhoodTask",
    "StitchAssignmentsTask", "StitchFacesTask", "StitchingMulticutTask", "SubSolutionsTask",
    "ThresholdTask", "TwoPassMwsTask", "TwoPassWatershedTask",
    "WatershedFromSeedsTask", "WatershedTask", "WriteTask", "kernel_params",
]
