from .affinities import EmbeddingDistancesTask, GradientsTask, InsertAffinitiesTask
from .agglomerative_clustering import AGGLO_ASSIGNMENTS_NAME, AgglomerativeClusteringTask
from .costs import ProbsToCostsTask
from .debugging import CheckComponentsTask, CheckSubGraphsTask
from .features import BlockEdgeFeaturesTask, MergeEdgeFeaturesTask
from .graph import InitialSubGraphsTask, MapEdgeIdsTask, MergeScaleSubGraphsTask, MergeSubGraphsTask
from .multicut import (
    ReduceProblemTask,
    ReducedAssignmentsTask,
    SolveGlobalTask,
    SolveSubproblemsTask,
    SubSolutionsTask,
)
from .mws import MwsBlocksTask, TwoPassMwsTask
from .region_features import ImageFilterTask, MergeRegionFeaturesTask, RegionFeaturesTask
from .stitching import STITCH_ASSIGNMENTS_NAME, StitchAssignmentsTask, StitchFacesTask
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
    "BlockComponentsTask", "BlockEdgeFeaturesTask", "BlockFacesTask", "CheckComponentsTask",
    "CheckSubGraphsTask", "EmbeddingDistancesTask", "GradientsTask", "ImageFilterTask",
    "InitialSubGraphsTask", "InsertAffinitiesTask",
    "MAX_IDS_KEY", "MapEdgeIdsTask", "MergeAssignmentsTask", "MergeEdgeFeaturesTask",
    "MergeOffsetsTask", "MergeRegionFeaturesTask", "MergeScaleSubGraphsTask",
    "MergeSubGraphsTask", "MwsBlocksTask", "ProbsToCostsTask", "ReduceProblemTask",
    "ReducedAssignmentsTask", "RegionFeaturesTask", "STITCH_ASSIGNMENTS_NAME",
    "SolveGlobalTask", "SolveSubproblemsTask", "StitchAssignmentsTask", "StitchFacesTask",
    "SubSolutionsTask", "TwoPassMwsTask", "TwoPassWatershedTask",
    "WatershedFromSeedsTask", "WatershedTask", "WriteTask", "kernel_params",
]
