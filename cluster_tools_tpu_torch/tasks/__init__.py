from .agglomerative_clustering import AGGLO_ASSIGNMENTS_NAME, AgglomerativeClusteringTask
from .costs import ProbsToCostsTask
from .features import BlockEdgeFeaturesTask, MergeEdgeFeaturesTask
from .graph import InitialSubGraphsTask, MapEdgeIdsTask, MergeScaleSubGraphsTask, MergeSubGraphsTask
from .multicut import ReduceProblemTask, SolveGlobalTask, SolveSubproblemsTask
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
    "BlockComponentsTask", "BlockEdgeFeaturesTask", "BlockFacesTask", "InitialSubGraphsTask",
    "MAX_IDS_KEY", "MapEdgeIdsTask", "MergeAssignmentsTask", "MergeEdgeFeaturesTask",
    "MergeOffsetsTask", "MergeScaleSubGraphsTask", "MergeSubGraphsTask", "ProbsToCostsTask",
    "ReduceProblemTask", "SolveGlobalTask", "SolveSubproblemsTask", "TwoPassWatershedTask",
    "WatershedFromSeedsTask", "WatershedTask", "WriteTask", "kernel_params",
]
