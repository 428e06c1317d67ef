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
from .watershed import MAX_IDS_KEY, WatershedFromSeedsTask, WatershedTask, kernel_params
from .write import WriteTask

__all__ = [
    "BlockComponentsTask", "BlockEdgeFeaturesTask", "BlockFacesTask", "InitialSubGraphsTask",
    "MAX_IDS_KEY", "MapEdgeIdsTask", "MergeAssignmentsTask", "MergeEdgeFeaturesTask",
    "MergeOffsetsTask", "MergeScaleSubGraphsTask", "MergeSubGraphsTask", "ProbsToCostsTask",
    "ReduceProblemTask", "SolveGlobalTask", "SolveSubproblemsTask", "WatershedFromSeedsTask",
    "WatershedTask", "WriteTask", "kernel_params",
]
