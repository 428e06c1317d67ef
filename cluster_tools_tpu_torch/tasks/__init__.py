from .thresholded_components import (
    BlockComponentsTask,
    BlockFacesTask,
    MergeAssignmentsTask,
    MergeOffsetsTask,
)
from .watershed import MAX_IDS_KEY, WatershedFromSeedsTask, WatershedTask, kernel_params
from .write import WriteTask

__all__ = [
    "BlockComponentsTask", "BlockFacesTask", "MAX_IDS_KEY", "MergeAssignmentsTask",
    "MergeOffsetsTask", "WatershedFromSeedsTask", "WatershedTask", "WriteTask", "kernel_params",
]
