from .thresholded_components import (
    BlockComponentsTask,
    BlockFacesTask,
    MergeAssignmentsTask,
    MergeOffsetsTask,
)
from .watershed import MAX_IDS_KEY, WatershedTask, kernel_params
from .write import WriteTask

__all__ = [
    "BlockComponentsTask", "BlockFacesTask", "MAX_IDS_KEY", "MergeAssignmentsTask",
    "MergeOffsetsTask", "WatershedTask", "WriteTask", "kernel_params",
]
