from .thresholded_components import ThresholdedComponentsWorkflow
from .watershed import WatershedWorkflow

__all__ = ["ThresholdedComponentsWorkflow", "WatershedWorkflow"]
