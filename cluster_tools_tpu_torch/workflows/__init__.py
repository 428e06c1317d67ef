from .thresholded_components import ThresholdAndWatershedWorkflow, ThresholdedComponentsWorkflow
from .watershed import WatershedWorkflow

__all__ = ["ThresholdAndWatershedWorkflow", "ThresholdedComponentsWorkflow", "WatershedWorkflow"]
