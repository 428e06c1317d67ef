from .watershed import WatershedWorkflow

__all__ = ["WatershedWorkflow"]
