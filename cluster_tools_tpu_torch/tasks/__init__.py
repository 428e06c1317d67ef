from .watershed import MAX_IDS_KEY, WatershedTask, kernel_params

__all__ = ["MAX_IDS_KEY", "WatershedTask", "kernel_params"]
