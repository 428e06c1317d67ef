from . import config
from .executor import get_executor, register_executor
from .task import BlockTask, FailedBlocksError, SimpleTask, Target, Task
from .workflow import WorkflowBase, build

__all__ = [
    "config", "get_executor", "register_executor", "BlockTask",
    "FailedBlocksError", "SimpleTask", "Target", "Task", "WorkflowBase", "build",
]
