"""Workflow DAG runner: topological execution with resume.

Port of ``cluster_tools_tpu/runtime/workflow.py``: a workflow's
``requires()`` builds the dependency chain and ``build([task])`` runs the
incomplete tasks in topological order, skipping those whose status file
says complete — re-running a workflow resumes at the first incomplete task.
Stream fusion of task chains is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from . import config as cfg
from .task import Target, Task


class WorkflowBase(Task):
    """A composite task: ``requires()`` returns the chain; completion
    mirrors its members."""

    def __init__(
        self,
        tmp_folder: str,
        config_dir: Optional[str] = None,
        max_jobs: Optional[int] = None,
        target: Optional[str] = None,
        dependencies: Sequence[Task] = (),
    ):
        super().__init__(tmp_folder, config_dir, max_jobs, dependencies)
        self.target = target  # informational; the global config decides

    def run(self) -> None:
        pass  # members do the work

    def output(self) -> Target:
        reqs = list(self.requires())
        return reqs[-1].output() if reqs else super().output()

    def complete(self) -> bool:
        reqs = list(self.requires())
        return all(r.complete() for r in reqs) if reqs else super().complete()

    @classmethod
    def get_config(cls) -> Dict[str, dict]:
        return {"global": dict(cfg.DEFAULT_GLOBAL_CONFIG)}


def _task_key(task: Task) -> str:
    return f"{type(task).__module__}.{type(task).__qualname__}:{task.output().path}"


def _toposort(roots: Sequence[Task]) -> List[Task]:
    order: List[Task] = []
    seen: Dict[str, Task] = {}
    visiting: set = set()

    def visit(task: Task) -> None:
        key = _task_key(task)
        if key in seen:
            return
        if key in visiting:
            raise RuntimeError(f"dependency cycle at {task!r}")
        visiting.add(key)
        for dep in task.requires():
            visit(dep)
        visiting.discard(key)
        seen[key] = task
        order.append(task)

    for t in roots:
        visit(t)
    return order


def build(tasks: Sequence[Task], raise_on_failure: bool = True) -> bool:
    """Run root tasks and their dependencies; returns success."""
    for task in _toposort(tasks):
        if task.complete():
            continue
        try:
            task.run()
        except Exception:
            if raise_on_failure:
                raise
            import traceback

            traceback.print_exc()
            return False
        if isinstance(task, WorkflowBase):
            continue
        if not task.complete():
            msg = f"task {task!r} ran but did not reach completion"
            if raise_on_failure:
                raise RuntimeError(msg)
            print(msg)
            return False
    return True
