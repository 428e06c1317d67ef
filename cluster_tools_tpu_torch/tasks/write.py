"""Write task: apply a node-label assignment to a label volume block-wise
(port of ``cluster_tools_tpu/tasks/write.py``).

Assignment modes (sniffed from the array on disk):
  * dense 1d array — ``out = assignment[labels]`` (labels must be dense ids);
  * 2-column table — (old_id, new_id) rows, looked up by searchsorted; ids
    absent from the table map to 0 (``table_default="zero"``) or pass
    through unchanged (``table_default="identity"``).

Optional per-block offsets (from merge_offsets) are added to non-zero labels
before the lookup.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..ops.relabel import apply_assignment_table_np
from ..utils.blocking import Blocking
from .base import VolumeTask


class WriteTask(VolumeTask):
    task_name = "write"
    output_dtype = "uint64"

    def __init__(
        self,
        *args,
        assignment_path: str = None,
        offsets_path: Optional[str] = None,
        identifier: Optional[str] = None,
        table_default: str = "zero",
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.assignment_path = assignment_path
        self.offsets_path = offsets_path
        self._identifier = identifier
        if table_default not in ("zero", "identity"):
            raise ValueError(
                f"table_default must be 'zero' or 'identity', got {table_default!r}"
            )
        self.table_default = table_default

    @property
    def identifier(self) -> str:
        # distinguishes several write tasks in one workflow
        return f"{self.task_name}_{self._identifier}" if self._identifier else self.task_name

    def _load_assignment(self) -> np.ndarray:
        if self.assignment_path.endswith(".npz"):
            with np.load(self.assignment_path) as f:
                return f[f.files[0]]
        return np.load(self.assignment_path)

    def process_block(self, block_id: int, blocking: Blocking, config: Dict[str, Any]):
        in_ds = self.input_ds()
        out_ds = self.output_ds()
        assignment = self._load_assignment()
        bb = blocking.block(block_id).slicing
        labels = in_ds[bb].astype(np.int64)
        if self.offsets_path is not None:
            with np.load(self.offsets_path) as f:
                offsets = f["offsets"]
            labels = np.where(labels > 0, labels + offsets[block_id], 0)
        if assignment.ndim == 1:
            out = assignment[labels]
        else:
            out = apply_assignment_table_np(
                labels.astype(np.uint64), assignment,
                default_zero=(self.table_default == "zero"),
            )
        out_ds[bb] = out.astype(np.uint64)
