"""Label-table application (port of the part of
``cluster_tools_tpu/ops/relabel.py`` that ``WriteTask`` uses)."""

from __future__ import annotations

import numpy as np


def apply_assignment_table_np(
    labels: np.ndarray, table: np.ndarray, default_zero: bool = True
) -> np.ndarray:
    """Apply a 2-column (old_id, new_id) assignment table; ids absent from
    the table map to 0 (``default_zero``) or pass through unchanged."""
    if table.shape[0] == 0:
        return np.zeros_like(labels) if default_zero else labels.copy()
    old, new = table[:, 0], table[:, 1]
    order = np.argsort(old)
    old, new = old[order], new[order]
    idx = np.searchsorted(old, labels.reshape(-1))
    idx = np.clip(idx, 0, old.size - 1)
    found = old[idx] == labels.reshape(-1)
    out = np.where(found, new[idx], 0 if default_zero else labels.reshape(-1))
    return out.reshape(labels.shape).astype(labels.dtype)
