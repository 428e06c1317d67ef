"""Consecutive relabelling and label-table application (port of
``cluster_tools_tpu/ops/relabel.py``).

``relabel_consecutive`` and ``apply_mapping`` run on the tensor's device:
a sorted unique, then ``searchsorted``, and one gather.  The ``*_np``
functions are the host versions for global (uint64) label volumes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _as_int64(labels: torch.Tensor, what: str) -> torch.Tensor:
    """``labels`` as int64 for sort, search and gather, which torch lacks for
    uint64 on many builds: a uint64 tensor must hold only ids below 2**63
    (checked, never truncated)."""
    if labels.dtype == torch.int64:
        return labels
    if labels.dtype == torch.uint64:
        as_i64 = labels.view(torch.int64)
        if as_i64.numel() and bool((as_i64 < 0).any()):
            raise ValueError(f"{what}: uint64 ids at or above 2**63 do not fit int64")
        return as_i64
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"{what}: integer labels expected, got {labels.dtype}")
    return labels.to(torch.int64)


def relabel_consecutive(
    labels: torch.Tensor, max_labels: int, keep_zero: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map non-negative labels to consecutive ids preserving order, on the
    tensor's device.

    ``max_labels`` bounds the distinct labels (labels must be below the
    dtype's maximum, the pad sentinel).  With ``keep_zero`` label 0 stays 0
    and the others become 1..n; otherwise ranks are 0..n-1.  Returns
    ``(relabelled, n_labels)`` (``n_labels`` an int32 scalar tensor) where n
    excludes zero with ``keep_zero``.

    Overflow contract (the JAX function's, whose unique has a static
    size): past ``max_labels`` distinct values only the ``max_labels``
    smallest keep their rank; every larger label aliases to rank
    ``max_labels``.  Callers treat ``n_labels == max_labels`` (or
    ``max_labels - 1`` with ``keep_zero``) as saturation and re-run with a
    larger bound.
    """
    dtype = labels.dtype
    flat = _as_int64(labels.reshape(-1), "relabel_consecutive")
    uniq = torch.unique(flat)[:max_labels]
    idx = torch.searchsorted(uniq, flat)
    # the dtype's maximum is the pad value of JAX's fixed-size unique and is
    # not counted; uint64 ids were checked to lie below 2**63, under it
    if dtype == torch.uint64:
        n_uniq = torch.tensor(uniq.numel(), dtype=torch.int32, device=uniq.device)
    else:
        n_uniq = (uniq < torch.iinfo(dtype).max).sum(dtype=torch.int32)
    if keep_zero:
        has_zero = (uniq == 0).any()
        shift = 1 - has_zero.to(torch.int64)
        new = torch.where(flat == 0, torch.zeros_like(idx), idx + shift)
        n = n_uniq - has_zero.to(torch.int32)
        return _back(new, dtype).reshape(labels.shape), n
    return _back(idx, dtype).reshape(labels.shape), n_uniq


def _back(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.uint64) if dtype == torch.uint64 else x.to(dtype)


def relabel_consecutive_np(
    labels: np.ndarray, keep_zero: bool = True
) -> Tuple[np.ndarray, int]:
    """Host relabelling for global (uint64) label volumes."""
    uniq, inv = np.unique(labels, return_inverse=True)
    inv = inv.reshape(labels.shape)
    if keep_zero and uniq.size and uniq[0] == 0:
        return inv.astype(labels.dtype), int(uniq.size - 1)
    return (inv + 1).astype(labels.dtype) if keep_zero else inv.astype(labels.dtype), int(
        uniq.size
    )


def apply_mapping_np(labels: np.ndarray, mapping: np.ndarray) -> np.ndarray:
    """labels → mapping[labels] with a dense mapping array."""
    return mapping[labels]


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


def apply_mapping(labels: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
    """Device gather: labels → mapping[labels]."""
    idx = _as_int64(labels.reshape(-1), "apply_mapping")
    return mapping[idx].reshape(labels.shape)
