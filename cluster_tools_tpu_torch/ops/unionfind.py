"""Union-find for global label merging.

Port of ``cluster_tools_tpu/ops/unionfind.py``:

  * ``UnionFindNp`` / ``merge_assignments_np`` — host numpy, iterative with
    full path compression (the single-shot merge tasks);
  * ``merge_labels_device`` — pointer jumping on a torch device: link every
    edge's larger root to its smaller one (``scatter_reduce_`` with
    ``amin`` resolves duplicates), then two pointer jumps, repeated until
    nothing changes;
  * ``merge_value_table`` / ``apply_value_roots`` — the compact form over the
    values that occur in the pairs (``torch.sort`` + ``torch.searchsorted``),
    for sparse id spaces such as tile-face equivalences.

Every class resolves to its minimal id, so all forms give the same roots.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class UnionFindNp:
    """Array-based union-find with path compression (host)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.int64)
        root = self.parent[x]
        # iterate until fixpoint (vectorized path walk)
        while True:
            nxt = self.parent[root]
            if (nxt == root).all():
                break
            root = nxt
        return root

    def merge(self, a: np.ndarray, b: np.ndarray) -> None:
        """Union pairs; roots are merged towards the smaller id."""
        a = np.asarray(a, dtype=np.int64).reshape(-1)
        b = np.asarray(b, dtype=np.int64).reshape(-1)
        # process iteratively: after each pass re-root and re-link
        while a.size:
            ra = self.find(a)
            rb = self.find(b)
            ne = ra != rb
            ra, rb = ra[ne], rb[ne]
            if ra.size == 0:
                break
            lo = np.minimum(ra, rb)
            hi = np.maximum(ra, rb)
            # link hi → lo; duplicate hi entries keep the smallest target
            order = np.lexsort((lo, hi))
            hi, lo = hi[order], lo[order]
            first = np.concatenate([[True], hi[1:] != hi[:-1]])
            self.parent[hi[first]] = lo[first]
            a, b = ra, rb  # re-check remaining conflicts next pass

    def compress(self) -> np.ndarray:
        """Full path compression; returns the root of every element."""
        while True:
            nxt = self.parent[self.parent]
            if (nxt == self.parent).all():
                break
            self.parent = nxt
        return self.parent


def _finalize_roots(
    roots: np.ndarray, consecutive: bool
) -> Tuple[np.ndarray, int]:
    roots[0] = 0
    if not consecutive:
        return roots, int(roots.max())
    uniq, inv = np.unique(roots, return_inverse=True)
    if uniq.size and uniq[0] == 0:
        assignment = inv.astype(np.int64)
        n_new = uniq.size - 1
    else:
        assignment = (inv + 1).astype(np.int64)
        n_new = uniq.size
    assignment[0] = 0
    return assignment, int(n_new)


def merge_assignments_np(
    n_labels: int, pairs: np.ndarray, consecutive: bool = True
) -> Tuple[np.ndarray, int]:
    """Merge equivalence ``pairs`` over ids [0, n_labels) and return a dense
    assignment array old_id → new_id (0 fixed to 0) plus the new max id."""
    uf = UnionFindNp(n_labels)
    if pairs.size:
        uf.merge(pairs[:, 0], pairs[:, 1])
    return _finalize_roots(uf.compress(), consecutive)


def merge_assignments_device(
    n_labels: int, pairs: np.ndarray, consecutive: bool = True, device="cuda"
) -> Tuple[np.ndarray, int]:
    """``merge_assignments_np`` with the id space on ``device`` (the card
    unless the caller names another): equivalences resolve by pointer
    jumping (``merge_labels_device``) instead of a host union-find."""
    dev = torch.device(device)
    parent = torch.arange(n_labels, dtype=torch.int64, device=dev)
    edges = torch.from_numpy(
        np.ascontiguousarray(np.asarray(pairs, dtype=np.int64).reshape(-1, 2))
    ).to(dev)
    roots = merge_labels_device(parent, edges).cpu().numpy()
    return _finalize_roots(roots, consecutive)


def merge_value_table(
    a_vals: torch.Tensor, b_vals: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Union-find over the *values* of the equivalence pairs
    ``(a_vals[i], b_vals[i])``: the parent table covers only the values that
    occur (O(#pairs) entries), not the id range they are drawn from.

    Returns ``(vals, root_vals)``: ``vals`` is the sorted multiset of all pair
    values and ``root_vals[i]`` the minimal value of the class of
    ``vals[i]``.  Positions in ``vals`` are order-isomorphic to the values,
    so link-to-min over positions resolves each class to its minimal value;
    duplicates share their leftmost slot.  Apply with ``apply_value_roots``.
    """
    vals, _ = torch.sort(torch.cat([a_vals.reshape(-1), b_vals.reshape(-1)]))
    edges = torch.stack(
        [torch.searchsorted(vals, a_vals.reshape(-1)),
         torch.searchsorted(vals, b_vals.reshape(-1))], dim=1,
    )
    roots = merge_labels_device(
        torch.arange(vals.shape[0], dtype=torch.int64, device=vals.device), edges
    )
    return vals, vals[roots]


def apply_value_roots(
    x: torch.Tensor, vals: torch.Tensor, root_vals: torch.Tensor
) -> torch.Tensor:
    """Map every element of ``x`` through a table from ``merge_value_table``;
    values absent from ``vals`` pass through unchanged."""
    n = vals.shape[0]
    if n == 0:
        return x
    idx = torch.clamp(torch.searchsorted(vals, x.reshape(-1)), 0, n - 1)
    hit = vals[idx] == x.reshape(-1)
    return torch.where(hit, root_vals[idx], x.reshape(-1)).view(x.shape)


def merge_labels_device(parent: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``parent`` a dense (n,) parent array, ``edges`` (m, 2) merge requests
    (rows with a == b merge nothing).  Iterates link-to-min over the edges
    plus two pointer jumps until stable; returns the compressed roots (the
    minimal id of every class)."""
    parent = parent.to(torch.int64)
    a = edges[:, 0].to(torch.int64)
    b = edges[:, 1].to(torch.int64)
    while True:
        ra, rb = parent[a], parent[b]
        lo, hi = torch.minimum(ra, rb), torch.maximum(ra, rb)
        new = parent.clone().scatter_reduce_(0, hi, lo, "amin")
        new = new[new]
        new = new[new]
        if torch.equal(new, parent):
            return parent
        parent = new
