"""One-flood hierarchical segmentation: build the merge hierarchy once,
re-cut it at any threshold (port of ``cluster_tools_tpu/ops/hier.py``).

For every pair of adjacent regions the hierarchy records the *saddle*: the
minimum over their shared boundary of ``max(h(p), h(q))``.  The
segmentation at merge threshold ``t`` unions every pair whose saddle is
≤ ``t``: a value-space union-find over the selected edges, then one gather
of the labels through the resolved roots.

  * ``block_merge_table`` — every canonical-offset adjacency of a labelled
    block (or a (B, Z, H, W) batch of blocks) as ``(a, b, saddle)`` columns
    of the JAX package's static length and slot order (``a < b``; slots
    that are not an edge between two regions carry ``(0, 0, BIG)``), in
    plain PyTorch on the tensor's device;
  * ``reduce_merge_table`` / ``merge_face_pairs`` / ``sort_by_saddle`` —
    host reductions to the per-pair minimum saddle;
  * ``cut_table`` — one ``searchsorted`` of the sorted saddles and one pass
    of ``ops.unionfind.merge_value_table`` on the device over the selected
    pairs, padded with self-loops of 0 to a power of two as in the JAX
    package, so that both give the same int32 ``(vals, roots)``;
    ``cut_table_np`` is the int64 host version past 2**31 regions;
  * ``recut_labels`` — the gather (``apply_value_roots``) on the device;
    it and ``block_merge_table`` count their calls on a card (``launches``);
    ``apply_cut_np`` its host twin; ``resegment_np`` the brute-force oracle;
  * ``save_hierarchy`` / ``load_hierarchy`` and ``save_cut_table`` /
    ``load_cut_table`` — the npz artifacts, in the JAX package's schema,
    so that each package reads the other's.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime.device import resolve_device
from ..utils.store import atomic_write_bytes
from ._build import count_on_card
from .cc import _canonical_offsets, shift
from .unionfind import UnionFindNp, apply_value_roots, merge_value_table

_BIG = np.float32(3.0e38)

HIER_SCHEMA_VERSION = 1
CUT_SCHEMA_VERSION = 1


# -- device: full-adjacency merge table of labelled blocks -----------------


def block_merge_table(
    labels: torch.Tensor,
    heights: torch.Tensor,
    connectivity: int = 1,
    per_slice: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-adjacency merge table of a labelled (Z, H, W) block, or of each
    block of a (B, Z, H, W) batch (then (B, E) columns): for every voxel
    pair ``(p, p + off)`` under the canonical half of the neighbourhood
    with distinct non-zero labels, ``(min, max, max(h(p), h(p + off)))``;
    ``len(offsets) * voxels`` slots per block, offset by offset."""
    lab = labels.to(torch.int32)
    h = heights.to(torch.float32)
    single = lab.dim() == 3
    if single:
        lab, h = lab[None], h[None]
    big = torch.tensor(float(_BIG), dtype=torch.float32, device=h.device)
    a_parts, b_parts, s_parts = [], [], []
    for off in _canonical_offsets(3, connectivity, per_slice):
        nei_l = shift(lab, off, 0)
        ok = (lab > 0) & (nei_l > 0) & (lab != nei_l)
        a_parts.append(torch.where(ok, torch.minimum(lab, nei_l), 0).flatten(1))
        b_parts.append(torch.where(ok, torch.maximum(lab, nei_l), 0).flatten(1))
        s_parts.append(torch.where(ok, torch.maximum(h, shift(h, off, float(_BIG))), big).flatten(1))
    cols = tuple(torch.cat(p, dim=1) for p in (a_parts, b_parts, s_parts))
    count_on_card(block_merge_table, lab)
    return tuple(c[0] for c in cols) if single else cols


block_merge_table.launches = 0


# -- host: reductions to per-pair minimum saddles --------------------------


def reduce_merge_table(
    a: np.ndarray, b: np.ndarray, saddle: np.ndarray, normalize: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce raw ``(a, b, saddle)`` columns to the per-pair minimum saddle:
    ``(pairs[k, 2] int64, saddles[k] float32)`` sorted by ``(a, b)``; slots
    with ``a == 0`` or ``b == 0`` drop.  ``normalize=False`` keeps each
    pair's sides (face pairs whose sides are in different id spaces)."""
    a = np.asarray(a).reshape(-1).astype(np.int64)
    b = np.asarray(b).reshape(-1).astype(np.int64)
    s = np.asarray(saddle).reshape(-1).astype(np.float32)
    keep = (a > 0) & (b > 0)
    if not keep.any():
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.float32)
    a, b, s = a[keep], b[keep], s[keep]
    if normalize:
        lo, hi = np.minimum(a, b), np.maximum(a, b)
    else:
        lo, hi = a, b
    order = np.lexsort((hi, lo))
    lo, hi, s = lo[order], hi[order], s[order]
    first = np.concatenate([[True], (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])])
    mins = np.minimum.reduceat(s, np.nonzero(first)[0])
    return np.stack([lo[first], hi[first]], axis=1), mins.astype(np.float32)


def merge_face_pairs(
    lo_labels: np.ndarray, hi_labels: np.ndarray,
    lo_heights: np.ndarray, hi_heights: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Edges across one 1-voxel block face: the label pairs and ``max`` of
    the two touching height planes, reduced to per-pair minimum saddles.
    The pairs stay side-ordered (lower block's ids first, both still
    block-local): the caller adds each side's offset."""
    lo = np.asarray(lo_labels).reshape(-1).astype(np.int64)
    hi = np.asarray(hi_labels).reshape(-1).astype(np.int64)
    s = np.maximum(np.asarray(lo_heights, np.float32).reshape(-1),
                   np.asarray(hi_heights, np.float32).reshape(-1))
    both = (lo > 0) & (hi > 0)
    return reduce_merge_table(lo[both], hi[both], s[both], normalize=False)


def sort_by_saddle(pairs: np.ndarray, saddles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Edges ascending by saddle, ties by pair: a threshold cut is then one
    ``searchsorted``."""
    order = np.lexsort((pairs[:, 1], pairs[:, 0], saddles))
    return pairs[order], saddles[order]


# -- artifacts --------------------------------------------------------------


def _save_npz(path: str, **arrays) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(path, buf.getvalue())


def save_hierarchy(path: str, pairs, saddles, n_labels: int, shape, block_shape) -> None:
    """Persist the global hierarchy (global ids), sorted by saddle."""
    pairs, saddles = sort_by_saddle(np.asarray(pairs, np.int64).reshape(-1, 2),
                                    np.asarray(saddles, np.float32).reshape(-1))
    _save_npz(
        path,
        schema=np.int64(HIER_SCHEMA_VERSION),
        a=pairs[:, 0],
        b=pairs[:, 1],
        saddle=saddles,
        n_labels=np.int64(n_labels),
        shape=np.asarray(shape, np.int64),
        block_shape=np.asarray(block_shape, np.int64),
    )


def load_hierarchy(path: str) -> dict:
    """Load a hierarchy artifact; raises on another schema or unsorted
    saddles."""
    with np.load(path) as f:
        out = {k: f[k] for k in f.files}
    schema = int(out.get("schema", -1))
    if schema != HIER_SCHEMA_VERSION:
        raise ValueError(f"hierarchy artifact {path!r} has schema {schema}, "
                         f"expected {HIER_SCHEMA_VERSION}")
    if not (np.diff(out["saddle"]) >= 0).all():
        raise ValueError(f"hierarchy artifact {path!r} is not sorted by saddle")
    return out


def save_cut_table(path: str, threshold: float, cut, n_labels: int) -> None:
    """Persist one threshold's relabel table (``cut`` from ``cut_table`` or
    ``cut_table_np``; None is the identity), its dtype kept."""
    vals, roots = (np.zeros(0, np.int32), np.zeros(0, np.int32)) if cut is None else cut
    _save_npz(
        path,
        schema=np.int64(CUT_SCHEMA_VERSION),
        threshold=np.float64(threshold),
        vals=np.asarray(vals),
        roots=np.asarray(roots),
        n_labels=np.int64(n_labels),
    )


def load_cut_table(path: str) -> dict:
    with np.load(path) as f:
        out = {k: f[k] for k in f.files}
    if int(out.get("schema", -1)) != CUT_SCHEMA_VERSION:
        raise ValueError(f"cut-table artifact {path!r}: schema mismatch")
    return out


# -- re-cut -------------------------------------------------------------------


def _pad_pow2(arr: np.ndarray, fill) -> np.ndarray:
    n = arr.shape[0]
    size = 1
    while size < n:
        size *= 2
    if size == n:
        return arr
    return np.concatenate([arr, np.full(size - n, fill, arr.dtype)])


def cut_table(a: np.ndarray, b: np.ndarray, saddle: np.ndarray, threshold: float,
              device=None) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Resolve the sorted hierarchy at ``threshold`` on ``device`` (the card
    unless the caller names another): the edges with ``saddle <=
    threshold``, one value-space union-find pass.  Returns int32 ``(vals,
    roots)`` (``vals`` sorted) or None when no edge is selected."""
    k = int(np.searchsorted(saddle, np.float32(threshold), side="right"))
    if k == 0:
        return None
    dev = resolve_device({"device": device})
    a_sel = torch.from_numpy(_pad_pow2(np.asarray(a[:k], np.int32), 0)).to(dev)
    b_sel = torch.from_numpy(_pad_pow2(np.asarray(b[:k], np.int32), 0)).to(dev)
    vals, roots = merge_value_table(a_sel, b_sel)
    return vals.cpu().numpy().astype(np.int32), roots.cpu().numpy().astype(np.int32)


def cut_table_np(a: np.ndarray, b: np.ndarray, saddle: np.ndarray, threshold: float
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``cut_table`` on the host in int64, for hierarchies past 2**31
    regions: ``vals`` are the distinct ids of the selected pairs."""
    k = int(np.searchsorted(saddle, np.float32(threshold), side="right"))
    if k == 0:
        return None
    a_sel = np.asarray(a[:k], np.int64)
    b_sel = np.asarray(b[:k], np.int64)
    vals = np.unique(np.concatenate([a_sel, b_sel]))
    uf = UnionFindNp(vals.size)
    # vals is sorted: merging dense ids to the smaller merges to the smaller value
    uf.merge(np.searchsorted(vals, a_sel), np.searchsorted(vals, b_sel))
    return vals, vals[uf.compress()]


def recut_labels(labels: torch.Tensor, vals: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """One gather of an int32 labels tensor through ``(vals, roots)``:
    labels absent from the table pass through; every merged class takes its
    minimum member id."""
    count_on_card(recut_labels, labels)
    return apply_value_roots(labels.to(torch.int32), vals.to(torch.int32), roots.to(torch.int32))


recut_labels.launches = 0


def apply_cut_np(labels: np.ndarray, vals: np.ndarray, roots: np.ndarray) -> np.ndarray:
    """``recut_labels`` in numpy (int64), for a persisted cut table."""
    lab = np.asarray(labels).astype(np.int64)
    vals = np.asarray(vals, np.int64)
    roots = np.asarray(roots, np.int64)
    if vals.size == 0:
        return lab
    idx = np.clip(np.searchsorted(vals, lab), 0, vals.size - 1)
    return np.where(vals[idx] == lab, roots[idx], lab)


def resegment_np(labels: np.ndarray, heights: np.ndarray, threshold: float,
                 connectivity: int = 1) -> np.ndarray:
    """Brute-force oracle: merge every pair of adjacent regions whose saddle
    is ≤ ``threshold`` with a host union-find over the full adjacency;
    merged classes take their minimum member id."""
    lab = np.asarray(labels).astype(np.int64)
    h = np.asarray(heights, np.float32)
    pairs_parts = []
    for off in _canonical_offsets(lab.ndim, connectivity, False):
        src = tuple(slice(None, -o) if o > 0 else slice(-o, None) for o in off)
        dst = tuple(slice(o, None) if o > 0 else slice(None, o or None) for o in off)
        la, lb = lab[src], lab[dst]
        ok = (la > 0) & (lb > 0) & (la != lb) & (np.maximum(h[src], h[dst]) <= np.float32(threshold))
        if ok.any():
            pairs_parts.append(np.stack([la[ok], lb[ok]], axis=1))
    if not pairs_parts:
        return lab
    pairs = np.concatenate(pairs_parts, axis=0)
    n = int(lab.max()) + 1
    if n <= 2**31:  # one int64 key per pair: a 1d unique, far faster than by rows
        keys = np.unique(pairs[:, 0] * n + pairs[:, 1])
        pairs = np.stack([keys // n, keys % n], axis=1)
    else:
        pairs = np.unique(pairs, axis=0)
    uf = UnionFindNp(n)
    uf.merge(pairs[:, 0], pairs[:, 1])
    return uf.compress()[lab]
