"""Paintera label multisets: per-voxel label histograms for multiscale labels
(a copy of ``cluster_tools_tpu/ops/label_multiset.py``, host numpy as there,
writing the same bytes; the serializer's list deduplication sorts one int64
key per voxel where JAX's sorts (offset, size) rows).

Replaces elf.label_multiset (reference label_multisets/create_multiset.py:25,
downscale_multiset.py:29).  A multiset assigns each voxel a list of
(label id, count) pairs; at scale 0 every voxel has one entry with count 1,
and each downscaling step pools the children's entries, so a coarse voxel
remembers every label beneath it — what paintera needs for consistent
painting across scales.

Serialization (big-endian, after the imglib2/paintera chunk layout):
  int32                 n_voxels
  int64[n_voxels]       argmax label per voxel (the majority label)
  int32[n_voxels]       byte offset of each voxel's entry list within the
                        entry-data region (shared lists deduplicated)
  entry data            per list: int32 N, then N x (int64 id, int32 count)

Everything here is vectorized numpy (byte scatters, repeat/cumsum gathers) —
the codec runs once per block per scale on the conversion hot path, so
per-voxel Python loops are not acceptable.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _gather_indices(offsets: np.ndarray, sizes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """For per-voxel contiguous slices [offset, offset+size): the flat entry
    indices of all voxels concatenated, plus each entry's voxel index."""
    total = int(sizes.sum())
    voxel_of_entry = np.repeat(np.arange(sizes.size), sizes)
    starts = np.repeat(offsets, sizes)
    within = np.arange(total) - np.repeat(
        np.cumsum(sizes) - sizes, sizes
    )
    return starts + within, voxel_of_entry


class LabelMultiset:
    """shape: spatial shape; per flat voxel v, entries are
    ids[entry_offsets[v] : entry_offsets[v] + entry_sizes[v]] / counts[...]."""

    def __init__(self, shape, entry_offsets, entry_sizes, ids, counts):
        self.shape = tuple(shape)
        self.n_voxels = int(np.prod(self.shape))
        self.entry_offsets = np.asarray(entry_offsets, dtype=np.int64)
        self.entry_sizes = np.asarray(entry_sizes, dtype=np.int64)
        self.ids = np.asarray(ids, dtype=np.uint64)
        self.counts = np.asarray(counts, dtype=np.int32)

    @property
    def argmax(self) -> np.ndarray:
        entry_idx, voxel_of_entry = _gather_indices(
            self.entry_offsets, self.entry_sizes
        )
        if entry_idx.size == 0:
            return np.zeros(self.n_voxels, dtype=np.uint64)
        counts = self.counts[entry_idx]
        ids = self.ids[entry_idx]
        # last entry per voxel after sorting by (voxel, count) is the argmax
        order = np.lexsort((counts, voxel_of_entry))
        voxel_s = voxel_of_entry[order]
        last = np.concatenate([voxel_s[1:] != voxel_s[:-1], [True]])
        out = np.zeros(self.n_voxels, dtype=np.uint64)
        out[voxel_s[last]] = ids[order][last]
        return out

    def voxel_entries(self, v: int):
        o, s = self.entry_offsets[v], self.entry_sizes[v]
        return self.ids[o : o + s], self.counts[o : o + s]


def create_multiset_from_labels(labels: np.ndarray) -> LabelMultiset:
    """Scale-0 multiset: one (label, 1) entry per voxel."""
    flat = labels.reshape(-1).astype(np.uint64)
    n = flat.size
    return LabelMultiset(
        labels.shape,
        entry_offsets=np.arange(n, dtype=np.int64),
        entry_sizes=np.ones(n, dtype=np.int64),
        ids=flat,
        counts=np.ones(n, dtype=np.int32),
    )


def downsample_multiset(
    multiset: LabelMultiset,
    scale_factor: Sequence[int],
    restrict_set: int = -1,
) -> LabelMultiset:
    """Pool scale_factor-sized voxel windows, summing entry counts;
    ``restrict_set`` > 0 keeps only the top-count entries per coarse voxel
    (paintera's maxNumEntries, reference downscale_multiset.py)."""
    sf = tuple(int(s) for s in scale_factor)
    shape = multiset.shape
    new_shape = tuple(-(-s // f) for s, f in zip(shape, sf))

    # coarse voxel of every fine voxel
    fine_idx = np.indices(shape).reshape(3, -1)
    coarse = [fi // f for fi, f in zip(fine_idx, sf)]
    coarse_of_voxel = np.ravel_multi_index(coarse, new_shape)

    # expand all entries, tag with coarse voxel, then aggregate (coarse, id)
    entry_idx, voxel_of_entry = _gather_indices(
        multiset.entry_offsets, multiset.entry_sizes
    )
    e_coarse = coarse_of_voxel[voxel_of_entry]
    e_ids = multiset.ids[entry_idx]
    e_counts = multiset.counts[entry_idx].astype(np.int64)

    order = np.lexsort((e_ids, e_coarse))
    e_coarse, e_ids, e_counts = (
        e_coarse[order], e_ids[order], e_counts[order]
    )
    newgroup = np.concatenate(
        [[True], (e_coarse[1:] != e_coarse[:-1]) | (e_ids[1:] != e_ids[:-1])]
    )
    group = np.cumsum(newgroup) - 1
    g_coarse = e_coarse[newgroup]
    g_ids = e_ids[newgroup]
    g_counts = np.zeros(group[-1] + 1, dtype=np.int64)
    np.add.at(g_counts, group, e_counts)

    if restrict_set > 0:
        # keep top-restrict_set counts per coarse voxel: sort by
        # (coarse, -count), rank within group, filter
        order2 = np.lexsort((-g_counts, g_coarse))
        gc, gi, gn = g_coarse[order2], g_ids[order2], g_counts[order2]
        newv = np.concatenate([[True], gc[1:] != gc[:-1]])
        group_start = np.maximum.accumulate(np.where(newv, np.arange(gc.size), 0))
        rank = np.arange(gc.size) - group_start
        keep = rank < restrict_set
        gc, gi, gn = gc[keep], gi[keep], gn[keep]
        # restore (coarse, id) order
        order3 = np.lexsort((gi, gc))
        g_coarse, g_ids, g_counts = gc[order3], gi[order3], gn[order3]

    sizes = np.bincount(g_coarse, minlength=int(np.prod(new_shape))).astype(
        np.int64
    )
    entry_offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return LabelMultiset(
        new_shape,
        entry_offsets=entry_offsets,
        entry_sizes=sizes,
        ids=g_ids,
        counts=g_counts.astype(np.int32),
    )


def merge_multisets(multisets, positions, shape) -> LabelMultiset:
    """Assemble a larger multiset from sub-multisets at given corner
    ``positions`` (fills gaps with background (0, 1) entries)."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    entry_offsets = np.full(n, -1, dtype=np.int64)
    entry_sizes = np.zeros(n, dtype=np.int64)
    ids_parts, counts_parts = [], []
    cursor = 0
    region_idx = np.arange(n).reshape(shape)
    for sub, pos in zip(multisets, positions):
        sl = tuple(
            slice(p, p + s) for p, s in zip(pos, sub.shape)
        )
        targets = region_idx[sl].reshape(-1)
        entry_offsets[targets] = cursor + sub.entry_offsets
        entry_sizes[targets] = sub.entry_sizes
        ids_parts.append(sub.ids)
        counts_parts.append(sub.counts)
        cursor += sub.ids.size
    missing = entry_offsets < 0
    if missing.any():
        m = int(missing.sum())
        entry_offsets[missing] = cursor + np.arange(m)
        entry_sizes[missing] = 1
        ids_parts.append(np.zeros(m, dtype=np.uint64))
        counts_parts.append(np.ones(m, dtype=np.int32))
    return LabelMultiset(
        shape,
        entry_offsets,
        entry_sizes,
        np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.uint64),
        np.concatenate(counts_parts) if counts_parts else np.zeros(0, np.int32),
    )


def _scatter_bytes(buf: np.ndarray, positions: np.ndarray, payload: np.ndarray):
    """buf[positions[i] : positions[i]+w] = payload[i] for fixed width w."""
    w = payload.shape[1]
    idx = positions[:, None] + np.arange(w)[None, :]
    buf[idx.reshape(-1)] = payload.reshape(-1)


def _unique_slices(offsets: np.ndarray, sizes: np.ndarray):
    """``np.unique`` of the (offset, size) rows with ``return_inverse``, in
    the same lexicographic order, each row keyed as one int64 (a 1-d sort
    instead of a sort of row views; offsets count entries and sizes a
    voxel's entries, so the key stays far below 2**63)."""
    span = int(sizes.max()) + 1
    uniq, inverse = np.unique(offsets * span + sizes, return_inverse=True)
    return uniq // span, uniq % span, inverse.reshape(-1)


def serialize_multiset(multiset: LabelMultiset) -> np.ndarray:
    """→ uint8 payload (the varlen chunk body); fully vectorized."""
    n = multiset.n_voxels
    offsets = multiset.entry_offsets
    sizes = multiset.entry_sizes

    # deduplicate shared lists by their (offset, size) slice identity
    u_off, u_size, voxel_list = _unique_slices(offsets, sizes)
    list_bytes = 4 + 12 * u_size
    list_pos = np.concatenate([[0], np.cumsum(list_bytes)[:-1]])
    region_size = int(list_bytes.sum())

    region = np.zeros(region_size, dtype=np.uint8)
    # headers
    _scatter_bytes(
        region, list_pos,
        np.ascontiguousarray(u_size.astype(">i4")).view(np.uint8).reshape(-1, 4),
    )
    # entries
    entry_idx, list_of_entry = _gather_indices(u_off, u_size)
    within = np.arange(entry_idx.size) - np.repeat(
        np.cumsum(u_size) - u_size, u_size
    )
    entry_pos = np.repeat(list_pos + 4, u_size) + 12 * within
    rec = np.zeros(entry_idx.size, dtype=[("id", ">i8"), ("count", ">i4")])
    rec["id"] = multiset.ids[entry_idx].astype(np.int64)
    rec["count"] = multiset.counts[entry_idx]
    _scatter_bytes(region, entry_pos, rec.view(np.uint8).reshape(-1, 12))

    header = np.asarray([n], dtype=">i4").view(np.uint8)
    argmax = (
        np.ascontiguousarray(multiset.argmax.astype(">i8")).view(np.uint8)
    )
    voxel_offsets = (
        np.ascontiguousarray(list_pos[voxel_list].astype(">i4")).view(np.uint8)
    )
    return np.concatenate([header, argmax, voxel_offsets, region])


def deserialize_multiset(payload: np.ndarray, shape: Sequence[int]) -> LabelMultiset:
    buf = np.ascontiguousarray(np.asarray(payload, dtype=np.uint8))
    n = int(buf[:4].view(">i4")[0])
    if int(np.prod(shape)) != n:
        raise ValueError(
            f"multiset has {n} voxels, shape {shape} expects "
            f"{int(np.prod(shape))}"
        )
    pos = 4 + 8 * n  # skip argmax (recomputable)
    voxel_offsets = buf[pos : pos + 4 * n].view(">i4").astype(np.int64)
    pos += 4 * n
    region = buf[pos:]

    uniq_pos, voxel_list = np.unique(voxel_offsets, return_inverse=True)
    # list sizes from the int32 headers
    hdr_idx = uniq_pos[:, None] + np.arange(4)[None, :]
    u_size = (
        np.ascontiguousarray(region[hdr_idx.reshape(-1)])
        .view(">i4")
        .astype(np.int64)
    )
    # entry records
    entry_idx, list_of_entry = _gather_indices(
        np.zeros(u_size.size, dtype=np.int64), u_size
    )
    within = np.arange(entry_idx.size) - np.repeat(
        np.cumsum(u_size) - u_size, u_size
    )
    entry_pos = np.repeat(uniq_pos + 4, u_size) + 12 * within
    rec_idx = entry_pos[:, None] + np.arange(12)[None, :]
    rec = (
        np.ascontiguousarray(region[rec_idx.reshape(-1)])
        .view([("id", ">i8"), ("count", ">i4")])
    )
    ids = rec["id"].astype(np.int64).astype(np.uint64)
    counts = rec["count"].astype(np.int32)

    u_offsets = np.concatenate([[0], np.cumsum(u_size)[:-1]])
    return LabelMultiset(
        shape,
        entry_offsets=u_offsets[voxel_list],
        entry_sizes=u_size[voxel_list],
        ids=ids,
        counts=counts,
    )
