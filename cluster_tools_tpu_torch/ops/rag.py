"""Region adjacency graph extraction and edge-feature accumulation.

Port of ``cluster_tools_tpu/ops/rag.py``'s boundary-map path.  Replaces
nifty.distributed's graph/feature layer (SURVEY.md §2.10:
computeMergeableRegionGraph, extractBlockFeaturesFromBoundaryMaps,
mergeFeatureBlocks, Graph).

Host path (numpy, a copy of the JAX package's, bit-identical): face-pair
extraction is vectorized (adjacent-voxel label pairs per axis); uniquing and
per-edge statistics run as sort-based reductions (np.lexsort + reduceat).
Three accumulators share it: boundary maps (``boundary_edge_features``),
a bank of filter responses (``filter_edge_features``: 9 statistics per
response and one count) and affinity maps with per-channel offsets
(``affinity_edge_features``, the min-corner owner rule).

Edge features (10 per edge, the reference's default feature width —
block_edge_features.py:146-148):
  [mean, variance, min, q10, q25, q50, q75, q90, max, count]
accumulated over the boundary-map values sampled on both sides of each label
face.  Cross-block merging combines (count, mean, var, min, max) exactly;
quantiles merge through a per-edge ``HIST_BINS``-bin histogram sketch over the
normalized [0, 1] value range (block partials carry the bin counts), so the
merged quantile error is bounded by one bin width with linear interpolation;
partials without histogram columns fall back to count-weighted quantile
averaging, and ``quantile_mode: "exact"`` partials (raw samples) merge
exactly (``merge_edge_features_multi``).

Device path (``boundary_edge_features_device``, plain PyTorch on the
tensors' device; XLA in the JAX package): the same statistics from one
sort of the face rows, float32 moments.  Edges, counts, histograms, minima,
maxima and quantiles equal the host path's; the moments hold its tolerance.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

N_FEATURES = 10
HIST_BINS = 64
QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9)

# int32 max: the endpoint of an invalid face row, which sorts after every
# real (u, v) pair
SENTINEL = int(np.iinfo(np.int32).max)


def block_edges(labels: np.ndarray, ignore_zero: bool = True) -> np.ndarray:
    """Unique adjacent label pairs (u < v) over face-neighbor voxels."""
    pairs = []
    for axis in range(labels.ndim):
        lo = np.moveaxis(labels, axis, 0)[:-1].reshape(-1)
        hi = np.moveaxis(labels, axis, 0)[1:].reshape(-1)
        sel = lo != hi
        if ignore_zero:
            sel &= (lo != 0) & (hi != 0)
        if sel.any():
            a, b = lo[sel], hi[sel]
            pairs.append(np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1))
    if not pairs:
        return np.zeros((0, 2), dtype=labels.dtype)
    # the rows' unique, in their lexicographic order, as a 1d unique of one
    # integer key per row: ``np.unique(axis=0)`` sorts row records under the
    # interpreter lock, which serialises the block threads
    pairs = np.concatenate(pairs, axis=0)
    ids, inv = np.unique(pairs, return_inverse=True)
    inv = inv.reshape(pairs.shape).astype(np.int64)
    key = np.unique(inv[:, 0] * ids.size + inv[:, 1])
    return np.stack([ids[key // ids.size], ids[key % ids.size]], axis=1)


def _owner_mask(shape, owner_shape) -> Optional[np.ndarray]:
    """True where a voxel lies inside the owning (inner) block region.

    Blocks read a +1 upper halo so cross-block faces are seen; a face is
    *owned* by the block containing its lower voxel.  Without this mask the
    orthogonal faces inside the halo slabs are accumulated by both adjacent
    blocks, double-counting their samples in the merged features."""
    if owner_shape is None:
        return None
    owned = np.ones(shape, dtype=bool)
    for d, s in enumerate(owner_shape):
        owned[(slice(None),) * d + (slice(s, None),)] = False
    return owned


def _face_values(
    labels: np.ndarray, values: np.ndarray, owner_shape=None
):
    """(u, v, sample) triples: for every face between two different labels, the
    boundary-map values on both sides of the face.  A thin gather over
    ``face_sample_indices`` — the owned-face rule lives there, once."""
    u, v, ilo, ihi = face_sample_indices(labels, owner_shape)
    flat = values.reshape(-1)
    return (
        np.concatenate([u, u]),
        np.concatenate([v, v]),
        np.concatenate([flat[ilo], flat[ihi]]).astype(np.float64),
    )


def _edge_group_features(u, v, s, dtype, hist_bins: int = 0,
                         return_samples: bool = False):
    """Shared per-edge statistics over (u, v, sample) triples.

    Returns ``(edges [m,2], features [m,10])`` with edges sorted
    lexicographically — or ``(edges, features, hist [m,hist_bins] uint32)``
    when ``hist_bins > 0``: the per-edge histogram of the samples (assumed in
    [0, 1], clipped), the compact mergeable quantile sketch consumed by
    ``merge_edge_features``.  With ``return_samples`` the per-edge sorted
    sample vector (edge-major, spans given by the count column) is appended —
    the raw material of the exact cross-block quantile merge.
    """
    if u.size == 0:
        empty = (
            np.zeros((0, 2), dtype=dtype),
            np.zeros((0, N_FEATURES)),
        )
        if hist_bins:
            empty = empty + (np.zeros((0, hist_bins), dtype=np.uint32),)
        if return_samples:
            empty = empty + (np.zeros(0, dtype=np.float64),)
        return empty
    order = np.lexsort((s, v, u))
    u, v, s = u[order], v[order], s[order]
    first = np.concatenate([[True], (u[1:] != u[:-1]) | (v[1:] != v[:-1])])
    starts = np.nonzero(first)[0]
    edges = np.stack([u[starts], v[starts]], axis=1)
    counts = np.diff(np.append(starts, u.size)).astype(np.float64)

    sums = np.add.reduceat(s, starts)
    sums2 = np.add.reduceat(s * s, starts)
    mean = sums / counts
    var = np.maximum(sums2 / counts - mean**2, 0.0)
    mins = np.minimum.reduceat(s, starts)
    maxs = np.maximum.reduceat(s, starts)
    # quantiles: values are sorted within each edge group (lexsort key order)
    qs = []
    for q in QUANTILES:
        pos = starts + np.minimum(
            (q * (counts - 1)).astype(np.int64), (counts - 1).astype(np.int64)
        )
        qs.append(s[pos])
    cols = [mean, var, mins, *qs, maxs, counts]
    feats = np.stack(cols, axis=1)
    out = (edges, feats)
    if hist_bins:
        group = np.cumsum(first) - 1
        bins = np.clip((s * hist_bins).astype(np.int64), 0, hist_bins - 1)
        hist = np.bincount(
            group * hist_bins + bins, minlength=edges.shape[0] * hist_bins
        ).reshape(edges.shape[0], hist_bins).astype(np.uint32)
        out = out + (hist,)
    if return_samples:
        out = out + (s,)
    return out


def boundary_edge_features(
    labels: np.ndarray,
    boundary_map: np.ndarray,
    hist_bins: int = 0,
    owner_shape=None,
    return_samples: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-edge feature matrix over the label faces of one block.

    ``owner_shape`` restricts accumulation to faces owned by the inner block
    when ``labels`` carries a +1 upper halo (see ``_owner_mask``); with
    ``hist_bins > 0`` a third return carries the per-edge histogram sketch;
    with ``return_samples`` the last return is the per-edge sorted sample
    vector (exact quantile-merge partials)."""
    u, v, s = _face_values(
        labels, boundary_map.astype(np.float64), owner_shape
    )
    return _edge_group_features(
        u, v, s, labels.dtype, hist_bins, return_samples
    )


def face_sample_indices(labels: np.ndarray, owner_shape=None):
    """Face geometry computed once, shared across value channels.

    Returns ``(u, v, ilo, ihi)``: for every owned face between two different
    non-zero labels, the label pair (u < v) and the flat indices of the two
    face voxels into ``labels.ravel()``.  A channel's (u, v, sample) triples
    are then ``(cat(u, u), cat(v, v), cat(vals.flat[ilo], vals.flat[ihi]))`` —
    both sides of a face sample the boundary evidence, exactly as
    ``_face_values`` does."""
    owned = _owner_mask(labels.shape, owner_shape)
    flat_idx = np.arange(labels.size, dtype=np.int64).reshape(labels.shape)
    us, vs, ilos, ihis = [], [], [], []
    for axis in range(labels.ndim):
        lab0 = np.moveaxis(labels, axis, 0)
        idx0 = np.moveaxis(flat_idx, axis, 0)
        lo, hi = lab0[:-1].reshape(-1), lab0[1:].reshape(-1)
        sel = (lo != hi) & (lo != 0) & (hi != 0)
        if owned is not None:
            sel &= np.moveaxis(owned, axis, 0)[:-1].reshape(-1)
        if not sel.any():
            continue
        us.append(np.minimum(lo[sel], hi[sel]))
        vs.append(np.maximum(lo[sel], hi[sel]))
        ilos.append(idx0[:-1].reshape(-1)[sel])
        ihis.append(idx0[1:].reshape(-1)[sel])
    if not us:
        z = np.zeros(0, dtype=np.int64)
        return np.zeros(0, dtype=labels.dtype), np.zeros(0, dtype=labels.dtype), z, z
    return (
        np.concatenate(us), np.concatenate(vs),
        np.concatenate(ilos), np.concatenate(ihis),
    )


def filter_edge_features(
    labels: np.ndarray,
    responses: Sequence[np.ndarray],
    owner_shape=None,
    return_samples: bool = False,
):
    """Edge features over a bank of filter responses (the reference's
    filter-accumulation path, block_edge_features.py:151-238 via
    ndist.accumulateInput): 9 statistics [mean, var, min, q10, q25, q50,
    q75, q90, max] per response channel plus ONE trailing count column.

    ``responses`` are label-shaped float arrays (one per filter × sigma ×
    channel, the caller's flattening of multichannel filters).  Returns
    ``(edges [m,2], feats [m, 9*G+1])`` and, with ``return_samples``, the
    group-major flat sample array ``[G * total_count]`` (each group's
    samples edge-major sorted — the exact-merge partials consumed by
    ``merge_edge_features_multi``)."""
    G = len(responses)
    u0, v0, ilo, ihi = face_sample_indices(labels, owner_shape)
    u = np.concatenate([u0, u0])
    v = np.concatenate([v0, v0])
    edges = None
    feat_groups, sample_groups = [], []
    count = None
    for resp in responses:
        if resp.shape != labels.shape:
            raise ValueError(
                f"response shape {resp.shape} != labels shape {labels.shape}"
            )
        flat = resp.reshape(-1).astype(np.float64)
        s = np.concatenate([flat[ilo], flat[ihi]])
        e, f, samp = _edge_group_features(
            u, v, s, labels.dtype, 0, return_samples=True
        )
        if edges is None:
            edges = e
            count = f[:, 9]
        feat_groups.append(f[:, :9])
        if return_samples:
            sample_groups.append(samp)
    if edges is None or edges.shape[0] == 0:
        feats = np.zeros((0, 9 * G + 1))
        if return_samples:
            return np.zeros((0, 2), dtype=labels.dtype), feats, np.zeros(0)
        return np.zeros((0, 2), dtype=labels.dtype), feats
    feats = np.concatenate(feat_groups + [count[:, None]], axis=1)
    if return_samples:
        return edges, feats, np.concatenate(sample_groups)
    return edges, feats


def affinity_edge_features(
    labels: np.ndarray,
    affs: np.ndarray,
    offsets: Sequence[Sequence[int]],
    hist_bins: int = 0,
    owner_shape=None,
    return_samples: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Edge features from an affinity map [C, *spatial] with per-channel offsets
    (reference extractBlockFeaturesFromAffinityMaps).  Samples the affinity
    value at the source voxel of each offset-crossing label pair.

    With ``owner_shape`` a pair is accumulated iff its *min-corner* voxel
    (elementwise min of the two endpoints) lies in the inner block — a global
    rule assigning every pair to exactly one block regardless of offset sign,
    so a cross-face pair of a negative offset is owned by the lower block
    (which sees it through the +1 upper halo) instead of being dropped.
    Cross-block pairs reaching further than the 1-voxel halo remain
    per-block-invisible, as in the reference's blockwise accumulation."""
    offsets = np.asarray(offsets, dtype=np.int64)
    owned = _owner_mask(labels.shape, owner_shape)
    us, vs, samples = [], [], []
    for c, off in enumerate(offsets):
        src = tuple(
            slice(max(-o, 0), s - max(o, 0)) for o, s in zip(off, labels.shape)
        )
        dst = tuple(
            slice(max(o, 0), s - max(-o, 0)) for o, s in zip(off, labels.shape)
        )
        lo, hi = labels[src].reshape(-1), labels[dst].reshape(-1)
        val = affs[c][src].reshape(-1).astype(np.float64)
        sel = (lo != hi) & (lo != 0) & (hi != 0)
        if owned is not None:
            # min-corner of (src, dst): slice [0, s - |o|) along every axis —
            # aligned elementwise with the src/dst iteration space
            anchor = tuple(
                slice(0, s - abs(o)) for o, s in zip(off, labels.shape)
            )
            sel &= owned[anchor].reshape(-1)
        if sel.any():
            us.append(np.minimum(lo[sel], hi[sel]))
            vs.append(np.maximum(lo[sel], hi[sel]))
            samples.append(val[sel])
    if not us:
        empty = (
            np.zeros((0, 2), dtype=labels.dtype),
            np.zeros((0, N_FEATURES)),
        )
        if hist_bins:
            empty = empty + (np.zeros((0, hist_bins), dtype=np.uint32),)
        if return_samples:
            empty = empty + (np.zeros(0, dtype=np.float64),)
        return empty
    u = np.concatenate(us)
    v = np.concatenate(vs)
    s = np.concatenate(samples)
    return _edge_group_features(
        u, v, s, labels.dtype, hist_bins, return_samples
    )


def _histogram_quantiles(hist: np.ndarray, cum: np.ndarray, counts, q: float):
    """Per-row quantile from bin counts over [0, 1], linearly interpolated
    within the selected bin (matches the lower-index sample quantile up to one
    bin width).  ``cum`` is the precomputed row cumsum (shared by all five
    quantile calls)."""
    n_bins = hist.shape[1]
    target = q * (counts - 1)
    # first bin whose cumulative count exceeds the target rank
    idx = (cum <= target[:, None]).sum(axis=1)
    idx = np.minimum(idx, n_bins - 1)
    rows = np.arange(hist.shape[0])
    below = np.where(idx > 0, cum[rows, np.maximum(idx - 1, 0)], 0.0)
    in_bin = np.maximum(hist[rows, idx], 1.0)
    frac = np.clip((target - below + 0.5) / in_bin, 0.0, 1.0)
    return (idx + frac) / n_bins


def merge_edge_features(
    edge_ids_list: Sequence[np.ndarray],
    feats_list: Sequence[np.ndarray],
    n_edges: int,
    hists_list: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> np.ndarray:
    """Merge per-block partial features into the global [n_edges, 10] matrix.

    count/mean/var/min/max merge exactly (parallel-variance formula).
    Quantiles merge exactly up to one histogram-bin width when every partial
    comes with a histogram sketch in ``hists_list`` AND the observed value
    range stays inside [0, 1] (the sketch's bin domain); otherwise — legacy
    partials without sketches, or out-of-range float data — the merge
    degrades to count-weighted quantile averaging for all edges rather than
    producing collapsed quantiles.
    """
    use_hist = (
        hists_list is not None
        and len(hists_list) == len(feats_list)
        and all(h is not None for h in hists_list)
        and any(h.shape[0] for h in hists_list)
    )
    hist_bins = (
        next(h.shape[1] for h in hists_list if h.shape[0]) if use_hist else 0
    )

    out = np.zeros((n_edges, N_FEATURES))
    count = np.zeros(n_edges)
    mean = np.zeros(n_edges)
    m2 = np.zeros(n_edges)
    mins = np.full(n_edges, np.inf)
    maxs = np.full(n_edges, -np.inf)
    qsum = np.zeros((n_edges, len(QUANTILES)))
    hist = np.zeros((n_edges, hist_bins), dtype=np.int64) if use_hist else None

    for i, (ids, feats) in enumerate(zip(edge_ids_list, feats_list)):
        if ids.size == 0:
            continue
        c = feats[:, 9]
        m = feats[:, 0]
        v = feats[:, 1]
        tot = count[ids] + c
        delta = m - mean[ids]
        m2[ids] += v * c + delta**2 * count[ids] * c / np.maximum(tot, 1)
        mean[ids] += delta * c / np.maximum(tot, 1)
        count[ids] = tot
        mins[ids] = np.minimum(mins[ids], feats[:, 2])
        maxs[ids] = np.maximum(maxs[ids], feats[:, 8])
        # accumulate both: the hist/fallback choice is made after the observed
        # value range is known
        qsum[ids] += feats[:, 3:8] * c[:, None]
        if use_hist:
            hist[ids] += hists_list[i].astype(np.int64)

    nonzero = count > 0
    if use_hist and nonzero.any():
        lo = mins[nonzero].min()
        hi = maxs[nonzero].max()
        if lo < -1e-9 or hi > 1.0 + 1e-9:
            use_hist = False  # samples escape the sketch's [0, 1] bin domain

    out[:, 0] = mean
    out[:, 1] = np.where(nonzero, m2 / np.maximum(count, 1), 0.0)
    out[:, 2] = np.where(nonzero, mins, 0.0)
    if use_hist:
        cum = np.cumsum(hist, axis=1)
        for qi, q in enumerate(QUANTILES):
            out[:, 3 + qi] = np.where(
                nonzero, _histogram_quantiles(hist, cum, count, q), 0.0
            )
        # histogram bin centers can't leave [min, max]; clamp to the exact ends
        out[:, 3:8] = np.clip(
            out[:, 3:8], out[:, 2:3], np.where(nonzero, maxs, 0.0)[:, None]
        )
    else:
        out[:, 3:8] = qsum / np.maximum(count, 1)[:, None]
    out[:, 8] = np.where(nonzero, maxs, 0.0)
    out[:, 9] = count
    return out


def _exact_quantiles_all_groups(
    out, ids_list, counts_list, samples_list, n_groups
):
    """Exact per-edge quantiles for every feature group from the raw sample
    partials: globally sort (edge, value) pairs pooled over all blocks and
    index the quantile positions — identical (by construction) to a
    single-shot whole-volume recompute, the reference's exact
    ``ndist.mergeFeatureBlocks`` semantics (merge_edge_features.py:141).

    The edge-id expansion and the per-edge spans are group-invariant
    (lexsort's primary key is the edge id), so they are computed once; only
    the value sort repeats per group."""
    eids, val_groups = [], []
    for ids, counts, flat in zip(ids_list, counts_list, samples_list):
        if ids.size == 0:
            continue
        total = int(counts.sum())
        eids.append(np.repeat(ids, counts.astype(np.int64)))
        val_groups.append(flat.reshape(n_groups, total))
    if not eids:
        return
    eids = np.concatenate(eids)
    vals_all = np.concatenate(val_groups, axis=1)
    # spans from the eids-sorted view: identical for every group, since any
    # lexsort((vals_g, eids)) orders groups by edge id first
    sorted_eids = np.sort(eids)
    first = np.concatenate([[True], sorted_eids[1:] != sorted_eids[:-1]])
    starts = np.nonzero(first)[0]
    counts = np.diff(np.append(starts, eids.size)).astype(np.int64)
    rows = sorted_eids[starts]
    qpos = [
        starts + np.minimum((q * (counts - 1)).astype(np.int64), counts - 1)
        for q in QUANTILES
    ]
    for g in range(n_groups):
        svals = vals_all[g][np.lexsort((vals_all[g], eids))]
        for qi in range(len(QUANTILES)):
            out[rows, 9 * g + 3 + qi] = svals[qpos[qi]]


def merge_edge_features_multi(
    edge_ids_list: Sequence[np.ndarray],
    feats_list: Sequence[np.ndarray],
    n_edges: int,
    samples_list: Optional[Sequence[np.ndarray]] = None,
) -> np.ndarray:
    """Merge per-block partials of the G-group feature layout
    ``[9 stats × G groups, count]`` (``filter_edge_features``; G=1 reproduces
    the default 10-column layout).

    count/mean/var/min/max merge exactly per group (parallel-variance
    formula).  Quantiles merge EXACTLY when every partial ships its raw
    sorted samples in ``samples_list`` (``quantile_mode: "exact"``) —
    matching a single-shot recompute bit-for-bit; without samples they
    degrade to count-weighted averaging."""
    n_cols = next(
        (f.shape[1] for f in feats_list if f.ndim == 2 and f.shape[0]), None
    )
    if n_cols is None:
        return np.zeros((n_edges, N_FEATURES))
    n_groups = (n_cols - 1) // 9
    if n_cols != 9 * n_groups + 1:
        raise ValueError(f"feature width {n_cols} is not 9*G+1")

    out = np.zeros((n_edges, n_cols))
    count = np.zeros(n_edges)
    mean = np.zeros((n_edges, n_groups))
    m2 = np.zeros((n_edges, n_groups))
    mins = np.full((n_edges, n_groups), np.inf)
    maxs = np.full((n_edges, n_groups), -np.inf)
    qsum = np.zeros((n_edges, n_groups, len(QUANTILES)))
    counts_list = []
    for ids, feats in zip(edge_ids_list, feats_list):
        if ids.size == 0:
            counts_list.append(np.zeros(0))
            continue
        c = feats[:, -1]
        counts_list.append(c)
        tot = count[ids] + c
        safe = np.maximum(tot, 1)
        for g in range(n_groups):
            base = 9 * g
            m = feats[:, base + 0]
            v = feats[:, base + 1]
            delta = m - mean[ids, g]
            m2[ids, g] += v * c + delta**2 * count[ids] * c / safe
            mean[ids, g] += delta * c / safe
            mins[ids, g] = np.minimum(mins[ids, g], feats[:, base + 2])
            maxs[ids, g] = np.maximum(maxs[ids, g], feats[:, base + 8])
            qsum[ids, g] += feats[:, base + 3 : base + 8] * c[:, None]
        count[ids] = tot

    nonzero = count > 0
    use_exact = (
        samples_list is not None
        and len(samples_list) == len(feats_list)
        and all(s is not None for s in samples_list)
    )
    for g in range(n_groups):
        base = 9 * g
        out[:, base + 0] = mean[:, g]
        out[:, base + 1] = np.where(nonzero, m2[:, g] / np.maximum(count, 1), 0.0)
        out[:, base + 2] = np.where(nonzero, mins[:, g], 0.0)
        if not use_exact:
            out[:, base + 3 : base + 8] = (
                qsum[:, g] / np.maximum(count, 1)[:, None]
            )
        out[:, base + 8] = np.where(nonzero, maxs[:, g], 0.0)
    if use_exact:
        _exact_quantiles_all_groups(
            out, edge_ids_list, counts_list, samples_list, n_groups
        )
    out[:, -1] = count
    return out

# ---------------------------------------------------------------------------
# device accumulator: RAG extraction + feature accumulation in PyTorch
# ---------------------------------------------------------------------------


def compact_valid_rows(u, v, s, max_samples: int):
    """Fixed-capacity compaction of the valid (``u != SENTINEL``) face rows
    before the sort: a stable cumsum/scatter keeps row order, rows beyond
    ``max_samples`` are dropped (they land in an overflow slot that is cut
    off) — callers compare the pre-compaction valid count against the cap
    and raise rather than lose samples silently."""
    valid0 = u != SENTINEL
    dest = torch.where(
        valid0, torch.cumsum(valid0, 0) - 1, torch.full_like(u, max_samples, dtype=torch.int64)
    ).clamp_(max=max_samples)

    def scatter(x, fill):
        out = torch.full((max_samples + 1,), fill, dtype=x.dtype, device=x.device)
        return out.index_put_((dest,), x)[:max_samples]

    return scatter(u, SENTINEL), scatter(v, SENTINEL), scatter(s, 0)


def _boundary_edge_features_device_impl(
    labels, values, max_edges, hist_bins, owner_shape=None, max_samples=None,
):
    """Face-pair extraction → sort by (u, v, sample) → segment reductions
    (count/mean/var/min/max), in-segment rank gathers for the five sample
    quantiles, and the per-edge histogram sketch.  Fixed output shapes:
    padded to ``max_edges`` rows (edges beyond it land in an overflow
    segment; the host wrapper raises on ``n_edges > max_edges``).

    PyTorch has no multi-key sort: the rows are sorted stably by sample,
    then stably by the int64 key ``u << 32 | v``, which orders them as the
    reference's 3-key sort does (``rag.py`` ``lax.sort(num_keys=3)``).  The
    quantile positions and histogram bins are computed in float32, as JAX's
    weak typing computes them, so they equal the reference's; the float32
    sums go through ``index_add_`` (on the card, atomics in no fixed order),
    so the moments hold a tolerance, not bit equality."""
    dev = labels.device
    owned = None
    if owner_shape is not None:
        # face ownership (see _owner_mask): lower voxel inside the inner block
        owned = torch.ones(labels.shape, dtype=torch.bool, device=dev)
        for d, lim in enumerate(owner_shape):
            shape = [1] * labels.dim()
            shape[d] = labels.shape[d]
            owned &= torch.arange(labels.shape[d], device=dev).view(shape) < lim
    us, vs, ss = [], [], []
    for axis in range(labels.dim()):
        lab0 = labels.movedim(axis, 0)
        val0 = values.movedim(axis, 0)
        lo = lab0[:-1].reshape(-1)
        hi = lab0[1:].reshape(-1)
        sel = _face_mask(lo, hi)
        if owned is not None:
            sel &= owned.movedim(axis, 0)[:-1].reshape(-1)
        a = torch.where(sel, torch.minimum(lo, hi), SENTINEL)
        b = torch.where(sel, torch.maximum(lo, hi), SENTINEL)
        us += [a, a]
        vs += [b, b]
        ss += [val0[:-1].reshape(-1), val0[1:].reshape(-1)]
    u = torch.cat(us)
    v = torch.cat(vs)
    s = torch.cat(ss).to(torch.float32)

    n_samples = (u != SENTINEL).sum()  # pre-compaction truth
    if max_samples is not None:
        u, v, s = compact_valid_rows(u, v, s, max_samples)
    key = (u.to(torch.int64) << 32) | v.to(torch.int64)
    s, order = torch.sort(s, stable=True)
    key = key[order]
    key, order = torch.sort(key, stable=True)
    s = s[order]
    sentinel_key = (SENTINEL << 32) | SENTINEL
    valid = key != sentinel_key
    first = torch.cat([valid[:1], key[1:] != key[:-1]]) & valid
    seg = torch.cumsum(first, 0) - 1
    n_edges = first.sum()
    # invalid rows and edges beyond the cap → the overflow segment
    seg = torch.where(valid & (seg < max_edges), seg, max_edges)

    n_seg = max_edges + 1
    ones = valid.to(torch.float32)
    count = torch.zeros(n_seg, device=dev).index_add_(0, seg, ones)
    ssum = torch.zeros(n_seg, device=dev).index_add_(0, seg, s * ones)
    ssum2 = torch.zeros(n_seg, device=dev).index_add_(0, seg, s * s * ones)
    inf = torch.tensor(float("inf"), device=dev)
    smin = torch.full((n_seg,), float("inf"), device=dev).scatter_reduce_(
        0, seg, torch.where(valid, s, inf), "amin"
    )
    smax = torch.full((n_seg,), float("-inf"), device=dev).scatter_reduce_(
        0, seg, torch.where(valid, s, -inf), "amax"
    )
    idx = torch.arange(s.shape[0], device=dev)
    starts = torch.full((n_seg,), s.shape[0], dtype=torch.int64, device=dev).scatter_reduce_(
        0, seg, idx, "amin"
    )

    count_e = count[:max_edges]
    safe_count = torch.clamp(count_e, min=1.0)
    mean = ssum[:max_edges] / safe_count
    var = torch.clamp(ssum2[:max_edges] / safe_count - mean**2, min=0.0)
    present = count_e > 0
    starts_e = torch.where(present, starts[:max_edges], 0)
    zero = torch.zeros((), device=dev)

    # quantiles: values are sorted within each segment (the second key);
    # an absent edge gathers a padding zero (position 0 of an empty block)
    s_pad = torch.cat([s, s.new_zeros(1)])
    qcols = []
    for q in QUANTILES:
        pos = starts_e + torch.minimum(
            (q * (count_e - 1)).to(torch.int32),
            torch.clamp(count_e - 1, min=0).to(torch.int32),
        )
        qcols.append(torch.where(present, s_pad[pos], zero))

    feats = torch.stack(
        [
            torch.where(present, mean, zero),
            torch.where(present, var, zero),
            torch.where(present, smin[:max_edges], zero),
            *qcols,
            torch.where(present, smax[:max_edges], zero),
            count_e,
        ],
        dim=1,
    )

    # per-edge histogram sketch over [0, 1]
    bins = torch.clamp((s * hist_bins).to(torch.int32), 0, hist_bins - 1)
    flat = torch.where(seg < max_edges, seg * hist_bins + bins, max_edges * hist_bins)
    hist = torch.bincount(flat, minlength=max_edges * hist_bins + 1)[
        : max_edges * hist_bins
    ].view(max_edges, hist_bins)

    edge_key = torch.full((n_seg,), sentinel_key, dtype=torch.int64, device=dev).scatter_reduce_(
        0, seg, key, "amin"
    )[:max_edges]
    edge_u = (edge_key >> 32).to(torch.int32)
    edge_v = (edge_key & 0xFFFFFFFF).to(torch.int32)
    return edge_u, edge_v, feats, hist, n_edges, n_samples


def sample_capacity(n_valid: int) -> int:
    """Static compaction capacity for a measured valid-sample count: 10%
    headroom rounded up to a quarter-octave bucket (2^k * {1, 1.25, 1.5,
    1.75}), as the reference sizes it (there it bounds the compiled
    shapes)."""
    need = max(int(n_valid * 1.1), 1024)
    base = 1 << (need.bit_length() - 1)
    for frac in (4, 5, 6, 7):
        cap = base * frac // 4
        if cap >= need:
            return cap
    return base * 2


def _face_mask(lo, hi):
    """THE face predicate of every RAG accumulator (device and host counts):
    an inter-label face with both sides foreground.  One definition — the
    host-side cap sizing must bound exactly what the accumulator generates
    (each face contributes 2 sample rows)."""
    return (lo != hi) & (lo != 0) & (hi != 0)


def count_boundary_samples(labels: np.ndarray) -> int:
    """Host-side exact count of the accumulator's valid face rows (2 samples
    per inter-label face, zero labels excluded), used to pick
    ``max_samples`` before the call."""
    n = 0
    for axis in range(labels.ndim):
        lo = np.moveaxis(labels, axis, 0)[:-1]
        hi = np.moveaxis(labels, axis, 0)[1:]
        n += 2 * int(_face_mask(lo, hi).sum())
    return n


def boundary_edge_features_device(
    labels: torch.Tensor,
    values: torch.Tensor,
    max_edges: int = 16384,
    hist_bins: int = HIST_BINS,
    owner_shape=None,
    max_samples=None,
):
    """The device RAG accumulator on the tensors' device; see
    ``_boundary_edge_features_device_impl``.  Returns ``(edge_u, edge_v,
    feats [max_edges, 10] float32, hist [max_edges, hist_bins] int64,
    n_edges, n_samples)`` as tensors.

    ``labels`` must be int32 (compact per-block ids — the host wrapper
    ``boundary_edge_features_gpu`` handles uint64 global labels).
    ``max_samples`` turns on the pre-sort compaction of valid face rows; the
    caller must check the returned ``n_samples`` against it.  Compaction
    that cannot shrink the sort (cap >= the raw face-row count) is skipped.
    A call on a CUDA tensor adds one to ``boundary_edge_features_device.launches``."""
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32 compact ids, got {labels.dtype}")
    if labels.shape != values.shape or labels.device != values.device:
        raise ValueError(
            f"labels {tuple(labels.shape)} on {labels.device} vs values "
            f"{tuple(values.shape)} on {values.device}"
        )
    if max_samples is not None:
        shape = labels.shape
        raw_rows = 2 * sum(
            (shape[ax] - 1) * int(np.prod(shape)) // max(shape[ax], 1)
            for ax in range(len(shape))
        )
        if int(max_samples) >= raw_rows:
            max_samples = None
    if labels.is_cuda:
        from ._build import count_launch

        count_launch(boundary_edge_features_device)
    return _boundary_edge_features_device_impl(
        labels, values, int(max_edges), int(hist_bins),
        None if owner_shape is None else tuple(owner_shape),
        None if max_samples is None else int(max_samples),
    )


boundary_edge_features_device.launches = 0


def boundary_edge_features_gpu(
    labels: np.ndarray,
    boundary_map: np.ndarray,
    hist_bins: int = 0,
    owner_shape=None,
    max_edges: int = 16384,
    device="cuda",
):
    """Device-backed replacement for ``boundary_edge_features`` — the port of
    the JAX package's ``boundary_edge_features_tpu``: compacts uint64 labels
    to int32 on the host (global labels stay numpy uint64; only the compact
    ids go to ``device``), runs ``boundary_edge_features_device`` and crops
    the padded outputs.  Moments accumulate in float32 — parity with the
    numpy path is to ~1e-5 relative, not bitwise."""
    uniq, inv = np.unique(labels, return_inverse=True)
    compact = inv.reshape(labels.shape).astype(np.int32)
    # keep 0 → 0 so the accumulator's background skip applies
    if uniq.size == 0 or uniq[0] != 0:
        compact = compact + 1
        # dtype-preserving prepend: a bare [0] would promote uint64 → float64
        uniq = np.concatenate([np.zeros(1, dtype=uniq.dtype), uniq])
    cap = sample_capacity(count_boundary_samples(compact))
    dev = torch.device(device)
    eu, ev, feats, hist, n_edges, n_samples = boundary_edge_features_device(
        torch.from_numpy(compact).to(dev),
        torch.from_numpy(np.asarray(boundary_map, dtype=np.float32)).to(dev),
        max_edges=max_edges, hist_bins=hist_bins or HIST_BINS,
        owner_shape=owner_shape, max_samples=cap,
    )
    n = int(n_edges)
    if n > max_edges:
        raise ValueError(
            f"block has {n} edges > max_edges={max_edges}; raise max_edges"
        )
    if int(n_samples) > cap:
        # count_boundary_samples covers every selection path (the owner
        # mask only removes rows), so this is a broken invariant, never a
        # silent sample drop
        raise AssertionError(
            f"accumulator saw {int(n_samples)} boundary samples > capacity {cap}"
        )
    uv = torch.stack([eu[:n], ev[:n]], dim=1).cpu().numpy().astype(np.int64)
    edges = uniq[uv]
    feats = feats[:n].cpu().numpy().astype(np.float64)
    if hist_bins:
        return edges, feats, hist[:n].cpu().numpy().astype(np.uint32)
    return edges, feats
