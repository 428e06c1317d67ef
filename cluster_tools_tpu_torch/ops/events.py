"""Batched per-frame event building for hybrid-pixel detectors, in PyTorch.

Port of ``cluster_tools_tpu/ops/events.py``: a stack of ``(n_frames, h,
w)`` frames, each holding a few particle-hit clusters ("events") that are
found as the connected components of the above-threshold mask and
summarised (size, total energy, energy-weighted centroid, bounding box).

``build_events`` labels the whole stack in one program on the tensor's
device (``_event_labels``): min-label propagation over the frame's
neighbourhood with pointer jumps to its fixpoint, frames never merging; the
roots ranked by a cumulative sum give per-frame labels 1..k in raster order
of first appearance (scipy's order).  The properties reduce over the active
pixels only: one ``index_add_`` of the summed columns and one
``scatter_reduce`` (``amin``) of the bounding box, keyed by ``frame *
capacity + label - 1``.  The capacity is the batch's largest cluster count,
so no overflow re-dispatch is needed and the rows equal the JAX package's
after its capacity growth.  The JAX package pads frame counts and shapes to
powers of two and grows its capacity in powers of two to bound its compile
cache (``kernel_cache_size``); PyTorch compiles nothing here, so neither has
a counterpart.  Its ``events.*`` metrics wait for the port's observability
layer (ROADMAP Queue A 13); ``build_events_device`` counts its calls on a
card and their rounds (``launches``, ``rounds``).

``build_events_np`` is the host oracle (per-frame ``scipy.ndimage.label``
and numpy reductions) of the JAX package, each cluster's pixels taken from
its bounding box: the same values, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..runtime.device import resolve_device
from ._build import count_launch
from .cc import shift

__all__ = [
    "PROP_FIELDS",
    "N_PROPS",
    "DEFAULT_MAX_CLUSTERS",
    "build_events",
    "build_events_np",
    "event_table",
]

# columns of the per-cluster property rows, in order
PROP_FIELDS = (
    "size", "energy", "cy", "cx", "ymin", "ymax", "xmin", "xmax",
)
N_PROPS = len(PROP_FIELDS)

# the JAX package's starting per-frame cluster capacity (a task config key)
DEFAULT_MAX_CLUSTERS = 16


def _event_labels(mask: torch.Tensor, connectivity: int):
    """Per-frame consecutive int32 labels of an (n, h, w) bool stack and the
    per-frame counts; also returns the labelling's rounds."""
    n, h, w = mask.shape
    ts = h * w
    dev = mask.device
    iota = torch.arange(ts, dtype=torch.int64, device=dev)
    sent = ts
    lab = torch.where(mask, iota.view(1, h, w), sent)

    def tjump(lab):
        flat = lab.reshape(n, ts)
        jumped = torch.gather(flat, 1, torch.clamp(flat, 0, ts - 1)).view(n, h, w)
        return torch.where(mask, jumped, sent)

    def neigh(lab):
        # 8-connectivity is the full 3 x 3 window: a row pass, then a
        # column pass; off-mask pixels hold the sentinel and add nothing
        if connectivity >= 2:
            r = torch.minimum(lab, torch.minimum(shift(lab, (0, 1), sent), shift(lab, (0, -1), sent)))
            best = torch.minimum(r, torch.minimum(shift(r, (1, 0), sent), shift(r, (-1, 0), sent)))
        else:
            best = lab
            for off in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                best = torch.minimum(best, shift(lab, off, sent))
        return torch.where(mask, best, sent)

    rounds = 0
    while True:
        new = tjump(tjump(neigh(neigh(neigh(lab)))))
        rounds += 1
        if torch.equal(new, lab):
            break
        lab = new
    if mask.is_cuda:
        count_launch(build_events_device, rounds=rounds)

    # the root of a component is the pixel whose label is its own flat
    # index (the minimum); ranks of the roots in raster order are scipy's
    flat = lab.reshape(n, ts)
    rank = torch.cumsum((flat == iota[None, :]).to(torch.int32), dim=1)
    counts = rank[:, -1] if ts else torch.zeros(n, dtype=torch.int32, device=dev)
    labels = torch.where(flat == sent, 0, torch.gather(rank, 1, torch.clamp(flat, 0, ts - 1)))
    return labels.view(n, h, w).to(torch.int32), counts.to(torch.int32), rounds


def _event_props(frames: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, cap: int):
    """``(n, cap, N_PROPS)`` float32 property rows over the active pixels."""
    n, h, w = frames.shape
    ts = h * w
    dev = frames.device
    sel = torch.nonzero(mask.reshape(-1), as_tuple=True)[0]
    lab_sel = labels.reshape(-1)[sel].to(torch.int64)
    frame_sel = sel // ts
    pix = sel % ts
    yy = (pix // w).to(torch.float32)
    xx = (pix % w).to(torch.float32)
    e = frames.reshape(-1)[sel]
    gid = frame_sel * cap + (lab_sel - 1)
    sums = torch.zeros((n * cap, 6), dtype=torch.float32, device=dev)
    sums.index_add_(0, gid, torch.stack([torch.ones_like(e), e, yy * e, xx * e, yy, xx], dim=-1))
    size, energy, wy, wx, sy, sx = sums.unbind(1)
    mins = torch.full((n * cap, 4), float(ts), dtype=torch.float32, device=dev)
    mins.scatter_reduce_(0, gid[:, None].expand(-1, 4), torch.stack([yy, xx, -yy, -xx], dim=-1),
                         "amin", include_self=True)
    ymin, xmin, ymax, xmax = mins[:, 0], mins[:, 1], -mins[:, 2], -mins[:, 3]
    # energy-weighted centroid; zero-energy clusters (negative thresholds)
    # take the unweighted pixel mean
    one = torch.ones_like(energy)
    denom = torch.where(energy != 0, energy, one)
    nsize = torch.where(size > 0, size, one)
    cy = torch.where(energy != 0, wy / denom, sy / nsize)
    cx = torch.where(energy != 0, wx / denom, sx / nsize)
    props = torch.stack([size, energy, cy, cx, ymin, ymax, xmin, xmax], dim=-1).view(n, cap, N_PROPS)
    return torch.where(size.view(n, cap, 1) > 0, props, torch.zeros_like(props))


def build_events_device(frames: torch.Tensor, threshold: float = 0.0, connectivity: int = 2):
    """Event building of an (n, h, w) float32 stack on its device: int32
    labels, int32 counts, ``(n, max_count, N_PROPS)`` float32 rows and the
    labelling's rounds."""
    mask = frames > float(threshold)
    labels, counts, rounds = _event_labels(mask, int(connectivity))
    cap = int(counts.max()) if counts.numel() else 0
    if cap == 0:
        props = torch.zeros((frames.shape[0], 0, N_PROPS), dtype=torch.float32, device=frames.device)
    else:
        props = _event_props(frames, labels, mask, cap)
    return labels, counts, props, rounds


build_events_device.launches = 0  # calls on a card, and their labelling rounds
build_events_device.rounds = 0


def build_events(
    frames,
    threshold: float = 0.0,
    connectivity: int = 2,
    max_clusters=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Event building over a stack of frames on ``device`` (the card unless
    the caller names another).  ``frames``: ``(n, h, w)`` or one ``(h,
    w)`` frame.  Returns ``(labels, counts, props)``: uint32 per-frame
    consecutive labels, int32 per-frame cluster counts and ``(n,
    max_count, N_PROPS)`` float32 property rows (``PROP_FIELDS`` order,
    rows past ``counts[f]`` zero).  ``max_clusters``, the JAX package's
    starting capacity, changes no output."""
    frames = np.asarray(frames, dtype=np.float32)
    if frames.ndim == 2:
        frames = frames[None]
    if frames.ndim != 3:
        raise ValueError(f"frames must be (n, h, w), got {frames.shape}")
    n, h, w = frames.shape
    if n == 0:
        return (
            np.zeros((0, h, w), np.uint32),
            np.zeros((0,), np.int32),
            np.zeros((0, 0, N_PROPS), np.float32),
        )
    dev = resolve_device({"device": device})
    labels, counts, props, _ = build_events_device(
        torch.from_numpy(frames).to(dev), threshold, connectivity)
    return (labels.cpu().numpy().astype(np.uint32), counts.cpu().numpy(),
            props.cpu().numpy())


def event_table(counts: np.ndarray, props: np.ndarray) -> np.ndarray:
    """Flatten per-frame property rows into one ``(total_clusters, 1 +
    N_PROPS)`` float64 table with the frame index prepended — the row
    format of the ragged per-block event datasets."""
    rows = []
    for f, k in enumerate(np.asarray(counts)):
        k = int(k)
        if k == 0:
            continue
        block = np.empty((k, 1 + N_PROPS), np.float64)
        block[:, 0] = f
        block[:, 1:] = props[f, :k]
        rows.append(block)
    if not rows:
        return np.zeros((0, 1 + N_PROPS), np.float64)
    return np.concatenate(rows, axis=0)


def build_events_np(
    frames,
    threshold: float = 0.0,
    connectivity: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host oracle: per-frame ``scipy.ndimage.label`` + numpy property
    reduction, with :func:`build_events`' return contract."""
    from scipy import ndimage

    frames = np.asarray(frames, dtype=np.float32)
    if frames.ndim == 2:
        frames = frames[None]
    n, h, w = frames.shape
    structure = ndimage.generate_binary_structure(2, connectivity)
    labels = np.zeros((n, h, w), np.uint32)
    counts = np.zeros((n,), np.int32)
    per_frame = []
    for f in range(n):
        lab, k = ndimage.label(frames[f] > threshold, structure=structure)
        labels[f] = lab
        counts[f] = k
        rows = np.zeros((k, N_PROPS), np.float32)
        # each cluster's pixels from its bounding box: the same pixels in the
        # same raster order as from the whole frame, at the cost of the box
        for c, (sy, sx) in enumerate(ndimage.find_objects(lab), start=1):
            ys, xs = np.nonzero(lab[sy, sx] == c)
            ys, xs = ys + sy.start, xs + sx.start
            e = frames[f][ys, xs].astype(np.float64)
            etot = float(e.sum())
            if etot != 0:
                cy, cx = float((ys * e).sum() / etot), float((xs * e).sum() / etot)
            else:
                cy, cx = float(ys.mean()), float(xs.mean())
            rows[c - 1] = (
                len(ys), etot, cy, cx,
                ys.min(), ys.max(), xs.min(), xs.max(),
            )
        per_frame.append(rows)
    max_count = int(counts.max()) if n else 0
    props = np.zeros((n, max_count, N_PROPS), np.float32)
    for f, rows in enumerate(per_frame):
        props[f, : len(rows)] = rows
    return labels, counts, props
