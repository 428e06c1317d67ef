"""Mutex watershed on long-range affinities (port of
``cluster_tools_tpu/ops/mws.py``, host numpy).

The per-block solve is Kruskal with mutex constraints: the host C++ solver
(``native.mutex_watershed``) by default, a Python fallback, or — with
``CTT_MWS_MODE=device`` / ``force_mws_mode("device")`` — the parallel-greedy
formulation in PyTorch on the caller's device (``ops/mws_device.py``).

``compute_mws_segmentation`` builds the voxel grid graph from the
affinities: the first ``ndim`` offsets are attractive (nearest neighbour),
the rest repulsive, the repulsive edges optionally subsampled by strides
or at random.  Weights are float64 on the host path; the noise and the
random strides draw from ``np.random.default_rng(seed)`` in the JAX
package's order, so both packages build the same graph.

The mode switch is the MWS kind of the JAX package's ``ops/_backend.py``
alone: ``CTT_MWS_MODE=device`` routes ``mutex_watershed_graph`` to the
device formulation, any other value (or none) keeps the host solver, and
``force_mws_mode(mode)`` overrides the environment inside a ``with``
block.  The JAX package's measured pin file is not carried over: it is
keyed by a JAX backend name.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional, Sequence

import numpy as np

from .. import native

_FORCED_MODE = None  # force_mws_mode's override; None: CTT_MWS_MODE decides
_MODE_LOCK = threading.Lock()


def use_mws_device() -> bool:
    """Whether graph-domain MWS solves take the parallel-greedy device
    formulation (``CTT_MWS_MODE=device``) instead of the host C++."""
    mode = _FORCED_MODE if _FORCED_MODE is not None else os.environ.get("CTT_MWS_MODE")
    return mode == "device"


@contextmanager
def force_mws_mode(mode):
    """Scoped MWS-mode override ('device' | 'host'), restored on exit even
    on error."""
    global _FORCED_MODE
    with _MODE_LOCK:
        prev, _FORCED_MODE = _FORCED_MODE, mode
    try:
        yield
    finally:
        with _MODE_LOCK:
            _FORCED_MODE = prev


def _grid_edges(
    shape: Sequence[int],
    offsets: np.ndarray,
    strides: Optional[Sequence[int]],
    randomize_strides: bool,
    rng: np.random.Generator,
    ndim: int,
):
    """Edges (u, v, channel, attractive) for every offset; long-range edges
    subsampled."""
    size = int(np.prod(shape))
    ids = np.arange(size, dtype=np.int64).reshape(shape)
    uvc = []
    for c, off in enumerate(offsets):
        src = [slice(max(-o, 0), s - max(o, 0)) for o, s in zip(off, shape)]
        dst = [slice(max(o, 0), s - max(-o, 0)) for o, s in zip(off, shape)]
        u = ids[tuple(src)]
        v = ids[tuple(dst)]
        is_attractive = c < ndim
        if not is_attractive and strides is not None:
            if randomize_strides:
                keep = rng.random(u.shape) < 1.0 / np.prod(strides)
                u, v = u[keep], v[keep]
            else:
                stride_sl = tuple(slice(None, None, s) for s in strides)
                u, v = u[stride_sl], v[stride_sl]
        uvc.append((u.reshape(-1), v.reshape(-1), c, is_attractive))
    return uvc


def _affinity_edge_lists(affs, offsets, strides, randomize_strides, noise_level, rng, ndim):
    """Grid-edge lists (u, v, weight, attractive per channel) shared by the
    plain and seeded variants: weight = affinity on attractive channels,
    1 - affinity on repulsive ones, in float64."""
    shape = affs.shape[1:]
    affs = affs.astype(np.float64)
    if noise_level > 0:
        affs = np.clip(affs + noise_level * rng.standard_normal(affs.shape), 0.0, 1.0)
    us, vs, ws, attr = [], [], [], []
    for u, v, c, is_attractive in _grid_edges(shape, offsets, strides, randomize_strides, rng, ndim):
        us.append(u)
        vs.append(v)
        aff_vals = affs[c].reshape(-1)
        # the edge's weight lives at the source voxel of the offset slice
        ws.append(aff_vals[u] if is_attractive else 1.0 - aff_vals[u])
        attr.append(np.full(u.shape, is_attractive, dtype=np.uint8))
    return us, vs, ws, attr


def _check_offsets(affs, offsets):
    offsets = np.asarray(offsets, dtype=np.int64)
    if offsets.shape[0] != affs.shape[0]:
        raise ValueError(f"{affs.shape[0]} affinity channels but {offsets.shape[0]} offsets")
    return offsets


def _masked(uv, weights, attractive, mask):
    if mask is None:
        return uv, weights, attractive
    m = mask.reshape(-1).astype(bool)
    keep = m[uv[:, 0]] & m[uv[:, 1]]
    return uv[keep], weights[keep], attractive[keep]


def compute_mws_segmentation(
    affs: np.ndarray,
    offsets: Sequence[Sequence[int]],
    strides: Optional[Sequence[int]] = None,
    randomize_strides: bool = False,
    mask: Optional[np.ndarray] = None,
    noise_level: float = 0.0,
    seed: int = 0,
    use_native: bool = True,
    device="cuda",
) -> np.ndarray:
    """Mutex watershed over an affinity map [C, *spatial]; uint64 labels
    1..n (0 outside ``mask``).  Attractive and repulsive edges are sorted
    together by weight, descending.  ``device`` is where the device mode
    solves (the card unless the caller names another); the host solvers
    ignore it."""
    offsets = _check_offsets(affs, offsets)
    ndim = affs.ndim - 1
    shape = affs.shape[1:]
    rng = np.random.default_rng(seed)
    us, vs, ws, attr = _affinity_edge_lists(
        affs, offsets, strides, randomize_strides, noise_level, rng, ndim
    )
    uv = np.stack([np.concatenate(us), np.concatenate(vs)], axis=1)
    uv, weights, attractive = _masked(uv, np.concatenate(ws), np.concatenate(attr), mask)

    roots = mutex_watershed_graph(int(np.prod(shape)), uv, weights, attractive, use_native, device)
    _, labels = np.unique(roots, return_inverse=True)
    labels = (labels + 1).astype(np.uint64).reshape(shape)
    if mask is not None:
        labels[~mask.astype(bool)] = 0
    return labels


def mutex_watershed_graph(
    n_nodes: int,
    uv: np.ndarray,
    weights: np.ndarray,
    attractive: np.ndarray,
    use_native: bool = True,
    device="cuda",
) -> np.ndarray:
    """Graph-domain MWS returning a root per node: the device formulation
    on ``device`` when the MWS mode is ``device`` (raises without the card
    it names), else the host C++ solver, or the Python one without it."""
    if use_mws_device():
        from .mws_device import mutex_watershed_device

        return mutex_watershed_device(n_nodes, uv, weights, attractive, device=device)
    if use_native and native.available():
        return native.mutex_watershed(n_nodes, uv, weights, attractive)
    return _mws_python(n_nodes, uv, weights, attractive)


def _mws_python(n_nodes, uv, weights, attractive) -> np.ndarray:
    order = np.argsort(-weights, kind="stable")
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    mutexes = [set() for _ in range(n_nodes)]
    for idx in order:
        a, b = int(uv[idx, 0]), int(uv[idx, 1])
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if attractive[idx]:
            if rb in mutexes[ra]:
                continue
            # merge the smaller mutex set into the larger
            if len(mutexes[ra]) < len(mutexes[rb]):
                ra, rb = rb, ra
            parent[rb] = ra
            for m in mutexes[rb]:
                mutexes[ra].add(m)
                mutexes[m].discard(rb)
                mutexes[m].add(ra)
            mutexes[rb] = set()
        else:
            mutexes[ra].add(rb)
            mutexes[rb].add(ra)
    return np.array([find(i) for i in range(n_nodes)], dtype=np.int64)


def compute_mws_segmentation_with_seeds(
    affs: np.ndarray,
    offsets: Sequence[Sequence[int]],
    seeds: np.ndarray,
    strides: Optional[Sequence[int]] = None,
    randomize_strides: bool = False,
    mask: Optional[np.ndarray] = None,
    noise_level: float = 0.0,
    seed: int = 0,
    use_native: bool = True,
    max_mutex_ids: int = 1024,
    device="cuda",
) -> np.ndarray:
    """MWS constrained by pre-labelled seed voxels (the two-pass MWS's
    pass 1): voxels sharing a seed label are chained with above-maximal
    attractive edges (processed before any affinity edge), and one
    representative per seed label is mutexed against every other label's
    representative (against the next one only when there are more than
    ``max_mutex_ids`` labels), so a block can neither split a neighbour's
    segment nor merge two.  Seeded voxels keep their seed label; new
    segments get ids past ``seeds.max()``."""
    offsets = _check_offsets(affs, offsets)
    ndim = affs.ndim - 1
    shape = affs.shape[1:]
    rng = np.random.default_rng(seed)
    us, vs, ws, attr = _affinity_edge_lists(
        affs, offsets, strides, randomize_strides, noise_level, rng, ndim
    )

    # seed voxels grouped by label with one stable argsort
    flat_seeds = seeds.reshape(-1).astype(np.int64)
    seeded_vox = np.nonzero(flat_seeds > 0)[0]
    order = seeded_vox[np.argsort(flat_seeds[seeded_vox], kind="stable")]
    lab_sorted = flat_seeds[order]
    new_group = np.concatenate([[True], lab_sorted[1:] != lab_sorted[:-1]])
    seed_ids = lab_sorted[new_group]
    reps = order[new_group]
    if order.size:
        # chains within each seed label (consecutive sorted voxels, group
        # boundaries skipped), weight 2: before any affinity edge
        intra = ~new_group[1:]
        if intra.any():
            us.append(order[:-1][intra])
            vs.append(order[1:][intra])
            ws.append(np.full(int(intra.sum()), 2.0))
            attr.append(np.ones(int(intra.sum()), dtype=np.uint8))
    k = reps.size
    if k > 1:
        if k <= max_mutex_ids:
            ru, rv = np.triu_indices(k, k=1)
        else:
            # all pairs would be O(k^2) edges; a chain of mutexes bounds the
            # count (a weaker guarantee: mutual exclusion is not transitive)
            ru = np.arange(k - 1)
            rv = ru + 1
        us.append(reps[ru])
        vs.append(reps[rv])
        ws.append(np.full(ru.size, 2.0))
        attr.append(np.zeros(ru.size, dtype=np.uint8))

    uv = np.stack([np.concatenate(us), np.concatenate(vs)], axis=1)
    uv, weights, attractive = _masked(uv, np.concatenate(ws), np.concatenate(attr), mask)

    roots = mutex_watershed_graph(int(np.prod(shape)), uv, weights, attractive, use_native, device)
    _, labels = np.unique(roots, return_inverse=True)
    labels = (labels + 1).astype(np.int64)

    # clusters holding a seed representative take the seed id, the rest
    # move past the seed id range
    seed_base = int(seed_ids.max()) if seed_ids.size else 0
    cluster_to_seed = np.zeros(int(labels.max()) + 1, dtype=np.int64)
    if reps.size:
        cluster_to_seed[labels[reps]] = seed_ids
    out = np.where(
        cluster_to_seed[labels] > 0, cluster_to_seed[labels], labels + seed_base,
    ).astype(np.uint64).reshape(shape)
    if mask is not None:
        out[~mask.astype(bool)] = 0
    return out
