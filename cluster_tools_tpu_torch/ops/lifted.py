"""Lifted multicut: sparse lifted neighborhoods and a lifted-GAEC solver.

Port of ``cluster_tools_tpu/ops/lifted.py`` (host numpy and scipy there and
here; it replaces nifty's lifted-multicut stack, reference
lifted_features/sparse_lifted_neighborhood.py:132-137 via
``ndist.computeLiftedNeighborhoodFromNodeLabels`` and
lifted_multicut/solve_lifted_subproblems.py:205-213 via
``elf...get_lifted_multicut_solver``).

The neighborhood search is a frontier BFS over a scipy CSR adjacency (ragged
graph data); the solver is greedy additive edge contraction generalized to
lifted edges: clusters are contractible only along *local* (RAG) edges, but
the contraction priority is the combined local+lifted cost between the two
clusters, and both cost maps merge on contraction.  Contraction stops when
the best combined cost drops to 0 (the GAEC stopping rule).  The native
solver is ``native.lifted_gaec``; ``_lifted_gaec_python`` keeps JAX's heap
and tie orders.
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional, Tuple

import numpy as np

from .. import native
from .multicut import solve_multicut


def lifted_neighborhood(
    n_nodes: int,
    edges: np.ndarray,
    participating: np.ndarray,
    depth: int = 2,
) -> np.ndarray:
    """Sparse lifted edges: pairs of ``participating`` nodes with graph
    distance in [2, depth] over the local graph.

    ``participating`` is a boolean mask [n_nodes] (the reference restricts the
    neighborhood to nodes carrying a semantic label,
    sparse_lifted_neighborhood.py:132-137).  Distance-1 pairs are local edges,
    not lifted ones.  Returns [L, 2] with u < v, lexicographically sorted.

    Memory stays sparse: chunked multi-source frontier BFS over a CSR
    adjacency (never a dense distance matrix), so the cost is proportional to
    the edges actually reached within ``depth``.
    """
    from scipy.sparse import csr_matrix

    part_idx = np.nonzero(participating)[0]
    if part_idx.size < 2 or edges.shape[0] == 0 or depth < 2:
        return np.zeros((0, 2), dtype=np.int64)
    # int32 path counts: int8 overflows at >=128 parallel paths through
    # high-degree hubs, silently dropping reached nodes; per-entry counts are
    # bounded by node degree, so int32 is safe at a quarter of int64's memory
    data = np.ones(edges.shape[0], dtype=np.int32)
    adj = csr_matrix(
        (data, (edges[:, 0], edges[:, 1])), shape=(n_nodes, n_nodes)
    )
    adj = ((adj + adj.T) > 0).astype(np.int32)

    pair_chunks = []
    chunk = 4096
    for lo in range(0, part_idx.size, chunk):
        sources = part_idx[lo : lo + chunk]
        visited = csr_matrix(
            (
                np.ones(sources.size, dtype=np.int32),
                (np.arange(sources.size), sources),
            ),
            shape=(sources.size, n_nodes),
        )
        frontier = visited
        reached = []
        for d in range(1, depth + 1):
            frontier = ((frontier @ adj) > 0).astype(np.int32)
            frontier = frontier - frontier.multiply(visited)
            frontier.eliminate_zeros()
            if frontier.nnz == 0:
                break
            visited = ((visited + frontier) > 0).astype(np.int32)
            if d >= 2:
                reached.append(frontier.tocoo())
        for coo in reached:
            u = sources[coo.row]
            v = coo.col.astype(np.int64)
            keep = (u < v) & participating[v]
            if keep.any():
                pair_chunks.append(
                    np.stack([u[keep], v[keep]], axis=1).astype(np.int64)
                )
    if not pair_chunks:
        return np.zeros((0, 2), dtype=np.int64)
    pairs = np.unique(np.concatenate(pair_chunks, axis=0), axis=0)
    return pairs


def lifted_costs_from_node_labels(
    lifted_uv: np.ndarray,
    node_labels: np.ndarray,
    same_cost: float,
    different_cost: float,
    ignore_label: Optional[int] = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Attractive/repulsive lifted costs from per-node semantic labels
    (reference lifted_features/costs_from_node_labels.py:25).

    Pairs with equal labels get ``same_cost`` (attractive > 0), different
    labels ``different_cost`` (repulsive < 0); pairs touching ``ignore_label``
    are dropped.  Returns (filtered lifted_uv, costs).
    """
    la = node_labels[lifted_uv[:, 0]]
    lb = node_labels[lifted_uv[:, 1]]
    keep = np.ones(lifted_uv.shape[0], dtype=bool)
    if ignore_label is not None:
        keep = (la != ignore_label) & (lb != ignore_label)
    la, lb = la[keep], lb[keep]
    costs = np.where(la == lb, float(same_cost), float(different_cost))
    return lifted_uv[keep], costs


def merge_lifted_problems(problems) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate (lifted_uv, costs) problems, summing costs of duplicate
    pairs (reference lifted_features/merge_lifted_problems.py:23)."""
    uvs = [p[0] for p in problems if p[0].shape[0]]
    if not uvs:
        return np.zeros((0, 2), dtype=np.int64), np.zeros(0)
    uv = np.concatenate(uvs, axis=0)
    costs = np.concatenate([p[1] for p in problems if p[0].shape[0]])
    uniq, inv = np.unique(uv, axis=0, return_inverse=True)
    summed = np.zeros(uniq.shape[0])
    np.add.at(summed, inv, costs)
    return uniq.astype(np.int64), summed


def _lifted_gaec_python(
    n_nodes: int,
    uv: np.ndarray,
    costs: np.ndarray,
    lifted_uv: np.ndarray,
    lifted_costs: np.ndarray,
) -> np.ndarray:
    """Greedy additive edge contraction with lifted costs (host fallback)."""
    local: list = [dict() for _ in range(n_nodes)]
    lifted: list = [dict() for _ in range(n_nodes)]
    for (u, v), c in zip(uv, costs):
        u, v = int(u), int(v)
        if u == v:
            continue
        local[u][v] = local[u].get(v, 0.0) + float(c)
        local[v][u] = local[u][v]
    for (u, v), c in zip(lifted_uv, lifted_costs):
        u, v = int(u), int(v)
        if u == v:
            continue
        lifted[u][v] = lifted[u].get(v, 0.0) + float(c)
        lifted[v][u] = lifted[u][v]

    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def combined(u, v):
        return local[u][v] + lifted[u].get(v, 0.0)

    stamp: Dict[Tuple[int, int], int] = {}
    counter = 0
    heap = []
    for u in range(n_nodes):
        for v in local[u]:
            if v > u:
                stamp[(u, v)] = 0
                heapq.heappush(heap, (-combined(u, v), u, v, 0))

    while heap:
        negp, u, v, st = heapq.heappop(heap)
        ru, rv = find(u), find(v)
        if ru == rv:
            continue
        key = (min(ru, rv), max(ru, rv))
        if stamp.get(key) != st:
            continue
        if -negp <= 0.0:
            break
        # contract rv into ru (smaller adjacency into larger)
        if len(local[ru]) + len(lifted[ru]) < len(local[rv]) + len(lifted[rv]):
            ru, rv = rv, ru
        parent[rv] = ru
        for m in (local, lifted):
            m[ru].pop(rv, None)
            m[rv].pop(ru, None)
        touched = set()
        for m in (local, lifted):
            for w, c in m[rv].items():
                m[w].pop(rv, None)
                m[ru][w] = m[ru].get(w, 0.0) + c
                m[w][ru] = m[ru][w]
                touched.add(w)
            m[rv].clear()
        touched.update(local[ru].keys())
        # sorted: heap push order must not depend on set hashing, or equal
        # costs tie-break nondeterministically across runs
        for w in sorted(touched):
            if w not in local[ru]:
                continue  # lifted-only pairs are not contractible
            counter += 1
            k2 = (min(ru, w), max(ru, w))
            stamp[k2] = counter
            heapq.heappush(heap, (-combined(ru, w), ru, w, counter))

    return np.array([find(i) for i in range(n_nodes)], dtype=np.int64)


def solve_lifted_multicut(
    n_nodes: int,
    uv: np.ndarray,
    costs: np.ndarray,
    lifted_uv: np.ndarray,
    lifted_costs: np.ndarray,
    use_native: bool = True,
) -> np.ndarray:
    """Lifted multicut via lifted-GAEC: consecutive node labeling (0..k-1).

    Positive cost = attractive, negative = repulsive, for both edge sets.
    Lifted edges influence merge priorities but never make two clusters
    contractible on their own.
    """
    if uv.shape[0] == 0:
        return np.arange(n_nodes, dtype=np.int64)
    if lifted_uv.shape[0] == 0:
        return solve_multicut(n_nodes, uv, costs, use_native=use_native)
    if use_native and native.available():
        roots = native.lifted_gaec(n_nodes, uv, costs, lifted_uv, lifted_costs)
    else:
        roots = _lifted_gaec_python(n_nodes, uv, costs, lifted_uv, lifted_costs)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int64)


def lifted_multicut_energy(
    uv: np.ndarray,
    costs: np.ndarray,
    lifted_uv: np.ndarray,
    lifted_costs: np.ndarray,
    labels: np.ndarray,
) -> float:
    """Sum of costs of cut edges, local + lifted (test oracle)."""
    e = 0.0
    if uv.shape[0]:
        cut = labels[uv[:, 0]] != labels[uv[:, 1]]
        e += float(costs[cut].sum())
    if lifted_uv.shape[0]:
        cut = labels[lifted_uv[:, 0]] != labels[lifted_uv[:, 1]]
        e += float(lifted_costs[cut].sum())
    return e
