"""Multicut solvers and cost transforms (port of
``cluster_tools_tpu/ops/multicut.py``, host numpy as there).

Replaces elf.segmentation.multicut / nifty solvers (reference
multicut/solve_subproblems.py:184, costs/probs_to_costs.py:212-215).

The solver is host-side (sequential combinatorial; C++ via the port's
``native`` copy of the solver library, with the same pure-python fallback);
the cost transform is vectorized numpy.
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional, Tuple

import numpy as np

from .. import native


def transform_probabilities_to_costs(
    probs: np.ndarray,
    beta: float = 0.5,
    edge_sizes: Optional[np.ndarray] = None,
    weighting_exponent: float = 1.0,
) -> np.ndarray:
    """Log-odds edge costs with optional edge-size weighting
    (reference probs_to_costs.py:212-215 via elf)."""
    p = np.clip(probs.astype(np.float64), 0.001, 0.999)
    costs = np.log((1.0 - p) / p) + np.log((1.0 - beta) / beta)
    if edge_sizes is not None:
        w = (edge_sizes / edge_sizes.max()) ** weighting_exponent
        costs = costs * w
    return costs


NODE_LABEL_MODES = ("ignore", "isolate", "ignore_transition")


def apply_node_label_costs(
    costs: np.ndarray,
    endpoint_labels: np.ndarray,
    mode: str,
    max_repulsive: float,
    max_attractive: float,
) -> np.ndarray:
    """Force edge costs from per-endpoint node labels (reference
    costs/probs_to_costs.py:116-152).

    ``endpoint_labels`` is ``[m, 2]``: the node label of each edge endpoint.
    A node "has the label" when its value is > 0.

    - ``ignore``: any edge touching a labeled node → ``max_repulsive``
      (excise labeled nodes from the partition).
    - ``isolate``: both endpoints labeled → ``max_attractive``; exactly one
      labeled → ``max_repulsive`` (labeled nodes form their own segment).
    - ``ignore_transition``: endpoints with *different* label values →
      ``max_repulsive`` (semantic boundaries must stay cut).
    """
    if mode not in NODE_LABEL_MODES:
        raise ValueError(f"invalid node-label mode {mode!r}, pick from {NODE_LABEL_MODES}")
    out = np.asarray(costs, dtype=np.float64).copy()
    lab = np.asarray(endpoint_labels)
    if lab.ndim != 2 or lab.shape[1] != 2 or lab.shape[0] != out.shape[0]:
        raise ValueError(
            f"endpoint_labels must be [{out.shape[0]}, 2], got {lab.shape}"
        )
    has = lab > 0
    if mode == "ignore":
        out[has.any(axis=1)] = max_repulsive
    elif mode == "isolate":
        n_labeled = has.sum(axis=1)
        out[n_labeled == 2] = max_attractive
        out[n_labeled == 1] = max_repulsive
    else:  # ignore_transition
        out[lab[:, 0] != lab[:, 1]] = max_repulsive
    return out


def _gaec_python(n_nodes: int, uv: np.ndarray, costs: np.ndarray,
                 stop_priority: float = 0.0, mean_mode: bool = False,
                 counts: Optional[np.ndarray] = None) -> np.ndarray:
    """Pure-python greedy edge contraction (fallback).

    ``mean_mode=False``: parallel edges sum, priority = value (GAEC).
    ``mean_mode=True``: parallel edges combine by count-weighted mean,
    priority = -mean (threshold clustering; pass stop_priority=-threshold).
    """
    if counts is None:
        counts = np.ones(len(costs))

    def combine(a, b):
        if mean_mode:
            return ((a[0] * a[1] + b[0] * b[1]) / (a[1] + b[1]), a[1] + b[1])
        return (a[0] + b[0], a[1] + b[1])

    def prio(val):
        return -val[0] if mean_mode else val[0]

    adj: list = [dict() for _ in range(n_nodes)]
    for (u, v), c, cnt in zip(uv, costs, counts):
        u, v = int(u), int(v)
        if u == v:
            continue
        val = (float(c), float(cnt))
        if v in adj[u]:
            val = combine(adj[u][v], val)
        adj[u][v] = val
        adj[v][u] = val

    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    stamp: Dict[Tuple[int, int], int] = {}
    counter = 0
    heap = []
    for u in range(n_nodes):
        for v, val in adj[u].items():
            if v > u:
                stamp[(u, v)] = 0
                heapq.heappush(heap, (-prio(val), u, v, 0))

    while heap:
        negp, u, v, st = heapq.heappop(heap)
        ru, rv = find(u), find(v)
        if ru == rv:
            continue
        key = (min(ru, rv), max(ru, rv))
        if stamp.get(key) != st:
            continue
        if -negp <= stop_priority:
            break
        # contract the smaller adjacency into the larger
        if len(adj[ru]) < len(adj[rv]):
            ru, rv = rv, ru
        parent[rv] = ru
        adj[ru].pop(rv, None)
        adj[rv].pop(ru, None)
        for w, val in adj[rv].items():
            adj[w].pop(rv, None)
            if w in adj[ru]:
                val = combine(adj[ru][w], val)
            adj[ru][w] = val
            adj[w][ru] = val
            counter += 1
            k2 = (min(ru, w), max(ru, w))
            stamp[k2] = counter
            heapq.heappush(heap, (-prio(val), ru, w, counter))
        adj[rv].clear()

    return np.array([find(i) for i in range(n_nodes)], dtype=np.int64)


def solve_multicut(
    n_nodes: int, uv: np.ndarray, costs: np.ndarray, use_native: bool = True
) -> np.ndarray:
    """GAEC multicut: returns a consecutive node labeling (0..k-1).

    Positive cost = attractive (merge), negative = repulsive — the convention of
    the log-odds transform above.
    """
    if uv.shape[0] == 0:
        return np.arange(n_nodes, dtype=np.int64)
    if use_native and native.available():
        roots = native.gaec_multicut(n_nodes, uv, costs)
    else:
        roots = _gaec_python(n_nodes, uv, costs)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int64)


def agglomerative_clustering(
    n_nodes: int,
    uv: np.ndarray,
    weights: np.ndarray,
    threshold: float,
    edge_sizes: Optional[np.ndarray] = None,
    use_native: bool = True,
) -> np.ndarray:
    """Merge edges with (size-weighted mean) weight < threshold, cheapest
    boundary first — mala clustering semantics (reference
    agglomerate.py:190-198).  Returns a consecutive labeling."""
    if uv.shape[0] == 0:
        return np.arange(n_nodes, dtype=np.int64)
    if use_native and native.available():
        roots = native.agglomerative_clustering(
            n_nodes, uv, weights, threshold, sizes=edge_sizes
        )
    else:
        roots = _gaec_python(
            n_nodes, uv, weights.astype(np.float64),
            stop_priority=-threshold, mean_mode=True, counts=edge_sizes,
        )
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int64)


def contract_edges(
    new_u: np.ndarray, new_v: np.ndarray, values: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Contract an edge list under a node relabeling: drops edges that became
    internal (u == v), canonicalizes pair order, and sums ``values`` over
    duplicate pairs (the reduce step of the hierarchical solve, reference
    reduce_problem.py:205-218 via nt.EdgeMapping).

    Returns ``(edges [k,2] sorted lexicographically, summed values [k])``.
    """
    live = new_u != new_v
    nu = np.asarray(new_u[live], dtype=np.int64).copy()
    nv = np.asarray(new_v[live], dtype=np.int64).copy()
    swap = nu > nv
    nu[swap], nv[swap] = nv[swap], nu[swap]
    if nu.size == 0:
        return np.zeros((0, 2), dtype=np.int64), np.zeros(0)
    base = int(max(nu.max(), nv.max())) + 2
    keys = nu * base + nv
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    summed = np.zeros(uniq_keys.size)
    np.add.at(summed, inv, values[live])
    edges = np.stack([uniq_keys // base, uniq_keys % base], axis=1)
    return edges.astype(np.int64), summed


def multicut_energy(uv: np.ndarray, costs: np.ndarray, labels: np.ndarray) -> float:
    """Energy of a node labeling: sum of costs of *cut* edges (lower = better
    when repulsive edges are cut; used by tests as a sanity oracle)."""
    cut = labels[uv[:, 0]] != labels[uv[:, 1]]
    return float(costs[cut].sum())
