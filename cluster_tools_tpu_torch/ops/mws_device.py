"""Device mutex watershed by mutually-best-edge parallel greedy, in PyTorch
(port of ``cluster_tools_tpu/ops/mws_device.py``, an XLA device function
there, plain PyTorch on the tensors' device here).

The reference reaches MWS through a sequential Kruskal-with-mutex-constraints
solver (``native.mutex_watershed``, ``ops/mws.py::_mws_python``).  The
data-parallel formulation:

Under a strict total priority order (weight descending, ties by input index
— the host solver's stable sort), an edge ``e = (A, B)`` that is the
highest-priority ACTIVE edge of BOTH its endpoint clusters can be decided
immediately, exactly as the sequential algorithm would decide it: every
higher-priority unprocessed edge is non-incident to A and B, and no
non-incident edge can change A/B's membership (a merge into A would be an
incident edge) or their mutex relation (a mutex between A and B needs an
edge incident to both).  Mutually-best edges form a matching on clusters
(each cluster has ONE best edge), so all of them apply in the same round:

  * attractive + not mutexed  → merge the two clusters;
  * attractive + mutexed      → discard (the sequential ``continue``);
  * repulsive                 → record the mutex, discard.

Progress: the globally highest active edge is always mutually best, so every
round processes ≥ 1 edge.  Repulsive edges also retire in BATCHES: a
repulsive edge that PRECEDES one side's strongest active attractive edge in
the strict (weight desc, index asc) order becomes a mutex at once (that
cluster's future merges all come later in the order, so the early mutex can
never block a merge the sequential algorithm would have done first).  This
is NOT the maximum-spanning-forest shortcut ("forest over all edges, then
cut the repulsive ones"), which is wrong for MWS: mutexes do not propagate
through chains of repulsive forest edges.

**Invariant 1 — mutual-best merges** (above).

**Invariant 2 — mutex-immune chain contraction.**  Beyond the mutual
matching, a cluster X whose best active edge ``e = (X, Y)`` is attractive
merges along it in the SAME round — even when ``e`` is not Y's best —
provided X is *mutex-immune*: no repulsive edge incident to X's cluster
(active or already processed) is stronger than ``e``.  At ``e``'s turn in
the sequential order X's cluster is unchanged (every X-incident edge is
weaker than ``e``), and a mutex involving X would need a processed — hence
stronger — X-incident repulsive edge, which immunity rules out; mutexes
retired early through the OTHER side cannot key against (X, Ycl) either,
because reaching Ycl would need a best-of-cluster merge chain through an
edge weaker than the retired mutex while ``e`` (stronger) is still pending
on Ycl.  Immunity is tested under the full lexicographic (weight desc,
index asc) order (scatter-max weight, then scatter-min index among the
achievers).  The eligible edges form a forest on clusters (one best edge
per cluster; acyclic because the strict order descends along chains),
applied with log-depth pointer jumping, so a monotone attractive chain
contracts in one round where the mutual matching alone needs one round per
merge.

**Invariant 3 — the doomed-pair discard and its weight bound.**  The mutex
join queries EVERY active inter-cluster edge, and any edge — either sign —
whose current cluster pair already carries a mutex is discarded at once.
Mutexes persist and follow merges (clusters only grow; the (min, max)
cluster key re-roots with ``comp``), so at that edge's sequential turn the
mutex still exists: an attractive edge would be skipped, a repulsive one
would record a redundant mutex for the same pair.  The load-bearing fact
behind "still exists at its sequential turn" is a WEIGHT BOUND: the mutex
edge PRECEDES the discarded edge in the sequential order.  It holds because
every merge edge joining a cluster grown from the mutexed pair was mutual
best at its round (or mutex-immune, which is stronger), so along any merge
chain the joining weights are bounded by the mutex edge's weight — every
ACTIVE edge now incident to the pair, the discarded one included, is no
heavier than the mutex edge.  Relaxing the mutual-best / immunity admission
(admitting locally-best-only merges, say) would break this bound, and with
it the discard rule.

Mutex bookkeeping is implicit: a processed repulsive edge IS a mutex
between the current clusters of its endpoints.  The per-round membership
test is a sort-join over (min comp, max comp, tag) rows, the three keys
packed into one int64 (two 30-bit cluster ids and a 2-bit tag, so the node
space must stay under 2**30).  Each round starts with one host read (the
loop condition and the count of rows still live); rounds are data
dependent: random-priority graphs converge in roughly O(log n) rounds,
smooth affinities in many more.

The JAX package pads the edge lists to a power of two for its jit cache;
the padded rows are never active, so the port does not pad.  The round
count is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.device import resolve_device
from ._build import count_launch

MAX_NODES = 1 << 30  # two 30-bit cluster ids and a 2-bit tag in one int64 key
_MUTEX, _QUERY, _NONE = 0, 1, 2  # join tags: a mutex row sorts before the queries


def _seg_max(n: int, cu, cv, vals):
    """``full(n, -inf).at[cu].max(vals).at[cv].max(vals)``."""
    out = torch.full((n,), float("-inf"), dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, cu, vals, "amax")
    return out.scatter_reduce_(0, cv, vals, "amax")


def _seg_min(n: int, big: int, cu, vals_u, cv, vals_v):
    """``full(n, big).at[cu].min(vals_u).at[cv].min(vals_v)``."""
    out = torch.full((n,), big, dtype=torch.int64, device=vals_u.device)
    out.scatter_reduce_(0, cu, vals_u, "amin")
    return out.scatter_reduce_(0, cv, vals_v, "amin")


def _mws_parallel_greedy(uv: torch.Tensor, weights: torch.Tensor, attractive: torch.Tensor,
                         n_nodes: int, enable_chain: bool = True, on_round=None):
    """The round loop on ``uv``'s device: int64 (m, 2) edges, float32
    weights, bool attractive flags.  Returns (cluster id per node, rounds).

    ``on_round(rounds, n_open, n_live)``, where given, is called with each
    round's host read (rounds done, inter-cluster rows still unprocessed,
    rows still read); a true return stops the loop there and the labels
    returned are an unfinished partition — a diagnostic of the schedule,
    never a solve.

    Each round first drops the rows that can never matter again: processed
    rows stay processed and clusters only grow, so a processed attractive
    row, or a processed repulsive one whose ends share a cluster, takes no
    part in any later round (the rest of the loop reads only unprocessed
    rows and recorded mutexes between two clusters).  Rows keep their
    input index for the tie-break, so labels and rounds are those of the
    full-width loop; the work per round follows the rows still open."""
    dev = uv.device
    m = uv.shape[0]
    u, v, w, att = uv[:, 0], uv[:, 1], weights, attractive
    idx = torch.arange(m, dtype=torch.int64, device=dev)  # input index: the tie-break
    nodes = torch.arange(n_nodes, dtype=torch.int64, device=dev)
    big = m
    n_jumps = max(int(np.ceil(np.log2(max(n_nodes, 2)))) + 1, 1)
    comp = nodes
    processed = torch.zeros(m, dtype=torch.bool, device=dev)
    rounds = 0
    while True:
        cu, cv = comp[u], comp[v]
        inter = cu != cv
        live = ~processed | (~att & inter)
        # the loop condition and the live count: one host read per round
        n_open, n_live = torch.stack([(~processed & inter).sum(), live.sum()]).tolist()
        if n_open == 0 or (on_round is not None and on_round(rounds, n_open, n_live)):
            break
        if n_live < u.shape[0]:
            keep = torch.nonzero(live).squeeze(1)
            u, v, w, att, idx, processed, cu, cv, inter = (
                t[keep] for t in (u, v, w, att, idx, processed, cu, cv, inter))
        k = u.shape[0]
        processed = processed | ~inter  # intra-cluster edges are no-ops
        # batched repulsive retirement: a repulsive edge that precedes one
        # side's strongest active attractive edge in the strict (weight
        # desc, index asc) order becomes a mutex now
        is_attr_act = ~processed & att
        w_attr = torch.where(is_attr_act, w, float("-inf"))
        alpha = _seg_max(n_nodes, cu, cv, w_attr)
        alpha_i = _seg_min(
            n_nodes, big,
            cu, torch.where(is_attr_act & (w == alpha[cu]), idx, big),
            cv, torch.where(is_attr_act & (w == alpha[cv]), idx, big),
        )

        def _precedes(side):
            a_w, a_i = alpha[side], alpha_i[side]
            return (w > a_w) | ((w == a_w) & (idx < a_i))

        retire = ~processed & ~att & (_precedes(cu) | _precedes(cv))
        processed = processed | retire
        active = ~processed
        # per-cluster best active incident edge under the strict order:
        # scatter-max weight, then scatter-min index among the achievers
        w_act = torch.where(active, w, float("-inf"))
        seg_w = _seg_max(n_nodes, cu, cv, w_act)
        best = _seg_min(
            n_nodes, big,
            cu, torch.where(active & (w_act == seg_w[cu]), idx, big),
            cv, torch.where(active & (w_act == seg_w[cv]), idx, big),
        )
        mutual = active & (best[cu] == idx) & (best[cv] == idx)

        # mutex membership of every active inter-cluster edge: sort-join of
        # mutex rows (processed repulsive edges keyed by their CURRENT
        # cluster pair) against query rows.  Stale intra-cluster mutex rows
        # key as (A, A) and never match a query's (A, B), A < B.
        a_key = torch.minimum(cu, cv)
        b_key = torch.maximum(cu, cv)
        is_mutex = processed & ~att
        is_query = active & inter
        pair = (a_key << 32) | (b_key << 2)
        key = torch.cat([
            pair | torch.where(is_mutex, _MUTEX, _NONE),
            pair | torch.where(is_query, _QUERY, _NONE),
        ])
        s_key, order = torch.sort(key)
        s_tag = s_key & 3
        # row of each sorted entry (k: a mutex row's, never scattered back)
        s_row = torch.where(order >= k, order - k, k)
        # a (A, B) run may hold several query rows; the tags sort mutex
        # before query, so "the run holds a mutex row" is "the run's first
        # row is a mutex row", spread over the run by a cummax of the run
        # starts
        run_start = torch.ones(2 * k, dtype=torch.bool, device=dev)
        run_start[1:] = (s_key[1:] >> 2) != (s_key[:-1] >> 2)
        pos2 = torch.arange(2 * k, dtype=torch.int64, device=dev)
        start_pos = torch.cummax(torch.where(run_start, pos2, 0), 0).values
        hit = (s_tag == _QUERY) & (s_tag[start_pos] == _MUTEX)
        mutexed = torch.zeros(k + 1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, torch.where(s_tag == _QUERY, s_row, k), hit.to(torch.int64), "amax",
        )[:k] > 0

        merge_e = mutual & att & ~mutexed
        # merged, mutex-blocked and repulsive mutual edges are decided; so
        # is every doomed edge of an already-mutexed cluster pair
        processed = processed | mutual | (is_query & mutexed)

        # chain contraction: a mutex-immune cluster merges along its
        # attractive best edge without mutuality.  beta: the strongest
        # repulsive edge still incident to the cluster (intra-cluster rows
        # are stale mutexes and excluded)
        is_rep = ~att & inter
        w_rep = torch.where(is_rep, w, float("-inf"))
        beta = _seg_max(n_nodes, cu, cv, w_rep)
        beta_i = _seg_min(
            n_nodes, big,
            cu, torch.where(is_rep & (w == beta[cu]), idx, big),
            cv, torch.where(is_rep & (w == beta[cv]), idx, big),
        )
        immune_u = (w > beta[cu]) | ((w == beta[cu]) & (idx < beta_i[cu]))
        immune_v = (w > beta[cv]) | ((w == beta[cv]) & (idx < beta_i[cv]))
        # ~mutexed is load-bearing: a mutexed chain candidate is a doomed
        # discard (processed above), never a chain merge
        chain = active & att & ~mutexed & bool(enable_chain)
        merge_u = chain & (best[cu] == idx) & immune_u & ~mutual
        merge_v = chain & (best[cv] == idx) & immune_v & ~mutual
        processed = processed | merge_u | merge_v

        # parent forest: mutual pairs point larger -> smaller, chain edges
        # the immune side at its partner's cluster.  Each cluster has at
        # most one best edge, so only the dump slot ``n_nodes`` (where
        # every unused row lands) sees duplicate writes; it is never read.
        parent = torch.cat([nodes, torch.zeros(1, dtype=torch.int64, device=dev)])
        parent[torch.where(merge_e, b_key, n_nodes)] = torch.where(merge_e, a_key, 0)
        parent[torch.where(merge_u, cu, n_nodes)] = torch.where(merge_u, cv, 0)
        parent[torch.where(merge_v, cv, n_nodes)] = torch.where(merge_v, cu, 0)
        # a strict forest (best-edge priorities descend along a chain), so
        # ceil(log2 n) + 1 pointer jumps reach every root
        p = parent[:n_nodes]
        for _ in range(n_jumps):
            p = p[p]
        comp = p[comp]
        rounds += 1
    return comp, rounds


def _solve(n_nodes, uv, weights, attractive, enable_chain, device):
    n_nodes = int(n_nodes)
    if n_nodes >= MAX_NODES:
        raise ValueError(f"device MWS packs cluster ids in 30 bits: {n_nodes} nodes >= 2**30")
    dev = resolve_device({"device": str(device)})
    uv = torch.from_numpy(np.ascontiguousarray(uv, dtype=np.int64).reshape(-1, 2)).to(dev)
    # the weights the JAX formulation solves with: float32
    w = torch.from_numpy(np.ascontiguousarray(weights, dtype=np.float32)).to(dev)
    att = torch.from_numpy(np.asarray(attractive).astype(bool)).to(dev)
    comp, rounds = _mws_parallel_greedy(uv, w, att, n_nodes, enable_chain)
    if dev.type == "cuda":
        count_launch(mutex_watershed_device, rounds=rounds)
    return comp.cpu().numpy(), rounds


def mutex_watershed_device(
    n_nodes: int,
    uv: np.ndarray,
    weights: np.ndarray,
    attractive: np.ndarray,
    device="cuda",
) -> np.ndarray:
    """Drop-in device counterpart of ``native.mutex_watershed``: the root
    (canonical cluster id) per node, solved on ``device`` (the card unless
    the caller names another; raises without one).  A call on the card adds
    one to ``mutex_watershed_device.launches`` and its rounds to
    ``mutex_watershed_device.rounds``."""
    labels, _ = _solve(n_nodes, uv, weights, attractive, True, device)
    return labels


mutex_watershed_device.launches = 0
mutex_watershed_device.rounds = 0


def mutex_watershed_device_rounds(
    n_nodes: int,
    uv: np.ndarray,
    weights: np.ndarray,
    attractive: np.ndarray,
    enable_chain: bool = True,
    device="cuda",
) -> int:
    """Round count of the solve — the convergence diagnostic.
    ``enable_chain=False`` runs the mutual-matching-only algorithm."""
    _, rounds = _solve(n_nodes, uv, weights, attractive, enable_chain, device)
    return rounds
