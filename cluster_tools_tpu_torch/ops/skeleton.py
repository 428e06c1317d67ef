"""Object skeletonization: TEASAR-style geodesic path skeletons (port of
``cluster_tools_tpu/ops/skeleton.py``).

Replaces elf.skeleton (reference skeletons/skeletonize.py:157-163, thinning /
teasar via skeletor).  The algorithm here is the TEASAR family (Sato et al.):

  1. root = the object voxel with maximal Euclidean DT (deepest interior);
  2. geodesic BFS distance field from the root over the 26-connected object;
  3. repeatedly: take the unvisited voxel farthest (geodesically) from the
     root, backtrace its shortest path to the already-extracted skeleton,
     append the path, and mark every voxel within ``mask_scale * DT`` of the
     new path as visited;
  4. stop when all object voxels are covered.

Output is a skeleton *graph*: node coordinates [n, 3] (voxel units) and edges
[m, 2] into the node list — the same (nodes, edges) contract as elf.skeleton.

The per-object work is a sparse graph traversal over ragged data — host numpy,
like the reference's; the dense EDT it consumes is ``ops/dt.py::
distance_transform`` on ``device`` (the card by default), held bit for bit
to the JAX package's, so the root and the skeleton are the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .dt import distance_transform


def _geodesic_field(obj: np.ndarray, root_flat: int):
    """BFS distances + predecessors from root over the 26-connected mask."""
    from collections import deque

    shape = obj.shape
    flat = obj.reshape(-1)
    dist = np.full(flat.size, -1, dtype=np.int64)
    pred = np.full(flat.size, -1, dtype=np.int64)
    strides = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == dy == dx == 0:
                    continue
                strides.append((dz, dy, dx))

    coords = np.unravel_index(np.arange(flat.size), shape)
    dist[root_flat] = 0
    frontier = np.array([root_flat], dtype=np.int64)
    while frontier.size:
        z = coords[0][frontier]
        y = coords[1][frontier]
        x = coords[2][frontier]
        nxt = []
        for dz, dy, dx in strides:
            nz, ny, nx_ = z + dz, y + dy, x + dx
            ok = (
                (nz >= 0) & (nz < shape[0])
                & (ny >= 0) & (ny < shape[1])
                & (nx_ >= 0) & (nx_ < shape[2])
            )
            nb = (nz[ok] * shape[1] + ny[ok]) * shape[2] + nx_[ok]
            src = frontier[ok]
            fresh = flat[nb] & (dist[nb] < 0)
            nb, src = nb[fresh], src[fresh]
            # dedupe within the wave (first writer wins)
            uniq, first = np.unique(nb, return_index=True)
            dist[uniq] = dist[src[first]] + 1
            pred[uniq] = src[first]
            nxt.append(uniq)
        frontier = np.unique(np.concatenate(nxt)) if nxt else np.array([], np.int64)
    return dist, pred


def skeletonize(
    obj: np.ndarray,
    resolution=None,
    mask_scale: float = 3.0,
    mask_min_radius: float = 2.0,
    max_paths: int = 512,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Skeletonize a binary object → (nodes [n,3] float voxel coords,
    edges [m,2] int node indices); the EDT runs on ``device``."""
    obj = np.ascontiguousarray(obj.astype(bool))
    if obj.sum() == 0:
        return np.zeros((0, 3)), np.zeros((0, 2), dtype=np.int64)
    if obj.sum() == 1:
        node = np.argwhere(obj)[0]
        return node[None].astype(float), np.zeros((0, 2), dtype=np.int64)

    dt = distance_transform(torch.from_numpy(obj).to(device)).cpu().numpy()
    root_flat = int(np.argmax(dt.reshape(-1)))

    dist, pred = _geodesic_field(obj, root_flat)
    inside = np.nonzero(obj.reshape(-1))[0]
    shape = obj.shape

    covered = np.zeros(obj.size, dtype=bool)
    covered[~obj.reshape(-1)] = True

    node_index = {}  # flat voxel -> node id
    nodes = []
    edges = []

    def add_node(fl):
        nid = node_index.get(fl)
        if nid is None:
            nid = len(nodes)
            node_index[fl] = nid
            nodes.append(np.unravel_index(fl, shape))
        return nid

    on_skeleton = np.zeros(obj.size, dtype=bool)

    def cover_path(path_flat):
        """Mark voxels within mask_scale*DT of each path voxel as covered.
        Per-ball O(ball) coordinates — no full-volume meshgrid."""
        pz, py, px = np.unravel_index(np.asarray(path_flat), shape)
        radius = np.maximum(
            mask_scale * dt.reshape(-1)[np.asarray(path_flat)], mask_min_radius
        )
        for z, y, x, r in zip(pz, py, px, radius):
            ri = int(np.ceil(r))
            sl = (
                slice(max(0, z - ri), min(shape[0], z + ri + 1)),
                slice(max(0, y - ri), min(shape[1], y + ri + 1)),
                slice(max(0, x - ri), min(shape[2], x + ri + 1)),
            )
            bz = np.arange(sl[0].start, sl[0].stop)[:, None, None] - z
            by = np.arange(sl[1].start, sl[1].stop)[None, :, None] - y
            bx = np.arange(sl[2].start, sl[2].stop)[None, None, :] - x
            ball = (bz * bz + by * by + bx * bx) <= r * r
            view = covered.reshape(shape)[sl]
            view[ball] = True

    add_node(root_flat)
    covered_root = False
    for _ in range(max_paths):
        cand = inside[~covered[inside]]
        if cand.size == 0:
            break
        far = cand[np.argmax(dist[cand])]
        if dist[far] < 0:  # disconnected fragment (shouldn't happen per CC)
            covered[far] = True
            continue
        # backtrace to the existing skeleton (or the root)
        path = [int(far)]
        cur = int(far)
        while pred[cur] >= 0 and not on_skeleton[cur]:
            cur = int(pred[cur])
            path.append(cur)
        # register nodes + edges along the path
        prev_id = None
        for fl in path:
            nid = add_node(fl)
            if prev_id is not None:
                edges.append((prev_id, nid))
            prev_id = nid
        on_skeleton[np.asarray(path)] = True
        cover_path(path)
        if not covered_root:
            covered_root = True

    nodes = np.asarray(nodes, dtype=float)
    edges = (
        np.unique(np.sort(np.asarray(edges, dtype=np.int64), axis=1), axis=0)
        if edges
        else np.zeros((0, 2), dtype=np.int64)
    )
    if resolution is not None:
        nodes = nodes * np.asarray(resolution, dtype=float)[None]
    return nodes, edges
