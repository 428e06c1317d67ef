"""Per-object surface meshes via naive surface nets (port of
``cluster_tools_tpu/ops/mesh.py``, host numpy as there).

Replaces elf.mesh.marching_cubes (reference meshes/compute_meshes.py:29).
Surface nets is the dual method: one vertex per grid cell that the surface
crosses (placed at the mean of the cell's edge crossings), one quad per
boundary face between adjacent crossing cells, triangulated.  It produces
watertight meshes on binary masks and vectorizes cleanly over numpy — no
256-case tables.

``smooth_mesh`` is simple laplacian smoothing (the reference forwards a
``smoothing_iterations`` knob to its marching cubes)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def marching_cubes(
    obj: np.ndarray,
    smoothing_iterations: int = 0,
    resolution=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary mask → (verts [n,3], faces [m,3] int, normals [n,3]).

    Coordinates are voxel units (scaled by ``resolution`` when given), with
    the surface at the voxel boundary between foreground and background."""
    obj = np.pad(obj.astype(bool), 1)  # close the surface at volume borders

    # a cell = a 2x2x2 voxel neighborhood; it is "active" if mixed fg/bg
    c = obj
    corners = [
        c[:-1, :-1, :-1], c[1:, :-1, :-1], c[:-1, 1:, :-1], c[1:, 1:, :-1],
        c[:-1, :-1, 1:], c[1:, :-1, 1:], c[:-1, 1:, 1:], c[1:, 1:, 1:],
    ]
    inside_count = np.sum(np.stack(corners), axis=0)
    active = (inside_count > 0) & (inside_count < 8)
    if not active.any():
        return (
            np.zeros((0, 3)),
            np.zeros((0, 3), dtype=np.int64),
            np.zeros((0, 3)),
        )

    # vertex per active cell at the centroid of its inside corners' boundary:
    # the mean of all corner positions weighted toward the crossing gives a
    # smooth placement; the simple variant (cell center) is good enough and
    # laplacian smoothing below refines it
    cell_index = np.full(active.shape, -1, dtype=np.int64)
    az, ay, ax = np.nonzero(active)
    cell_index[az, ay, ax] = np.arange(az.size)
    # position: offset -1 compensates the pad; +0.5 centers the dual vertex
    verts = np.stack([az, ay, ax], axis=1).astype(float) + 0.5 - 1.0

    faces = []
    inside_refs = []  # per triangle: the inside voxel's position (pad coords)
    # for each axis, a face sits between voxel v and v+axis where fg changes;
    # the face's 4 dual vertices are the 4 cells sharing that voxel edge
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(None, -1)
        hi[axis] = slice(1, None)
        sign_change = c[tuple(lo)] != c[tuple(hi)]
        # voxel-face at (z,y,x)→(z+1,y,x) etc; its surrounding cells are the
        # 4 cells adjacent in the two other axes
        fz, fy, fx = np.nonzero(sign_change)
        into = c[tuple(hi)][fz, fy, fx]  # True: the +axis voxel is inside
        other = [a for a in range(3) if a != axis]
        quads = []
        for d0 in (0, 1):
            for d1 in (0, 1):
                idx = [fz.copy(), fy.copy(), fx.copy()]
                idx[other[0]] -= d0
                idx[other[1]] -= d1
                for a in range(3):
                    idx[a] = np.clip(idx[a], 0, active.shape[a] - 1)
                quads.append(cell_index[tuple(idx)])
        q00, q01, q10, q11 = quads
        valid = (q00 >= 0) & (q01 >= 0) & (q10 >= 0) & (q11 >= 0)
        q00, q01, q10, q11 = (q[valid] for q in quads)
        fl = into[valid]
        # the inside voxel center in unpadded dual coordinates: the voxel at
        # (f + e_axis if into else f), center offset -1 for pad, +0 since
        # voxel centers sit at integer coords relative to dual verts - 0.5
        base = np.stack([fz, fy, fx], axis=1)[valid].astype(float)
        ref = base.copy()
        ref[fl, axis] += 1.0
        ref -= 1.0  # pad compensation (dual verts already subtract 1)
        t1 = np.stack([q00, q01, q11], 1)
        t2 = np.stack([q00, q11, q10], 1)
        faces.append(t1)
        faces.append(t2)
        inside_refs.append(ref)
        inside_refs.append(ref)
    faces = np.concatenate(faces, axis=0)
    inside_refs = np.concatenate(inside_refs, axis=0)
    # drop degenerate triangles (repeated vertices from edge-of-volume clips)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[ok]
    inside_refs = inside_refs[ok]
    # orient every triangle outward: its normal must point away from the
    # inside voxel it was generated from
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    centroid = (v0 + v1 + v2) / 3.0
    inward = (fn * (centroid - inside_refs)).sum(axis=1) < 0
    faces[inward] = faces[inward][:, ::-1]

    if smoothing_iterations:
        verts = smooth_mesh(verts, faces, smoothing_iterations)

    normals = vertex_normals(verts, faces)
    if resolution is not None:
        verts = verts * np.asarray(resolution, dtype=float)[None]
    return verts, faces, normals


def smooth_mesh(verts: np.ndarray, faces: np.ndarray, iterations: int):
    """Uniform laplacian smoothing over the face graph."""
    if faces.size == 0 or iterations <= 0:
        return verts
    nbr_a = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    nbr_b = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    for _ in range(iterations):
        acc = np.zeros_like(verts)
        cnt = np.zeros(len(verts))
        np.add.at(acc, nbr_a, verts[nbr_b])
        np.add.at(cnt, nbr_a, 1)
        np.add.at(acc, nbr_b, verts[nbr_a])
        np.add.at(cnt, nbr_b, 1)
        moved = cnt > 0
        verts = np.where(
            moved[:, None], 0.5 * verts + 0.5 * acc / np.maximum(cnt, 1)[:, None],
            verts,
        )
    return verts


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    normals = np.zeros_like(verts)
    if faces.size == 0:
        return normals
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    for i in range(3):
        np.add.at(normals, faces[:, i], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


# -- io (reference meshes via elf.mesh.io) ------------------------------------


def write_obj(path: str, verts, faces, normals=None) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if normals is not None:
            for n in normals:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for face in faces + 1:  # obj is 1-indexed
            if normals is not None:
                f.write(
                    f"f {face[0]}//{face[0]} {face[1]}//{face[1]} "
                    f"{face[2]}//{face[2]}\n"
                )
            else:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def read_obj(path: str):
    verts, normals, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(p) for p in parts[1:4]])
            elif parts[0] == "vn":
                normals.append([float(p) for p in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return (
        np.asarray(verts),
        np.asarray(faces, dtype=np.int64),
        np.asarray(normals) if normals else None,
    )


def write_ply(path: str, verts, faces, normals=None) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            row = f"{v[0]} {v[1]} {v[2]}"
            if normals is not None:
                n = normals[i]
                row += f" {n[0]} {n[1]} {n[2]}"
            f.write(row + "\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def write_numpy(path: str, verts, faces, normals=None) -> None:
    np.savez(path, verts=verts, faces=faces,
             normals=normals if normals is not None else np.zeros((0, 3)))
