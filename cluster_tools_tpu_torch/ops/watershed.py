"""Seeded watershed and seed detection in PyTorch — the per-block
DT-watershed in every mode, and the seeded flood.

Port of ``cluster_tools_tpu/ops/watershed.py``: threshold → distance
transform (per slice or 3d, with a pixel pitch) → smoothed-maxima seeds
(optionally thinned by non-maximum suppression) → height map → seeded flood
→ size filter (a second flood of the voxels of small segments).

The flood is the unique fixpoint of the lexicographic path cost
(pass height, hops, seed label), ties to the smaller label (``minlex``), so
any schedule gives the same labels.  ``seeded_watershed`` dispatches as the
JAX package does: a per-slice flood goes to kernel 1 (``cuda_flood.
flood_slices``); a 3d flood to the global sweeps (``cuda_flood.
flood_volume``), warm-started by kernel 3 (``cuda_flood.flood_tiles_warm``)
when a flood tile resolves (``resolve_flood_tile``).  On the CPU each runs
its plain PyTorch version.  The production 2d mode of ``dt_watershed`` runs
as kernel 2 (``cuda_dtws``).  ``two_pass_flood`` is pass 2 of the
checkerboard two-pass watershed: the same steps, seeded from the labels
pass 1 wrote into the halo as well.  Tensors carry a leading batch axis of blocks
(B, Z, H, W) where the JAX package used ``vmap``.

The flood's other entry points: a capped flood (``max_iter`` > 0) runs the
sweep schedule (``cuda_flood.flood_volume_scan``), ``connectivity`` > 1
the neighbour-sweep flood (``_seeded_watershed_sweep``), both plain PyTorch
on the tensor's device; ``flood_with_stats`` returns the altitudes and
round counters beside the labels, ``flood_merge_table`` the tile-face
``(a, b, saddle)`` edges of a labelling and ``seeded_watershed_hier`` both
(the hierarchy hook of ``ops/hier.py``'s callers and of the tests).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ._build import count_on_card
from .cc import (
    _canonical_offsets,
    _tile_grid,
    connected_components,
    neighbor_offsets,
    parse_tile_spec,
    resolve_coarse_tile,
    shift,
    tile_crossing_take,
    tile_stack,
    tile_unstack,
)
from .cuda_flood import (
    BIG_DIST,
    altitude_sweeps,
    assign_sweeps,
    flood_slices,
    flood_tiles_warm,
    flood_volume,
    flood_volume_scan,
    volume_edges,
)
from .dt import distance_transform, distance_transform_2d_stack, parabola_pass_axis
from .filters import fma32, gaussian, maximum_filter, minimum_filter, normalize

FLOOD_TILE_ENV = "CTT_FLOOD_TILE"
_BIG = 3.0e38


def minlex(d1, l1, d2, l2):
    """Min over (dist, label) in lexicographic order where label 0 is +inf."""
    take1 = (l1 > 0) & ((l2 == 0) | (d1 < d2) | ((d1 == d2) & (l1 < l2)))
    return torch.where(take1, d1, d2), torch.where(take1, l1, l2)


def hmap_weights(alpha: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``alpha`` and ``1 - alpha`` (the difference taken in float64,
    then rounded — as the JAX package's traced Python constant is)."""
    return (
        torch.tensor(alpha, dtype=torch.float32),
        torch.tensor(1.0 - alpha, dtype=torch.float32),
    )


def _sigmas(per_slice: bool, sigma: float) -> Tuple[float, float, float]:
    """Gaussian sigmas over (Z, H, W): in plane only when ``per_slice``."""
    return (0.0 if per_slice else sigma, sigma, sigma)


def local_maxima(dt: torch.Tensor, sigma: float, per_slice: bool = False) -> torch.Tensor:
    """Plateau maxima of the smoothed distances where dt > 0, per slice
    (3×3 window) or in 3d (3×3×3) over a (..., Z, H, W) tensor."""
    sm = gaussian(dt, _sigmas(per_slice, float(sigma))) if sigma and sigma > 0 else dt
    window = (3, 3) if per_slice else (3, 3, 3)
    return (maximum_filter(sm, window) == sm) & (dt > 0)


def suppress_seeds(
    maxima: torch.Tensor,
    dt: torch.Tensor,
    per_slice: bool = False,
    pixel_pitch: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Distance-based non-maximum suppression of seed maxima over the three
    trailing axes: p is dropped iff a maximum q covers it,
    ``dt(q)² − ‖p−q‖² > dt(p)²`` (up to the JAX package's 1e-5 slack); the
    cover field is a separable max-parabola transform."""
    pitch = (1.0, 1.0, 1.0) if pixel_pitch is None else tuple(float(p) for p in pixel_pitch)
    d = dt.to(torch.float32)
    d2 = d * d
    g = torch.where(maxima, -d2, torch.tensor(_BIG, dtype=torch.float32, device=dt.device))
    nd = dt.dim()
    for axis in ((1, 2) if per_slice else (0, 1, 2)):
        g = parabola_pass_axis(g, nd - 3 + axis, pitch[axis])
    slack = torch.tensor(1.0 + 1e-5, dtype=torch.float32, device=dt.device).expand_as(d2)
    eps = torch.tensor(1e-5, dtype=torch.float32, device=dt.device).expand_as(d2)
    return maxima & (-g <= fma32(d2, slack, eps))


def dt_seeds(
    dt: torch.Tensor,
    sigma: float = 2.0,
    per_slice: bool = False,
    nms: bool = False,
    pixel_pitch: Optional[Sequence[float]] = None,
):
    """Seeds from a (B, Z, H, W) distance transform: smooth → plateau
    maxima → optional NMS → CC of the maxima (8-connected per slice, or
    26-connected in 3d) → consecutive ids per block in minimal-flat-index
    order.  Returns ``(int32 seeds, n per block)``."""
    lm = local_maxima(dt, sigma, per_slice)
    if nms:
        lm = suppress_seeds(lm, dt, per_slice=per_slice, pixel_pitch=pixel_pitch)
    return connected_components(lm, connectivity=3, per_slice=per_slice)


def make_hmap(
    x: torch.Tensor, dt: torch.Tensor, alpha: float, sigma: float = 0.0, per_slice: bool = False
) -> torch.Tensor:
    """Height map ``alpha·x + (1-alpha)·(1 - normalize(dt))`` of a
    (B, Z, H, W) batch, the distances normalized and the result smoothed per
    z-slice (``per_slice``) or per block; the blend is
    ``fma(alpha, x, (1-alpha)·(1-dtn))``, the JAX package's contraction of it
    on the CPU."""
    a, b = (w.to(x.device) for w in hmap_weights(alpha))
    dtn = normalize(dt, dims=(-2, -1) if per_slice else (-3, -2, -1))
    hmap = fma32(a.expand_as(x), x, b * (1 - dtn))
    if sigma and sigma > 0:
        hmap = gaussian(hmap, _sigmas(per_slice, float(sigma)))
    return hmap


def resolve_flood_tile(shape, coarse_tile=None) -> Optional[Tuple[int, ...]]:
    """The flood's warm-start tile: an explicit ``coarse_tile`` (int = cube,
    sequence = per axis) first, then the ``CTT_FLOOD_TILE`` environment
    variable, read at call time, then None (no warm start) — clipped per
    axis to ``shape``.  An invalid variable warns and gives None."""
    ndim = len(shape)
    if coarse_tile is None:
        pin = os.environ.get(FLOOD_TILE_ENV)
        if pin is None:
            return None
        tile = parse_tile_spec(pin, ndim)
        if tile is None:
            warnings.warn(
                f"invalid {FLOOD_TILE_ENV}={pin!r}; tile warm start off",
                RuntimeWarning,
                stacklevel=2,
            )
            return None
    elif isinstance(coarse_tile, (int, np.integer)):
        tile = (int(coarse_tile),) * ndim
    else:
        tile = tuple(int(t) for t in coarse_tile)
        if len(tile) != ndim:
            raise ValueError(f"coarse_tile {coarse_tile!r} does not match ndim {ndim}")
    return tuple(max(1, min(int(t), int(s))) for t, s in zip(tile, shape))


def seeded_watershed(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    connectivity: int = 1,
    max_iter: int = 0,
    per_slice: bool = False,
    coarse_tile=None,
) -> torch.Tensor:
    """Flood ``seeds`` (0 = unlabeled) over ``hmap`` to the fixpoint,
    restricted to ``mask``, for one (Z, H, W) block or a (B, Z, H, W) batch.
    ``per_slice`` floods each z-slice on its own (kernel 1); otherwise the
    3d flood, warm-started by kernel 3 when a tile resolves from
    ``coarse_tile`` or ``CTT_FLOOD_TILE`` (same labels, fewer global
    rounds).  ``max_iter`` > 0 caps each phase at that many rounds of the
    sweep schedule (``cuda_flood.flood_volume_scan``: the JAX package's
    sequential sweeps, whose rounds a capped result depends on), in plain
    PyTorch on the tensor's device and without a tile; ``connectivity`` >
    1 runs the neighbour-sweep flood (``_seeded_watershed_sweep``).
    Returns int32 labels."""
    if mask is None:
        mask = torch.ones(hmap.shape, dtype=torch.bool, device=hmap.device)
    shape = hmap.shape
    if connectivity != 1:
        return _seeded_watershed_sweep(hmap, seeds, mask, connectivity, max_iter, per_slice)
    if max_iter:
        batch = (-1,) + tuple(shape[-3:])
        return flood_volume_scan(
            *(t.reshape(batch) for t in (hmap, seeds, mask)),
            axes=(1, 2) if per_slice else (0, 1, 2), max_iter=int(max_iter),
        )[0].view(shape)
    tile = resolve_flood_tile(shape[-3:], coarse_tile)
    h, w = shape[-2:]
    if per_slice:
        out = flood_slices(hmap.reshape(-1, h, w), seeds.reshape(-1, h, w), mask.reshape(-1, h, w))
        return out.view(shape)
    batch = (-1,) + tuple(shape[-3:])
    hmap, seeds, mask = (t.reshape(batch) for t in (hmap, seeds, mask))
    warm = None
    if tile is not None:
        warm = flood_tiles_warm(
            hmap.reshape(-1, h, w), seeds.reshape(-1, h, w), mask.reshape(-1, h, w), tile[1:]
        ).view(hmap.shape)
    return flood_volume(hmap, seeds, mask, warm=warm).view(shape)


def _seeded_watershed_sweep(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    connectivity: int = 1,
    max_iter: int = 0,
    per_slice: bool = False,
) -> torch.Tensor:
    """The neighbour-sweep Bellman–Ford flood over any connectivity, of one
    (Z, H, W) block or a (B, Z, H, W) batch: every round recomputes each
    voxel's (pass height, hops, label) from its neighbours alone (a voxel's
    own state is no candidate, so a state whose witness is gone does not
    survive), until a round changes nothing or ``max_iter`` rounds when it
    is > 0.  Plain PyTorch on the tensor's device."""
    hmap = hmap.to(torch.float32)
    mask = mask.bool()
    seeds = torch.where(mask, seeds.to(torch.int32), 0)
    is_seed = seeds > 0
    big = torch.tensor(_BIG, dtype=torch.float32, device=hmap.device)
    offsets = neighbor_offsets(connectivity, per_slice)
    alt0 = torch.where(is_seed, hmap, big)
    dist0 = torch.where(is_seed, 0, BIG_DIST).to(torch.int32)
    label, alt, dist = seeds, alt0, dist0
    count_on_card(_seeded_watershed_sweep, hmap)
    it = 0
    while True:
        best_alt, best_dist, best_label = alt0, dist0, seeds
        for off in offsets:
            n_label = shift(label, off, 0)
            valid = n_label > 0
            cand_alt = torch.where(valid, torch.maximum(shift(alt, off, _BIG), hmap), big)
            cand_dist = torch.where(valid, shift(dist, off, BIG_DIST) + 1, BIG_DIST)
            same_alt = cand_alt == best_alt
            better = ((cand_alt < best_alt) | (same_alt & (cand_dist < best_dist))
                      | (same_alt & (cand_dist == best_dist) & valid
                         & ((best_label == 0) | (n_label < best_label))))
            better &= ~is_seed
            best_alt = torch.where(better, cand_alt, best_alt)
            best_dist = torch.where(better, cand_dist, best_dist)
            best_label = torch.where(better, n_label, best_label)
        best_label = torch.where(mask, best_label, 0)
        best_alt = torch.where(mask, best_alt, big)
        best_dist = torch.where(mask, best_dist, BIG_DIST)
        changed = not (torch.equal(best_label, label) and torch.equal(best_alt, alt)
                       and torch.equal(best_dist, dist))
        label, alt, dist = best_label, best_alt, best_dist
        it += 1
        if not changed or (max_iter and it >= max_iter):
            return label


_seeded_watershed_sweep.launches = 0


def _tile_round_counts(hmap, seeds, mask, alt, tile, axes):
    """The round counters of the JAX package's tile-warm flood
    (``_flood_scan_impl`` with a tile) on the sweep schedule: the
    tile-local phase 1 over ``tile_stack``ed tiles, the global phase 1 from
    their altitudes, the tile-local phase 2 against the global altitudes
    ``alt`` (the fixpoint), then the global phase 2 from its keys."""
    shape = tuple(hmap.shape)
    is_seed = seeds > 0
    h_t, m_t, sd_t = (tile_stack(x, tile, f) for x, f in ((hmap, _BIG), (mask, False), (seeds, 0)))
    alt0 = torch.where(is_seed, hmap, torch.full_like(hmap, _BIG))
    alt_t, it_a = altitude_sweeps(tile_stack(alt0, tile, _BIG), h_t, m_t, axes)
    _, alt_iters = altitude_sweeps(tile_unstack(alt_t, shape, tile)[None], hmap[None], mask[None], axes)
    dist0 = torch.where(is_seed, 0, BIG_DIST).to(torch.int64)
    dist_t, label_t, it_s = assign_sweeps(
        tile_stack(dist0, tile, BIG_DIST), sd_t,
        volume_edges(tile_stack(alt, tile, _BIG), h_t, m_t, sd_t), axes)
    _, _, asg_iters = assign_sweeps(
        tile_unstack(dist_t, shape, tile)[None], tile_unstack(label_t, shape, tile)[None],
        volume_edges(alt[None], hmap[None], mask[None], seeds[None]), axes)
    return {
        "flood_tile_iters": int(it_a.max()) + int(it_s.max()),
        "flood_alt_iters": int(alt_iters[0]),
        "flood_assign_iters": int(asg_iters[0]),
    }


def flood_with_stats(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    per_slice: bool = False,
    tile: Optional[Sequence[int]] = None,
):
    """``(labels, alt, stats)`` of the seeded flood of one (Z, H, W) volume:
    int32 labels, float32 altitudes and the JAX package's round counters
    ``flood_tile_iters`` / ``flood_alt_iters`` / ``flood_assign_iters``.

    A 3d flood runs on the card: kernel 3's warm start where ``tile`` is
    given, then the 3d flood, whose altitudes and rounds come back with its
    labels.  With a tile the counters are those of the JAX package's
    tile-local loops over ``tile_stack``ed (tz, th, tw) tiles and of the
    global loops after them (``_tile_round_counts``: the sweep schedule in
    PyTorch on the tensor's device; no kernel runs that schedule).  A
    ``per_slice`` flood (y and x sweeps only) runs wholly on the sweep
    schedule, because kernel 1 returns no altitudes."""
    hmap = hmap.to(torch.float32)
    mask = mask.bool()
    seeds = torch.where(mask, seeds.to(torch.int32), 0)
    axes = (1, 2) if per_slice else (0, 1, 2)
    tile = None if tile is None else tuple(int(t) for t in tile)
    if per_slice:
        labels, alt, rounds = flood_volume_scan(hmap[None], seeds[None], mask[None], axes=axes)
        labels, alt = labels[0], alt[0]
        stats = {"flood_tile_iters": 0, "flood_alt_iters": rounds[0],
                 "flood_assign_iters": rounds[1]}
    else:
        warm = None
        if tile is not None:
            warm = flood_tiles_warm(hmap, seeds, mask, tile[1:])[None]
        stats = {"flood_tile_iters": 0}
        labels, alt = flood_volume(hmap[None], seeds[None], mask[None], warm=warm,
                                   stats=stats, return_alt=True)
        labels, alt = labels[0], alt[0]
    if tile is not None:
        stats = _tile_round_counts(hmap, seeds, mask, alt, tile, axes)
    return labels, alt, stats


def flood_merge_table(
    labels: torch.Tensor,
    heights: torch.Tensor,
    tile: Sequence[int],
    connectivity: int = 1,
    per_slice: bool = False,
):
    """Tile-face merge table of a flooded (Z, H, W) labelling: for every
    adjacency (p, p + off) under the canonical offsets that crosses a tile
    face, the label pair and the saddle ``max(heights[p], heights[p +
    off])``.  Returns flat ``(a, b, saddle)`` columns of the JAX package's
    static length and slot order; slots that are not an edge between two
    regions carry ``(0, 0, BIG)``.  Plain PyTorch on the tensor's device."""
    shape = tuple(labels.shape)
    labels = labels.to(torch.int32)
    heights = heights.to(torch.float32)
    grid = _tile_grid(shape, tile)
    a_parts, b_parts, s_parts = [], [], []
    for off in _canonical_offsets(len(shape), connectivity, per_slice):
        if all(o == 0 or grid[ax] == 1 for ax, o in enumerate(off)):
            continue
        nei_l = shift(labels, off, 0)
        nei_h = shift(heights, off, _BIG)
        for a_v, b_v, h_a, h_b in tile_crossing_take((labels, nei_l, heights, nei_h), off, tile, grid):
            ok = (a_v > 0) & (b_v > 0) & (a_v != b_v)
            a_parts.append(torch.where(ok, a_v, 0))
            b_parts.append(torch.where(ok, b_v, 0))
            s_parts.append(torch.where(ok, torch.maximum(h_a, h_b), torch.full_like(h_a, _BIG)))
    if not a_parts:
        z = torch.zeros((0,), dtype=torch.int32, device=labels.device)
        return z, z, torch.zeros((0,), dtype=torch.float32, device=labels.device)
    return torch.cat(a_parts), torch.cat(b_parts), torch.cat(s_parts)


def seeded_watershed_hier(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    coarse_tile=None,
    per_slice: bool = False,
):
    """The tile-warm flood of one (Z, H, W) volume (labels equal to
    ``seeded_watershed``'s) plus its tile-face merge table over ``hmap``:
    ``(labels, (a, b, saddle), stats)``.  The tile is ``coarse_tile``, else
    ``CTT_FLOOD_TILE``, else ``CTT_CC_TILE`` or the built-in tile, each read
    at call time: this entry point always tiles."""
    if mask is None:
        mask = torch.ones(hmap.shape, dtype=torch.bool, device=hmap.device)
    tile = resolve_flood_tile(hmap.shape, coarse_tile)
    if tile is None:
        tile = resolve_coarse_tile(hmap.shape, None)
    labels, _, stats = flood_with_stats(hmap, seeds, mask.bool(), per_slice=per_slice, tile=tile)
    table = flood_merge_table(labels, hmap.to(torch.float32), tile, per_slice=per_slice)
    return labels, table, stats


def apply_size_filter(
    labels: torch.Tensor,
    hmap: torch.Tensor,
    size_filter: int,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    connectivity: int = 1,
    per_slice: bool = False,
    protect_upto=None,
) -> torch.Tensor:
    """Per block of one (Z, H, W) block or a (B, Z, H, W) batch: zero the
    segments with fewer than ``size_filter`` voxels and re-flood the freed
    voxels from the survivors.  ``num_segments`` bounds the label values
    (exclusive).  Labels ≤ ``protect_upto`` (a scalar, or a (B,) tensor of
    one bound per block) are never filtered: the two-pass watershed's
    continuations of written neighbour labels."""
    lab = labels.reshape((-1,) + tuple(labels.shape[-3:]))
    b = lab.shape[0]
    flat = lab.reshape(b, -1).to(torch.int64)
    base = (torch.arange(b, device=labels.device) * num_segments)[:, None]
    counts = torch.bincount((flat + base).reshape(-1), minlength=b * num_segments)
    counts = counts[: b * num_segments].view(b, num_segments)
    too_small = torch.gather(counts, 1, torch.clamp(flat, max=num_segments - 1)) < size_filter
    if protect_upto is not None:
        protect = torch.as_tensor(protect_upto, device=labels.device).reshape(-1, 1)
        too_small = too_small & (flat > protect)
    kept = torch.where(too_small, 0, flat).view(labels.shape).to(torch.int32)
    return seeded_watershed(hmap, kept, mask, connectivity=connectivity, per_slice=per_slice)


def dt_watershed(
    input_: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    threshold: float = 0.25,
    apply_dt_2d: bool = True,
    apply_ws_2d: bool = True,
    pixel_pitch=None,
    sigma_seeds: float = 2.0,
    sigma_weights: float = 2.0,
    alpha: float = 0.8,
    size_filter: int = 25,
    invert_input: bool = False,
    non_maximum_suppression: bool = False,
    valid: Optional[torch.Tensor] = None,
):
    """The full per-block DT-watershed of a (Z, H, W) block or a (B, Z, H, W)
    batch of blocks, on the tensor's device.  Returns ``(int32 labels,
    n_seeds)`` (n_seeds per block for a batch).

    The 2d mode (``apply_dt_2d`` and ``apply_ws_2d``, no NMS) runs as
    kernel 2; every other mode runs the steps here, with the 3d flood (or
    kernel 1 for a per-slice flood).  ``valid`` restricts the flood and the
    size filter to the real voxels of a padded block."""
    from .cuda_dtws import dt_watershed_slices

    if pixel_pitch is not None and apply_dt_2d:
        raise ValueError("pixel_pitch requires apply_dt_2d=False")
    single = input_.dim() == 3
    x = input_[None] if single else input_
    m = None if mask is None else (mask[None] if single else mask)
    v = None if valid is None else (valid[None] if single else valid)
    if apply_dt_2d and apply_ws_2d and not non_maximum_suppression:
        labels, n = dt_watershed_slices(
            x, m, v, threshold=threshold, sigma_seeds=sigma_seeds,
            sigma_weights=sigma_weights, alpha=alpha, size_filter=size_filter,
            invert_input=invert_input,
        )
    else:
        x = x.to(torch.float32)
        if invert_input:
            x = 1.0 - x
        fg = x < torch.tensor(threshold, dtype=torch.float32, device=x.device)
        if m is not None:
            fg = fg & m.bool()
        dt = distance_transform_2d_stack(fg) if apply_dt_2d else distance_transform(fg, pixel_pitch)
        seeds, n = dt_seeds(
            dt, sigma_seeds, per_slice=apply_ws_2d, nms=non_maximum_suppression,
            pixel_pitch=pixel_pitch,
        )
        hmap = make_hmap(x, dt, alpha, sigma_weights, per_slice=apply_ws_2d)
        flood_mask = fg if v is None else fg & v.bool()
        labels = seeded_watershed(hmap, seeds, flood_mask, per_slice=apply_ws_2d)
        if size_filter > 0:
            labels = apply_size_filter(
                labels, hmap, size_filter, num_segments_of(x.shape[1:]), flood_mask,
                per_slice=apply_ws_2d,
            )
    if single:
        return labels[0], n[0]
    return labels, n


def two_pass_flood(
    input_: torch.Tensor,
    written: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    threshold: float = 0.25,
    apply_dt_2d: bool = True,
    apply_ws_2d: bool = True,
    pixel_pitch=None,
    sigma_seeds: float = 2.0,
    sigma_weights: float = 2.0,
    alpha: float = 0.8,
    size_filter: int = 25,
    invert_input: bool = False,
    non_maximum_suppression: bool = False,
    num_segments: Optional[int] = None,
):
    """Pass 2 of the checkerboard two-pass watershed for a (Z, H, W) block
    or a (B, Z, H, W) batch, on the tensors' device.

    ``written`` holds the labels pass 1 wrote into the halo, compacted per
    block to 1..k (0 = unwritten).  Threshold → distance transform (in the
    2d mode zeroed at written voxels, so no own maximum lands there) →
    seeds, shifted above k → height map → seeded flood from the written
    labels and the own seeds (kernel 1 per slice, or the 3d flood) → size
    filter, which never removes labels ≤ k.  Returns ``(int32 labels, k)``,
    k per block for a batch.  ``num_segments`` bounds the label values
    (exclusive); the default ``2·N + 2`` always holds."""
    if pixel_pitch is not None and apply_dt_2d:
        raise ValueError("pixel_pitch requires apply_dt_2d=False")
    single = input_.dim() == 3

    def batched(t):
        return None if t is None else (t[None] if single else t)

    x, w, m, v = (batched(t) for t in (input_, written, mask, valid))
    x = x.to(torch.float32)
    w = w.to(torch.int32)
    if invert_input:
        x = 1.0 - x
    fg = x < torch.tensor(threshold, dtype=torch.float32, device=x.device)
    if m is not None:
        fg = fg & m.bool()
    dt = distance_transform_2d_stack(fg) if apply_dt_2d else distance_transform(fg, pixel_pitch)
    k = w.reshape(w.shape[0], -1).amax(1)
    if apply_ws_2d:
        dt = torch.where(w > 0, torch.zeros((), dtype=dt.dtype, device=dt.device), dt)
    own, _ = dt_seeds(
        dt, sigma_seeds, per_slice=apply_ws_2d, nms=non_maximum_suppression,
        pixel_pitch=pixel_pitch,
    )
    own = own.to(torch.int32)
    seeds = torch.where(w > 0, w, torch.where(own > 0, own + k.view(-1, 1, 1, 1), 0))
    hmap = make_hmap(x, dt, alpha, sigma_weights, per_slice=apply_ws_2d)
    flood_mask = fg if v is None else fg & v.bool()
    labels = seeded_watershed(hmap, seeds, flood_mask, per_slice=apply_ws_2d)
    if size_filter > 0:
        if num_segments is None:
            num_segments = 2 * int(np.prod(x.shape[1:])) + 2
        labels = apply_size_filter(
            labels, hmap, size_filter, num_segments, flood_mask,
            per_slice=apply_ws_2d, protect_upto=k,
        )
    if single:
        return labels[0], k[0]
    return labels, k


def num_segments_of(block_shape) -> int:
    """Exclusive bound of the seed ids of one block (the JAX package's
    ``prod(shape)//2 + 2``)."""
    return int(np.prod(block_shape)) // 2 + 2


def fit_to_hmap(
    objs: np.ndarray,
    hmap: torch.Tensor,
    erode_by: int,
    erode_3d: bool = True,
) -> np.ndarray:
    """Refit (possibly resampled) objects to a boundary height map: erode each
    object, then re-grow all of them with a seeded watershed on a DT-blended
    height map (reference volume_utils.fit_to_hmap:336-357).

    Labels are compacted to int32 on the host and the refit runs on
    ``hmap``'s device: the per-object erosion is the min==max window test
    (a voxel is interior iff its whole window carries one label), the
    background seed is the eroded background, the height map
    ``0.8·h + 0.2·(1 − normalize(dt(h > 0.3)))`` of the normalized map
    (each operation rounded on its own, as the JAX package's eager
    operations are), and the flood the 3d one of ``seeded_watershed``.
    Returns the refit uint64 labels on the host."""
    uniq = np.unique(objs)
    if uniq[0] != 0:
        uniq = np.concatenate([[0], uniq])
    local = np.searchsorted(uniq, objs).astype(np.int32)
    bg_id = int(uniq.size)

    size = 2 * int(erode_by) + 1
    win = size if erode_3d else (1, size, size)
    labels = torch.from_numpy(local).to(hmap.device)
    mn = minimum_filter(labels, win)
    mx = maximum_filter(labels, win)
    interior = (mn == mx) & (labels > 0)
    seeds = torch.where(interior, labels, 0)
    seeds = torch.where(mx == 0, bg_id, seeds).to(torch.int32)

    h = normalize(hmap.to(torch.float32))
    dt = distance_transform(h > 0.3)
    h = 0.8 * h + 0.2 * (1.0 - normalize(dt))

    fitted = seeded_watershed(h, seeds).to(torch.int64)
    fitted = torch.where(fitted == bg_id, 0, fitted).cpu().numpy()
    return uniq[fitted].astype(np.uint64)
