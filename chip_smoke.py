#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--z 125] [--batch 8] [--seed 0] [--compare DIR] [--kernels-only]
    python3 chip_smoke.py --mws-scaling

Phases (any failure exits non-zero; nothing is caught and carried on from):

  1. device and build: the card's name and power limit (nvidia-smi), the
     CUDA kernels built from ``cluster_tools_tpu_torch/csrc`` with nvcc, one
     compiler per source, all started together;
  2. kernels against their plain PyTorch versions on the card.  Kernels 1-2
     (watershed) on a batch of (32, 256, 256) blocks of the synthetic volume
     (the workflow's batch), a ragged edge block (29, 226, 226), serpentine
     corridors (one of 64 x 256, and two of 256 x 256 that cross every band
     border of the cluster route along rows and along columns), empty and
     full masks, and (2, 384, 384) slices above the cluster route's size
     rule: labels and seed roots exactly, the height map exactly (the
     kernels round every float operation as the plain versions do), each
     case on the route its size gives.  At the workflow's batch the cluster
     route's flood rounds must equal the parent design's (the global
     route's), both designs are timed in turns and their phase splits
     printed.  Kernels 4-5 (CC) on the same blocks thresholded (``vol < 0.5``)
     and their complement, the ragged block, a serpentine corridor and,
     for kernel 5, the (32, 640, 640) blocks of the second components run
     and their complement: labels exactly; kernel 4 on both routes (the
     cluster route its size gives and the global route, the parent
     design), and on (2, 700, 700) slices above its cluster route's size
     rule.  Kernel and plain times at the workflows' batch shapes, kernel
     4's routes in turns (parent, new, new, parent) with their rounds; with
     ``--compare DIR`` kernel 5 in turns with that checkout's on the
     (32, 640, 640) blocks, whose labels must be equal, the rounds per tile
     of both printed;
  3. the watershed workflow: a seeded synthetic boundary volume at CREMI
     sample A's shape (125, 1250, 1250), made the way ``bench.make_volume``
     makes it, written to n5 with raw chunks (its first 64 planes,
     ``EARLY_Z``, two block layers, in a second container for phase 10:
     the cut that keeps phases 12-13 inside the time limit);
     ``build([WatershedWorkflow(...)])``
     on the ``cuda`` target with the default watershed config and blocks
     (32, 256, 256).  Both kernels' launch counts must rise in this run, all
     down the cluster route; the
     output is checked (shape, labels only on the foreground, ids unique per
     block through the offsets) and two blocks re-run through the plain
     versions on the card must equal it byte for byte;
  4. the thresholded-components workflow on the same volume
     (``threshold_mode="less"``: the cell interior), ``cuda`` target, twice:
     blocks (32, 256, 256), whose slices take kernel 4 (every launch down
     its cluster route), and blocks (32, 640, 640), whose slices exceed the
     whole-slice limit and take kernel 5.  The kernel's launch count must
     rise in its run; the output must have scipy's 6-connected partition
     of ``vol < 0.5`` with ids 1..n, and every block's local labels (before
     the merge) must equal scipy's labels of that block.  The (32, 256,
     256) run is repeated with the decoded-chunk cache off
     (``set_chunk_cache_budget(0)``): its output must equal the default
     budget's byte for byte, and both runs' block-face seconds are printed;
  5. kernel 3 (tile-local flood altitudes) against its plain version on a
     halo'd (36, 272, 272) block at the pinned tile (64, 128) (ragged
     tiles), a divisible (32, 256, 256) stack and a serpentine, with its
     rounds per tile equal to those of its schedule in plain PyTorch
     (``flood_tiles_warm_scan``), and the 3d flood against its plain
     version on two halo'd blocks, warm and cold, and on a corridor
     snaking through (z, x): exactly, with the rounds of both phases equal
     to those of the flood's schedule in plain PyTorch
     (``flood_volume_scan``).  Times, bounds and rounds of kernel 3 at one
     halo'd block and of the 3d flood at one halo'd block (the seeded
     workflow's call), warm and cold, and at a batch of 8 (the 3d
     watershed's call), with the time split by phase and axis (the
     kernel's stamps); with ``--compare DIR`` (a checkout of the parent
     commit, say) that checkout's kernel 3 and 3d flood on the same
     inputs, from a child process in it, in turns with this tree's, whose
     outputs and rounds (per tile for kernel 3) must be equal.  The turns
     (``in_turns``) are: each such checkout and this tree in child
     processes, all timed alike, then this tree in this process twice
     (the kernels line's ms), then the children again in reverse;
  6. ``ThresholdAndWatershedWorkflow`` on the same volume: seeds are the
     components of ``vol < 0.3`` (``"less"``), the watershed from seeds runs
     with its defaults (3d flood, sigma 2, halo [2, 8, 8]) on the ``cuda``
     target with ``CTT_FLOOD_TILE`` pinned to the kernel phase's tile.
     Kernel 3's and the 3d flood's launch counts must rise, kernel 4's all
     down its cluster route; every seed id must be kept, the output must
     cover the volume, two blocks re-run through the plain versions and a
     second, unpinned run of the watershed task must equal it byte for
     byte;
  7. ``WatershedWorkflow`` in the 3d mode (``apply_dt_2d`` and
     ``apply_ws_2d`` False, halo [2, 8, 8]: the CC re-close runs), the
     3d flood's launch count must rise, two blocks re-run through the
     plain versions must equal it;
  8. ``MulticutSegmentationWorkflow`` on the ``cuda`` target, blocks (32,
     256, 256), n_scales 1, the default 2d watershed config, twice: run 1
     computes the watershed (kernels 2 and 1 must launch) and host edge
     features, run 2 reuses it (``skip_ws``) with ``device_accumulation``
     (the RAG accumulator in PyTorch on the card must launch, its
     ``max_edges_per_block`` sized from run 1's edge counts).  Gates: the
     native solvers built; run 1's watershed equals phase 3's byte for
     byte; each segmentation is its (fragment, segment) table applied to
     the watershed, with between 1 and the fragment count segments; the
     accumulator on the card equals the host features on four blocks within
     the reference's tolerances.  Printed: walls, voxels/s, seconds per
     task, chunk-cache hits and misses, the multicut energy of each run,
     Rand and VoI between the runs, and the accumulator's ms per block
     against its byte bound;
  9. ``WatershedWorkflow(agglomeration=True)``, the default watershed and
     agglomerate configs, ``max_jobs`` 8: kernels 2 and 1 must launch, all
     on the cluster route, and the native solvers must have built; the
     fragments (``<key>_frag``) must equal phase 3's watershed byte for
     byte, the output must merge them within each block's offset range
     with their coverage, and two blocks re-run with the Python solver
     must equal it.  Printed: wall, voxels/s, seconds per task, fragment
     and segment counts, and the share of the two blocks' edges under the
     threshold;
 10. ``WatershedWorkflow(two_pass=True)`` in the 2d mode (NMS on, the task
     default) with halo [2, 8, 8], twice: at the default
     ``pipeline_depth`` with the kernels (kernel 1 must launch, all on the
     cluster route, kernel 2 must not), then at ``pipeline_depth`` 1
     through the plain versions; the outputs must be equal byte for byte.
     The flood runs per slice, so labels continue across the in-plane
     block faces only: agreement over the y and x faces above 0.25, phase
     3's single pass 0 on every axis (each axis' agreement is printed).
     Printed: walls, voxels/s, seconds per pass and stage;
 11. ``AgglomerativeClusteringWorkflow`` over phase 8's watershed, in phase
     8 run 1's tmp folder: its graph and feature tasks must be skipped
     (status files untouched); the output must be its table applied to
     the watershed, with between 1 and the fragment count segments;
 12. ``MwsWorkflow`` at the whole shape (125, 1250, 1250) on long-range
     affinities made on the card from the boundary map (8 offsets,
     ``aff(x) = 1 - max(b(x), b(x + o))``, uint8 raw n5, chunks (8, 32,
     256, 256)), the task's defaults, 8 host threads.  Gates: the native
     solver built; every voxel labelled; the output is the stitch table
     applied to ``mws_blocks``; blocks first and last recomputed with
     ``compute_mws_segmentation`` equal ``mws_blocks``; the dominant
     stitched id crosses a y face and an x face.  Printed: wall, voxels/s,
     seconds per task, segment counts, face agreement;
 12b. the device MWS (``CTT_MWS_MODE=device``) on the card on the centre
     (36, 24, 24) of two interior halo'd blocks — a crop, not a workflow
     block: the whole (36, 264, 264) block does not finish inside the
     script's time (``--mws-scaling``) — k/256 weights give the native
     partition, the workflow's k/255 weights Rand > 0.99 and VI < 0.1
     against it; rounds, ms and the native solve's ms;
 13. ``TwoPassMwsWorkflow`` at full width on the first 16 planes (half a
     block layer); gates: every voxel labelled, two pass-1 blocks
     recomputed equal to what was written, seeded voxels keep seed ids
     (their own where a block has at most 1024 seed ids).  Printed: wall, the passes' seconds, face
     agreement;
 14. one JSON line with the accumulator and the device MWS
     (``device_functions``), one listing the six kernels, then the result
     line.

``--mws-scaling`` runs only the device MWS's schedule study (no build, no
result line): growing (36, s, s) centres of phase 12's first interior
halo'd block up to the whole (36, 264, 264) block, each solve stopped after
``MWS_SCALING_BUDGET_S`` host seconds; rounds, ms per round, the rows still
open, and a profiler window over the whole block's rounds.

Without a CUDA device, or without the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# Kernel 2's operations per voxel besides its gaussians, for an exact
# O(1)-per-voxel algorithm: threshold 1, EDT column scans 4, the row lower
# envelope (insert, pop, query) 10, square root 1, 3x3 maxima 8, their CC 4,
# the height map's normalisation and blend 6, one pass of each flood phase
# over 4 neighbours 8 + 12.
DTWS_OTHER_OPS = 54
CREMI_A = (125, 1250, 1250)
BLOCK = (32, 256, 256)
BLOCK_WIDE = (32, 640, 640)  # 640 x 640 slices exceed the whole-slice limit
THRESHOLD = 0.5
SEED_THRESHOLD = 0.3  # seeds: 5.3% of the voxels, ~800 components per 40 x 250 x 250
FLOOD_TILE = "8,64,128"  # CTT_FLOOD_TILE of the seeds run: kernel 3 tiles of 64 x 128
HALO = (2, 8, 8)  # the watershed-from-seeds default, also given to the 3d watershed
EARLY_Z = 64  # depth of phase 10 (two block layers), cut for phases 12-13's time


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_volume(shape, seed: int, dev, boundary_frac: float = 0.12) -> torch.Tensor:
    """``bench.make_volume``'s recipe on the card: uniform noise smoothed by
    an anisotropic (1, 4, 4) gaussian (scipy's reflect boundary, truncate 4),
    min-max normalized, then remapped so ``boundary_frac`` of the voxels lie
    above 0.5 (CREMI-A membrane statistics)."""
    rng = np.random.default_rng(seed)
    vol = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
    for axis, sigma in zip((0, 1, 2), (1.0, 4.0, 4.0)):
        radius = int(4.0 * sigma + 0.5)
        k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
        k = k / k.sum()
        n = vol.shape[axis]
        pos = torch.arange(n, device=dev)
        acc = torch.zeros_like(vol)
        for i, w in enumerate(k):
            q = (pos + i - radius) % (2 * n)
            q = torch.where(q >= n, 2 * n - 1 - q, q)
            acc += float(w) * torch.index_select(vol, axis, q)
        vol = acc
    vol = (vol - vol.min()) / (vol.max() - vol.min())
    flat = vol.reshape(-1)
    q = torch.kthvalue(flat.cpu(), int(round((1.0 - boundary_frac) * (flat.numel() - 1))) + 1).values
    return torch.clamp(vol * (0.5 / q.item()), 0.0, 1.0).contiguous()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs after
    one warm-up run (CUDA events around the whole loop)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_kernels():
    """Route the port's host wrappers to the plain versions (the kernels'
    launch counts do not move)."""
    from cluster_tools_tpu_torch.ops import cuda_dtws, cuda_flood, watershed

    saved = (cuda_dtws.dtws_slices, watershed.flood_slices, watershed.flood_tiles_warm,
             watershed.flood_volume)
    cuda_dtws.dtws_slices = cuda_dtws.dtws_slices_plain
    watershed.flood_slices = cuda_flood.flood_slices_plain
    watershed.flood_tiles_warm = cuda_flood.flood_tiles_warm_plain
    watershed.flood_volume = cuda_flood.flood_volume_plain
    try:
        yield
    finally:
        (cuda_dtws.dtws_slices, watershed.flood_slices, watershed.flood_tiles_warm,
         watershed.flood_volume) = saved


def size_filter_inputs(x, mask, valid, labels_flat, roots, hmap):
    """The re-flood inputs the size filter hands kernel 1: block-ranked
    labels with the segments under 25 voxels zeroed, the height map and the
    flood mask (what ``dt_watershed_slices`` computes before the re-flood)."""
    from cluster_tools_tpu_torch.ops.cc import rank_of_flat_roots
    from cluster_tools_tpu_torch.ops.watershed import num_segments_of

    b = x.shape[0]
    size = int(np.prod(x.shape[1:]))
    rank, _ = rank_of_flat_roots(roots.view(b, size).long(), size)
    lf = labels_flat.view(b, size).long()
    lab = torch.where(lf > 0, torch.gather(rank, 1, (lf - 1).clamp(0, size - 1)), 0)
    nseg = num_segments_of(x.shape[1:])
    counts = torch.stack([torch.bincount(lab[i], minlength=nseg)[:nseg] for i in range(b)])
    kept = torch.where(torch.gather(counts, 1, lab.clamp(max=nseg - 1)) < 25, 0, lab)
    h, w = x.shape[-2:]
    flood_mask = (x < THRESHOLD) & mask & valid
    return (hmap.view(-1, h, w), kept.view(-1, h, w).int(), flood_mask.view(-1, h, w))


def phase_split(stamps: torch.Tensor, names) -> dict:
    """Per-phase microseconds (mean and max over slices) from an (N, K)
    tensor of the card's clock stamps in ns, K = len(names) + 1."""
    d = (stamps[:, 1:] - stamps[:, :-1]).double() / 1e3
    total = (stamps[:, -1] - stamps[:, 0]).double() / 1e3
    out = {n: (round(d[:, i].mean().item(), 1), round(d[:, i].max().item(), 1))
           for i, n in enumerate(names)}
    out["slice total"] = (round(total.mean().item(), 1), round(total.max().item(), 1))
    return out


def tile_split(stamps: torch.Tensor) -> dict:
    """Per-phase microseconds (mean and max over tiles) from the tile
    kernels' (tiles, len(TILE_PHASES)) stamps of ns per phase."""
    from cluster_tools_tpu_torch.ops.tile_scan import TILE_PHASES

    us = stamps.double() / 1e3
    out = {n: (round(us[:, i].mean().item(), 2), round(us[:, i].max().item(), 2))
           for i, n in enumerate(TILE_PHASES)}
    out["tile total"] = (round(us.sum(1).mean().item(), 2), round(us.sum(1).max().item(), 2))
    return out


def serpentine(h, w, dev):
    from cluster_tools_tpu_torch.ops.cc import serpentine_mask

    m = torch.from_numpy(serpentine_mask((1, h, w))).to(dev)
    seeds = torch.zeros((1, h, w), dtype=torch.int32, device=dev)
    seeds[0, 0, 0] = 1
    return torch.full((1, h, w), 0.5, device=dev), seeds, m


def cluster_occupancy(n_slices: int, h: int, w: int) -> str:
    """The cluster routes' launch shape at (h, w) slices: shared memory per
    CTA and the clusters (slices) the card runs at once, from
    cudaOccupancyMaxActiveClusters, hence the waves of ``n_slices``."""
    import ctypes

    from cluster_tools_tpu_torch.ops import _build
    from cluster_tools_tpu_torch.ops.cuda_flood import CLUSTER

    parts = []
    for name, lib, fn, args in (
        ("dtws_slices", "dtws", "ctt_dtws_cluster_occupancy", (h, w, 17)),
        ("flood_slices", "flood", "ctt_flood_cluster_occupancy", (h, w)),
    ):
        smem = _build.cluster_smem(lib, *args)
        f = getattr(_build.library(lib), fn)
        f.argtypes = [ctypes.c_int] * len(args)
        f.restype = ctypes.c_int
        clusters = f(*args)
        if clusters <= 0:
            raise AssertionError(f"{fn}: no cluster fits the card (code {clusters})")
        parts.append(f"{name} {smem} B per CTA, {clusters} slices at once, "
                     f"{-(-n_slices // clusters)} waves of {n_slices}")
    return (f"cluster route at ({h}, {w}): clusters of {CLUSTER} CTAs x 1024 threads; "
            + "; ".join(parts))


def check_route(wrapper, before: dict, route: str, what: str) -> None:
    """``wrapper`` launched once since ``before``, down ``route``."""
    after = wrapper.launches_by_route
    if after[route] != before[route] + 1 or sum(after.values()) != sum(before.values()) + 1:
        raise AssertionError(f"{what}: expected one launch down the {route} route, "
                             f"counts {before} -> {after}")


def kernel_phase(vol, dev, batch: int):
    """Phase 2: both kernels against their plain versions on both routes,
    and the cluster route's rounds, times and phase split against the
    parent design's (the global route).  Returns the per-kernel records of
    the kernels line (without the launch counts)."""
    from cluster_tools_tpu_torch.ops.cuda_dtws import (
        DTWS_PHASES, DTWS_STAMPS, dtws_route, dtws_slices, dtws_slices_plain,
    )
    from cluster_tools_tpu_torch.ops.cuda_flood import (
        FLOOD_STAMPS, flood_route, flood_slices, flood_slices_plain,
    )

    zb, yb, xb = BLOCK
    blocks = [
        vol[z:z + zb, y:y + yb, x:x + xb]
        for z in range(0, vol.shape[0] - zb + 1, zb)
        for y in range(0, vol.shape[1] - yb + 1, yb)
        for x in range(0, vol.shape[2] - xb + 1, xb)
    ][:batch]
    x_main = torch.stack(blocks).contiguous()
    ones = torch.ones(x_main.shape, dtype=torch.bool, device=dev)
    ragged = vol[-29:, -226:, -226:][None].contiguous()
    rones = torch.ones(ragged.shape, dtype=torch.bool, device=dev)
    sh, ss, sm = serpentine(64, 256, dev)
    serp_x = torch.where(sm, 0.2, 0.9).view(1, 1, 64, 256).expand(1, 2, 64, 256).contiguous()
    sones = torch.ones(serp_x.shape, dtype=torch.bool, device=dev)
    from cluster_tools_tpu_torch.ops.cc import serpentine_mask

    # corridors that cross every band border of the cluster route along
    # columns (runs every 8 rows) and, transposed, along rows
    m = serpentine_mask((256, 256), 8)
    bands = {t: torch.from_numpy(np.ascontiguousarray(m.T if t else m)).to(dev) for t in (False, True)}
    big = vol[:2, :384, :384][None].contiguous()  # above the size rule of both kernels
    bones = torch.ones(big.shape, dtype=torch.bool, device=dev)
    three = vol[:3, :256, :256][None].contiguous()
    tones = torch.ones(three.shape, dtype=torch.bool, device=dev)

    def case_xmv(x):
        return x, torch.ones(x.shape, dtype=torch.bool, device=dev), torch.ones(x.shape, dtype=torch.bool, device=dev)

    cases = {
        "main": (x_main, ones, ones),
        "ragged": (ragged, rones, rones),
        "serpentine": (serp_x, sones, sones),
        "serpentine rows 256": case_xmv(torch.where(bands[False], 0.2, 0.9)[None, None].contiguous()),
        "serpentine columns 256": case_xmv(torch.where(bands[True], 0.2, 0.9)[None, None].contiguous()),
        "empty mask": (three, torch.zeros_like(tones), tones),
        "full mask": case_xmv(torch.full((1, 3, 256, 256), 0.2, device=dev)),
        "above the size rule": (big, bones, bones),
    }
    dt_err = 0.0
    main_out = None
    for name, (x, m, v) in cases.items():
        route = dtws_route(x.shape[2], x.shape[3], 17)
        before = dict(dtws_slices.launches_by_route)
        got = dtws_slices(x, m, v, threshold=THRESHOLD)
        want = dtws_slices_plain(x, m, v, threshold=THRESHOLD)
        torch.cuda.synchronize()
        check_route(dtws_slices, before, route, f"dtws_slices {name}")
        for what, g, w in zip(("labels", "roots", "hmap"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"dtws_slices {name}: {what} differs from the plain version "
                    f"(max abs err {(g.double() - w.double()).abs().max().item()})"
                )
        dt_err = max(dt_err, (got[2] - want[2]).abs().max().item())
        log(f"dtws_slices {name} {tuple(x.shape)}: equal to plain ({route} route, "
            f"{int((got[1] >= 0).sum())} maxima, {int((got[0] > 0).sum())} voxels labelled)")
        if name == "main":
            main_out = got

    flood_err = 0.0
    flood_main = size_filter_inputs(x_main, ones, ones, *main_out)
    rlab, rroots, rhmap = dtws_slices(ragged, rones, rones, threshold=THRESHOLD)

    def corridor(t):
        seeds = torch.zeros((1, 256, 256), dtype=torch.int32, device=dev)
        seeds[0, 0, 0] = 1
        return torch.full((1, 256, 256), 0.5, device=dev), seeds, bands[t][None]

    spaced = torch.zeros(big[0].numel(), dtype=torch.int32, device=dev)  # a seed every 997 voxels
    spaced[::997] = torch.arange(1, spaced[::997].numel() + 1, dtype=torch.int32, device=dev)
    flood_cases = {
        "main": flood_main,
        "ragged": size_filter_inputs(ragged, rones, rones, rlab, rroots, rhmap),
        "serpentine": (sh, ss, sm),
        "serpentine rows 256": corridor(False),
        "serpentine columns 256": corridor(True),
        "empty mask": (flood_main[0][:2], flood_main[1][:2], torch.zeros_like(flood_main[2][:2])),
        "full mask": (flood_main[0][:2], flood_main[1][:2], torch.ones_like(flood_main[2][:2])),
        "above the size rule": (big[0], spaced.view(big[0].shape), big[0] < THRESHOLD),
    }
    for name, (h, s, m) in flood_cases.items():
        route = flood_route(h.shape[1], h.shape[2])
        before = dict(flood_slices.launches_by_route)
        got = flood_slices(h, s, m)
        want = flood_slices_plain(h, s, m)
        torch.cuda.synchronize()
        check_route(flood_slices, before, route, f"flood_slices {name}")
        if not torch.equal(got, want):
            raise AssertionError(f"flood_slices {name}: differs from the plain version")
        flood_err = max(flood_err, (got - want).abs().max().item())
        if name.startswith("serpentine") and not bool((got[m] == 1).all()):
            raise AssertionError(f"flood_slices {name}: corridor not flooded to its end")
        log(f"flood_slices {name} {tuple(h.shape)}: equal to plain ({route} route)")

    # rounds, times and phase split at the workflow's batch shape: the new
    # design (the cluster route) against the parent's (the global route)
    n_sl = x_main.shape[0] * x_main.shape[1]
    if dtws_route(*x_main.shape[2:], 17) != "cluster" or flood_route(*flood_main[0].shape[1:]) != "cluster":
        raise AssertionError("the timed shapes must take the cluster route")
    rounds = {}
    for design in ("parent", "new"):
        d_rounds = torch.zeros((n_sl, 3), dtype=torch.int32, device=dev)
        f_rounds = torch.zeros((n_sl, 2), dtype=torch.int32, device=dev)
        fg = design == "parent"
        dtws_slices(x_main, ones, ones, threshold=THRESHOLD, rounds=d_rounds, force_global=fg)
        flood_slices(*flood_main, rounds=f_rounds, force_global=fg)
        torch.cuda.synchronize()
        rounds[design] = (d_rounds, f_rounds)
    (pd, pf), (nd, nf) = rounds["parent"], rounds["new"]
    if not torch.equal(pd[:, 1:], nd[:, 1:]) or not torch.equal(pf, nf):
        raise AssertionError("the cluster route's flood rounds differ from the parent design's")
    cc_diff = int((pd[:, 0] != nd[:, 0]).sum())
    log(f"rounds per slice equal to the parent design's: dtws flood alt/assign, flood_slices "
        f"alt/assign; maxima CC rounds differ in {cc_diff} of {n_sl} slices "
        f"(parent mean {pd[:, 0].float().mean().item():.2f}, new {nd[:, 0].float().mean().item():.2f})")

    ms = {("parent", "d"): [], ("new", "d"): [], ("parent", "f"): [], ("new", "f"): []}
    for design in ("parent", "new", "new", "parent"):  # in turns, on one card
        fg = design == "parent"
        ms[(design, "d")].append(cuda_ms(
            lambda: dtws_slices(x_main, ones, ones, threshold=THRESHOLD, force_global=fg), 3))
        ms[(design, "f")].append(cuda_ms(lambda: flood_slices(*flood_main, force_global=fg), 5))
    ms = {k: sum(v) / len(v) for k, v in ms.items()}
    dtws_ms, flood_ms = ms[("new", "d")], ms[("new", "f")]
    dtws_plain_ms = cuda_ms(lambda: dtws_slices_plain(x_main, ones, ones, threshold=THRESHOLD), 1)
    flood_plain_ms = cuda_ms(lambda: flood_slices_plain(*flood_main), 1)
    for design in ("parent", "new"):
        d_stamps = torch.zeros((n_sl, DTWS_STAMPS), dtype=torch.int64, device=dev)
        f_stamps = torch.zeros((n_sl, FLOOD_STAMPS), dtype=torch.int64, device=dev)
        fg = design == "parent"
        dtws_slices(x_main, ones, ones, threshold=THRESHOLD, stamps=d_stamps, force_global=fg)
        flood_slices(*flood_main, stamps=f_stamps, force_global=fg)
        torch.cuda.synchronize()
        log(f"dtws_slices {tuple(x_main.shape)} {design} design phase split, us per slice "
            f"(mean, max): {phase_split(d_stamps, DTWS_PHASES)}")
        log(f"flood_slices {tuple(flood_main[0].shape)} {design} design phase split, us per "
            f"slice (mean, max): {phase_split(f_stamps, ('set-up', 'phase 1', 'phase 2'))}")
    log(cluster_occupancy(n_sl, x_main.shape[2], x_main.shape[3]))
    vox = x_main.numel()
    d_bytes, f_bytes = 24 * vox, 16 * vox
    # operations of an exact O(1)-per-voxel kernel 2: the four gaussian
    # passes' fused multiply-adds (2 operations each; 17 taps at sigma 2) and
    # DTWS_OTHER_OPS per voxel for the rest
    d_ops = (4 * 2 * 17 + DTWS_OTHER_OPS) * vox
    d_bound = max(d_bytes / HBM_BYTES_PER_S, d_ops / FP32_OPS_PER_S) * 1e3
    dense_ms = 2 * x_main.shape[-1] * vox / FP32_OPS_PER_S * 1e3  # PRs 1-3's count
    f_bound = f_bytes / HBM_BYTES_PER_S * 1e3
    dr, fr = nd.float(), nf.float()
    log(
        f"dtws_slices {tuple(x_main.shape)}: {dtws_ms:.3f} ms/launch (cluster route; parent "
        f"design {ms[('parent', 'd')]:.3f} ms), plain {dtws_plain_ms:.1f} ms, bound {d_bound:.4f} ms "
        f"({'operations' if d_ops / FP32_OPS_PER_S > d_bytes / HBM_BYTES_PER_S else 'bytes'}; "
        f"a dense EDT's 2*W operations per voxel would take {dense_ms:.4f} ms); "
        f"rounds per slice cc/alt/assign max {dr.max(0).values.tolist()} "
        f"mean {[round(v, 2) for v in dr.mean(0).tolist()]}"
    )
    log(
        f"flood_slices {tuple(flood_main[0].shape)}: {flood_ms:.3f} ms/launch (cluster route; "
        f"parent design {ms[('parent', 'f')]:.3f} ms), plain {flood_plain_ms:.1f} ms, bound "
        f"{f_bound:.4f} ms (bytes); rounds per slice alt/assign max {fr.max(0).values.tolist()} "
        f"mean {[round(v, 2) for v in fr.mean(0).tolist()]}"
    )
    return {
        "dtws_slices": dict(
            name="dtws_slices", route="cuda",
            source="cluster_tools_tpu_torch/csrc/dtws_cluster.cuh",
            replaces="cluster_tools_tpu/ops/pallas_dtws.py:265",
            max_abs_err=dt_err, ms=dtws_ms, plain_ms=dtws_plain_ms, bound_ms=d_bound,
            bound_by="operations" if d_ops / FP32_OPS_PER_S > d_bytes / HBM_BYTES_PER_S else "bytes",
            library_ms=None,
        ),
        "flood_slices": dict(
            name="flood_slices", route="cuda",
            source="cluster_tools_tpu_torch/csrc/flood_cluster.cuh",
            replaces="cluster_tools_tpu/ops/pallas_flood.py:186",
            max_abs_err=flood_err, ms=flood_ms, plain_ms=flood_plain_ms, bound_ms=f_bound,
            bound_by="bytes", library_ms=None,
        ),
    }


def cc_kernel_phase(vol, dev, batch: int, compare=()):
    """Phase 2, kernels 4-5: each against its plain version on the card,
    kernel 5 timed in turns with the checkouts in ``compare``.  Returns the
    per-kernel records of the kernels line."""
    from cluster_tools_tpu_torch.ops.cc import serpentine_mask
    from cluster_tools_tpu_torch.ops.cuda_cc import (
        WHOLE_SLICE_MAX, cc_route, cc_slices, cc_slices_plain, cc_tiles, cc_tiles_plain,
        default_tile,
    )
    from cluster_tools_tpu_torch.ops.tile_scan import TILE_PHASES

    def blocks_of(block, corners):
        zb, yb, xb = block
        return torch.cat([
            vol[z:z + zb, y:y + yb, x:x + xb] < THRESHOLD for z, y, x in corners
        ]).contiguous()

    zb, yb, xb = BLOCK
    corners = [
        (z, y, x)
        for z in range(0, vol.shape[0] - zb + 1, zb)
        for y in range(0, vol.shape[1] - yb + 1, yb)
        for x in range(0, vol.shape[2] - xb + 1, xb)
    ][:batch]
    main = blocks_of(BLOCK, corners)
    wz, wy, wx = BLOCK_WIDE
    z_last, y_last, x_last = (max(s - b, 0) for s, b in zip(vol.shape, BLOCK_WIDE))
    wide_corners = [
        (z, y, x)
        for z in sorted({min(k * wz, z_last) for k in range(3)} | {z_last})
        for y, x in ((0, 0), (y_last, x_last))
    ][:batch]
    wide = blocks_of(BLOCK_WIDE, wide_corners)
    ragged = (vol[-29:, -226:, -226:] < THRESHOLD).contiguous()
    cases = {
        "main": (main, zb),
        "ragged": (ragged, ragged.shape[0]),
        "serpentine": (torch.from_numpy(serpentine_mask((2, yb, xb))).to(dev), 2),
        "wide": (wide, wz),
        # the complement (vol >= 0.5, the membrane): many small components
        "membrane": (~main, zb),
        "membrane wide": (~wide, wz),
    }
    cases["above the size rule"] = ((vol[:2, :700, :700] < THRESHOLD).contiguous(), 2)
    for name, (m, depth) in cases.items():
        runs = [("cc_tiles", cc_tiles, cc_tiles_plain, (default_tile(*m.shape[1:]),), False)]
        if m.shape[1] * m.shape[2] <= WHOLE_SLICE_MAX:
            runs[:0] = [("cc_slices", cc_slices, cc_slices_plain, (), False),
                        ("cc_slices", cc_slices, cc_slices_plain, (), True)]
        elif name == "above the size rule":
            runs = [("cc_slices", cc_slices, cc_slices_plain, (), False)]
        for kname, kernel, plain, extra, parent in runs:
            route = ""
            if kname == "cc_slices":
                route = "global" if parent else cc_route(*m.shape[1:])
                before = dict(cc_slices.launches_by_route)
                got = cc_slices(m, depth=depth, force_global=parent)
                check_route(cc_slices, before, route, f"cc_slices {name}")
                route = f" ({route} route)"
            else:
                got = kernel(m, *extra, depth=depth)
            want = plain(m, *extra, depth)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{kname} {name}{route}: labels differ from the plain version "
                                     f"({int((got != want).sum())} voxels)")
            pieces = int(torch.unique(got[got >= 0]).numel())
            log(f"{kname} {name} {tuple(m.shape)}{route}: equal to plain "
                f"({pieces} in-{'slice' if kname == 'cc_slices' else 'tile'} components)")
    if cc_route(*main.shape[1:]) != "cluster":
        raise AssertionError("the workflow's slices must take kernel 4's cluster route")

    # kernel 4 at the workflow's batch: the cluster route and the parent
    # design (the global route) in turns: parent, new, new, parent
    n_sl = main.shape[0]
    rounds = {d: torch.zeros(n_sl, dtype=torch.int32, device=dev) for d in ("parent", "new")}
    times = {"parent": [], "new": []}
    for design in ("parent", "new", "new", "parent"):
        times[design].append(cuda_ms(lambda: cc_slices(
            main, depth=zb, rounds=rounds[design], force_global=design == "parent"), 3))
    ms, parent_ms = (sum(times[d]) / 2 for d in ("new", "parent"))
    plain_ms = cuda_ms(lambda: cc_slices_plain(main, zb), 1)
    bound = 5 * main.numel() / HBM_BYTES_PER_S * 1e3  # bool mask in, int32 labels out
    rn, rp = (rounds[d].float() for d in ("new", "parent"))
    log(f"cc_slices {tuple(main.shape)}: cluster route {ms:.3f} ms/launch "
        f"({', '.join(f'{t:.3f}' for t in times['new'])}), parent design (global route) "
        f"{parent_ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times['parent'])}), plain "
        f"{plain_ms:.1f} ms, bound {bound:.4f} ms (bytes); rounds per slice mean/max cluster "
        f"{rn.mean().item():.2f}/{int(rn.max())}, parent {rp.mean().item():.2f}/{int(rp.max())}")
    log(cc_occupancy(n_sl, *main.shape[1:]))
    records = {"cc_slices": dict(
        name="cc_slices", route="cuda", source="cluster_tools_tpu_torch/csrc/cc_cluster.cuh",
        replaces="cluster_tools_tpu/ops/pallas_cc.py:89", max_abs_err=0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None,
    )}
    # kernel 5 at the second components run's batch, in turns with the
    # checkouts in ``compare`` (``in_turns``): labels equal
    tile = default_tile(wy, wx)
    n_tiles = wide.shape[0] * -(-wy // tile[0]) * -(-wx // tile[1])
    t_rounds = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    labels = cc_tiles(wide, tile, depth=wz, rounds=t_rounds)
    name = f"cc_tiles {tuple(wide.shape)}"
    times, results = in_turns(
        compare, {name: ("cc_tiles", (wide, tile), {"depth": wz}, n_tiles, 3)},
        lambda _: cuda_ms(lambda: cc_tiles(wide, tile, depth=wz), 3))
    t = times[name]
    ms = sum(t["new"]) / 2
    plain_ms = cuda_ms(lambda: cc_tiles_plain(wide, tile, wz), 1)
    bound = 5 * wide.numel() / HBM_BYTES_PER_S * 1e3
    r = t_rounds.float()
    log(f"{name} tile {tile}: {ms:.4f} ms/launch ({', '.join(f'{x:.4f}' for x in t['new'])})"
        f"{turns_text(t)}, plain {plain_ms:.1f} ms, bound {bound:.4f} ms (bytes); rounds per "
        f"tile mean {r.mean().item():.2f} max {int(r.max())}")
    st = torch.zeros((n_tiles, len(TILE_PHASES)), dtype=torch.int64, device=dev)
    cc_tiles(wide, tile, depth=wz, stamps=st)
    log(f"{name}: us per tile per phase (mean, max): {tile_split(st)}")
    for design, res in results.items():
        other, other_rounds = res[name]
        if not torch.equal(other, labels.cpu()):
            raise AssertionError(f"{name}: labels differ from {design}'s "
                                 f"({int((other != labels.cpu()).sum())} voxels)")
        ro = other_rounds.float()
        log(f"{name}: labels equal to {design}'s; its rounds per tile mean "
            f"{ro.mean().item():.2f} max {int(ro.max())}")
    records["cc_tiles"] = dict(
        name="cc_tiles", route="cuda", source="cluster_tools_tpu_torch/csrc/cc.cuh",
        replaces="cluster_tools_tpu/ops/pallas_cc.py:143", max_abs_err=0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None,
    )
    return records


def cc_occupancy(n_slices: int, h: int, w: int) -> str:
    """Kernel 4's cluster route at (h, w) slices: shared memory per CTA and
    the clusters the card runs at once (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from cluster_tools_tpu_torch.ops import _build

    smem = _build.cluster_smem("cc", h, w)
    f = _build.library("cc").ctt_cc_cluster_occupancy
    f.argtypes = [ctypes.c_int] * 2
    f.restype = ctypes.c_int
    clusters = f(h, w)
    if clusters <= 0:
        raise AssertionError(f"ctt_cc_cluster_occupancy: no cluster fits the card (code {clusters})")
    return (f"cc_slices cluster route at ({h}, {w}): clusters of 8 CTAs, {smem} B "
            f"per CTA, {clusters} slices at once, {-(-n_slices // clusters)} waves of {n_slices}")


def check_partition(out: np.ndarray, ref: np.ndarray, n_ref: int) -> int:
    """``out`` must label ``ref``'s components (scipy labels 1..n_ref) with
    consecutive ids 1..n and the same partition, in O(voxels): map each
    output id to the scipy id of one of its voxels, then the map must explain
    every voxel and be a bijection onto 1..n_ref."""
    ids = out.reshape(-1).view(np.int64)
    r = ref.reshape(-1).astype(np.int64)
    if not np.array_equal(ids == 0, r == 0):
        raise AssertionError("labelled voxels differ from the foreground")
    n = int(ids.max())
    to_ref = np.zeros(n + 1, dtype=np.int64)
    to_ref[ids] = r
    if not np.array_equal(to_ref[ids], r):
        raise AssertionError("an output id covers two scipy components")
    if (np.bincount(ids, minlength=n + 1)[1:] == 0).any():
        raise AssertionError("output ids are not consecutive")
    used = np.bincount(to_ref[1:], minlength=n_ref + 1)
    if used[0] or (used[1:] != 1).any():
        raise AssertionError("a scipy component is split or missing")
    return n


def components_phase(path: str, work: str, block, card: str, fg, ref, n_ref: int, kernel):
    """Phase 4: ``ThresholdedComponentsWorkflow`` end to end on the card;
    ``kernel`` (the wrapper of the CC kernel this block shape routes to)
    must be launched, the output must have scipy's partition of ``fg``, and
    each block's local labels must equal scipy's labels of the block."""
    from scipy import ndimage

    from cluster_tools_tpu_torch import ThresholdedComponentsWorkflow, build
    from cluster_tools_tpu_torch.ops.cuda_cc import cc_slices, cc_tiles
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    tag = "x".join(str(b) for b in block)
    config_dir = os.path.join(work, f"configs_cc_{tag}")
    cfg.write_global_config(config_dir, {
        "block_shape": list(block), "target": "cuda", "device": "cuda",
        "max_jobs": min(8, os.cpu_count() or 1),
    })
    cfg.write_config(config_dir, "block_components", {
        "threshold": THRESHOLD, "threshold_mode": "less", "sigma": 0.0, "connectivity": 1,
    })
    wf = ThresholdedComponentsWorkflow(
        os.path.join(work, f"tmp_cc_{tag}"), config_dir, input_path=path, input_key="raw",
        output_path=path, output_key=f"cc_{tag}",
    )
    reset_counts(cc_slices, cc_tiles)
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("components workflow build failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cc_slices": cc_slices.launches, "cc_tiles": cc_tiles.launches}
    if launches[kernel] == 0:
        raise AssertionError(f"the components run at blocks {block} never launched {kernel}")
    if cc_slices.launches_by_route["global"]:
        raise AssertionError(f"components {tag}: kernel 4 took the global route "
                             f"{cc_slices.launches_by_route}")
    vox = int(np.prod(ref.shape))
    log(f"components {tag}: {ref.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on {card}; "
        f"launches {launches}, cc_slices by route {cc_slices.launches_by_route}")
    # per task, upstream first: seconds, and the cuda target's stage sums
    chain, node = [], wf.requires()[0]
    while node is not None:
        chain.append(node)
        node = node.requires()[0] if node.requires() else None
    for node in reversed(chain):
        status = node.output().read()
        seconds = status.get("runtime_s", sum(status.get("block_runtimes", [])))
        stages = {t["label"]: round(t["seconds"], 3) for t in status.get("timings", [])
                  if t["label"].startswith("stage_") or t["label"] == "blocks_total"}
        log(f"components {tag} task {node.identifier}: {seconds:.3f} s {stages}")
    t0 = time.perf_counter()
    out = file_reader(path, "r")[f"cc_{tag}"][:]
    if out.shape != ref.shape or out.dtype != np.uint64:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    n = check_partition(out, ref, n_ref)
    del out
    log(f"components {tag}: {n} components, partition equal to scipy's, ids 1..{n} "
        f"(checked in {time.perf_counter() - t0:.1f} s)")
    # block-local labels (before the merge): scipy numbers components in
    # raster order of their first voxel, the port in minimal-flat-index
    # order, so every block must equal scipy's labeling of the block exactly
    t0 = time.perf_counter()
    local = file_reader(path, "r")[f"cc_{tag}_blocks"]
    blocking = Blocking(ref.shape, block)
    n_local = 0
    for bid in range(blocking.n_blocks):
        bb = blocking.block(bid).slicing
        want, k = ndimage.label(fg[bb])
        if not np.array_equal(local[bb], want):
            raise AssertionError(f"components {tag}: block {bid} differs from scipy's labels")
        n_local += k
    log(f"components {tag}: all {blocking.n_blocks} blocks' local labels equal scipy's "
        f"({n_local} block-local components, checked in {time.perf_counter() - t0:.1f} s)")
    return launches, wall, vox / wall


def workflow_phase(vol_np, path: str, work: str, card: str):
    """Phase 3: the workflow end to end on the card, then its checks."""
    from cluster_tools_tpu_torch import WatershedWorkflow, build
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    config_dir = os.path.join(work, "configs")
    cfg.write_global_config(
        config_dir, {"block_shape": list(BLOCK), "target": "cuda", "device": "cuda"}
    )
    cfg.write_config(config_dir, "watershed", WatershedTask.default_task_config())
    wf = WatershedWorkflow(
        os.path.join(work, "tmp"), config_dir, input_path=path, input_key="raw",
        output_path=path, output_key="ws",
    )
    reset_counts(dtws_slices, flood_slices)
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("workflow build failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dtws_slices": dtws_slices.launches, "flood_slices": flood_slices.launches}
    for name, wrapper in (("dtws_slices", dtws_slices), ("flood_slices", flood_slices)):
        if wrapper.launches == 0:
            raise AssertionError(f"the workflow never launched {name}")
        if wrapper.launches_by_route["cluster"] != wrapper.launches:
            raise AssertionError(f"{name}: launches off the cluster route {wrapper.launches_by_route}")
    vox = int(np.prod(vol_np.shape))
    log(f"workflow: {vol_np.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on {card}; "
        f"launches {launches}, all down the cluster route")
    stages = {t["label"]: t["seconds"] for t in wf.output().read()["timings"]
              if t["label"].startswith("stage_")}
    log(f"workflow stages (summed over batches, s): {stages}")

    out = file_reader(path, "r")["ws"][:]
    if out.shape != vol_np.shape or out.dtype != np.uint64:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    fg = vol_np < THRESHOLD
    if (out[~fg] != 0).any():
        raise AssertionError("labels outside the foreground")
    blocking = Blocking(vol_np.shape, BLOCK)
    unit = int(np.prod(BLOCK))
    for bid in range(blocking.n_blocks):
        ids = out[blocking.block(bid).slicing]
        ids = ids[ids > 0]
        if ids.size and (ids.min() <= bid * unit or ids.max() > (bid + 1) * unit):
            raise AssertionError(f"block {bid}: ids outside its offset range")
    log(f"output: foreground labelled {float((out[fg] > 0).mean()):.4f}, "
        f"{len(np.unique(out)) - 1} segments, ids unique per block")

    task = wf.requires()[0]
    config = {**task.global_config(), **task.get_task_config()}
    check_ids = [0, blocking.n_blocks - 1]  # an interior-corner block and the ragged last one
    with plain_kernels():
        _, blocks, labels = task.compute_batch(
            task.read_batch(check_ids, blocking, config), blocking, config
        )
    torch.cuda.synchronize()
    for bid, bh, lab in zip(check_ids, blocks, labels):
        lab = lab[bh.inner_local.slicing]
        lab = np.where(lab > 0, lab + np.uint64(bid * unit), 0).astype(np.uint64)
        if not np.array_equal(lab, out[bh.inner.slicing]):
            raise AssertionError(f"block {bid}: plain re-run differs from the workflow")
    log(f"blocks {check_ids} re-run through the plain versions: byte-identical")
    return launches, wall, vox / wall


def halo_block(vol, corner, dev):
    """The watershed-from-seeds inputs of the (36, 272, 272) halo'd block at
    ``corner``: the boundary map smoothed by the task's 3d gaussian (sigma
    2) and the components of ``vol < SEED_THRESHOLD`` inside it as seeds."""
    from cluster_tools_tpu_torch.ops.cc import connected_components
    from cluster_tools_tpu_torch.ops.filters import gaussian

    shape = tuple(b + 2 * h for b, h in zip(BLOCK, HALO))
    z, y, x = corner
    blk = vol[z:z + shape[0], y:y + shape[1], x:x + shape[2]]
    seeds, _ = connected_components((blk < SEED_THRESHOLD)[None])
    return gaussian(blk, 2.0), seeds[0], torch.ones(shape, dtype=torch.bool, device=dev)


def check_flood_rounds(name: str, args, stats: dict) -> tuple:
    """The kernel's rounds of each phase (``stats``) must be those of its
    schedule in plain PyTorch (``flood_volume_scan``, the JAX package's
    counts) on the same inputs ``(h, s, m, warm)``.  Returns them."""
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_volume_scan

    got = (stats["flood_alt_iters"], stats["flood_assign_iters"])
    want = flood_volume_scan(*args[:3], warm=args[3])[2]
    if got != want:
        raise AssertionError(f"flood_volume {name}: rounds alt/assign {got}, the sequential "
                             f"sweeps' {want}")
    log(f"flood_volume {name}: equal to plain, rounds alt/assign {got[0]}/{got[1]} equal to "
        f"the sequential sweeps'")
    return got


# Run in a child process from the root of a checkout: calls that
# checkout's kernel wrappers on the inputs saved in argv[1], as ``cuda_ms``
# times them (one call that also fills the rounds, then ``reps`` calls
# between CUDA events) after 0.25 s of untimed calls, each waited for, that
# bring the card's clocks up from the child's idle start; saves each output
# and its
# rounds to argv[2] and prints the ms per call of each input as one JSON
# line.
OTHER_TIMER = r"""
import json, sys, time, torch
from cluster_tools_tpu_torch.ops import cuda_cc, cuda_flood
dev = lambda t: t.cuda() if isinstance(t, torch.Tensor) else t
ms, saved = {}, {}
for name, (fn, args, kw, n_rounds, reps) in torch.load(sys.argv[1]).items():
    f = getattr(cuda_cc if fn.startswith("cc_") else cuda_flood, fn)
    args = tuple(dev(t) for t in args)
    kw = {k: dev(v) for k, v in kw.items()}
    if n_rounds is None:
        stats = {}
        y = f(*args, **kw, stats=stats)
        rounds = (stats["flood_alt_iters"], stats["flood_assign_iters"])
    else:
        r = torch.zeros(n_rounds, dtype=torch.int32, device="cuda")
        y = f(*args, **kw, rounds=r)
        rounds = r
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.25:
        f(*args, **kw)
        torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        f(*args, **kw)
    b.record()
    torch.cuda.synchronize()
    ms[name] = a.elapsed_time(b) / reps
    saved[name] = (y.cpu(), rounds.cpu() if isinstance(rounds, torch.Tensor) else rounds)
torch.save(saved, sys.argv[2])
print(json.dumps(ms))
"""


def other_kernels(checkout: str, calls: dict):
    """``OTHER_TIMER`` on another checkout (the parent design, say):
    ``calls`` maps a name to (wrapper name, args, kwargs, rounds entries or
    None for the 3d flood's stats, reps).  Returns the ms per call and the
    (output, rounds) of each name."""
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        path, out_path = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "outputs.pt")
        torch.save({k: (fn, tuple(cpu(t) for t in args), {n: cpu(v) for n, v in kw.items()},
                        n_rounds, reps)
                    for k, (fn, args, kw, n_rounds, reps) in calls.items()}, path)
        out = subprocess.run([sys.executable, "-c", OTHER_TIMER, path, out_path], cwd=checkout,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise AssertionError(f"{checkout}: kernels failed:\n{out.stderr[-4000:]}")
        return json.loads(out.stdout.strip().splitlines()[-1]), torch.load(out_path)


HERE = os.path.dirname(os.path.abspath(__file__))
THIS_TREE = "this tree in a child"


def in_turns(compare, calls: dict, new_ms) -> dict:
    """Time ``calls`` in turns: each checkout in ``compare`` and this tree
    in child processes, this tree in this process twice, the children again
    in reverse (parent, this tree's child, new, new, this tree's child,
    parent).  ``new_ms(name)`` times this tree's call in this process (the
    kernels line's ms); the children, timed alike, compare the designs.
    Returns each name's times per design and the (output, rounds) of each
    child's first run."""
    children = [*compare, THIS_TREE] if compare else []
    times = {name: {d: [] for d in ["new", *children]} for name in calls}
    results = {}
    for design in [*children, "new", "new", *children[::-1]]:
        if design == "new":
            for name in calls:
                times[name]["new"].append(new_ms(name))
            continue
        ms, res = other_kernels(HERE if design == THIS_TREE else design, calls)
        results.setdefault(design, res)
        for name, t in ms.items():
            times[name][design].append(t)
    return times, results


def turns_text(t: dict) -> str:
    """Mean and single times of every design but the new one."""
    return "".join(f"; {d}: {sum(v) / len(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)})"
                   for d, v in t.items() if d != "new")


def flood3d_kernel_phase(vol, dev, compare=()):
    """Phase 5: kernel 3 and the 3d flood against their plain versions on
    the card, the flood's rounds against its schedule in plain PyTorch, and
    its times (with those of the checkouts in ``compare``, the parent
    commit's say).  Returns their records of the kernels line (without the
    launch counts)."""
    from cluster_tools_tpu_torch.ops.cc import serpentine_mask
    from cluster_tools_tpu_torch.ops.cuda_flood import (
        FLOOD3D_LINES, FLOOD3D_PHASES, flood_tiles_warm, flood_tiles_warm_plain,
        flood_tiles_warm_scan, flood_volume, flood_volume_plain,
    )
    from cluster_tools_tpu_torch.ops.tile_scan import TILE_PHASES

    def flood_tiles_warm_rounds(h, s, m, tile):
        n_tiles = h.shape[0] * -(-h.shape[1] // tile[0]) * -(-h.shape[2] // tile[1])
        rounds = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        return flood_tiles_warm(h, s, m, tile, rounds=rounds), rounds
    from cluster_tools_tpu_torch.ops.watershed import resolve_flood_tile

    os.environ["CTT_FLOOD_TILE"] = FLOOD_TILE
    shape = tuple(b + 2 * h for b, h in zip(BLOCK, HALO))
    tile = resolve_flood_tile(shape)[1:]
    del os.environ["CTT_FLOOD_TILE"]
    far = tuple(v - b for v, b in zip(vol.shape, shape))  # the far corner's halo'd block
    blocks = [halo_block(vol, c, dev) for c in ((0, 0, 0), far)]
    h2, s2, m2 = (torch.stack(t) for t in zip(*blocks))
    # a serpentine corridor in every tile, each with a seed at its start:
    # Theta(th * tw) in-tile steps and a bend every other row
    grid = (BLOCK[1] // tile[0], BLOCK[2] // tile[1])
    serp = torch.from_numpy(np.tile(serpentine_mask(tile), (2,) + grid)).to(dev)
    serp_seeds = torch.zeros(serp.shape, dtype=torch.int32, device=dev)
    serp_seeds[:, ::tile[0], ::tile[1]] = torch.arange(
        1, 2 * grid[0] * grid[1] + 1, dtype=torch.int32, device=dev).view((2,) + grid)
    zb, yb, xb = BLOCK
    div = vol[:zb, :yb, :xb].contiguous()
    div_seeds = halo_block(vol, (0, 0, 0), dev)[1][:zb, :yb, :xb].contiguous()
    cases = {
        f"halo'd block {shape}": blocks[0],
        f"divisible {tuple(div.shape)}": (div, div_seeds, torch.ones_like(div, dtype=torch.bool)),
        f"serpentine {tuple(serp.shape)}": (torch.full(serp.shape, 0.5, device=dev), serp_seeds, serp),
    }
    for name, (h, s, m) in cases.items():
        got, got_rounds = flood_tiles_warm_rounds(h, s, m, tile)
        want = flood_tiles_warm_plain(h, s, m, tile)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"flood_tiles_warm {name}: differs from the plain version "
                                 f"({int((got != want).sum())} voxels)")
        want_rounds = flood_tiles_warm_scan(h, s, m, tile)[1]
        if not torch.equal(got_rounds, want_rounds):
            raise AssertionError(f"flood_tiles_warm {name}: rounds per tile differ from the "
                                 f"schedule's ({int((got_rounds != want_rounds).sum())} tiles)")
        log(f"flood_tiles_warm {name} tile {tile}: equal to plain "
            f"({int((got < 1e38).sum())} voxels reached in their tiles), rounds per tile equal "
            f"to the schedule's (max {int(got_rounds.max())})")

    hw = shape[1:]
    warm2 = flood_tiles_warm(h2.view((-1,) + hw), s2.view((-1,) + hw), m2.view((-1,) + hw),
                             tile).view(h2.shape)
    zx = torch.zeros((1, shape[0], 3, shape[2]), dtype=torch.bool, device=dev)
    zx[0, :, 1, :] = torch.from_numpy(serpentine_mask(zx.shape[1:2] + zx.shape[3:])).to(dev)
    zx_seeds = torch.zeros(zx.shape, dtype=torch.int32, device=dev)
    zx_seeds[0, 0, 1, 0] = 1
    flood_cases = {
        "two halo'd blocks cold": (h2, s2, m2, None),
        "two halo'd blocks warm": (h2, s2, m2, warm2),
        f"serpentine (z, x) {tuple(zx.shape)}": (torch.full(zx.shape, 0.5, device=dev), zx_seeds, zx, None),
    }
    for name, (h, s, m, w) in flood_cases.items():
        stats = {}
        got = flood_volume(h, s, m, warm=w, stats=stats)
        want = flood_volume_plain(h, s, m, warm=w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"flood_volume {name}: differs from the plain version "
                                 f"({int((got != want).sum())} voxels)")
        if name.startswith("serpentine") and not bool((got[m] == 1).all()):
            raise AssertionError("flood_volume serpentine: corridor not flooded to its end")
        check_flood_rounds(name, (h, s, m, w), stats)

    # times at one halo'd block (the seeded workflow's call, warm and cold)
    # and at the 3d watershed's batch of 8 halo'd blocks (cold), the parent
    # design's in turns where a checkout of it is given
    h1, s1, m1 = (t[None] for t in blocks[0])
    hs, ss, ms = (t.view((-1,) + hw) for t in (h1, s1, m1))
    warm1, t_rounds = flood_tiles_warm_rounds(hs, ss, ms, tile)
    warm1 = warm1.view(h1.shape)
    k3_plain_ms = cuda_ms(lambda: flood_tiles_warm_plain(hs, ss, ms, tile), 1)
    z_last, y_last, x_last = (v - b for v, b in zip(vol.shape, shape))
    corners8 = [(z, y, x) for z in (0, z_last) for y in (0, y_last) for x in (0, x_last)]
    h8, s8, m8 = (torch.stack(t) for t in zip(*(halo_block(vol, c, dev) for c in corners8)))
    timed = {
        f"{tuple(h1.shape)} warm": (h1, s1, m1, warm1),
        f"{tuple(h1.shape)} cold": (h1, s1, m1, None),
        f"{tuple(h8.shape)} cold": (h8, s8, m8, None),
    }
    rounds = {}
    for name, args in timed.items():
        stats = {}
        got = flood_volume(*args[:3], warm=args[3], stats=stats)
        if not torch.equal(got, flood_volume_plain(*args[:3], warm=args[3])):
            raise AssertionError(f"flood_volume {name}: differs from the plain version")
        rounds[name] = check_flood_rounds(name, args, stats)
    # kernel 3 and the 3d flood in turns with the checkouts in ``compare``
    k3 = f"flood_tiles_warm {tuple(hs.shape)}"
    calls = {name: ("flood_volume", args[:3], {"warm": args[3]}, None, 3)
             for name, args in timed.items()}
    calls[k3] = ("flood_tiles_warm", (hs, ss, ms, tile), {}, t_rounds.numel(), 5)

    def new_ms(name):
        if name == k3:
            return cuda_ms(lambda: flood_tiles_warm(hs, ss, ms, tile), 5)
        h, s, m, w = timed[name]
        return cuda_ms(lambda: flood_volume(h, s, m, warm=w), 3)

    times, results = in_turns(compare, calls, new_ms)
    for design, res in results.items():
        for name in timed:
            if tuple(res[name][1]) != rounds[name]:
                raise AssertionError(f"flood_volume {name}: rounds {rounds[name]} differ from "
                                     f"{design}'s {tuple(res[name][1])}")
        log(f"flood_volume: rounds equal to {design}'s on every timed input")
        other, other_rounds = res[k3]
        if not torch.equal(other, warm1.view(hs.shape).cpu()):
            raise AssertionError(f"flood_tiles_warm: altitudes differ from {design}'s")
        if not torch.equal(other_rounds, t_rounds.cpu()):
            raise AssertionError(f"flood_tiles_warm: rounds per tile differ from {design}'s "
                                 f"({int((other_rounds != t_rounds.cpu()).sum())} tiles)")
        log(f"flood_tiles_warm {tuple(hs.shape)}: altitudes and rounds per tile equal to "
            f"{design}'s")
    times_k3 = times.pop(k3)
    k3_ms = sum(times_k3["new"]) / 2
    fv_plain_ms = cuda_ms(lambda: flood_volume_plain(h1, s1, m1, warm=warm1), 1)
    vox = h1.numel()
    k3_bound = 13 * vox / HBM_BYTES_PER_S * 1e3  # f32 h, i32 seeds, byte mask in; f32 out
    tr = t_rounds.float()
    log(f"flood_tiles_warm {tuple(hs.shape)} tile {tile}: {k3_ms:.4f} ms/launch "
        f"({', '.join(f'{x:.4f}' for x in times_k3['new'])}){turns_text(times_k3)}, plain "
        f"{k3_plain_ms:.1f} ms, bound {k3_bound:.4f} ms (bytes); rounds per tile max "
        f"{int(tr.max())} mean {tr.mean().item():.2f}")
    st = torch.zeros((t_rounds.numel(), len(TILE_PHASES)), dtype=torch.int64, device=dev)
    flood_tiles_warm(hs, ss, ms, tile, stamps=st)
    log(f"flood_tiles_warm {tuple(hs.shape)}: us per tile per phase (mean, max): "
        f"{tile_split(st)}")
    stamps = torch.zeros((1, len(FLOOD3D_PHASES) + len(FLOOD3D_LINES)), dtype=torch.int64,
                         device=dev)
    for name, t in times.items():
        h, s, m, w = timed[name]
        # f32 h, i32 seeds, byte mask (and f32 warm) in; i32 labels out
        bound = (17 if w is not None else 13) * h.numel() / HBM_BYTES_PER_S * 1e3
        log(f"flood_volume {name}: {sum(t['new']) / 2:.3f} ms/launch "
            f"({', '.join(f'{x:.3f}' for x in t['new'])}){turns_text(t)}; bound {bound:.4f} ms "
            f"(bytes)")
        flood_volume(h, s, m, warm=w, stamps=stamps)
        st = stamps[0].tolist()
        split = {p: round(v / 1e3, 1) for p, v in zip(FLOOD3D_PHASES, st)}
        lines = dict(zip(FLOOD3D_LINES, st[len(FLOOD3D_PHASES):]))
        log(f"flood_volume {name}: us per phase {split}; lines swept in all rounds {lines}")
    fv_ms = sum(times[f"{tuple(h1.shape)} warm"]["new"]) / 2
    fv_bound = 17 * vox / HBM_BYTES_PER_S * 1e3  # the same plus f32 warm in; i32 labels out
    log(f"flood_volume {tuple(h1.shape)} warm: plain {fv_plain_ms:.1f} ms")
    records = {
        "flood_tiles_warm": dict(
            name="flood_tiles_warm", route="cuda",
            source="cluster_tools_tpu_torch/csrc/flood3d.cuh",
            replaces="cluster_tools_tpu/ops/pallas_flood.py:242",
            max_abs_err=0, ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound,
            bound_by="bytes", library_ms=None,
        ),
        "flood_volume": dict(
            name="flood_volume", route="cuda",
            source="cluster_tools_tpu_torch/csrc/flood3d.cuh",
            replaces="cluster_tools_tpu/ops/watershed.py:249",
            max_abs_err=0, ms=fv_ms, plain_ms=fv_plain_ms, bound_ms=fv_bound,
            bound_by="bytes", library_ms=None,
        ),
    }
    return records


def task_seconds(wf, tag: str) -> None:
    """Seconds per task of a workflow run, upstream first, with the cuda
    target's stage sums."""
    chain, todo = [], list(wf.requires())
    while todo:
        node = todo.pop()
        chain.append(node)
        todo.extend(node.requires())
    for node in reversed(chain):
        if not hasattr(node, "get_shape") and not hasattr(node, "run_impl"):
            continue
        status = node.output().read()
        seconds = status.get("runtime_s", sum(status.get("block_runtimes", [])))
        stages = {t["label"]: round(t["seconds"], 3) for t in status.get("timings", [])
                  if t["label"].startswith("stage_") or t["label"] == "blocks_total"}
        log(f"{tag} task {node.identifier}: {seconds:.3f} s {stages}")


def reset_counts(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0
        for route in getattr(w, "launches_by_route", {}):
            w.launches_by_route[route] = 0
        for name in ("alt_rounds", "assign_rounds"):
            if hasattr(w, name):
                setattr(w, name, 0)


def seeds_phase(vol_np, path: str, work: str, card: str):
    """Phase 6: ``ThresholdAndWatershedWorkflow`` end to end on the card with
    the flood tile pinned, then its checks: seed ids kept, volume covered,
    two blocks equal to their plain re-run, an unpinned re-run of the
    watershed task equal byte for byte."""
    from cluster_tools_tpu_torch import ThresholdAndWatershedWorkflow, build
    from cluster_tools_tpu_torch.ops.cuda_cc import cc_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_tiles_warm, flood_volume
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks.watershed import WatershedFromSeedsTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    config_dir = os.path.join(work, "configs_seeds")
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": "cuda",
        "max_jobs": min(8, os.cpu_count() or 1),
    })
    cfg.write_config(config_dir, "block_components", {
        "threshold": SEED_THRESHOLD, "threshold_mode": "less", "sigma": 0.0, "connectivity": 1,
    })
    cfg.write_config(config_dir, "watershed_from_seeds", WatershedFromSeedsTask.default_task_config())
    wf = ThresholdAndWatershedWorkflow(
        os.path.join(work, "tmp_seeds"), config_dir, input_path=path, input_key="raw",
        output_path=path, output_key="seg",
    )
    os.environ["CTT_FLOOD_TILE"] = FLOOD_TILE
    reset_counts(cc_slices, flood_tiles_warm, flood_volume)
    t0 = time.perf_counter()
    try:
        if not build([wf]):
            raise AssertionError("seeds workflow build failed")
        torch.cuda.synchronize()
    finally:
        del os.environ["CTT_FLOOD_TILE"]
    wall = time.perf_counter() - t0
    launches = {"cc_slices": cc_slices.launches, "flood_tiles_warm": flood_tiles_warm.launches,
                "flood_volume": flood_volume.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the seeds workflow never launched {name}")
    warm_rounds = (flood_volume.alt_rounds / flood_volume.launches,
                   flood_volume.assign_rounds / flood_volume.launches)
    if cc_slices.launches_by_route["global"]:
        raise AssertionError(f"seeds workflow: kernel 4 took the global route "
                             f"{cc_slices.launches_by_route}")
    vox = int(np.prod(vol_np.shape))
    log(f"seeds workflow: {vol_np.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on {card}; "
        f"launches {launches}, cc_slices by route {cc_slices.launches_by_route}; flood rounds "
        f"per block alt/assign (warm) {warm_rounds[0]:.2f}/{warm_rounds[1]:.2f}")
    task_seconds(wf, "seeds workflow")

    f = file_reader(path, "r")
    seeds, seg = f["seg_seeds"][:], f["seg"][:]
    if seg.shape != vol_np.shape or seg.dtype != np.uint64:
        raise AssertionError(f"output {seg.shape} {seg.dtype}")
    has = seeds > 0
    if not np.array_equal(seg[has], seeds[has]):
        raise AssertionError("a seed voxel lost its id")
    n = int(seeds.max())
    if int(seg.max()) != n or (np.bincount(seg.reshape(-1).view(np.int64), minlength=n + 1)[1:] == 0).any() \
            or (np.bincount(seeds.reshape(-1).view(np.int64), minlength=n + 1)[1:] == 0).any():
        raise AssertionError("the output's ids are not the seed ids")
    if not (seg > 0).all():
        raise AssertionError("the unmasked flood left voxels unlabelled")
    log(f"seeds workflow output: {n} seed ids, all kept, {float(has.mean()):.4f} of the voxels seeds, "
        f"volume covered")

    task = wf.requires()[0]
    config = {**task.global_config(), **task.get_task_config()}
    blocking = Blocking(vol_np.shape, BLOCK)
    check_ids = [0, blocking.n_blocks - 1]
    plain = WatershedFromSeedsTask(
        task.tmp_folder, config_dir, input_path=path, input_key="raw", seeds_path=path,
        seeds_key="seg_seeds", output_path=path, output_key="seg_plain",
    )
    plain.prepare(blocking, config)
    os.environ["CTT_FLOOD_TILE"] = FLOOD_TILE
    try:
        with plain_kernels():
            for bid in check_ids:
                plain.process_block(bid, blocking, config)
    finally:
        del os.environ["CTT_FLOOD_TILE"]
    torch.cuda.synchronize()
    for bid in check_ids:
        bb = blocking.block(bid).slicing
        if not np.array_equal(f["seg_plain"][bb], seg[bb]):
            raise AssertionError(f"seeds block {bid}: plain re-run differs from the workflow")
    log(f"seeds blocks {check_ids} re-run through the plain versions: byte-identical")

    cold = WatershedFromSeedsTask(
        os.path.join(work, "tmp_seeds_cold"), config_dir, input_path=path, input_key="raw",
        seeds_path=path, seeds_key="seg_seeds", output_path=path, output_key="seg_cold",
    )
    reset_counts(flood_tiles_warm, flood_volume)
    t0 = time.perf_counter()
    if not build([cold]):
        raise AssertionError("unpinned watershed-from-seeds build failed")
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    if flood_tiles_warm.launches or not flood_volume.launches:
        raise AssertionError("the unpinned run must take the sweeps alone")
    cold_rounds = (flood_volume.alt_rounds / flood_volume.launches,
                   flood_volume.assign_rounds / flood_volume.launches)
    if not np.array_equal(f["seg_cold"][:], seg):
        raise AssertionError("the unpinned run differs from the pinned one")
    log(f"seeds watershed task unpinned: {cold_wall:.2f} s, byte-identical to the pinned run; "
        f"flood rounds per block alt/assign (cold) {cold_rounds[0]:.2f}/{cold_rounds[1]:.2f}")
    return launches, wall, vox / wall


def ws3d_phase(vol_np, path: str, work: str, card: str):
    """Phase 7: ``WatershedWorkflow`` in the 3d mode with a halo, then two
    blocks against their plain re-run."""
    from cluster_tools_tpu_torch import WatershedWorkflow, build
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_volume
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    config_dir = os.path.join(work, "configs_ws3d")
    cfg.write_global_config(
        config_dir, {"block_shape": list(BLOCK), "target": "cuda", "device": "cuda"}
    )
    cfg.write_config(config_dir, "watershed", {
        **WatershedTask.default_task_config(), "apply_dt_2d": False, "apply_ws_2d": False,
        "halo": list(HALO),
    })
    wf = WatershedWorkflow(
        os.path.join(work, "tmp_ws3d"), config_dir, input_path=path, input_key="raw",
        output_path=path, output_key="ws3d",
    )
    reset_counts(flood_volume)
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("3d watershed workflow build failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if flood_volume.launches == 0:
        raise AssertionError("the 3d watershed never launched flood_volume")
    vox = int(np.prod(vol_np.shape))
    log(f"3d watershed: {vol_np.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on {card}; "
        f"flood_volume launches {flood_volume.launches}, rounds per batch alt/assign "
        f"{flood_volume.alt_rounds / flood_volume.launches:.2f}/"
        f"{flood_volume.assign_rounds / flood_volume.launches:.2f}")
    task_seconds(wf, "3d watershed")
    out = file_reader(path, "r")["ws3d"]
    task = wf.requires()[0]
    config = {**task.global_config(), **task.get_task_config()}
    blocking = Blocking(vol_np.shape, BLOCK)
    check_ids = [0, blocking.n_blocks - 1]
    with plain_kernels():
        _, blocks, labels = task.compute_batch(
            task.read_batch(check_ids, blocking, config), blocking, config
        )
    torch.cuda.synchronize()
    unit = int(np.prod(BLOCK))
    fg = 0
    for bid, bh, lab in zip(check_ids, blocks, labels):
        lab = lab[tuple(slice(0, e - b) for b, e in zip(bh.inner.begin, bh.inner.end))]
        lab = np.where(lab > 0, lab + np.uint64(bid * unit), 0).astype(np.uint64)
        got = out[bh.inner.slicing]
        if not np.array_equal(lab, got):
            raise AssertionError(f"3d watershed block {bid}: plain re-run differs from the workflow")
        fg += int((got > 0).sum())
    if fg == 0:
        raise AssertionError("3d watershed: the checked blocks hold no labels")
    log(f"3d watershed blocks {check_ids} re-run through the plain versions: byte-identical")
    return wall, vox / wall


def chunk_files(root: str) -> dict:
    """Every chunk file of a dataset directory (its metadata excluded) by
    relative path, with its bytes: gzip is deterministic, so two datasets
    hold equal arrays exactly when these are equal."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name in ("attributes.json", ".zarray", ".zattrs"):
                continue
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


def status_seconds(tmp_folder: str, identifier: str) -> float:
    """A task's seconds from its status file: the runtime of a single-shot
    task, the summed attempt walls of a block task."""
    with open(os.path.join(tmp_folder, "status", f"{identifier}.status.json")) as f:
        status = json.load(f)
    return status.get("runtime_s", sum(status.get("block_runtimes", [])))


def cache_budget_phase(path: str, work: str, block) -> None:
    """Phase 4, the decoded-chunk cache's gate: the components run at
    ``block`` again with the cache off (budget 0).  Its output must equal the
    run at the default budget byte for byte; the block faces' seconds of
    both runs are printed."""
    from cluster_tools_tpu_torch import ThresholdedComponentsWorkflow, build
    from cluster_tools_tpu_torch.utils import store

    tag = "x".join(str(b) for b in block)
    tmp = os.path.join(work, f"tmp_cc_{tag}_budget0")
    wf = ThresholdedComponentsWorkflow(
        tmp, os.path.join(work, f"configs_cc_{tag}"), input_path=path, input_key="raw",
        output_path=path, output_key=f"cc_{tag}_budget0",
    )
    prev = store.set_chunk_cache_budget(0)
    t0 = time.perf_counter()
    try:
        if not build([wf]):
            raise AssertionError("components workflow at cache budget 0 failed")
    finally:
        store.set_chunk_cache_budget(prev)
    wall = time.perf_counter() - t0
    if chunk_files(os.path.join(path, f"cc_{tag}_budget0")) != chunk_files(
            os.path.join(path, f"cc_{tag}")):
        raise AssertionError(f"components {tag}: the output at cache budget 0 differs")
    faces = status_seconds(os.path.join(work, f"tmp_cc_{tag}"), "block_faces")
    faces0 = status_seconds(tmp, "block_faces")
    log(f"components {tag} chunk cache: block_faces {faces0:.3f} s at budget 0, "
        f"{faces:.3f} s at the default {prev / 2**20:.0f} MiB; the run at budget 0 "
        f"{wall:.2f} s, output byte-identical")


def rand_voi(pairs: np.ndarray, sizes: np.ndarray) -> dict:
    """Rand index and variation of information (split, merge) between two
    labellings given as (label a, label b) rows with their voxel counts
    (rows may repeat a pair)."""
    pairs, cell = np.unique(pairs, axis=0, return_inverse=True)
    sizes = np.bincount(cell.reshape(-1), weights=sizes)
    n = float(sizes.sum())
    _, ia = np.unique(pairs[:, 0], return_inverse=True)
    _, ib = np.unique(pairs[:, 1], return_inverse=True)
    a = np.bincount(ia.reshape(-1), weights=sizes)
    b = np.bincount(ib.reshape(-1), weights=sizes)

    def pairs_in(x):
        return float((x * (x - 1)).sum()) / 2

    total = n * (n - 1) / 2
    rand = (total + 2 * pairs_in(sizes) - pairs_in(a) - pairs_in(b)) / total
    p = sizes / n
    h_a_given_b = 0.0 - float((p * np.log(sizes / b[ib.reshape(-1)])).sum())
    h_b_given_a = 0.0 - float((p * np.log(sizes / a[ia.reshape(-1)])).sum())
    return {"rand_index": rand, "voi_split": h_b_given_a, "voi_merge": h_a_given_b}


def check_segmentations(path: str, ws_key: str, runs: dict, blocking) -> dict:
    """Gate 2 of phase 8, in one pass over the blocks: each run's
    segmentation must be its (fragment, segment) table applied to the
    watershed — every fragment in the table, each mapped to one segment,
    background kept — with between 1 and the fragment count segments.
    Returns the contingency of the runs' segmentations, counted over the
    fragments with their voxel counts."""
    from cluster_tools_tpu_torch.utils import file_reader

    f = file_reader(path, "r")
    ws_ds = f[ws_key]
    unit = int(np.prod(blocking.block_shape))
    tags = list(runs)
    frag_ids, frag_sizes, n_zero = [], [], 0
    for bid in range(blocking.n_blocks):
        bb = blocking.block(bid).slicing
        ws = ws_ds[bb]
        local = np.where(ws > 0, ws - np.uint64(bid * unit), 0).astype(np.int64)
        if local.max() > unit:
            raise AssertionError(f"block {bid}: watershed ids outside its offset range")
        counts = np.bincount(local.reshape(-1), minlength=unit + 1)
        n_zero += int(counts[0])
        present = np.nonzero(counts[1:])[0] + 1
        frag_ids.append(present.astype(np.uint64) + np.uint64(bid * unit))
        frag_sizes.append(counts[present])
        for tag in tags:
            table = runs[tag]["table"]
            lo, hi = np.searchsorted(table[:, 0], [bid * unit + 1, (bid + 1) * unit + 1])
            lut = np.zeros(unit + 1, dtype=np.uint64)
            has = np.zeros(unit + 1, dtype=bool)
            ids = (table[lo:hi, 0] - np.uint64(bid * unit)).astype(np.int64)
            lut[ids] = table[lo:hi, 1]
            has[ids] = True
            has[0] = True
            if not has[local].all():
                raise AssertionError(f"{tag}: block {bid} has fragments missing from the table")
            if not np.array_equal(f[runs[tag]["key"]][bb], lut[local]):
                raise AssertionError(f"{tag}: block {bid} is not the table applied to the watershed")
    frag_ids = np.concatenate(frag_ids)
    frag_sizes = np.concatenate(frag_sizes)
    segs = []
    for tag in tags:
        table = runs[tag]["table"]
        if not np.array_equal(np.sort(table[:, 0]), np.sort(frag_ids)):
            raise AssertionError(f"{tag}: the table's fragments are not the watershed's")
        seg = table[np.searchsorted(table[:, 0], frag_ids), 1]
        n_seg = len(np.unique(seg))
        if not 1 < n_seg < frag_ids.size:
            raise AssertionError(f"{tag}: {n_seg} segments of {frag_ids.size} fragments")
        runs[tag]["n_segments"] = n_seg
        segs.append(seg)
    pairs = np.stack(segs, axis=1)
    if n_zero:
        pairs = np.concatenate([pairs, np.zeros((1, len(tags)), pairs.dtype)])
        frag_sizes = np.concatenate([frag_sizes, [n_zero]])
    return {"n_fragments": int(frag_ids.size), "pairs": pairs, "sizes": frag_sizes.astype(np.float64)}


def accumulator_check(path: str, ws_key: str, blocking, max_edges: int, card: str) -> dict:
    """Gate 3 of phase 8: the device RAG accumulator on the card against the
    host ``boundary_edge_features`` on four blocks (edges, counts and
    histograms equal; min, max and quantiles to 1e-6; mean rtol 1e-4, atol
    1e-5; variance rtol 1e-3, atol 1e-4 — the reference's tolerances), then
    its time per block: the device function alone (``cuda_ms``), the host
    wrapper with its compaction and copies, and the host path."""
    from cluster_tools_tpu_torch.ops import rag
    from cluster_tools_tpu_torch.tasks.graph import read_block_with_upper_halo
    from cluster_tools_tpu_torch.utils import file_reader

    f = file_reader(path, "r")
    n = blocking.n_blocks
    check_ids = sorted({0, n // 3, 2 * n // 3, n - 1})
    record = None
    for bid in check_ids:
        block = blocking.block(bid)
        seg = read_block_with_upper_halo(f[ws_key], blocking, bid).astype(np.uint64)
        end = tuple(min(e + 1, s) for e, s in zip(block.end, blocking.shape))
        data = f["raw"][tuple(slice(b, e) for b, e in zip(block.begin, end))].astype(np.float64)
        t0 = time.perf_counter()
        want = rag.boundary_edge_features(seg, data, hist_bins=rag.HIST_BINS, owner_shape=block.shape)
        host_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got = rag.boundary_edge_features_gpu(
            seg, data, hist_bins=rag.HIST_BINS, owner_shape=block.shape, max_edges=max_edges,
        )
        wrapper_ms = (time.perf_counter() - t0) * 1e3
        (ge, gf, gh), (we, wf, wh) = got, want
        if not (np.array_equal(ge, we) and np.array_equal(gh, wh)
                and np.array_equal(gf[:, 9], wf[:, 9])):
            raise AssertionError(f"accumulator block {bid}: edges, histograms or counts differ")
        err = np.abs(gf - wf).max(axis=0, initial=0.0)
        close = (err[2:9] <= 1e-6).all() and np.allclose(
            gf[:, 0], wf[:, 0], rtol=1e-4, atol=1e-5) and np.allclose(
            gf[:, 1], wf[:, 1], rtol=1e-3, atol=1e-4)
        if not close:
            raise AssertionError(f"accumulator block {bid}: features beyond the tolerances, "
                                 f"max abs err per column {err}")
        log(f"accumulator block {bid} {tuple(seg.shape)}: {ge.shape[0]} edges equal to the host "
            f"path's, max abs err per column {np.array2string(err, precision=3)}; "
            f"host {host_ms:.1f} ms, wrapper on the card {wrapper_ms:.1f} ms")
        if record is None and block.shape == tuple(blocking.block_shape):
            uniq, inv = np.unique(seg, return_inverse=True)
            compact = (inv.reshape(seg.shape) + (0 if uniq[0] == 0 else 1)).astype(np.int32)
            cap = rag.sample_capacity(rag.count_boundary_samples(compact))
            lab_d = torch.from_numpy(compact).cuda()
            val_d = torch.from_numpy(data.astype(np.float32)).cuda()
            ms = cuda_ms(lambda: rag.boundary_edge_features_device(
                lab_d, val_d, max_edges=max_edges, owner_shape=block.shape, max_samples=cap), 20)
            edges = int(ge.shape[0])
            # reads an i32 label and an f32 value per voxel; writes the
            # per-edge outputs: u, v (i32), 10 f32 features, 64 i64 bins
            nbytes = seg.size * 8 + edges * (2 * 4 + 10 * 4 + rag.HIST_BINS * 8)
            record = {"name": "boundary_edge_features_device", "block": bid,
                      "shape": list(seg.shape), "edges": edges, "ms": ms,
                      "wrapper_ms": wrapper_ms, "host_ms": host_ms,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(f"accumulator on {card}: {record}")
    return record


def multicut_phase(vol_np, path: str, work: str, card: str) -> dict:
    """Phase 8: ``MulticutSegmentationWorkflow`` at the volume's full size on
    the ``cuda`` target, blocks (32, 256, 256), n_scales 1, the default 2d
    watershed config.  Run 1 computes the watershed (kernels 2 and 1 on the
    card) and the host features; run 2 reuses run 1's watershed
    (``skip_ws``) with ``device_accumulation``.  Gates: the native solvers
    built; run 1's watershed equals phase 3's byte for byte; each run's
    segmentation is its table applied to the watershed, with between 1 and
    the fragment count segments; the device accumulator launched in run 2
    and equal to the host path on four blocks within the reference's
    tolerances."""
    from cluster_tools_tpu_torch import MulticutSegmentationWorkflow, build, native
    from cluster_tools_tpu_torch.ops import rag
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.ops.multicut import multicut_energy
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks.features import FEATURE_IDS_KEY
    from cluster_tools_tpu_torch.tasks.multicut import ASSIGNMENTS_NAME
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader, store
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native solvers did not build: {native.load_error}")
    log(f"multicut: native solvers {native.library_path()} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    blocking = Blocking(vol_np.shape, BLOCK)
    vox = int(np.prod(vol_np.shape))

    def run(tag: str, features: dict, skip_ws: bool) -> dict:
        config_dir = os.path.join(work, f"configs_mc_{tag}")
        cfg.write_global_config(config_dir, {
            "block_shape": list(BLOCK), "target": "cuda", "device": "cuda",
            "max_jobs": min(8, os.cpu_count() or 1),
        })
        cfg.write_config(config_dir, "watershed", WatershedTask.default_task_config())
        cfg.write_config(config_dir, "block_edge_features", features)
        tmp = os.path.join(work, f"tmp_mc_{tag}")
        wf = MulticutSegmentationWorkflow(
            tmp, config_dir, input_path=path, input_key="raw", ws_path=path, ws_key="mc_ws",
            output_path=path, output_key=f"mc_seg_{tag}", skip_ws=skip_ws,
        )
        before = store.chunk_cache_counts()
        t0 = time.perf_counter()
        if not build([wf]):
            raise AssertionError(f"multicut {tag} build failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = store.chunk_cache_counts()
        cache = {k: after[k] - before[k] for k in after}
        log(f"multicut {tag}: {vol_np.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on "
            f"{card}; chunk cache at {store.chunk_cache_budget() / 2**20:.0f} MiB: {cache}")
        task_seconds(wf, f"multicut {tag}")
        return {"tmp": tmp, "config_dir": config_dir, "key": f"mc_seg_{tag}", "wall": wall,
                "cache": cache, "table": np.load(os.path.join(tmp, ASSIGNMENTS_NAME))}

    reset_counts(dtws_slices, flood_slices)
    host = run("host", {}, skip_ws=False)
    launches = {"dtws_slices": dtws_slices.launches, "flood_slices": flood_slices.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"multicut run 1 never launched {name}")
    log(f"multicut host: kernel launches {launches}, by route dtws "
        f"{dtws_slices.launches_by_route}, flood {flood_slices.launches_by_route}")
    if chunk_files(os.path.join(path, "mc_ws")) != chunk_files(os.path.join(path, "ws")):
        raise AssertionError("multicut run 1's watershed differs from phase 3's")
    log("multicut host: watershed byte-identical to phase 3's")

    ids = file_reader(os.path.join(host["tmp"], "data.zarr"), "r")[FEATURE_IDS_KEY]
    most = max(ids.read_chunk((bid,)).size for bid in range(blocking.n_blocks))
    max_edges = -(-int(most * 1.25) // 1024) * 1024
    log(f"multicut: at most {most} edges per block in the host run; the device run's "
        f"max_edges_per_block {max_edges}")
    reset_counts(rag.boundary_edge_features_device)
    dev = run("device", {"device_accumulation": True, "max_edges_per_block": max_edges},
              skip_ws=True)
    acc_launches = rag.boundary_edge_features_device.launches
    if acc_launches == 0:
        raise AssertionError("multicut run 2 never launched the device accumulator")
    log(f"multicut device: accumulator launches {acc_launches} ({blocking.n_blocks} blocks)")

    t0 = time.perf_counter()
    runs = {"host": host, "device": dev}
    cont = check_segmentations(path, "mc_ws", runs, blocking)
    scores = rand_voi(cont["pairs"], cont["sizes"])
    energies, attractive = {}, {}
    scratch = file_reader(os.path.join(host["tmp"], "data.zarr"), "r")
    nodes, edges = scratch["graph/nodes"][:], scratch["graph/edges"][:]
    for tag, r in runs.items():
        if not np.array_equal(r["table"][:, 0], nodes):
            raise AssertionError(f"{tag}: the table's rows are not the graph's nodes")
        costs = np.load(os.path.join(r["tmp"], "costs.npy"))
        energies[tag] = multicut_energy(edges, costs, r["table"][:, 1].astype(np.int64))
        attractive[tag] = float((costs > 0).mean())
    log(f"multicut: {cont['n_fragments']} fragments, {edges.shape[0]} edges; segments "
        f"host {host['n_segments']}, device {dev['n_segments']}; each segmentation is its "
        f"table applied to the watershed (checked in {time.perf_counter() - t0:.1f} s)")
    log(f"multicut energies (sum of cut costs): host {energies['host']:.6g}, device "
        f"{energies['device']:.6g}; share of attractive edges (cost > 0): {attractive}; "
        f"between the runs: {scores}")
    record = accumulator_check(path, "mc_ws", blocking, max_edges, card)
    record["launches"] = acc_launches
    return {"launches": launches, "walls": {k: r["wall"] for k, r in runs.items()},
            "accumulator": record, "tmp": host["tmp"], "config_dir": host["config_dir"]}


def merge_check(path: str, frag_key: str, out_key: str, blocking) -> dict:
    """Phase 9's gate, in one pass over the blocks: ``out_key`` must merge
    ``frag_key``'s fragments within each block — every fragment mapped to
    one id, that id inside the block's offset range, background kept
    (``(out > 0) == (frag > 0)``).  Returns the fragment and segment
    counts."""
    from cluster_tools_tpu_torch.utils import file_reader

    f = file_reader(path, "r")
    unit = int(np.prod(blocking.block_shape))
    n_frag = n_seg = 0
    for bid in range(blocking.n_blocks):
        bb = blocking.block(bid).slicing
        base = np.uint64(bid * unit)
        frag, out = f[frag_key][bb], f[out_key][bb]
        if not np.array_equal(frag > 0, out > 0):
            raise AssertionError(f"agglomeration block {bid}: coverage differs from the fragments'")
        fl = np.where(frag > 0, frag - base, 0).astype(np.int64)
        ol = np.where(out > 0, out - base, 0).astype(np.int64)
        if fl.max() > unit or ol.max() > unit or (out[out > 0] <= base).any():
            raise AssertionError(f"agglomeration block {bid}: ids outside its offset range")
        lut = np.zeros(unit + 1, dtype=np.int64)
        lut[fl] = ol
        if not np.array_equal(lut[fl], ol):
            raise AssertionError(f"agglomeration block {bid}: a fragment maps to two ids")
        present = np.bincount(fl.reshape(-1), minlength=unit + 1)[1:] > 0
        n_frag += int(present.sum())
        n_seg += len(np.unique(lut[1:][present]))
    return {"n_fragments": n_frag, "n_segments": n_seg}


def agglomeration_phase(vol_np, path: str, work: str, card: str):
    """Phase 9: ``WatershedWorkflow(agglomeration=True)`` with the default
    watershed and agglomerate configs, ``max_jobs`` 8.  Gates: kernels 2
    and 1 launched, all on the cluster route; the native solvers built;
    ``agglo_frag`` equal to phase 3's watershed byte for byte; the output a
    per-block merge of the fragments; two blocks re-run with the Python
    solver equal to the workflow's output."""
    import functools

    from cluster_tools_tpu_torch import WatershedWorkflow, build, native
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.ops.multicut import agglomerative_clustering
    from cluster_tools_tpu_torch.ops.rag import boundary_edge_features
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import watershed as ws_tasks
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    if not native.available():
        raise AssertionError(f"the native solvers did not build: {native.load_error}")
    config_dir = os.path.join(work, "configs_agglo")
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": "cuda",
        "max_jobs": min(8, os.cpu_count() or 1),
    })
    cfg.write_config(config_dir, "watershed", ws_tasks.WatershedTask.default_task_config())
    agglo_conf = ws_tasks.AgglomerateTask.default_task_config()
    cfg.write_config(config_dir, "agglomerate", agglo_conf)
    wf = WatershedWorkflow(
        os.path.join(work, "tmp_agglo"), config_dir, input_path=path, input_key="raw",
        output_path=path, output_key="agglo", agglomeration=True,
    )
    reset_counts(dtws_slices, flood_slices)
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("agglomeration workflow build failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dtws_slices": dtws_slices.launches, "flood_slices": flood_slices.launches}
    for name, wrapper in (("dtws_slices", dtws_slices), ("flood_slices", flood_slices)):
        if wrapper.launches == 0:
            raise AssertionError(f"the agglomeration run never launched {name}")
        if wrapper.launches_by_route["cluster"] != wrapper.launches:
            raise AssertionError(f"{name}: launches off the cluster route {wrapper.launches_by_route}")
    vox = int(np.prod(vol_np.shape))
    log(f"agglomeration: {vol_np.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on {card}; "
        f"launches {launches}, all down the cluster route")
    task_seconds(wf, "agglomeration")
    if chunk_files(os.path.join(path, "agglo_frag")) != chunk_files(os.path.join(path, "ws")):
        raise AssertionError("the agglomeration's fragments differ from phase 3's watershed")
    blocking = Blocking(vol_np.shape, BLOCK)
    t0 = time.perf_counter()
    counts = merge_check(path, "agglo_frag", "agglo", blocking)
    log(f"agglomeration: fragments byte-identical to phase 3's watershed; {counts['n_fragments']} "
        f"fragments merged into {counts['n_segments']} segments, each inside its block's offset "
        f"range, coverage kept (checked in {time.perf_counter() - t0:.1f} s)")

    # two blocks again through the Python solver; the edges' weights
    agglo = wf.requires()[0]
    config = {**agglo.global_config(), **agglo.get_task_config()}
    python = ws_tasks.AgglomerateTask(
        agglo.tmp_folder, config_dir, input_path=path, input_key="raw", labels_path=path,
        labels_key="agglo_frag", output_path=path, output_key="agglo_python",
    )
    python.prepare(blocking, config)
    check_ids = [0, blocking.n_blocks - 1]
    saved = ws_tasks.agglomerative_clustering
    ws_tasks.agglomerative_clustering = functools.partial(agglomerative_clustering, use_native=False)
    try:
        t0 = time.perf_counter()
        for bid in check_ids:
            python.process_block(bid, blocking, config)
        py_s = (time.perf_counter() - t0) / len(check_ids)
    finally:
        ws_tasks.agglomerative_clustering = saved
    f = file_reader(path, "r")
    under = total = 0
    for bid in check_ids:
        bb = blocking.block(bid).slicing
        if not np.array_equal(f["agglo_python"][bb], f["agglo"][bb]):
            raise AssertionError(f"agglomeration block {bid}: the Python solver differs from the native")
        frag = f["agglo_frag"][bb].astype(np.uint64)
        _, feats = boundary_edge_features(frag, f["raw"][bb].astype(np.float64))
        under += int((feats[:, 0] < agglo_conf["threshold"]).sum())
        total += feats.shape[0]
    log(f"agglomeration blocks {check_ids}: the Python solver's merge equal to the native one's "
        f"({py_s:.2f} s per block); {under} of their {total} edges ({under / max(total, 1):.4f}) "
        f"under the threshold {agglo_conf['threshold']}")
    return launches, wall, vox / wall


def face_agreement(ws, axes) -> float:
    """Share of labelled voxel pairs across the block faces normal to
    ``axes`` that carry one id (a segment continued across the face)."""
    agree = total = 0
    for axis in axes:
        for pos in range(BLOCK[axis], ws.shape[axis], BLOCK[axis]):
            a, b = np.take(ws, pos - 1, axis), np.take(ws, pos, axis)
            sel = (a > 0) & (b > 0)
            total += int(sel.sum())
            agree += int((a[sel] == b[sel]).sum())
    return agree / max(total, 1)


def two_pass_phase(vol_np, path: str, work: str, card: str, single_pass: np.ndarray):
    """Phase 10: ``WatershedWorkflow(two_pass=True)`` in the 2d mode (the
    task's defaults: NMS on) with halo [2, 8, 8], at the default
    ``pipeline_depth`` with the kernels, then at ``pipeline_depth`` 1 with
    the plain versions.  Gates: kernel 1 launched in the first run, kernel
    2 not; both outputs equal byte for byte; labels continue across the
    in-plane block faces (agreement over the y and x faces above 0.25;
    phase 3's single pass 0 on every axis)."""
    from cluster_tools_tpu_torch import WatershedWorkflow, build
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import watershed as ws_tasks
    from cluster_tools_tpu_torch.tasks.watershed import TwoPassWatershedTask
    from cluster_tools_tpu_torch.utils import file_reader

    vox = int(np.prod(vol_np.shape))

    def run(tag: str, gconf: dict):
        config_dir = os.path.join(work, f"configs_tp_{tag}")
        cfg.write_global_config(config_dir, {
            "block_shape": list(BLOCK), "target": "cuda", "device": "cuda", **gconf,
        })
        cfg.write_config(config_dir, "two_pass_watershed", {
            **TwoPassWatershedTask.default_task_config(), "halo": list(HALO),
        })
        wf = WatershedWorkflow(
            os.path.join(work, f"tmp_tp_{tag}"), config_dir, input_path=path, input_key="raw",
            output_path=path, output_key=f"tp_{tag}", two_pass=True,
        )
        t0 = time.perf_counter()
        if not build([wf]):
            raise AssertionError(f"two-pass {tag} build failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"two-pass {tag}: {vol_np.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on {card}")
        task_seconds(wf, f"two-pass {tag}")
        return wall

    # time each call of pass 1's device function in the kernel run, the
    # card synchronised around it; its bound: the tensors it is handed read
    # once and its labels written once
    calls = []
    untimed = ws_tasks.two_pass_flood

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = untimed(*args, **kwargs)
        torch.cuda.synchronize()
        tensors = [a for a in args + tuple(kwargs.values()) if torch.is_tensor(a)] + [out[0]]
        calls.append(((time.perf_counter() - t0) * 1e3,
                      sum(t.numel() * t.element_size() for t in tensors), tuple(args[0].shape)))
        return out

    reset_counts(dtws_slices, flood_slices)
    ws_tasks.two_pass_flood = timed
    try:
        wall = run("kernels", {})
    finally:
        ws_tasks.two_pass_flood = untimed
    flood_call = {"calls": len(calls), "shapes": sorted({c[2] for c in calls}),
                  "ms": float(np.mean([c[0] for c in calls])),
                  "bound_ms": float(np.mean([c[1] for c in calls])) / HBM_BYTES_PER_S * 1e3}
    log(f"two-pass kernels: two_pass_flood {flood_call['calls']} calls at {flood_call['shapes']}, "
        f"{flood_call['ms']:.2f} ms per call (host clock, card synchronised), bound "
        f"{flood_call['bound_ms']:.4f} ms (bytes) on {card}")
    launches = {"dtws_slices": dtws_slices.launches, "flood_slices": flood_slices.launches}
    if flood_slices.launches == 0 or dtws_slices.launches:
        raise AssertionError(f"two-pass: kernel 1 must launch and kernel 2 must not: {launches}")
    if flood_slices.launches_by_route["cluster"] != flood_slices.launches:
        raise AssertionError(f"two-pass: flood_slices off the cluster route "
                             f"{flood_slices.launches_by_route}")
    log(f"two-pass kernels: launches {launches}, flood_slices all down the cluster route")
    with plain_kernels():
        plain_wall = run("plain", {"pipeline_depth": 1})
    if chunk_files(os.path.join(path, "tp_kernels")) != chunk_files(os.path.join(path, "tp_plain")):
        raise AssertionError("two-pass: the kernel run differs from the plain run at pipeline_depth 1")
    f = file_reader(path, "r")
    two, one = f["tp_kernels"][:], single_pass
    if (two[vol_np >= THRESHOLD] != 0).any():
        raise AssertionError("two-pass: labels outside the foreground")
    agree = {name: [face_agreement(ws, [axis]) for axis in range(3)]
             for name, ws in (("two-pass", two), ("single pass", one))}
    in_plane = face_agreement(two, [1, 2])
    log(f"two-pass: byte-identical to the plain run at pipeline_depth 1 ({plain_wall:.2f} s); "
        f"cross-face agreement (z, y, x) two-pass {agree['two-pass']} (y and x faces together "
        f"{in_plane:.4f}), phase 3's single pass {agree['single pass']}")
    # pass 1 zeroes the distances at written voxels (the reference's 2d
    # mode), so own seeds next to a face compete with the continued labels
    if not in_plane > 0.25:
        raise AssertionError("two-pass: labels do not continue across the in-plane block faces")
    if any(agree["single pass"]):
        raise AssertionError("single pass: an id crosses a block face")
    return launches, wall, vox / wall


def clustering_phase(vol_np, path: str, work: str, card: str, mc: dict):
    """Phase 11: ``AgglomerativeClusteringWorkflow`` over phase 8's
    watershed, in phase 8 run 1's tmp folder and config dir: its graph and
    feature tasks are complete and must be skipped (their status files
    untouched).  Gate: the output is its table applied to the watershed,
    with between 1 and the fragment count segments, coverage kept."""
    from cluster_tools_tpu_torch import AgglomerativeClusteringWorkflow, build
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks.agglomerative_clustering import (
        AGGLO_ASSIGNMENTS_NAME, AgglomerativeClusteringTask,
    )
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    tmp, config_dir = mc["tmp"], mc["config_dir"]
    cfg.write_config(config_dir, "agglomerative_clustering",
                     AgglomerativeClusteringTask.default_task_config())
    reused = ["initial_sub_graphs", "merge_sub_graphs", "map_edge_ids", "block_edge_features",
              "merge_edge_features"]

    def stamps():
        return {n: os.stat(os.path.join(tmp, "status", f"{n}.status.json")).st_mtime_ns
                for n in reused}

    before = stamps()
    wf = AgglomerativeClusteringWorkflow(
        tmp, config_dir, input_path=path, input_key="raw", ws_path=path, ws_key="mc_ws",
        output_path=path, output_key="ac_seg",
    )
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("agglomerative clustering build failed")
    wall = time.perf_counter() - t0
    if stamps() != before:
        raise AssertionError("agglomerative clustering re-ran a graph or feature task")
    vox = int(np.prod(vol_np.shape))
    log(f"agglomerative clustering: {vol_np.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on "
        f"{card}; graph and feature tasks of phase 8 run 1 reused (status files untouched)")
    for name in ("agglomerative_clustering", "write_agglomerative_clustering"):
        with open(os.path.join(tmp, "status", f"{name}.status.json")) as fh:
            split = {t["label"]: round(t["seconds"], 3) for t in json.load(fh)["timings"]}
        log(f"agglomerative clustering task {name}: {status_seconds(tmp, name):.3f} s {split}")
    t0 = time.perf_counter()
    runs = {"agglomerative clustering": {
        "key": "ac_seg", "table": np.load(os.path.join(tmp, AGGLO_ASSIGNMENTS_NAME))}}
    cont = check_segmentations(path, "mc_ws", runs, Blocking(vol_np.shape, BLOCK))
    log(f"agglomerative clustering: {runs['agglomerative clustering']['n_segments']} segments of "
        f"{cont['n_fragments']} fragments; the output is its table applied to the watershed, "
        f"coverage kept (checked in {time.perf_counter() - t0:.1f} s)")
    return wall, vox / wall


AFF_CHUNKS = (8, 32, 256, 256)
MWS_HALO = (2, 4, 4)  # the MWS tasks' default
MWS_DEVICE_CROP = (36, 24, 24)  # phase 12b: the centre of a halo'd block
MAX_MUTEX_IDS = 1024  # compute_mws_segmentation_with_seeds' default
TWO_PASS_MWS_Z = 16  # phase 13's depth: half a block layer (pass 1 runs a block at a time)


def mws_offsets() -> list:
    """``MwsBlocksTask``'s default long-range offsets (z, y, x)."""
    from cluster_tools_tpu_torch.tasks import MwsBlocksTask

    return MwsBlocksTask.default_task_config()["offsets"]


def make_affinities(vol: torch.Tensor) -> torch.Tensor:
    """Long-range affinities of the boundary map on the card, uint8
    ``round(255 * aff)``: for offset o, ``aff(x) = 1 - max(b(x), b(x + o))``
    (attractive inside a compartment, repulsive across a membrane), ``b(x)``
    alone where ``x + o`` lies outside."""
    offsets = mws_offsets()
    out = torch.empty((len(offsets),) + tuple(vol.shape), dtype=torch.uint8, device=vol.device)
    for c, off in enumerate(offsets):
        src = tuple(slice(max(-o, 0), n - max(o, 0)) for o, n in zip(off, vol.shape))
        dst = tuple(slice(max(o, 0), n - max(-o, 0)) for o, n in zip(off, vol.shape))
        nb = vol.clone()
        nb[src] = vol[dst]
        out[c] = torch.round(255.0 * (1.0 - torch.maximum(vol, nb))).to(torch.uint8)
    return out


def relabel_outer(seg: np.ndarray, block_id: int, blocking, halo) -> np.ndarray:
    """``MwsBlocksTask``'s relabel: the outer region consecutive from 1,
    offset into the block's namespace of the full halo'd size."""
    _, inv = np.unique(seg, return_inverse=True)
    unit = block_id * int(np.prod([b + 2 * h for b, h in zip(blocking.block_shape, halo)]))
    return inv.reshape(seg.shape).astype(np.uint64) + np.uint64(1 + unit)


def mws_graph(affs_u8: np.ndarray, block_id: int, scale: float):
    """The block's MWS graph as ``compute_mws_segmentation`` builds it from
    affinities ``k / scale`` (255: the workflow's cast; 256: re-quantised,
    exact in float32 and float64): nodes, uv, float64 weights, flags."""
    from cluster_tools_tpu_torch.ops.mws import _affinity_edge_lists

    affs = affs_u8.astype(np.float32) / np.float32(scale)
    us, vs, ws, att = _affinity_edge_lists(
        affs, np.asarray(mws_offsets()), [1, 1, 1], False, 0.0, np.random.default_rng(block_id), 3)
    uv = np.stack([np.concatenate(us), np.concatenate(vs)], axis=1)
    return int(np.prod(affs.shape[1:])), uv, np.concatenate(ws), np.concatenate(att)


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    key = ia.reshape(-1).astype(np.int64) * (int(ib.max()) + 1) + ib.reshape(-1)
    n = np.unique(key).size
    return n == int(ia.max()) + 1 == int(ib.max()) + 1


def mws_phase(vol_np, work: str, card: str, dev) -> dict:
    """Phase 12: ``MwsWorkflow`` at the volume's full size on the ``cuda``
    target, blocks (32, 256, 256), the task's defaults (halo [2, 4, 4],
    strides [1, 1, 1], no noise), 8 host threads, on long-range affinities
    made on the card from the boundary map (uint8, raw n5, chunks (8, 32,
    256, 256)).  Gates: the native solver built; every voxel labelled; the
    output is the stitch table applied to ``mws_blocks``; blocks first and
    last recomputed with ``compute_mws_segmentation`` from the halo'd read
    equal ``mws_blocks`` after the relabel and offset; the dominant
    stitched id continues across a y face and an x face."""
    from cluster_tools_tpu_torch import MwsWorkflow, build, native
    from cluster_tools_tpu_torch.ops.mws import compute_mws_segmentation
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import STITCH_ASSIGNMENTS_NAME, MwsBlocksTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    t0 = time.perf_counter()
    affs = make_affinities(torch.from_numpy(vol_np).to(dev)).cpu().numpy()
    torch.cuda.empty_cache()
    path = os.path.join(work, "affs.n5")
    file_reader(path).create_dataset("affs", data=affs, chunks=AFF_CHUNKS, compression="raw")
    log(f"setup: affinities {affs.shape} uint8 ({affs.nbytes / 1e9:.2f} GB) made on the card and "
        f"written as raw n5 in {time.perf_counter() - t0:.1f} s")
    if not native.available():
        raise AssertionError(f"mws: native solvers unavailable: {native.load_error}")
    tmp, config_dir = os.path.join(work, "tmp_mws"), os.path.join(work, "configs_mws")
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": str(dev),
        "max_jobs": min(8, os.cpu_count() or 1),
    })
    conf = MwsBlocksTask.default_task_config()
    cfg.write_config(config_dir, "mws_blocks", conf)
    wf = MwsWorkflow(tmp, config_dir, input_path=path, input_key="affs", output_path=path,
                     output_key="mws")
    vox = int(np.prod(vol_np.shape))
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("mws workflow build failed")
    wall = time.perf_counter() - t0
    log(f"mws: {vol_np.shape} in {wall:.2f} s = {vox / wall:.6g} voxels/s on {card}")
    task_seconds(wf, "mws")
    t0 = time.perf_counter()
    f = file_reader(path, "r")
    seg, blocks = f["mws"][:], f["mws_blocks"][:]
    table = np.load(os.path.join(tmp, STITCH_ASSIGNMENTS_NAME))
    if not (seg > 0).all():
        raise AssertionError("mws: unlabelled voxels")
    # ids lie below n_blocks x the halo'd block size: dense tables over them
    # are a few GB and a pass each, where sorts of the volume take minutes
    lut = np.arange(int(blocks.max()) + 1, dtype=np.uint64)
    lut[table[:, 0]] = table[:, 1]
    if not np.array_equal(lut[blocks], seg):
        raise AssertionError("mws: the output is not the stitch table applied to mws_blocks")
    del lut
    n_blocks_ids = int(np.count_nonzero(np.bincount(blocks.reshape(-1).view(np.int64))))
    counts = np.bincount(seg.reshape(-1).view(np.int64))
    n_ids, dom = int(np.count_nonzero(counts)), int(counts.argmax())
    log(f"mws: {n_blocks_ids} segments in the blocks, {n_ids} after stitching "
        f"({table.shape[0]} voted ids in the table); the output is the table applied to "
        f"mws_blocks (checked in {time.perf_counter() - t0:.1f} s)")
    blocking = Blocking(vol_np.shape, BLOCK)
    for bid in (0, blocking.n_blocks - 1):
        bh = blocking.block_with_halo(bid, MWS_HALO)
        a = affs[(slice(None),) + bh.outer.slicing].astype(np.float32) / 255.0
        t0 = time.perf_counter()
        got = compute_mws_segmentation(a, conf["offsets"], strides=conf["strides"], seed=bid)
        dt = time.perf_counter() - t0
        got = relabel_outer(got, bid, blocking, MWS_HALO)[bh.inner_local.slicing]
        if not np.array_equal(got, blocks[bh.inner.slicing]):
            raise AssertionError(f"mws block {bid}: recomputed labels differ from mws_blocks")
        log(f"mws block {bid} {tuple(a.shape[1:])}: compute_mws_segmentation (edges, native "
            f"solve, relabel) {dt:.3f} s on the host; equals mws_blocks")
    crossing = []
    for axis in (1, 2):
        crossing.append(any(
            bool(((np.take(seg, pos - 1, axis) == dom) & (np.take(seg, pos, axis) == dom)).any())
            for pos in range(BLOCK[axis], seg.shape[axis], BLOCK[axis])))
    agree = [face_agreement(seg, [axis]) for axis in range(3)]
    log(f"mws: dominant id {dom} holds {counts[dom] / seg.size:.4f} of the voxels, crosses a "
        f"y face {crossing[0]}, an x face {crossing[1]}; face voxel pairs agreeing (z, y, x) {agree}")
    if not all(crossing):
        raise AssertionError("mws: the dominant stitched id does not continue across y and x faces")
    return {"wall": wall, "rate": vox / wall, "affs": affs, "path": path}


def device_mws_phase(affs: np.ndarray, card: str, dev) -> dict:
    """Phase 12b: the device MWS on the card, on the centre (36, 24, 24) of
    two interior halo'd blocks of phase 12's input — a crop: the whole
    (36, 264, 264) block does not finish inside the script's time (its
    rounds and round cost: ``--mws-scaling``).  Weights re-quantised to k/256 (exact in float32 and
    float64): ``CTT_MWS_MODE=device`` must give the native solve's
    partition.  The workflow's k/255 weights: Rand > 0.99 and VI split +
    merge < 0.1 against the native solve.  Printed per solve: rounds, ms
    (CUDA events around the call, its copies included), the native solve's
    ms; for the first block's k/255 graph a bytes bound (uv, weight and flag
    read once: 13 B per edge; 4 B per node written)."""
    from cluster_tools_tpu_torch import native
    from cluster_tools_tpu_torch.ops.mws import force_mws_mode
    from cluster_tools_tpu_torch.ops.mws import mutex_watershed_graph
    from cluster_tools_tpu_torch.ops.mws_device import mutex_watershed_device
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    blocking = Blocking(affs.shape[1:], BLOCK)
    grid = blocking.grid_shape
    picks = [blocking.block_id_from_grid_position((1, 1, 1)),
             blocking.block_id_from_grid_position(tuple(max(g - 2, 1) for g in grid))]
    reset_counts(mutex_watershed_device)
    mutex_watershed_device.rounds = 0
    record = None
    for bid in picks:
        bh = blocking.block_with_halo(bid, MWS_HALO)
        outer = affs[(slice(None),) + bh.outer.slicing]
        crop = tuple(slice((s - min(c, s)) // 2, (s - min(c, s)) // 2 + min(c, s))
                     for s, c in zip(outer.shape[1:], MWS_DEVICE_CROP))
        block = np.ascontiguousarray(outer[(slice(None),) + crop])
        for scale in (256, 255):
            n, uv, w, att = mws_graph(block, bid, scale)
            t0 = time.perf_counter()
            want = native.mutex_watershed(n, uv, w, att)
            native_ms = (time.perf_counter() - t0) * 1e3
            rounds = mutex_watershed_device.rounds
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with force_mws_mode("device"):
                got = mutex_watershed_graph(n, uv, w, att, device=dev)
            end.record()
            torch.cuda.synchronize()
            wrapper_ms = (time.perf_counter() - t0) * 1e3
            ms = start.elapsed_time(end)
            rounds = mutex_watershed_device.rounds - rounds
            if scale == 256:
                if not same_partition(got, want):
                    raise AssertionError(f"device mws block {bid}: k/256 partition differs from native")
                verdict = "the native partition"
            else:
                scores = rand_voi(np.stack([want, got], axis=1), np.ones(n))
                if not (scores["rand_index"] > 0.99
                        and scores["voi_split"] + scores["voi_merge"] < 0.1):
                    raise AssertionError(f"device mws block {bid}: k/255 beyond Rand/VoI {scores}")
                verdict = f"Rand/VoI {scores}"
            log(f"device mws block {bid} centre {tuple(block.shape[1:])} k/{scale}: {n} nodes, "
                f"{uv.shape[0]} edges, {len(np.unique(want))} segments; {verdict}; {rounds} rounds, "
                f"{ms:.1f} ms on the card ({ms / max(rounds, 1):.3f} ms per round; host clock "
                f"{wrapper_ms:.1f} ms), native {native_ms:.1f} ms, on {card}")
            if record is None and scale == 255:
                bound = (13 * uv.shape[0] + 4 * n) / HBM_BYTES_PER_S * 1e3
                record = {"name": "mutex_watershed_device", "block": bid,
                          "shape": list(block.shape[1:]), "crop_of": list(outer.shape[1:]),
                          "nodes": n, "edges": int(uv.shape[0]),
                          "ms": ms, "rounds": rounds, "ms_per_round": ms / max(rounds, 1),
                          "wrapper_ms": wrapper_ms, "native_ms": native_ms,
                          "bound_ms": bound, "bound_by": "bytes"}
    if mutex_watershed_device.launches != 2 * len(picks):
        raise AssertionError(f"device mws: {mutex_watershed_device.launches} launches, "
                             f"{2 * len(picks)} expected")
    record["launches"] = mutex_watershed_device.launches
    log(f"device mws on {card}: {record}")
    return record


MWS_SCALING_SIDES = (24, 32, 48, 96, 264)  # (36, s, s) centres; 264: the whole halo'd block
MWS_SCALING_BUDGET_S = 120.0  # host seconds per device solve before it is stopped unfinished
MWS_PROFILE_ROUNDS = (50, 70)  # rounds of the whole block under torch.profiler


def device_time_us(evt) -> float:
    return float(getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0.0))


def mws_scaling_phase(card: str, dev, seed: int) -> list:
    """``--mws-scaling``: the device MWS's schedule on growing centres
    (36, s, s) of phase 12's first interior halo'd block, up to the whole
    block, on the workflow's k/255 weights.  Each solve runs the round loop
    for at most ``MWS_SCALING_BUDGET_S`` host seconds (``on_round``); a
    finished one is held to the native solve by Rand/VoI as in phase 12b.
    Printed per size: nodes, edges, rounds, ms per round (host clock: the
    loop reads the card once per round), rows still open and read, the
    native solve's ms; the open rows at rounds 1, 10, 100, ...; for the
    whole block a ``torch.profiler`` window over rounds
    ``MWS_PROFILE_ROUNDS``: the card's busy share and its top operators."""
    from cluster_tools_tpu_torch import native
    from cluster_tools_tpu_torch.ops.mws_device import _mws_parallel_greedy
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    t0 = time.perf_counter()
    vol = make_volume(CREMI_A, seed, dev)
    blocking = Blocking(CREMI_A, BLOCK)
    bid = blocking.block_id_from_grid_position((1, 1, 1))
    bh = blocking.block_with_halo(bid, MWS_HALO)
    outer = make_affinities(vol)[(slice(None),) + bh.outer.slicing].cpu().numpy()
    del vol
    torch.cuda.empty_cache()
    log(f"mws scaling: block {bid} halo'd {outer.shape[1:]} affinities in "
        f"{time.perf_counter() - t0:.1f} s")
    out = []
    for side in MWS_SCALING_SIDES:
        crop = tuple(slice((s - min(c, s)) // 2, (s - min(c, s)) // 2 + min(c, s))
                     for s, c in zip(outer.shape[1:], (36, side, side)))
        block = np.ascontiguousarray(outer[(slice(None),) + crop])
        n, uv, w, att = mws_graph(block, bid, 255)
        t0 = time.perf_counter()
        want = native.mutex_watershed(n, uv, w, att)
        native_ms = (time.perf_counter() - t0) * 1e3
        uv_d = torch.from_numpy(uv.astype(np.int64)).to(dev)
        w_d = torch.from_numpy(w.astype(np.float32)).to(dev)
        att_d = torch.from_numpy(att.astype(bool)).to(dev)
        trace, prof = [], None
        whole = block.shape[1:] == outer.shape[1:]
        torch.cuda.synchronize()
        t_start = time.perf_counter()

        def on_round(rounds, n_open, n_live):
            nonlocal prof
            now = time.perf_counter() - t_start
            if rounds & (rounds - 1) == 0:
                trace.append((rounds, round(now, 3), n_open, n_live))
            if whole and rounds == MWS_PROFILE_ROUNDS[0]:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.start()
                prof.t0 = time.perf_counter()
            if prof is not None and rounds == MWS_PROFILE_ROUNDS[1]:
                prof.wall_us = (time.perf_counter() - prof.t0) * 1e6
                prof.stop()
            on_round.last = (rounds, now, n_open, n_live)
            return now > MWS_SCALING_BUDGET_S

        on_round.last = None
        comp, rounds = _mws_parallel_greedy(uv_d, w_d, att_d, n, True, on_round)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_start
        if prof is not None and not hasattr(prof, "wall_us"):
            prof.stop()  # the loop ended inside the window: no profile kept
            prof = None
        # the profiled rounds run slower: they are left out of ms per round
        span = MWS_PROFILE_ROUNDS[1] - MWS_PROFILE_ROUNDS[0]
        plain_s, plain_rounds = ((secs - prof.wall_us / 1e6, rounds - span) if prof is not None
                                 else (secs, rounds))
        # the loop ends on its own (no open row: the hook is not called that
        # round) or when the hook stops it (rounds equal the hook's last)
        finished = on_round.last is None or on_round.last[0] != rounds
        rec = {"shape": list(block.shape[1:]),
               "nodes": n, "edges": int(uv.shape[0]), "rounds": rounds, "finished": finished,
               "seconds": secs, "ms_per_round": plain_s * 1e3 / max(plain_rounds, 1),
               "native_ms": native_ms, "open_trace": trace}
        if not finished:
            rec["open_at_stop"], rec["live_at_stop"] = on_round.last[2], on_round.last[3]
            verdict = (f"stopped unfinished after {secs:.1f} s: {on_round.last[2]} of "
                       f"{uv.shape[0]} rows still open, {on_round.last[3]} still read")
        else:
            scores = rand_voi(np.stack([want, comp.cpu().numpy()], axis=1), np.ones(n))
            if not (scores["rand_index"] > 0.99 and scores["voi_split"] + scores["voi_merge"] < 0.1):
                raise AssertionError(f"mws scaling {side}: beyond Rand/VoI {scores}")
            rec["scores"] = scores
            verdict = f"finished in {secs:.1f} s, Rand/VoI against native {scores}"
        log(f"mws scaling {tuple(block.shape[1:])}: {n} nodes, {uv.shape[0]} edges; {rounds} rounds, "
            f"{rec['ms_per_round']:.3f} ms per round; {verdict}; native {native_ms:.1f} ms; "
            f"open rows at rounds 2**k {trace}; on {card}")
        if prof is not None:
            evts = prof.key_averages()
            # self device time counts each kernel once, under the kernel
            busy = sum(float(getattr(e, "self_device_time_total", None)
                             or getattr(e, "self_cuda_time_total", 0.0)) for e in evts)
            ops = [e for e in evts if e.key.startswith("aten::") and device_time_us(e) > 0]
            top = sorted(ops, key=device_time_us, reverse=True)[:10]
            rec["profile"] = {
                "rounds": list(MWS_PROFILE_ROUNDS), "wall_ms_per_round": prof.wall_us / span / 1e3,
                "device_ms_per_round": busy / span / 1e3,
                "top": [[e.key, e.count // span, round(device_time_us(e) / span / 1e3, 4)]
                        for e in top]}
            log(f"mws scaling whole block profile: {rec['profile']}")
        out.append(rec)
        del uv_d, w_d, att_d, comp
        torch.cuda.empty_cache()
    return out


def face_seeds(written: np.ndarray, inner_local) -> np.ndarray:
    """``TwoPassMwsTask``'s seeds: the written labels in the halo's face
    slabs only."""
    seeds = np.zeros_like(written)
    for axis in range(3):
        for lo, hi in ((0, inner_local[axis].start), (inner_local[axis].stop, written.shape[axis])):
            slab = list(inner_local)
            slab[axis] = slice(lo, hi)
            seeds[tuple(slab)] = written[tuple(slab)]
    return seeds


def two_pass_mws_phase(affs: np.ndarray, path: str, work: str, card: str, dev, z: int) -> dict:
    """Phase 13: ``TwoPassMwsWorkflow`` at full width on the first ``z``
    planes of phase 12's input, written as a dataset of their own (pass 1
    is serial by design, so its depth is cut; an ROI would still run whole
    blocks), the task's defaults.  Gates: every voxel labelled; the first
    and last pass-1 blocks, recomputed from the written volume, equal what
    was written (new ids shifted past the seeds), every
    seeded voxel (a pass-0 id in the halo's face slabs) keeps a seed id, and
    its own id where the block has at most ``MAX_MUTEX_IDS`` seed ids."""
    from cluster_tools_tpu_torch import TwoPassMwsWorkflow, build
    from cluster_tools_tpu_torch.ops.mws import compute_mws_segmentation_with_seeds
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import TwoPassMwsTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    affs = np.ascontiguousarray(affs[:, :z])
    shape = affs.shape[1:]
    file_reader(path).create_dataset("affs_tp", data=affs, chunks=AFF_CHUNKS, compression="raw")
    tmp, config_dir = os.path.join(work, "tmp_tp_mws"), os.path.join(work, "configs_tp_mws")
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": str(dev),
        "max_jobs": min(8, os.cpu_count() or 1),
    })
    conf = TwoPassMwsTask.default_task_config()
    cfg.write_config(config_dir, "two_pass_mws", conf)
    wf = TwoPassMwsWorkflow(tmp, config_dir, input_path=path, input_key="affs_tp",
                            output_path=path, output_key="tp_mws")
    vox = int(np.prod(shape))
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("two-pass mws build failed")
    wall = time.perf_counter() - t0
    passes = [status_seconds(tmp, f"two_pass_mws_pass{i}") for i in (0, 1)]
    seg = file_reader(path, "r")["tp_mws"][:]
    if not (seg > 0).all():
        raise AssertionError("two-pass mws: unlabelled voxels")
    agree = [face_agreement(seg, [axis]) for axis in (1, 2)]
    log(f"two-pass mws: {shape} in {wall:.2f} s = {vox / wall:.6g} voxels/s "
        f"on {card}; pass 0 {passes[0]:.3f} s, pass 1 {passes[1]:.3f} s; face voxel pairs "
        f"agreeing (y, x) {agree}; {np.unique(seg).size} ids")
    blocking = Blocking(shape, BLOCK)
    black = TwoPassMwsTask(tmp, config_dir, pass_id=1).get_block_list(blocking, cfg.global_config(config_dir))
    full = file_reader(path, "r")["tp_mws"]
    for bid in (black[0], black[-1]):
        bh = blocking.block_with_halo(bid, conf["halo"])
        seeds = face_seeds(full[bh.outer.slicing], bh.inner_local.slicing)
        a = affs[(slice(None),) + bh.outer.slicing].astype(np.float32) / 255.0
        t0 = time.perf_counter()
        out = compute_mws_segmentation_with_seeds(a, conf["offsets"], seeds, strides=conf["strides"],
                                                  seed=bid)
        dt = time.perf_counter() - t0
        seed_ids = np.unique(seeds[seeds > 0])
        k, at = seed_ids.size, seeds > 0
        kept = float((out[at] == seeds[at]).mean()) if at.any() else 1.0
        # the reference's contract: every seeded voxel keeps a seed id; its
        # own one when at most MAX_MUTEX_IDS seed ids are mutexed pair by
        # pair (past that, only consecutive ids are: two seeds may merge)
        if not np.isin(out[at], seed_ids).all():
            raise AssertionError(f"two-pass mws block {bid}: a seeded voxel took a new id")
        if k <= MAX_MUTEX_IDS and kept < 1.0:
            raise AssertionError(f"two-pass mws block {bid}: a seed id did not survive ({k} seed ids)")
        seed_max = int(seeds.max())
        unit = np.uint64(bid * int(np.prod([b + 2 * h for b, h in zip(BLOCK, conf["halo"])])))
        out = np.where(out > seed_max, out - np.uint64(seed_max) + unit, out)
        if not np.array_equal(out[bh.inner_local.slicing], full[bh.inner.slicing]):
            raise AssertionError(f"two-pass mws block {bid}: the recomputed block differs")
        log(f"two-pass mws block {bid}: {k} seed ids on {int(at.sum())} face voxels, each seeded "
            f"voxel keeps a seed id, its own on a share {kept:.6f} (all must where k <= "
            f"{MAX_MUTEX_IDS}); recomputed in {dt:.3f} s, equal to the written block")
    return {"wall": wall, "rate": vox / wall, "passes": passes, "agree": agree,
            "shape": ", ".join(map(str, shape))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--z", type=int, default=CREMI_A[0], help="volume depth (cut z only)")
    ap.add_argument("--batch", type=int, default=8, help="blocks per kernel-phase batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare", action="append", default=[], metavar="DIR",
                    help="another checkout, e.g. of the parent commit unpacked with git "
                         "archive (repeatable): phase 2 times its kernel 5 and phase 5 its "
                         "kernel 3 and 3d flood in turns with this tree's, each in a child "
                         "process, this tree in one too")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 5 (no workflow runs, no result line)")
    ap.add_argument("--mws-scaling", action="store_true",
                    help="only the device MWS's rounds and round cost on growing centres of a "
                         "halo'd block, up to the whole block (no build, no result line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cluster_tools_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    if args.mws_scaling:
        log(json.dumps({"mws_scaling": mws_scaling_phase(card, torch.device("cuda"), args.seed)}))
        log(f"script: {time.perf_counter() - t_start:.1f} s")
        return 0
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"setup: built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        with open(os.path.join(_build.BUILD_DIR, name + ".log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"ptxas {name}: {line.strip()}")

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    shape = (args.z,) + CREMI_A[1:]
    vol = make_volume(shape, args.seed, dev)
    log(f"setup: synthetic volume {shape} in {time.perf_counter() - t0:.1f} s, "
        f"boundary fraction {float((vol >= THRESHOLD).float().mean()):.4f}")
    records = kernel_phase(vol, dev, args.batch)
    records.update(cc_kernel_phase(vol, dev, args.batch, args.compare))
    records.update(flood3d_kernel_phase(vol, dev, args.compare))
    log(f"phases 1-5 done at {time.perf_counter() - t_start:.1f} s")
    if args.kernels_only:
        log("kernels only: no workflow run")
        return 0
    vol_np = vol.cpu().numpy()
    del vol
    torch.cuda.empty_cache()
    # phase 10 runs on the first EARLY_Z planes so that the mutex
    # watershed's phases fit the time limit; the rest on the whole
    cut_np = vol_np[:EARLY_Z]
    from scipy import ndimage

    from cluster_tools_tpu_torch.utils import file_reader

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        path = os.path.join(work, "cremi_a.n5")
        cut_path = os.path.join(work, "cremi_a_cut.n5")
        t0 = time.perf_counter()
        file_reader(path).create_dataset("raw", data=vol_np, chunks=BLOCK, compression="raw")
        file_reader(cut_path).create_dataset("raw", data=cut_np, chunks=BLOCK, compression="raw")
        log(f"setup: wrote {vol_np.shape} and {cut_np.shape} raw n5 in "
            f"{time.perf_counter() - t0:.1f} s")
        launches, wall, rate = workflow_phase(vol_np, path, work, card)
        t0 = time.perf_counter()
        fg = vol_np < THRESHOLD
        ref, n_ref = ndimage.label(fg)
        log(f"setup: scipy labelled vol < {THRESHOLD}: {n_ref} components in "
            f"{time.perf_counter() - t0:.1f} s")
        rates = {}
        for block, kernel in ((BLOCK, "cc_slices"), (BLOCK_WIDE, "cc_tiles")):
            cc_launches, cc_wall, cc_rate = components_phase(
                path, work, block, card, fg, ref, n_ref, kernel)
            launches[kernel] = cc_launches[kernel]
            rates[block] = (cc_wall, cc_rate)
        del ref, fg
        cache_budget_phase(path, work, BLOCK)
        log(f"phases 3-4 done at {time.perf_counter() - t_start:.1f} s")
        seed_launches, seeds_wall, seeds_rate = seeds_phase(vol_np, path, work, card)
        for name in ("flood_tiles_warm", "flood_volume"):
            launches[name] = seed_launches[name]
        ws3d_wall, ws3d_rate = ws3d_phase(vol_np, path, work, card)
        log(f"phases 6-7 done at {time.perf_counter() - t_start:.1f} s")
        mc = multicut_phase(vol_np, path, work, card)
        log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
        agglo_launches, agglo_wall, agglo_rate = agglomeration_phase(vol_np, path, work, card)
        tp_launches, tp_wall, tp_rate = two_pass_phase(
            cut_np, cut_path, work, card, file_reader(path, "r")["ws"][:EARLY_Z])
        ac_wall, ac_rate = clustering_phase(vol_np, path, work, card, mc)
        log(f"phases 9-11 done at {time.perf_counter() - t_start:.1f} s")
        mws = mws_phase(vol_np, work, card, dev)
        log(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
        device_mws = device_mws_phase(mws["affs"], card, dev)
        log(f"phase 12b done at {time.perf_counter() - t_start:.1f} s")
        tp_mws = two_pass_mws_phase(mws["affs"], mws["path"], work, card, dev,
                                    min(TWO_PASS_MWS_Z, vol_np.shape[0]))
        log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
    for name, rec in records.items():
        rec["launches"] = launches[name]
        log(f"kernel {name}: {rec['launches']} launches in its workflow run, {rec['ms']:.3f} ms "
            f"per launch, plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), max abs err {rec['max_abs_err']}")
    log(f"{card}: WatershedWorkflow {vol_np.shape} {rate:.6g} voxels/s ({wall:.3f} s)")
    for block, (cc_wall, cc_rate) in rates.items():
        log(f"{card}: ThresholdedComponentsWorkflow {vol_np.shape} blocks {block} "
            f"{cc_rate:.6g} voxels/s ({cc_wall:.3f} s)")
    log(f"{card}: ThresholdAndWatershedWorkflow {vol_np.shape} {seeds_rate:.6g} voxels/s "
        f"({seeds_wall:.3f} s)")
    log(f"{card}: WatershedWorkflow 3d {vol_np.shape} {ws3d_rate:.6g} voxels/s ({ws3d_wall:.3f} s)")
    for tag, wall in mc["walls"].items():
        log(f"{card}: MulticutSegmentationWorkflow {tag} {vol_np.shape} "
            f"{int(np.prod(vol_np.shape)) / wall:.6g} voxels/s ({wall:.3f} s)")
    log(f"multicut run 1 kernel launches {mc['launches']}")
    log(f"{card}: WatershedWorkflow agglomeration {vol_np.shape} {agglo_rate:.6g} voxels/s "
        f"({agglo_wall:.3f} s); kernel launches {agglo_launches}")
    log(f"{card}: WatershedWorkflow two-pass {cut_np.shape} {tp_rate:.6g} voxels/s "
        f"({tp_wall:.3f} s); kernel launches {tp_launches}")
    log(f"{card}: AgglomerativeClusteringWorkflow {vol_np.shape} {ac_rate:.6g} voxels/s "
        f"({ac_wall:.3f} s, graph and features reused)")
    log(f"{card}: MwsWorkflow {vol_np.shape} {mws['rate']:.6g} voxels/s ({mws['wall']:.3f} s)")
    log(f"{card}: TwoPassMwsWorkflow ({tp_mws['shape']}) {tp_mws['rate']:.6g} voxels/s "
        f"({tp_mws['wall']:.3f} s; pass 0 {tp_mws['passes'][0]:.3f} s, pass 1 "
        f"{tp_mws['passes'][1]:.3f} s)")
    log(f"script: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"device_functions": [mc["accumulator"], device_mws]}))
    log(json.dumps({"kernels": [records[k] for k in (
        "flood_slices", "dtws_slices", "flood_tiles_warm", "cc_slices", "cc_tiles",
        "flood_volume")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
