#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--z 125] [--batch 8] [--seed 0] [--compare DIR] [--kernels-only]
                          [--fixpoint-paths]
    python3 chip_smoke.py --mws-scaling
    python3 chip_smoke.py --filter-bank-exact
    python3 chip_smoke.py --label-phases
    python3 chip_smoke.py --container-phases
    python3 chip_smoke.py --volume-phases
    python3 chip_smoke.py --inference-phases
    python3 chip_smoke.py --hier-phases
    python3 chip_smoke.py --stream-phases

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
     ``EARLY_Z``, two block layers, and its first 32, ``SHALLOW_Z``, in
     containers of their own for the phases cut to those depths so that
     the script keeps inside its time);
     ``build([WatershedWorkflow(...)])``
     on the ``cuda`` target with the default watershed config and blocks
     (32, 256, 256).  Both kernels' launch counts must rise in this run, all
     down the cluster route; the
     output is checked (shape, labels only on the foreground, ids unique per
     block through the offsets) and two blocks re-run through the plain
     versions on the card must equal it byte for byte;
  4. the thresholded-components workflow on the first 32 planes of the
     same volume (``SHALLOW_Z``, a cut for the script's time;
     ``threshold_mode="less"``: the cell interior), ``cuda`` target, twice:
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
  6. ``ThresholdAndWatershedWorkflow`` on the first 32 planes: seeds are the
     components of ``vol < 0.3`` (``"less"``), the watershed from seeds runs
     with its defaults (3d flood, sigma 2, halo [2, 8, 8]) on the ``cuda``
     target with ``CTT_FLOOD_TILE`` pinned to the kernel phase's tile.
     Kernel 3's and the 3d flood's launch counts must rise, kernel 4's all
     down its cluster route; every seed id must be kept, the output must
     cover the volume, two blocks re-run through the plain versions and a
     second, unpinned run of the watershed task must equal it byte for
     byte;
  7. ``WatershedWorkflow`` in the 3d mode on the first 32 planes
     (``apply_dt_2d`` and ``apply_ws_2d`` False, halo [2, 8, 8]: the CC
     re-close runs), the
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
  9. ``WatershedWorkflow(agglomeration=True)`` on the first 32 planes, the
     default watershed and agglomerate configs, ``max_jobs`` 8: kernels 2
     and 1 must launch, all on the cluster route, and the native solvers
     must have built; the fragments (``<key>_frag``) must equal phase 3's
     watershed on those planes byte for byte, the output must merge them
     within each block's offset range
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
 12. ``MwsWorkflow`` at full width on an ROI of the first 16 planes
     (``MWS_Z``, a ``roi_end`` in the global config: the cut that keeps
     the later phases inside the time limit) on long-range affinities made
     on the card from the whole boundary map (8 offsets, ``aff(x) = 1 -
     max(b(x), b(x + o))``, uint8 raw n5, chunks (8, 32, 256, 256); the
     first 34 planes written, so the ROI selects the first of two block
     layers), the task's defaults, 8 host threads.  Gates: the native
     solver built; the ROI runs a strict subset of the blocks and the rest
     stay unwritten; inside the ROI every voxel labelled; the output is the
     stitch table applied to ``mws_blocks``; the ROI's first and last
     blocks recomputed with
     ``compute_mws_segmentation`` equal ``mws_blocks``; the dominant
     stitched id crosses a y face and an x face.  Printed: wall, voxels/s,
     seconds per task, segment counts, face agreement;
 12b. the device MWS (``CTT_MWS_MODE=device``) on the card on the centre
     (36, 24, 24) of two interior halo'd blocks — a crop, not a workflow
     block: the whole (36, 264, 264) block does not finish inside the
     script's time (``--mws-scaling``) — k/256 weights give the native
     partition, the workflow's k/255 weights Rand > 0.99 and VI < 0.1
     against it; rounds, ms and the native solve's ms;
 13. ``TwoPassMwsWorkflow`` at full width on the first 4 planes (``TWO_PASS_MWS_Z``);
     gates: every voxel labelled, two pass-1 blocks
     recomputed equal to what was written, seeded voxels keep seed ids
     (their own where a block has at most 1024 seed ids).  Printed: wall, the passes' seconds, face
     agreement;
 14. ``MulticutSegmentationWorkflow`` from affinities on the first 32 planes:
     ``255 -`` phase 12's channels 0-2 (offsets [-1, 0, 0], [0, -1, 0],
     [0, 0, -1], boundary convention; uint8 raw n5, chunks (3, 32, 256,
     256)), n_scales 1, ``sanity_checks``, the watershed over channels
     0-3 (mean), the ``offsets`` features.  Gates: kernels 2 and 1 launch,
     all on the cluster route; ``CheckSubGraphsTask`` passes; blocks first
     and last of the watershed re-run through the plain versions equal it;
     their saved feature chunks equal ``affinity_edge_features`` on the
     host; the output is its table applied to the watershed, with between
     1 and the fragment count segments.  Printed: wall, voxels/s, seconds
     per task, the energy;
 15. ``SubSolutionsWorkflow`` and ``ReducedSolutionWorkflow`` at scale 1 in
     phase 14's tmp folder: each fragment one sub-solution id within a
     scale-1 block; the reduced labelling its table applied to the
     watershed, a coarsening with 1 < segments < fragments;
 16. on the first 8 planes (``FILTER_Z``), over an ROI of 2 x 2 blocks
     (``FILTER_ROI_BLOCKS``), cut for the script's time: the multicut with the filter
     bank (all four filters, sigma 1.6, halo [6, 6, 6], ``quantile_mode``
     "approx": the default exact raw-sample merge alone takes minutes,
     ``--filter-bank-exact``), ``ImageFilterTask`` (hessian eigenvalues)
     and the region features over its watershed.  Gates: the card's filter
     responses equal the port's on the CPU on block 0's whole halo'd read
     (exactly; the eigenvalues within 1e-5·max|H|), saved features equal a
     host recompute, region counts, minima and maxima equal numpy's and
     means within rtol 1e-4;
 17. on the first 8 planes: ``InsertAffinitiesTask`` (phase 12's 8
     channels; objects phase 6's seeds left of x = 512), ``GradientsTask``
     and ``EmbeddingDistancesTask`` (the 8 channels as an embedding).
     Gates: the 3d flood launches; blocks without objects are copied; three
     blocks of each output equal the port's CPU recompute (uint8 byte for
     byte, float within 1e-6 relative);
 18. label bookkeeping on the first 64 planes of phase 3's watershed
     (copied; 50 blocks, so z, y and x faces occur): ``UniqueWorkflow``,
     ``RelabelWorkflow``, ``MorphologyWorkflow``, ``BlockNodeLabelsTask`` +
     ``MergeNodeLabelsTask`` against phase 8 run 1's segmentation,
     ``ThresholdTask`` at 0.5 with sigma 0 and 2.  Gates: the uniques are
     numpy's; the relabelled volume has ids 1..n and the same partition;
     sizes equal numpy's bincount, three fragments' centres of mass (within
     1e-9) and bounding boxes numpy's; every fragment's node label is its
     phase 8 segment; sigma 0 is ``raw > 0.5`` byte for byte, sigma 2 equals
     the port's CPU recompute on two blocks;
 19. postprocessing on the same planes, ``min_size`` the 30th percentile of
     the fragment sizes: ``SizeFilterWorkflow`` to background and with
     filling over the boundary map (``relabel=True``, ``CTT_FLOOD_TILE``
     pinned to the kernel phase's tile: kernel 3 and the 3d flood launch
     once per block with discarded ids), the watershed's problem (graph,
     boundary features, costs), ``SizeFilterAndGraphWatershedWorkflow``,
     ``FilterLabelsWorkflow``, ``FilterByThresholdWorkflow``,
     ``FilterOrphansWorkflow`` and ``ConnectedComponentsWorkflow``.  Gates:
     no discarded id left and kept voxels unchanged; two blocks of the
     filling re-run through the plain flood on the card equal it byte for
     byte; each output is its table applied to the watershed; every
     reassigned fragment has a RAG neighbour with its new id.  Kernel 3 and
     the 3d flood timed at the filling filter's (1, 32, 256, 256) call;
 20. ``SimpleStitchingWorkflow`` and ``MulticutStitchingWorkflow`` on the
     same planes: each output is its table applied to the watershed with
     1 < segments < fragments; the simple stitch's segments are the
     components of the fragment pairs touching across block faces; the
     face agreement per axis is printed;
 22. the first 32 planes of the boundary map (``SHALLOW_Z``) in three
     containers: a blosc-lz4 byte-shuffle ``.zarr``, a blosc-zstd
     bit-shuffle ``.n5`` and an ``.h5`` written by h5py under CREMI's
     ``volumes/boundaries`` (chunks (32, 256, 256), gzip);
     ``WatershedWorkflow`` from each on the card.  Gates: kernels 2 and 1
     launch; each output equals phase 3's watershed on those planes byte
     for byte and is gzip; the runs' chunked scratch datasets carry the codec
     that ``default_compression()`` names on the host;
 23. ``LiftedMulticutSegmentationWorkflow`` from the ``.zarr`` leg (phase
     3's watershed config, n_scales 1), the prior the class volume ``1 + x
     // 256`` made on the card (5 classes), costs from node labels +4 / -4.
     Gates: kernels 2 and 1 launch; the watershed equals phase 3's; the
     output is the lifted assignment table applied to it; below half of
     the segments have voxels in two class bands; the graph's and features'
     scratch datasets carry the house codec; the native lifted GAEC and the
     Python one give one partition on the nodes below 1,500; the lifted
     energy is at most 0 and at most the plain multicut's.  Printed: nodes,
     edges, lifted edges, segments, every task's seconds;
 24. ``LearningWorkflow`` on phase 23's problem (its graph, features and
     node votes reused, their status files untouched) with the class
     volume as the ground truth, ``n_trees`` 10, then
     ``PredictEdgeProbabilitiesTask`` and ``ProbsToCostsTask`` with
     ``probs_path``.  Gates: edge labels in {0, 1}, both present; mean
     probability above 0.7 on label-1 edges, below 0.3 on label-0 edges.
     The host's optional libraries are probed first and printed on an early
     line (h5py, scikit-learn, libblosc): without libblosc phase 22 writes
     its ``.zarr`` and ``.n5`` with the house codec (gzip there), without
     h5py it leaves the ``.h5`` leg out, without scikit-learn phase 24 runs
     up to ``EdgeLabelsTask``; each such cut is printed on its own line.
     Phases 22-24 run after 20, before 21's lines;
 25. volume ops and exports on the first 32 planes, the ``cuda`` target
     (``volume_phase``): ``round(255·b)`` as a uint8 n5 into
     ``DownscalingWorkflow`` (paintera, factors [1, 2, 2], [1, 2, 2],
     [2, 2, 2], "interpolate"), a second prefix with "skimage" (mean), then
     ``PainteraToBdvWorkflow`` to ``bdv.n5``; phase 3's watershed down by
     [1, 2, 2] and up again (nearest); ``ScaleToBoundariesTask`` from the
     coarse labels onto the boundary map with its defaults and again eroding
     by 2 in plane, ``CTT_FLOOD_TILE`` pinned (the 3d flood and kernel 3
     must launch; every id is a coarse id plus the offset; the in-plane
     run's blocks 0 and last hold objects and equal a re-run through the
     plain floods, and its kernels are timed at an interior block with
     object seeds); ``CopyVolumeTask`` float32 to uint8
     over an ROI, ``BlocksFromMaskTask`` and ``MinfilterTask`` on ``b < 0.5``
     at half resolution, ``LinearTransformationTask`` per slice under that
     mask; ``PainteraConversionWorkflow`` over a two-block ROI (with h5py
     also the ``bdv.hdf5`` copy and ``BigcatWorkflow``).  Gates in
     ``volume_phase``'s docstring; it runs after 24, before 21's lines;
 26. inference and analysis on the first 32 planes, the ``cuda`` target
     (``inference_phase``): the JAX package's full-width U-Net (16
     features, depth 3, CREMI's [1, 2, 2] pooling) with seeded random
     weights, saved in the shared checkpoint format, through
     ``InferenceTask`` (halo [4, 32, 32], a three-channel ``pred`` and a
     ``bmap``, uint8), re-predicted blocks, bf16 against float32, mirror
     TTA and a masked run held to the module; ``WatershedWorkflow`` on the
     prediction (kernels 2 and 1); ``EvaluationWorkflow`` against phase
     3's watershed held to one contingency table; ``SkeletonWorkflow``,
     ``MeshWorkflow`` and ``DistanceWorkflow`` on crops of phase 3's
     watershed held to host recomputations and scipy's EDT; the U-Net
     forward timed against its FLOP bound.  Gates in ``inference_phase``'s
     docstring; it runs after 25, before 21's lines;
 27. the hierarchy, event building and the flood's remaining entry points
     (``hier_phase``): ``HierarchyWorkflow`` on the first 32 planes with
     the default ``hierarchy_blocks`` config (kernels 2 and 1, all down the
     cluster route), two blocks re-run through the plain versions, the
     artifact's invariants, ``ResegmentWorkflow`` at quantiles of the
     saddles held to the host oracle, to each other and to its table mode;
     ``EventBuildingWorkflow`` on 2048 detector-like 256 x 256 frames held
     to scipy; ``flood_with_stats`` at the pinned tile on a halo'd block
     (kernel 3 and the 3d flood), ``seeded_watershed_hier``, a capped and a
     26-connected flood on a crop held to the same calls on the CPU; the
     hierarchy runs as its fused chain and once more with
     ``stream_fusion: false``, byte for byte equal.  Gates
     in ``hier_phase``'s docstring; it runs after 26, before 28;
 28. stream fusion and device residency (``stream_phase``) on the first 32
     planes in gzip n5 at chunk-cache budget 0: ``StreamingSegmentationWorkflow``
     fused and unfused (equal bytes, one chain, no fallback, no mask, half
     the store reads, kernels 4 and 2 launched in the chain), then the 2d
     ``WatershedWorkflow`` with the device-buffer cache off, cold, warm
     and at ``hbm_stack`` 2 (equal bytes, every warm batch from the cache,
     half the dispatches).  Gates in ``stream_phase``'s docstring; it runs
     after 27, before 21's lines;
 21. one JSON line with the device functions (the accumulator, the device
     MWS, the filter bank with its ``eigvalsh``, the segment reductions,
     the dilation, phase 25's resamplers, minimum filter and affine step,
     phase 26's U-Net forward, phase 27's event labelling, merge table,
     re-cut gather and neighbour-sweep flood),
     one with the filling filter's kernel 3 and 3d flood,
     one listing the six kernels, then the result line.

A flushed ``phase N start at ... s`` line precedes each phase, and if the
script still runs after ``STACK_DUMP_S`` (900 s) every thread's stack is
printed once to standard error (``faulthandler``; it changes nothing else).

``--mws-scaling`` runs only the device MWS's schedule study (no build, no
result line): growing (36, s, s) centres of phase 12's first interior
halo'd block up to the whole (36, 264, 264) block, each solve stopped after
``MWS_SCALING_BUDGET_S`` host seconds; rounds, ms per round, the rows still
open, and a profiler window over the whole block's rounds.

``--filter-bank-exact`` runs only phase 16 (after the build and the
volume; no result line) with the filter bank's default quantile mode, the
exact raw-sample merge that the full run leaves out for time; its gates are
phase 16's, with the saved raw samples checked too.

``--label-phases`` runs only the build, the volume, phases 3 and 8 and
phases 18-20 (no result line): the new phases measured without the rest.
``--container-phases`` runs only the build, the volume, phase 3 and phases
22-24 (no result line).
``--volume-phases`` runs only the build, the volume, phase 3 and phase 25
(no result line).
``--inference-phases`` runs only the build, the volume, phase 3 and phase 26
(no result line).
``--hier-phases`` runs only the build, the volume and phase 27 (no result
line).
``--stream-phases`` runs only the build, the volume and phase 28 (no result
line).

Without a CUDA device, or without the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
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
EARLY_Z = 64  # depth of phases 18-20 (two block layers: z faces occur), cut for the script's time
SHALLOW_Z = 32  # depth of phases 4, 6, 7, 9, 10, 14, 15 and 22-24 (one block layer), cut for time
FIXPOINT_PATHS = False  # --fixpoint-paths: time the plain floods down each card path
STACK_DUMP_S = 900  # every thread's stack is printed once if the script runs this long


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


def timed_call(fn):
    """``fn()`` once between two CUDA events: its result and milliseconds
    (a gate's own reference call, timed where it is made)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def fixpoint_paths(name: str, fn, turns: bool = True) -> dict:
    """The plain flood ``fn()`` timed (``timed_call``, warm) down the card
    paths of ``cuda_flood._fixpoint``: "default" (round by round, graphs
    after ``GRAPH_AFTER_ROUNDS``), "graph" (graphs from the first round)
    and "launched" (round by round to the end), in turns (default, graph,
    launched, then back) or, without ``turns``, once each; the outputs must
    be equal.  Run with ``--fixpoint-paths``."""
    from cluster_tools_tpu_torch.ops import cuda_flood

    saved = cuda_flood.GRAPH_AFTER_ROUNDS
    after = {"default": saved, "graph": 0, "launched": 1 << 62}
    order = list(after) + (list(after)[::-1] if turns else [])
    ms, outs = {path: [] for path in after}, {}
    try:
        for path in order:
            cuda_flood.GRAPH_AFTER_ROUNDS = after[path]
            outs[path], t = timed_call(fn)
            ms[path].append(t)
    finally:
        cuda_flood.GRAPH_AFTER_ROUNDS = saved
    if not all(torch.equal(outs["default"], o) for o in outs.values()):
        raise AssertionError(f"fixpoint paths {name}: the paths' outputs differ")
    log(f"fixpoint paths {name}: " + ", ".join(f"{k} {v} ms" for k, v in ms.items())
        + f" (GRAPH_AFTER_ROUNDS {saved})")
    return ms


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
    plain_s = {}  # seconds of each gate's plain reference
    for name, (x, m, v) in cases.items():
        route = dtws_route(x.shape[2], x.shape[3], 17)
        before = dict(dtws_slices.launches_by_route)
        got = dtws_slices(x, m, v, threshold=THRESHOLD)
        want, plain_ms = timed_call(lambda: dtws_slices_plain(x, m, v, threshold=THRESHOLD))
        plain_s[f"dtws_slices {name}"] = plain_ms / 1e3
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
        want, plain_ms = timed_call(lambda: flood_slices_plain(h, s, m))
        plain_s[f"flood_slices {name}"] = plain_ms / 1e3
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
    log("plain references, s per gate call (the first call of each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in plain_s.items()))
    # plain_ms of the kernels line: one warm call at the main shape, the
    # gate's call above having been the first
    dtws_plain_ms = timed_call(lambda: dtws_slices_plain(x_main, ones, ones, threshold=THRESHOLD))[1]
    flood_plain_ms = timed_call(lambda: flood_slices_plain(*flood_main))[1]
    if FIXPOINT_PATHS:
        fixpoint_paths(f"flood_slices_plain {tuple(flood_main[0].shape)}",
                       lambda: flood_slices_plain(*flood_main))
        h, s, m = flood_cases["serpentine rows 256"]
        fixpoint_paths(f"flood_slices_plain serpentine rows {tuple(h.shape)}",
                       lambda: flood_slices_plain(h, s, m), turns=False)
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

    check_ids = [0, blocking.n_blocks - 1]  # an interior-corner block and the ragged last one
    check_watershed_blocks(wf.requires()[0], path, "ws", blocking, check_ids)
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


def flood_references(gates: dict) -> dict:
    """The references of the 3d flood's gates: ``gates`` maps a gate's name
    to the single blocks ``(h, s, m, warm or None)`` of the batch it gave
    the kernel.  Each distinct block is computed once, one call per block
    shape: the plain flood's labels (blocks never interact, so a batch's
    labels are its blocks') and the rounds of the flood's schedule in plain
    PyTorch (``flood_volume_scan``, the JAX package's counts; a batch's
    rounds are the most of its blocks', ``per_item``).  A cold block runs
    warm from ``BIG`` everywhere, which leaves its start unchanged.  Returns
    each gate's (stacked labels, (phase 1, phase 2) rounds)."""
    from cluster_tools_tpu_torch.ops.cuda_flood import BIG, flood_volume_plain, flood_volume_scan

    def same(a, b):
        return a is b or (a is not None and b is not None and a.shape == b.shape
                          and bool(torch.equal(a, b)))

    blocks, index = [], {}
    for name, items in gates.items():
        index[name] = []
        for item in items:
            at = next((i for i, u in enumerate(blocks)
                       if all(same(a, b) for a, b in zip(u, item))), None)
            if at is None:
                at = len(blocks)
                blocks.append(item)
            index[name].append(at)
    labels, rounds = [None] * len(blocks), [None] * len(blocks)
    for shape in dict.fromkeys(tuple(b[0].shape) for b in blocks):
        ids = [i for i, b in enumerate(blocks) if tuple(b[0].shape) == shape]
        h, s, m = (torch.stack([blocks[i][k] for i in ids]) for k in range(3))
        w = torch.stack([blocks[i][3] if blocks[i][3] is not None
                         else torch.full(shape, BIG, device=h.device) for i in ids])
        t0 = time.perf_counter()
        plain = flood_volume_plain(h, s, m, warm=w)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scan = flood_volume_scan(h, s, m, warm=w, per_item=True)[2]
        log(f"flood_volume references of {len(ids)} distinct blocks {shape}: plain "
            f"{t1 - t0:.1f} s, schedule (flood_volume_scan) {time.perf_counter() - t1:.1f} s")
        for k, i in enumerate(ids):
            labels[i], rounds[i] = plain[k], scan[k]
    return {name: (torch.stack([labels[i] for i in idx]),
                   (max(rounds[i][0] for i in idx), max(rounds[i][1] for i in idx)))
            for name, idx in index.items()}


def check_flood(name: str, got: torch.Tensor, stats: dict, ref: tuple) -> tuple:
    """The kernel's labels must equal the plain flood's and its rounds of
    each phase (``stats``) those of its schedule (``ref``, from
    ``flood_references``).  Returns the rounds."""
    want, want_rounds = ref
    if not torch.equal(got, want):
        raise AssertionError(f"flood_volume {name}: differs from the plain version "
                             f"({int((got != want).sum())} voxels)")
    rounds = (stats["flood_alt_iters"], stats["flood_assign_iters"])
    if rounds != want_rounds:
        raise AssertionError(f"flood_volume {name}: rounds alt/assign {rounds}, the sequential "
                             f"sweeps' {want_rounds}")
    log(f"flood_volume {name}: equal to plain, rounds alt/assign {rounds[0]}/{rounds[1]} equal "
        f"to the sequential sweeps'")
    return rounds


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

    # times at one halo'd block (the seeded workflow's call, warm and cold)
    # and at the 3d watershed's batch of 8 halo'd blocks (cold), the parent
    # design's in turns where a checkout of it is given
    h1, s1, m1 = (t[None] for t in blocks[0])
    hs, ss, ms = (t.view((-1,) + hw) for t in (h1, s1, m1))
    warm1, t_rounds = flood_tiles_warm_rounds(hs, ss, ms, tile)
    warm1 = warm1.view(h1.shape)
    z_last, y_last, x_last = (v - b for v, b in zip(vol.shape, shape))
    corners8 = [(z, y, x) for z in (0, z_last) for y in (0, y_last) for x in (0, x_last)]
    h8, s8, m8 = (torch.stack(t) for t in zip(*(halo_block(vol, c, dev) for c in corners8)))
    timed = {
        f"{tuple(h1.shape)} warm": (h1, s1, m1, warm1),
        f"{tuple(h1.shape)} cold": (h1, s1, m1, None),
        f"{tuple(h8.shape)} cold": (h8, s8, m8, None),
    }
    # the kernel on every gate's batch, then each distinct block's plain
    # flood and schedule once, then the gates
    gates = {**flood_cases, **timed}
    got = {}
    for name, (h, s, m, w) in gates.items():
        stats = {}
        got[name] = (flood_volume(h, s, m, warm=w, stats=stats), stats)
    torch.cuda.synchronize()
    refs = flood_references({
        name: [(h[i], s[i], m[i], None if w is None else w[i]) for i in range(h.shape[0])]
        for name, (h, s, m, w) in gates.items()})
    rounds = {}
    for name, (h, s, m, w) in gates.items():
        out, stats = got[name]
        if name.startswith("serpentine") and not bool((out[m] == 1).all()):
            raise AssertionError("flood_volume serpentine: corridor not flooded to its end")
        rounds[name] = check_flood(name, out, stats, refs[name])
    k3_plain_ms = cuda_ms(lambda: flood_tiles_warm_plain(hs, ss, ms, tile), 1)
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
    if FIXPOINT_PATHS:
        fixpoint_paths(f"flood_tiles_warm_plain {tuple(hs.shape)}",
                       lambda: flood_tiles_warm_plain(hs, ss, ms, tile))
        fixpoint_paths(f"flood_volume_plain {tuple(h1.shape)} warm",
                       lambda: flood_volume_plain(h1, s1, m1, warm=warm1))
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
    chain, todo, seen = [], [wf], set()
    while todo:
        node = todo.pop()
        key = (node.tmp_folder, node.identifier)
        if key in seen:
            continue
        seen.add(key)
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
        batch, labels = task.compute_batch(
            task.read_batch(check_ids, blocking, config), blocking, config
        )
        blocks = batch.blocks
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


def chunk_files(root: str, z_chunks=None) -> dict:
    """Every chunk file of an n5 dataset directory (its metadata excluded)
    by relative path, with its bytes: gzip is deterministic, so two datasets
    hold equal arrays exactly when these are equal.  ``z_chunks`` keeps the
    chunks of the first that many chunk layers in z (n5's chunk path ends
    with the z index), to hold a run on the first planes against a run on
    the whole volume."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name in ("attributes.json", ".zarray", ".zattrs"):
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if z_chunks is not None and int(rel.split(os.sep)[-1]) >= z_chunks:
                continue
            with open(full, "rb") as f:
                out[rel] = f.read()
    return out


def same_as_phase3(path: str, key: str, ws_path: str, shape) -> bool:
    """``path/key`` equals phase 3's ``ws_path/ws`` on its ``shape[0]``
    planes, chunk file for chunk file (the blocks align: the depth is a
    multiple of the block's)."""
    return chunk_files(os.path.join(path, key)) == chunk_files(
        os.path.join(ws_path, "ws"), z_chunks=-(-shape[0] // BLOCK[0]))


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


def local_ids(ws: np.ndarray, bid: int, unit: int) -> np.ndarray:
    """Block ``bid``'s watershed ids less its offset (``bid * unit``), 0
    kept: the watershed writes ids in (bid * unit, (bid + 1) * unit]."""
    local = np.where(ws > 0, ws - np.uint64(bid * unit), 0).astype(np.int64)
    if local.max(initial=0) > unit:
        raise AssertionError(f"block {bid}: watershed ids outside its offset range")
    return local


def fragments_of(ws, blocking, check=None):
    """Sorted non-zero fragment ids of a block-offset watershed (an array or
    a dataset, read block by block) and their voxel counts, from a bincount
    per block (numpy, independent of the port's tasks); the count of
    background voxels.  ``check(bid, slicing, local)`` runs on each block's
    local ids."""
    unit = int(np.prod(blocking.block_shape))

    def one(bid):
        bb = blocking.block(bid).slicing
        local = local_ids(ws[bb], bid, unit)
        if check is not None:
            check(bid, bb, local)
        counts = np.bincount(local.reshape(-1), minlength=unit + 1)
        present = np.nonzero(counts[1:])[0] + 1
        return present.astype(np.uint64) + np.uint64(bid * unit), counts[present], int(counts[0])

    parts = over_blocks(one, blocking)
    return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
            sum(p[2] for p in parts))


def check_segmentations(path: str, ws_key: str, runs: dict, blocking) -> dict:
    """Gate 2 of phase 8, in one pass over the blocks on host threads: each run's
    segmentation must be its (fragment, segment) table applied to the
    watershed — every fragment in the table, each mapped to one segment,
    background kept — with between 1 and the fragment count segments.
    Returns the contingency of the runs' segmentations, counted over the
    fragments with their voxel counts."""
    from cluster_tools_tpu_torch.utils import file_reader

    f = file_reader(path, "r")
    unit = int(np.prod(blocking.block_shape))
    tags = list(runs)

    def check(bid, bb, local):
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

    frag_ids, frag_sizes, n_zero = fragments_of(f[ws_key], blocking, check)
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
    if not same_as_phase3(path, "mc_ws", path, vol_np.shape):
        raise AssertionError("multicut run 1's watershed differs from phase 3's")
    log(f"multicut host: watershed byte-identical to phase 3's on its {vol_np.shape[0]} planes")

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
            "accumulator": record, "tmp": host["tmp"], "config_dir": host["config_dir"],
            "table": host["table"], "path": path}


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


def agglomeration_phase(vol_np, path: str, work: str, card: str, ws_path: str):
    """Phase 9: ``WatershedWorkflow(agglomeration=True)`` on ``vol_np`` (the
    first ``SHALLOW_Z`` planes in the script) with the default watershed and
    agglomerate configs, ``max_jobs`` 8.  Gates: kernels 2
    and 1 launched, all on the cluster route; the native solvers built;
    ``agglo_frag`` equal to phase 3's watershed (``ws_path/ws``) on those
    planes byte for byte; the output a
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
    if not same_as_phase3(path, "agglo_frag", ws_path, vol_np.shape):
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
TWO_PASS_MWS_Z = 4  # phase 13's depth (pass 1 runs a block at a time), cut for the script's time
MWS_Z = 16  # phase 12's ROI depth (half a block layer); the ROI's blocks run whole
# phase 12's stored depth: the first block layer with its z halo, so its
# halo'd reads are the whole volume's, and a second layer outside the ROI
MWS_STORED_Z = BLOCK[0] + MWS_HALO[0]


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
    """Phase 12: ``MwsWorkflow`` at full width on the first ``MWS_Z``
    planes (a ``roi_end`` in the global config; the affinities are made for
    the whole volume, for phases 12b-14 and 17, and stored for the first
    ``MWS_STORED_Z`` planes, so the ROI selects the first of two block
    layers and the stitching runs over that subset) on the ``cuda``
    target, blocks (32, 256, 256), the task's defaults (halo [2, 4, 4],
    strides [1, 1, 1], no noise), 8 host threads, on long-range affinities
    made on the card from the boundary map (uint8, raw n5, chunks (8, 32,
    256, 256)).  Gates: the native solver built; the ROI selects a strict
    subset of the blocks and the blocks outside it stay unwritten; inside
    the ROI every voxel labelled; the output is the stitch table applied to
    ``mws_blocks``; the ROI's blocks first and last recomputed with
    ``compute_mws_segmentation`` from the halo'd read equal ``mws_blocks``
    after the relabel and offset; the dominant stitched id continues across
    a y face and an x face."""
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
    z, stored = min(MWS_Z, vol_np.shape[0]), min(MWS_STORED_Z, vol_np.shape[0])
    file_reader(path).create_dataset("affs", data=np.ascontiguousarray(affs[:, :stored]),
                                     chunks=AFF_CHUNKS, compression="raw")
    log(f"setup: affinities {affs.shape} uint8 ({affs.nbytes / 1e9:.2f} GB) made on the card, "
        f"the first {stored} planes written as raw n5, in {time.perf_counter() - t0:.1f} s")
    if not native.available():
        raise AssertionError(f"mws: native solvers unavailable: {native.load_error}")
    tmp, config_dir = os.path.join(work, "tmp_mws"), os.path.join(work, "configs_mws")
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": str(dev),
        "max_jobs": min(8, os.cpu_count() or 1),
        "roi_begin": [0, 0, 0], "roi_end": [z] + list(vol_np.shape[1:]),
    })
    conf = MwsBlocksTask.default_task_config()
    cfg.write_config(config_dir, "mws_blocks", conf)
    wf = MwsWorkflow(tmp, config_dir, input_path=path, input_key="affs", output_path=path,
                     output_key="mws")
    roi = (z,) + tuple(vol_np.shape[1:])
    vox = int(np.prod(roi))
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("mws workflow build failed")
    wall = time.perf_counter() - t0
    log(f"mws: {roi} of {(stored,) + roi[1:]} in {wall:.2f} s = {vox / wall:.6g} voxels/s on {card}")
    task_seconds(wf, "mws")
    t0 = time.perf_counter()
    f = file_reader(path, "r")
    blocking = Blocking((stored,) + roi[1:], BLOCK)
    in_roi = blocking.blocks_overlapping_roi([0, 0, 0], list(roi))
    if not len(in_roi) < blocking.n_blocks:
        raise AssertionError(f"mws: the ROI selects all {blocking.n_blocks} blocks")
    outside = (slice(blocking.block(in_roi[-1]).end[0], stored),)
    if f["mws_blocks"][outside].any() or f["mws"][outside].any():
        raise AssertionError("mws: a block outside the ROI was written")
    seg, blocks = f["mws"][:z], f["mws_blocks"][:z]
    table = np.load(os.path.join(tmp, STITCH_ASSIGNMENTS_NAME))
    if not (seg > 0).all():
        raise AssertionError("mws: unlabelled voxels")
    # ids lie below n_blocks x the halo'd block size: dense tables over them
    # are a few GB and a pass each, where sorts of the volume take minutes
    lut = np.arange(max(int(blocks.max()), int(table[:, 0].max(initial=0))) + 1, dtype=np.uint64)
    lut[table[:, 0]] = table[:, 1]
    if not np.array_equal(lut[blocks], seg):
        raise AssertionError("mws: the output is not the stitch table applied to mws_blocks")
    del lut
    n_blocks_ids = int(np.count_nonzero(np.bincount(blocks.reshape(-1).view(np.int64))))
    counts = np.bincount(seg.reshape(-1).view(np.int64))
    n_ids, dom = int(np.count_nonzero(counts)), int(counts.argmax())
    log(f"mws: {n_blocks_ids} segments in the blocks, {n_ids} after stitching "
        f"({table.shape[0]} voted ids in the table); the output is the table applied to "
        f"mws_blocks; the ROI runs {len(in_roi)} of {blocking.n_blocks} blocks, the rest "
        f"stay unwritten (checked in {time.perf_counter() - t0:.1f} s)")
    for bid in (in_roi[0], in_roi[-1]):
        bh = blocking.block_with_halo(bid, MWS_HALO)
        a = affs[(slice(None),) + bh.outer.slicing].astype(np.float32) / 255.0
        t0 = time.perf_counter()
        got = compute_mws_segmentation(a, conf["offsets"], strides=conf["strides"], seed=bid)
        dt = time.perf_counter() - t0
        got = relabel_outer(got, bid, blocking, MWS_HALO)[bh.inner_local.slicing]
        if not np.array_equal(got, f["mws_blocks"][bh.inner.slicing]):
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
    return {"wall": wall, "rate": vox / wall, "affs": affs, "path": path, "shape": roi}


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


AFF_MC_OFFSETS = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]  # MwsBlocksTask's offsets 0-2
AFF_MC_CHUNKS = (3, 32, 256, 256)
# the watershed's threshold on the affinities' channel mean: at the task's 0.5
# the mean's foreground is one connected piece whose RAG edges all lie below
# 0.5, so every cost is attractive and the multicut returns one segment
# (PERF.md §4); at 0.4 the cells separate
AFF_WS_THRESHOLD = 0.4
FEATURE_Z = 8  # depth of phase 17 (a quarter block layer), cut for the script's time
FILTER_Z = 8  # depth of phase 16 (a quarter block layer), cut for the script's time
# phase 16's ROI in y and x, in blocks: 2 x 2 keeps block faces along both axes.  Cut from all
# 25 blocks for the script's time (the filter bank's host features, per block, took 36.8 of
# the phase's 70.2 s in a 952.7 s script on one host)
FILTER_ROI_BLOCKS = (2, 2)
FILTER_SIGMA = 1.6
FILTER_HALO = [6, 6, 6]  # int(4 * 1.6 + 0.5): the filters' radius at FILTER_SIGMA
# phase 16's quantile merge: the filter bank's default, the exact raw-sample
# merge, took 258.8 s alone at 32 planes (PERF.md §4), more than the script
# has room for; ``--filter-bank-exact`` runs phase 16 with it
FILTER_QUANTILE_MODE = "approx"
OBJECTS_X = 512  # phase 17: objects only left of x = 512, so blocks right of it hold none
# phase 17's refit: the seeds average ~165 voxels, so the default erosion (6,
# a 13^3 window) would leave almost none; 2 in plane (5 x 5) keeps many
INSERT_CONFIG = {"erode_by": 2, "erode_3d": False}


def check_watershed_blocks(task, path: str, ws_key: str, blocking, check_ids) -> None:
    """Blocks ``check_ids`` of a ``WatershedTask``'s output re-run through the
    plain versions on the card: byte-identical."""
    from cluster_tools_tpu_torch.utils import file_reader

    config = {**task.global_config(), **task.get_task_config()}
    with plain_kernels():
        batch, labels = task.compute_batch(
            task.read_batch(list(check_ids), blocking, config), blocking, config)
        blocks = batch.blocks
    torch.cuda.synchronize()
    out = file_reader(path, "r")[ws_key]
    unit = int(np.prod(blocking.block_shape))
    for bid, bh, lab in zip(check_ids, blocks, labels):
        lab = lab[bh.inner_local.slicing]
        lab = np.where(lab > 0, lab + np.uint64(bid * unit), 0).astype(np.uint64)
        if not np.array_equal(lab, out[bh.inner.slicing]):
            raise AssertionError(f"{ws_key} block {bid}: plain re-run differs from the workflow")


def saved_block_features(tmp: str, bid: int, edges: np.ndarray):
    """A block's saved feature partial (``BlockEdgeFeaturesTask``): its
    global edge ids, the feature rows and sketches, with the graph ids of
    ``edges`` and which of them the graph holds."""
    from cluster_tools_tpu_torch.tasks.features import (
        FEATURE_HISTS_KEY, FEATURE_IDS_KEY, FEATURE_VALS_KEY, global_edge_ids)
    from cluster_tools_tpu_torch.tasks.graph import load_graph
    from cluster_tools_tpu_torch.utils import file_reader

    scratch = file_reader(os.path.join(tmp, "data.zarr"), "r")
    ids, valid = global_edge_ids(*load_graph(scratch), edges)
    saved_ids = scratch[FEATURE_IDS_KEY].read_chunk((bid,))
    vals = scratch[FEATURE_VALS_KEY].read_chunk((bid,)).reshape(saved_ids.size, -1)
    hists = scratch[FEATURE_HISTS_KEY].read_chunk((bid,))
    if not np.array_equal(saved_ids, ids[valid]):
        raise AssertionError(f"block {bid}: saved edge ids differ from the recompute's")
    return vals, hists, valid


def affinity_multicut_phase(affs: np.ndarray, work: str, card: str) -> dict:
    """Phase 14: ``MulticutSegmentationWorkflow`` from affinities (the first
    ``SHALLOW_Z`` planes of phase 12's, a cut for the script's time) on the
    ``cuda`` target: the boundary-convention nearest-neighbour
    affinities ``255 -`` phase 12's channels 0-2 (offsets ``AFF_MC_OFFSETS``,
    uint8 raw n5, chunks (3, 32, 256, 256)); blocks (32, 256, 256), n_scales
    1, ``sanity_checks``; the watershed over channels 0-3, mean, threshold
    ``AFF_WS_THRESHOLD`` (kernels 2 and 1 on a 4d input); the ``offsets``
    features.  Gates: kernels 2 and 1
    launched, all on the cluster route; ``CheckSubGraphsTask`` found no
    failed block; blocks first and last of the watershed re-run through the
    plain versions equal it; their saved feature chunks equal
    ``affinity_edge_features`` recomputed on the host from the stored
    inputs; the output is its table applied to the watershed, with between
    1 and the fragment count segments."""
    from cluster_tools_tpu_torch import MulticutSegmentationWorkflow, build
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.ops.multicut import multicut_energy
    from cluster_tools_tpu_torch.ops.rag import HIST_BINS, affinity_edge_features
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks.debugging import FAILED_SUBGRAPH_BLOCKS_NAME
    from cluster_tools_tpu_torch.tasks.graph import read_block_with_upper_halo
    from cluster_tools_tpu_torch.tasks.multicut import ASSIGNMENTS_NAME
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    if mws_offsets()[:3] != AFF_MC_OFFSETS:
        raise AssertionError(f"phase 12's channels 0-2 are not {AFF_MC_OFFSETS}")
    t0 = time.perf_counter()
    aff3 = 255 - affs[:3]
    path = os.path.join(work, "affs_mc.n5")
    file_reader(path).create_dataset("affs", data=aff3, chunks=AFF_MC_CHUNKS, compression="raw")
    log(f"setup: boundary affinities {aff3.shape} uint8 written as raw n5 in "
        f"{time.perf_counter() - t0:.1f} s")
    shape = aff3.shape[1:]
    config_dir, tmp = os.path.join(work, "configs_mc_aff"), os.path.join(work, "tmp_mc_aff")
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": "cuda",
        "max_jobs": min(8, os.cpu_count() or 1),
    })
    ws_conf = WatershedTask.default_task_config()
    ws_conf.update({"channel_begin": 0, "channel_end": 3, "agglomerate_channels": "mean",
                    "threshold": AFF_WS_THRESHOLD})
    cfg.write_config(config_dir, "watershed", ws_conf)
    cfg.write_config(config_dir, "block_edge_features", {"offsets": AFF_MC_OFFSETS})
    wf = MulticutSegmentationWorkflow(
        tmp, config_dir, input_path=path, input_key="affs", ws_path=path, ws_key="ws",
        output_path=path, output_key="seg", n_scales=1, sanity_checks=True,
    )
    reset_counts(dtws_slices, flood_slices)
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("affinity multicut build failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vox = int(np.prod(shape))
    launches = {"dtws_slices": dtws_slices.launches, "flood_slices": flood_slices.launches}
    for name, wrapper in (("dtws_slices", dtws_slices), ("flood_slices", flood_slices)):
        if wrapper.launches == 0:
            raise AssertionError(f"the affinity multicut never launched {name}")
        if wrapper.launches_by_route["cluster"] != wrapper.launches:
            raise AssertionError(f"{name}: launches off the cluster route {wrapper.launches_by_route}")
    log(f"affinity multicut: {shape} in {wall:.2f} s = {vox / wall:.6g} voxels/s on {card}; "
        f"launches {launches}, all down the cluster route")
    task_seconds(wf, "affinity multicut")
    failed = np.load(os.path.join(tmp, FAILED_SUBGRAPH_BLOCKS_NAME))
    if failed.size:
        raise AssertionError(f"check_sub_graphs: failed blocks {failed[:10]}")

    t0 = time.perf_counter()
    blocking = Blocking(shape, BLOCK)
    check_ids = [0, blocking.n_blocks - 1]
    ws_task = WatershedTask(tmp, config_dir, input_path=path, input_key="affs",
                            output_path=path, output_key="ws")
    check_watershed_blocks(ws_task, path, "ws", blocking, check_ids)
    f = file_reader(path, "r")
    for bid in check_ids:
        block = blocking.block(bid)
        seg = read_block_with_upper_halo(f["ws"], blocking, bid).astype(np.uint64)
        end = tuple(min(e + 1, s) for e, s in zip(block.end, shape))
        bb = tuple(slice(b, e) for b, e in zip(block.begin, end))
        data = aff3[(slice(None),) + bb].astype(np.float64) / 255.0
        edges, feats, hists = affinity_edge_features(
            seg, data, AFF_MC_OFFSETS, hist_bins=HIST_BINS, owner_shape=block.shape)
        vals, saved_hists, valid = saved_block_features(tmp, bid, edges)
        if not (np.array_equal(vals, feats[valid])
                and np.array_equal(saved_hists, hists[valid].reshape(-1))):
            raise AssertionError(f"affinity multicut block {bid}: saved features differ from "
                                 "the host recompute")
    log(f"affinity multicut: watershed blocks {check_ids} equal their plain re-run; their saved "
        f"features equal affinity_edge_features on the host ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    table = np.load(os.path.join(tmp, ASSIGNMENTS_NAME))
    run = {"table": table, "key": "seg"}
    cont = check_segmentations(path, "ws", {"affinity": run}, blocking)
    scratch = file_reader(os.path.join(tmp, "data.zarr"), "r")
    edges = scratch["graph/edges"][:]
    costs = np.load(os.path.join(tmp, "costs.npy"))
    energy = multicut_energy(edges, costs, table[:, 1].astype(np.int64))
    log(f"affinity multicut: {cont['n_fragments']} fragments, {edges.shape[0]} edges, "
        f"{run['n_segments']} segments; the output is its table applied to the watershed "
        f"(checked in {time.perf_counter() - t0:.1f} s); energy {energy:.6g}, attractive share "
        f"{float((costs > 0).mean()):.4f}")
    return {"wall": wall, "rate": vox / wall, "shape": shape, "launches": launches, "path": path,
            "tmp": tmp, "config_dir": config_dir, "n_fragments": cont["n_fragments"]}


def solutions_phase(mc: dict, card: str) -> dict:
    """Phase 15: ``SubSolutionsWorkflow`` and ``ReducedSolutionWorkflow`` at
    scale 1 in phase 14's tmp folder (its scale-0 solve and reduce are
    reused).  Gates (the JAX package's workflow tests): within the first
    and last scale-1 blocks each fragment maps to one sub-solution id; the
    reduced output is its table applied to the watershed, a coarsening with
    1 < segments < fragments."""
    from cluster_tools_tpu_torch import build
    from cluster_tools_tpu_torch.tasks.multicut import reduced_assignments_name
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking
    from cluster_tools_tpu_torch.workflows import ReducedSolutionWorkflow, SubSolutionsWorkflow

    path, tmp, config_dir = mc["path"], mc["tmp"], mc["config_dir"]
    vox = int(np.prod(mc["shape"]))
    walls = {}
    for tag, cls, key in (("sub", SubSolutionsWorkflow, "subsol"),
                          ("reduced", ReducedSolutionWorkflow, "redsol")):
        wf = cls(tmp, config_dir, ws_path=path, ws_key="ws", output_path=path, output_key=key,
                 n_scales=1)
        t0 = time.perf_counter()
        if not build([wf]):
            raise AssertionError(f"{tag} solution build failed")
        walls[tag] = time.perf_counter() - t0
        log(f"{tag} solution: {mc['shape']} in {walls[tag]:.2f} s = {vox / walls[tag]:.6g} "
            f"voxels/s on {card}")
        task_seconds(wf, f"{tag} solution")
    t0 = time.perf_counter()
    f = file_reader(path, "r")
    coarse = Blocking(mc["shape"], [2 * b for b in BLOCK])
    for bid in (0, coarse.n_blocks - 1):
        bb = coarse.block(bid).slicing
        ws, sub = f["ws"][bb], f["subsol"][bb]
        fg = ws > 0
        if (sub[~fg] != 0).any() or (sub[fg] == 0).any():
            raise AssertionError(f"sub solution block {bid}: background not kept")
        key = ws[fg] * np.uint64(int(sub.max()) + 1) + sub[fg]
        if np.unique(key).size != np.unique(ws[fg]).size:
            raise AssertionError(f"sub solution block {bid}: a fragment maps to two ids")
    table = np.load(os.path.join(tmp, reduced_assignments_name(1)))
    run = {"table": table, "key": "redsol"}
    check_segmentations(path, "ws", {"reduced": run}, Blocking(mc["shape"], BLOCK))
    log(f"solutions: each fragment one sub-solution id in scale-1 blocks 0 and "
        f"{coarse.n_blocks - 1}; the reduced labelling is its table applied to the watershed, "
        f"{run['n_segments']} segments of {mc['n_fragments']} fragments (checked in "
        f"{time.perf_counter() - t0:.1f} s)")
    return walls


def filter_bank_phase(vol_np, work: str, card: str, quantile_mode=FILTER_QUANTILE_MODE) -> dict:
    """Phase 16 on the first ``FILTER_Z`` planes over an ROI of
    ``FILTER_ROI_BLOCKS`` blocks in y and x (the rest of the full-width
    volume stays unwritten): ``MulticutSegmentationWorkflow`` with the
    filter bank (all four filters,
    sigma 1.6, halo [6, 6, 6]; ``quantile_mode`` as given, None for the
    task's default, which for the filter bank is the exact raw-sample
    merge), then ``ImageFilterTask``
    (hessian eigenvalues, sigma 1.6), then ``RegionFeaturesTask`` +
    ``MergeRegionFeaturesTask`` over the multicut's watershed and the
    boundary map.  Gates: the filter bank launched; on the whole halo'd
    read of block 0 (the one ``ImageFilterTask`` reuses) the card's
    responses equal the port's on the CPU — exactly for the gaussian,
    gradient magnitude and LoG, within 1e-5·max|H| for the eigenvalues; its
    saved features (and, in the exact mode, raw samples) equal
    ``filter_edge_features`` on the host over the card's responses within
    1e-6; the image filter's eigenvalues finite
    and descending, its block 0 (the same halo'd read) within 1e-5·max|H| of
    the CPU's; region counts, minima and maxima equal a numpy group-by,
    means within rtol 1e-4."""
    from cluster_tools_tpu_torch import MulticutSegmentationWorkflow, build
    from cluster_tools_tpu_torch.ops import filters as F
    from cluster_tools_tpu_torch.ops import segment
    from cluster_tools_tpu_torch.ops.rag import filter_edge_features
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import (
        BlockEdgeFeaturesTask, ImageFilterTask, MergeRegionFeaturesTask, RegionFeaturesTask)
    from cluster_tools_tpu_torch.tasks.features import FEATURE_SAMPLES_KEY, quantile_plan
    from cluster_tools_tpu_torch.tasks.graph import read_block_with_upper_halo
    from cluster_tools_tpu_torch.tasks.region_features import load_region_features
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking, blocks_in_volume

    z = min(FILTER_Z, vol_np.shape[0])
    raw = np.ascontiguousarray(vol_np[:z])
    shape = raw.shape
    vox = int(np.prod(shape))
    path = os.path.join(work, "filters.n5")
    file_reader(path).create_dataset("raw", data=raw, chunks=BLOCK, compression="raw")
    config_dir, tmp = os.path.join(work, "configs_filters"), os.path.join(work, "tmp_filters")
    roi_end = [z] + [n * b for n, b in zip(FILTER_ROI_BLOCKS, BLOCK[1:])]
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": "cuda",
        "max_jobs": min(8, os.cpu_count() or 1), "roi_begin": [0, 0, 0], "roi_end": roi_end,
    })
    cfg.write_config(config_dir, "watershed", WatershedTask.default_task_config())
    features = {"filters": list(F.FILTERS), "sigmas": [FILTER_SIGMA], "halo": FILTER_HALO}
    if quantile_mode is not None:
        features["quantile_mode"] = quantile_mode
    cfg.write_config(config_dir, "block_edge_features", features)
    wf = MulticutSegmentationWorkflow(
        tmp, config_dir, input_path=path, input_key="raw", ws_path=path, ws_key="ws",
        output_path=path, output_key="seg")
    reset_counts(F.apply_filter)
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("filter-bank multicut build failed")
    torch.cuda.synchronize()
    walls = {"multicut": time.perf_counter() - t0}
    launches = {"apply_filter": F.apply_filter.launches}
    blocking = Blocking(shape, BLOCK)
    roi_blocks = blocks_in_volume(shape, BLOCK, [0, 0, 0], roi_end)
    if launches["apply_filter"] != len(F.FILTERS) * len(roi_blocks):
        raise AssertionError(f"the filter bank launched {launches['apply_filter']} times, not "
                             f"{len(F.FILTERS)} per block of the ROI")
    vox = int(np.prod(roi_end))
    log(f"filter-bank multicut: {shape}, ROI {roi_end} ({len(roi_blocks)} blocks) in "
        f"{walls['multicut']:.2f} s = {vox / walls['multicut']:.6g} voxels/s on {card}; "
        f"filter launches {launches}")
    task_seconds(wf, "filter-bank multicut")

    # the card's responses against the CPU's, then the saved features
    t0 = time.perf_counter()
    task = BlockEdgeFeaturesTask(tmp, config_dir, input_path=path, input_key="raw",
                                 labels_path=path, labels_key="ws")
    config = {**task.global_config(), **task.get_task_config()}
    f = file_reader(path, "r")
    exact, _ = quantile_plan(features)
    if exact:
        saved_samples = file_reader(os.path.join(tmp, "data.zarr"), "r")[FEATURE_SAMPLES_KEY]
    errs = {name: 0.0 for name in F.FILTERS}
    regions, cpu_s = {}, 0.0
    for bid in (0,):
        block = blocking.block(bid)
        ob = [max(b - h, 0) for b, h in zip(block.begin, FILTER_HALO)]
        oe = [min(e + h + 1, s) for e, h, s in zip(block.end, FILTER_HALO, shape)]
        x = np.ascontiguousarray(raw[tuple(slice(b, e) for b, e in zip(ob, oe))])
        x_card = torch.from_numpy(x).cuda()
        for name in F.FILTERS:
            card_r = F.apply_filter(x_card, name, FILTER_SIGMA).cpu().numpy()
            t1 = time.perf_counter()
            cpu_r = F.apply_filter(torch.from_numpy(x), name, FILTER_SIGMA).numpy()
            cpu_s += time.perf_counter() - t1
            err = float(np.abs(card_r - cpu_r).max())
            errs[name] = max(errs[name], err)
            if name == "hessianOfGaussianEigenvalues":
                regions[bid] = (ob, oe, cpu_r)
                if err > 1e-5 * float(np.abs(cpu_r).max()):
                    raise AssertionError(f"block {bid}: card eigenvalues off the CPU's by {err}")
            elif not np.array_equal(card_r, cpu_r):
                raise AssertionError(f"block {bid}: card {name} differs from the CPU's ({err})")
        seg = read_block_with_upper_halo(f["ws"], blocking, bid).astype(np.uint64)
        responses = task._filter_responses(blocking, bid, config)
        edges, feats, samples = filter_edge_features(
            seg, responses, owner_shape=block.shape, return_samples=True)
        vals, _, valid = saved_block_features(tmp, bid, edges)
        err = float(np.abs(vals - feats[valid]).max(initial=0.0))
        if vals.shape != feats[valid].shape or err > 1e-6:
            raise AssertionError(f"filter features block {bid}: saved partial off the host "
                                 f"recompute by {err}")
        if exact:
            counts = feats[:, -1].astype(np.int64)
            kept = samples.reshape(len(responses), -1)[:, np.repeat(valid, counts)].reshape(-1)
            if not np.array_equal(saved_samples.read_chunk((bid,)), kept):
                raise AssertionError(f"filter features block {bid}: saved raw samples differ "
                                     "from the host recompute")
    log(f"filter bank ({quantile_mode or 'default'} quantile mode): card vs CPU on the whole "
        f"halo'd block 0, max abs err {errs} (the CPU's responses "
        f"{cpu_s:.1f} s); saved features{' and raw samples' if exact else ''} equal the host "
        f"recompute ({time.perf_counter() - t0:.1f} s)")

    # ImageFilterTask
    hess = ImageFilterTask(tmp, config_dir, input_path=path, input_key="raw", output_path=path,
                           output_key="hessian", filter_name="hessianOfGaussianEigenvalues",
                           sigma=FILTER_SIGMA)
    t0 = time.perf_counter()
    if not build([hess]):
        raise AssertionError("image filter build failed")
    torch.cuda.synchronize()
    walls["image_filter"] = time.perf_counter() - t0
    out = f["hessian"][:]
    if out.shape != (3,) + shape or not np.isfinite(out).all() \
            or not ((out[0] >= out[1]).all() and (out[1] >= out[2]).all()):
        raise AssertionError("image filter: eigenvalues not finite and descending")
    # block 0's halo'd read is the one the bank was compared on (at its
    # origin, the task's halo of 7 and the bank's 6 + 1 end alike), so the
    # CPU's eigenvalues from there are block 0's reference
    bh = blocking.block_with_halo(0, hess.halo)
    ob, oe, cpu_r = regions[0]
    if list(bh.outer.begin) != ob or list(bh.outer.end) != oe:
        raise AssertionError(f"image filter: block 0 reads {bh.outer} and not {ob}..{oe}")
    inner = blocking.block(0).slicing
    cpu_r = np.moveaxis(cpu_r, -1, 0)[(slice(None),) + inner]
    got = out[(slice(None),) + inner]
    err = float(np.abs(got - cpu_r).max())
    if err > 1e-5 * float(np.abs(cpu_r).max()):
        raise AssertionError(f"image filter: block 0 off the CPU's by {err}")
    log(f"image filter: ROI {roi_end} in {walls['image_filter']:.2f} s = "
        f"{vox / walls['image_filter']:.6g} voxels/s on {card}; eigenvalues finite and "
        f"descending; block 0 max abs err {err} against the CPU")

    # region features
    counts = {name: 0 for name in ("segment_count", "segment_sum", "segment_min", "segment_max")}
    reset_counts(*(getattr(segment, n) for n in counts))
    block = RegionFeaturesTask(tmp, config_dir, input_path=path, input_key="raw",
                               labels_path=path, labels_key="ws")
    merge = MergeRegionFeaturesTask(tmp, config_dir, dependencies=[block], input_path=path,
                                    input_key="raw")
    t0 = time.perf_counter()
    if not build([merge]):
        raise AssertionError("region features build failed")
    torch.cuda.synchronize()
    walls["region_features"] = time.perf_counter() - t0
    counts = {n: getattr(segment, n).launches for n in counts}
    if not all(counts.values()):
        raise AssertionError(f"region features: a reduction never launched {counts}")
    t0 = time.perf_counter()
    feats = load_region_features(tmp)
    ws_all = f["ws"][:]
    unit = int(np.prod(BLOCK))
    n_seg = 0
    worst = 0.0
    for bid in range(blocking.n_blocks):
        bb = blocking.block(bid).slicing
        lab = ws_all[bb].reshape(-1)
        val = raw[bb].reshape(-1).astype(np.float64)
        sel = lab > 0
        local = (lab[sel] - np.uint64(bid * unit)).astype(np.int64)
        v = val[sel]
        cnt = np.bincount(local, minlength=unit + 1)
        mean = np.bincount(local, weights=v, minlength=unit + 1) / np.maximum(cnt, 1)
        mn = np.full(unit + 1, np.inf)
        mx = np.full(unit + 1, -np.inf)
        np.minimum.at(mn, local, v)
        np.maximum.at(mx, local, v)
        present = np.nonzero(cnt)[0]
        got = feats[present + bid * unit]
        if not (np.array_equal(got[:, 0], cnt[present])
                and np.array_equal(got[:, 2], mn[present])
                and np.array_equal(got[:, 3], mx[present])):
            raise AssertionError(f"region features block {bid}: counts, minima or maxima differ")
        rel = np.abs(got[:, 1] - mean[present]) / np.maximum(np.abs(mean[present]), 1e-12)
        worst = max(worst, float(rel.max(initial=0.0)))
        n_seg += present.size
    if worst > 1e-4:
        raise AssertionError(f"region features: a mean off numpy's by rtol {worst}")
    log(f"region features: ROI {roi_end} in {walls['region_features']:.2f} s = "
        f"{vox / walls['region_features']:.6g} voxels/s on {card}; reductions {counts}; "
        f"{n_seg} segments: counts, minima, maxima equal numpy's, means within rtol {worst:.3g} "
        f"(checked in {time.perf_counter() - t0:.1f} s)")
    return {"walls": walls, "shape": shape, "roi_shape": tuple(roi_end), "launches": launches,
            "segment_launches": counts, "raw": raw, "ws": ws_all}


def affinity_tasks_phase(affs: np.ndarray, vol_np, seeds_path: str, work: str, card: str) -> dict:
    """Phase 17 on the first ``FEATURE_Z`` planes at full width, the
    ``cuda`` target, 8 host threads: ``InsertAffinitiesTask`` on phase 12's
    8 channels at their offsets, the objects phase 6's seeds (the components
    of ``vol < 0.3``) left of x = ``OBJECTS_X``, refit with
    ``INSERT_CONFIG``; ``GradientsTask`` on the
    boundary map; ``EmbeddingDistancesTask`` with the 8 affinity channels
    taken as an embedding.  Gates: the 3d flood (the objects' refit)
    launched; blocks whose halo'd read holds no object are copied
    unchanged; blocks 0, 1 and the last of each output equal the port's
    recompute on the CPU (``"device": "cpu"``, a block list): byte for byte
    for the uint8 affinities, within 1e-6 of each block's largest value for
    the float ones."""
    import json as _json

    from cluster_tools_tpu_torch import build
    from cluster_tools_tpu_torch.ops import affinities as A
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_volume
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import EmbeddingDistancesTask, GradientsTask, InsertAffinitiesTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    z = min(FEATURE_Z, vol_np.shape[0])
    t0 = time.perf_counter()
    path = os.path.join(work, "aff_tasks.n5")
    fw = file_reader(path)
    a = np.ascontiguousarray(affs[:, :z])
    fw.create_dataset("affs", data=a, chunks=AFF_CHUNKS, compression="raw")
    objs = file_reader(seeds_path, "r")["seg_seeds"][:z]
    objs[..., OBJECTS_X:] = 0
    fw.create_dataset("objs", data=objs, chunks=BLOCK, compression="raw")
    fw.create_dataset("raw", data=np.ascontiguousarray(vol_np[:z]), chunks=BLOCK, compression="raw")
    for c in range(a.shape[0]):
        fw.create_dataset(f"emb{c}", data=a[c], chunks=BLOCK, compression="raw")
    shape = a.shape[1:]
    vox = int(np.prod(shape))
    log(f"setup: affinity-task inputs {shape} written in {time.perf_counter() - t0:.1f} s; "
        f"{len(np.unique(objs)) - 1} objects")

    def tasks(tmp, config_dir, suffix=""):
        return {
            "insert_affinities": InsertAffinitiesTask(
                tmp, config_dir, input_path=path, input_key="affs", output_path=path,
                output_key="ins" + suffix, objects_path=path, objects_key="objs",
                offsets=mws_offsets()),
            "gradients": GradientsTask(
                tmp, config_dir, input_paths=[path], input_keys=["raw"], output_path=path,
                output_key="grad" + suffix),
            "embedding_distances": EmbeddingDistancesTask(
                tmp, config_dir, input_paths=[path] * a.shape[0],
                input_keys=[f"emb{c}" for c in range(a.shape[0])], output_path=path,
                output_key="dist" + suffix),
        }

    config_dir, tmp = os.path.join(work, "configs_aff_tasks"), os.path.join(work, "tmp_aff_tasks")
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": "cuda",
        "max_jobs": min(8, os.cpu_count() or 1),
    })
    cfg.write_config(config_dir, "insert_affinities", INSERT_CONFIG)
    reset_counts(flood_volume, A.binary_dilation)
    walls = {}
    for name, task in tasks(tmp, config_dir).items():
        t0 = time.perf_counter()
        if not build([task]):
            raise AssertionError(f"{name} build failed")
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        log(f"{name}: {shape} in {walls[name]:.2f} s = {vox / walls[name]:.6g} voxels/s on {card}")
        task_seconds(task, name)
    launches = {"flood_volume": flood_volume.launches, "binary_dilation": A.binary_dilation.launches}
    if launches["flood_volume"] == 0:
        raise AssertionError("insert_affinities never launched the 3d flood")
    blocking = Blocking(shape, BLOCK)
    f = file_reader(path, "r")
    ins = f["ins"][:]
    task = tasks(tmp, config_dir)["insert_affinities"]
    halo = task._halo({**task.global_config(), **task.get_task_config()})
    empty = [bid for bid in range(blocking.n_blocks)
             if not objs[blocking.block_with_halo(bid, halo).outer.slicing].any()]
    if not empty or len(empty) == blocking.n_blocks:
        raise AssertionError(f"insert_affinities: {len(empty)} blocks without objects")
    for bid in empty:
        inner = (slice(None),) + blocking.block(bid).slicing
        if not np.array_equal(ins[inner], a[inner]):
            raise AssertionError(f"insert_affinities block {bid}: no objects, not copied")
    if np.array_equal(ins, a):
        raise AssertionError("insert_affinities changed nothing")
    log(f"affinity tasks: launches {launches}; {len(empty)} blocks without objects copied "
        f"unchanged")

    # the port's recompute on the CPU of blocks 0 and 1 (both with objects)
    # and the last one
    check_ids = [0, 1, blocking.n_blocks - 1]
    cpu_dir, cpu_tmp = os.path.join(work, "configs_aff_cpu"), os.path.join(work, "tmp_aff_cpu")
    block_list = os.path.join(work, "aff_check_blocks.json")
    with open(block_list, "w") as fh:
        _json.dump(check_ids, fh)
    cfg.write_global_config(cpu_dir, {
        "block_shape": list(BLOCK), "target": "local", "device": "cpu", "max_jobs": 2,
        "block_list_path": block_list,
    })
    cfg.write_config(cpu_dir, "insert_affinities", INSERT_CONFIG)
    t0 = time.perf_counter()
    if not build(list(tasks(cpu_tmp, cpu_dir, "_cpu").values())):
        raise AssertionError("affinity tasks: the CPU recompute failed")
    errs = {}
    for key in ("ins", "grad", "dist"):
        card_ds, cpu_ds = f[key], f[key + "_cpu"]
        lead = (slice(None),) * (card_ds.ndim - 3)
        for bid in check_ids:
            bb = lead + blocking.block(bid).slicing
            got, want = card_ds[bb], cpu_ds[bb]
            if got.dtype == np.uint8:
                if not np.array_equal(got, want):
                    raise AssertionError(f"{key} block {bid}: the card differs from the CPU")
                errs[key] = 0
            else:
                err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
                errs[key] = max(errs.get(key, 0.0), err)
                if err > 1e-6:
                    raise AssertionError(f"{key} block {bid}: off the CPU by {err}")
    log(f"affinity tasks: blocks {check_ids} equal the port's CPU recompute (uint8 exactly, "
        f"float relative max err {errs}; {time.perf_counter() - t0:.1f} s)")
    return {"walls": walls, "shape": shape, "launches": launches, "affs": a, "path": path,
            "halo": halo}


def slice_device_functions(fb: dict, at: dict, card: str) -> list:
    """The plain PyTorch device functions of phases 16-17 timed on the card
    at their workflow shapes (CUDA events, ``cuda_ms``): the filter bank on
    block 1's halo'd read (its four filters; ``torch.linalg.eigvalsh`` of
    the hessians alone, with its workspace), the region features'
    reductions on block 1, one channel's in-plane dilation on block 1's
    halo'd read.  Bounds: bytes (inputs read once, outputs written once)
    over 3.35 TB/s against float32 operations over 67 TFLOP/s — the bank
    2 per tap of each separable pass and ~60 per eigen solve, the
    dilation 2 iterations x 4 neighbours."""
    from cluster_tools_tpu_torch.ops import affinities as A
    from cluster_tools_tpu_torch.ops import filters as F
    from cluster_tools_tpu_torch.ops import segment
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    def bound(nbytes, ops):
        b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (b, "bytes") if b >= o else (o, "operations")

    blocking = Blocking(fb["shape"], BLOCK)
    block = blocking.block(1)
    ob = [max(b - h, 0) for b, h in zip(block.begin, FILTER_HALO)]
    oe = [min(e + h + 1, s) for e, h, s in zip(block.end, FILTER_HALO, fb["shape"])]
    x = torch.from_numpy(fb["raw"][tuple(slice(b, e) for b, e in zip(ob, oe))]).cuda()
    v = x.numel()
    before = F.apply_filter.launches
    bank_ms = cuda_ms(lambda: [F.apply_filter(x, name, FILTER_SIGMA) for name in F.FILTERS], 5)
    F.apply_filter.launches = before
    taps = len(F.gauss_kernel(FILTER_SIGMA))
    passes = 3 + 9 + 9 + 18  # gaussian, gradient magnitude, LoG, hessian (per axis)
    ops = v * (2 * taps * passes + 60)
    nbytes = v * 4 * (len(F.FILTERS) + 1 + 1 + 1 + 3)
    hess = [F._separable(x, FILTER_SIGMA, [(1 if ax == i else 0) + (1 if ax == j else 0)
                                          for ax in range(3)])
            for i in range(3) for j in range(i, 3)]
    h = torch.stack([hess[0], hess[1], hess[2], hess[1], hess[3], hess[4], hess[2], hess[4],
                     hess[5]], dim=-1).reshape(x.shape + (3, 3))
    del hess
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eig = F.eigenvalues_descending(h)
    torch.cuda.synchronize()
    # beyond the result and its flipped copy
    workspace = max(torch.cuda.max_memory_allocated() - base - 2 * eig.numel() * eig.element_size(), 0)
    del eig
    eig_ms = cuda_ms(lambda: F.eigenvalues_descending(h), 3)
    del h
    b_ms, b_by = bound(nbytes, ops)
    records = [{
        "name": "filter_bank (apply_filter x 4: gaussian, gradient magnitude, LoG, hessian "
                "eigenvalues; sigma 1.6)",
        "shape": list(x.shape), "ms": bank_ms / len(F.FILTERS), "block_ms": bank_ms,
        "launches": fb["launches"]["apply_filter"], "bound_ms": b_ms / len(F.FILTERS),
        "bound_by": b_by, "eigvalsh_ms": eig_ms, "eigvalsh_workspace_bytes": int(workspace),
    }]
    del x
    torch.cuda.empty_cache()

    bb = block.slicing
    lab = fb["ws"][bb]
    ids = np.unique(lab[lab > 0])
    local = np.searchsorted(ids, lab).clip(0, ids.size - 1)
    local = np.where((lab > 0) & (lab == ids[local]), local + 1, 0)
    lab_d = torch.from_numpy(local.astype(np.int64).reshape(-1)).cuda()
    val_d = torch.from_numpy(fb["raw"][bb].reshape(-1)).cuda()
    k = ids.size + 1
    saved = {n: getattr(segment, n).launches for n in fb["segment_launches"]}

    def reductions():
        return (segment.segment_count(lab_d, k), segment.segment_mean(lab_d, val_d, k),
                segment.segment_min(lab_d, val_d, k), segment.segment_max(lab_d, val_d, k))

    red_ms = cuda_ms(reductions, 10)
    for n, c in saved.items():
        getattr(segment, n).launches = c
    n_calls = 5  # count, mean (a sum and a count), min, max
    b_ms, b_by = bound(lab_d.numel() * (8 * n_calls + 4 * 4), 0)
    records.append({
        "name": "segment reductions (count, sum, min, max; region features)",
        "shape": list(lab.shape), "segments": int(ids.size), "ms": red_ms / n_calls,
        "block_ms": red_ms, "launches": int(sum(fb["segment_launches"].values())),
        "bound_ms": b_ms / n_calls, "bound_by": b_by,
    })
    del lab_d, val_d

    bh = Blocking(at["shape"], BLOCK).block_with_halo(1, at["halo"])
    m = torch.from_numpy(at["affs"][(0,) + bh.outer.slicing] > 127).cuda()
    before = A.binary_dilation.launches
    dil_ms = cuda_ms(lambda: A.binary_dilation(m, 2, in_2d=True), 10)
    A.binary_dilation.launches = before
    b_ms, b_by = bound(2 * m.numel(), 2 * 4 * m.numel())
    records.append({
        "name": "binary_dilation (insert_affinities: 2 iterations in plane)",
        "shape": list(m.shape), "ms": dil_ms, "launches": at["launches"]["binary_dilation"],
        "bound_ms": b_ms, "bound_by": b_by,
    })
    for rec in records:
        rec["gap_ms"] = rec["ms"] - rec["bound_ms"]
        rec["launches_x_gap_ms"] = rec["launches"] * rec["gap_ms"]
        log(f"device function on {card}: {rec}")
    return records


# -- phases 18-20: label bookkeeping, postprocessing, stitching ------------------
# On the first EARLY_Z planes at full width: 50 blocks in two block layers, so
# stitching sees z faces as well as y and x faces.  The label input is phase
# 3's watershed, its first EARLY_Z planes copied into the cut container as
# ``ws``; the workflows run in one tmp folder (``tmp_labels``) where they can
# share what is complete (the morphology, the size filter, the problem graph,
# its features and costs), in folders of their own where task names would
# collide (two relabels, two block filters, two stitching writes).
MIN_SIZE_PERCENTILE = 30  # of the fragment sizes: the size filters' min_size


def slice_threads() -> int:
    return min(8, os.cpu_count() or 1)


def over_blocks(fn, blocking) -> list:
    """``fn(block_id)`` for every block over ``slice_threads()`` host
    threads (numpy and the chunk codecs release the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(slice_threads()) as pool:
        return list(pool.map(fn, range(blocking.n_blocks)))


def read_volume(ds, blocking) -> np.ndarray:
    """The blocks of ``blocking`` (the whole dataset, or its first planes)
    read over host threads."""
    out = np.empty(tuple(blocking.shape), dtype=ds.dtype)

    def one(bid):
        bb = blocking.block(bid).slicing
        out[bb] = ds[bb]

    over_blocks(one, blocking)
    return out


def check_applied(ws: np.ndarray, out: np.ndarray, table: np.ndarray, blocking, what: str,
                  identity: bool = False) -> None:
    """``out`` must be the (id, new id) ``table`` applied to the block-offset
    ``ws``: checked block by block through a dense lookup over the block's
    offset range; ids absent from the table keep themselves (``identity``)
    or become 0, as the write task's ``table_default`` says."""
    unit = int(np.prod(BLOCK))
    table = table[np.argsort(table[:, 0], kind="stable")].astype(np.uint64)
    zero = table[table[:, 0] == 0]

    def one(bid):
        bb = blocking.block(bid).slicing
        base = bid * unit
        local = local_ids(ws[bb], bid, unit)
        lut = (np.arange(unit + 1, dtype=np.uint64) + np.uint64(base) if identity
               else np.zeros(unit + 1, dtype=np.uint64))
        lut[0] = zero[0, 1] if zero.size else 0
        lo, hi = np.searchsorted(table[:, 0], [base + 1, base + unit + 1])
        lut[(table[lo:hi, 0] - np.uint64(base)).astype(np.int64)] = table[lo:hi, 1]
        if not np.array_equal(out[bb], lut[local]):
            raise AssertionError(f"{what}: block {bid} is not its table applied to the watershed")

    over_blocks(one, blocking)


def slice_config(work: str, tag: str) -> str:
    """A config dir of the new phases: the ``cuda`` target, 8 host threads."""
    from cluster_tools_tpu_torch.runtime import config as cfg

    config_dir = os.path.join(work, f"configs_{tag}")
    cfg.write_global_config(config_dir, {
        "block_shape": list(BLOCK), "target": "cuda", "device": "cuda",
        "max_jobs": slice_threads(),
    })
    return config_dir


def run_workflow(wf, tag: str, vox: int, card: str, walls: dict) -> None:
    """Build ``wf`` on the card; its wall, voxels/s and seconds per task."""
    from cluster_tools_tpu_torch import build

    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError(f"{tag} build failed")
    torch.cuda.synchronize()
    walls[tag] = time.perf_counter() - t0
    log(f"{tag}: {vox} voxels in {walls[tag]:.3f} s = {vox / walls[tag]:.6g} voxels/s on {card}")
    task_seconds(wf, tag)


def bookkeeping_phase(cut_np, path: str, ws_path: str, work: str, card: str, mc: dict) -> dict:
    """Phase 18, label bookkeeping on phase 3's watershed (``ws_path/ws``,
    its first planes copied to ``path/ws``): ``UniqueWorkflow`` and
    ``RelabelWorkflow`` (one tmp folder: the relabel reuses the uniques),
    ``MorphologyWorkflow``, ``BlockNodeLabelsTask`` + ``MergeNodeLabelsTask``
    against phase 8 run 1's segmentation of the whole volume
    (``mc_seg_host``), ``ThresholdTask`` on the boundary map at 0.5, sigma
    0 and 2.
    Gates: the uniques are numpy's; the relabelled volume has ids 1..n and
    is the consecutive map applied to the watershed; the morphology's sizes
    are numpy's bincount, and three fragments' centres of mass (within 1e-9
    voxels) and bounding boxes (exactly) numpy's over the volume; every
    fragment's node label is its segment in phase 8 run 1's table; the
    sigma-0 mask is ``raw > 0.5`` byte for byte, and two blocks of the
    sigma-2 mask equal the port's recompute on the CPU."""
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import BlockNodeLabelsTask, MergeNodeLabelsTask, ThresholdTask
    from cluster_tools_tpu_torch.tasks.morphology import MORPHOLOGY_NAME
    from cluster_tools_tpu_torch.tasks.node_labels import NODE_LABELS_NAME
    from cluster_tools_tpu_torch.tasks.relabel import LABELING_NAME
    from cluster_tools_tpu_torch.tasks.threshold import _threshold_batch
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking
    from cluster_tools_tpu_torch.workflows import MorphologyWorkflow, RelabelWorkflow, UniqueWorkflow

    shape = cut_np.shape
    vox = int(np.prod(shape))
    blocking = Blocking(shape, BLOCK)
    t0 = time.perf_counter()
    ws = read_volume(file_reader(ws_path, "r")["ws"], blocking)
    copy = file_reader(path).create_dataset("ws", shape=shape, dtype="uint64", chunks=BLOCK,
                                            compression="gzip")

    def write(bid):
        bb = blocking.block(bid).slicing
        copy[bb] = ws[bb]

    over_blocks(write, blocking)
    f = file_reader(path, "r")
    frag, sizes, n_bg = fragments_of(ws, blocking)
    log(f"setup: phase 3's watershed on the first {shape[0]} planes copied, {frag.size} "
        f"fragments counted per block, in {time.perf_counter() - t0:.1f} s")
    walls = {}
    config_dir = slice_config(work, "labels")
    tmp = os.path.join(work, "tmp_relabel")
    io = {"input_path": path, "input_key": "ws", "output_path": path}
    run_workflow(UniqueWorkflow(tmp, config_dir, output_key="uniques", **io), "UniqueWorkflow",
                 vox, card, walls)
    run_workflow(RelabelWorkflow(tmp, config_dir, output_key="relabelled", **io),
                 "RelabelWorkflow (uniques reused)", vox, card, walls)
    t0 = time.perf_counter()
    want = np.concatenate([[0], frag]).astype(np.uint64) if n_bg else frag
    if not np.array_equal(f["uniques"][:], want):
        raise AssertionError("UniqueWorkflow: the uniques are not numpy's")
    table = np.load(os.path.join(tmp, LABELING_NAME))
    if not (np.array_equal(table[:, 0], frag)
            and np.array_equal(table[:, 1], np.arange(1, frag.size + 1, dtype=np.uint64))):
        raise AssertionError("RelabelWorkflow: the labelling is not consecutive over the fragments")
    check_applied(ws, read_volume(f["relabelled"], blocking), table, blocking, "RelabelWorkflow")
    log(f"bookkeeping: uniques equal numpy's ({want.size} ids); the relabelled volume has ids "
        f"1..{frag.size}, the consecutive map applied to the watershed (checked in "
        f"{time.perf_counter() - t0:.1f} s)")

    mc_tmp = os.path.join(work, "tmp_labels")
    run_workflow(MorphologyWorkflow(mc_tmp, config_dir, input_path=path, input_key="ws"),
                 "MorphologyWorkflow", vox, card, walls)
    t0 = time.perf_counter()
    morpho = np.load(os.path.join(mc_tmp, MORPHOLOGY_NAME))
    ids = morpho[:, 0].astype(np.uint64)
    nz = ids != 0
    if not (np.array_equal(ids[nz], frag) and np.array_equal(morpho[nz, 1], sizes)):
        raise AssertionError("MorphologyWorkflow: ids or sizes differ from numpy's bincount")
    picks = [int(frag[int(np.argmax(sizes))]), int(frag[frag.size // 2]), int(frag[-1])]
    for pick in picks:
        coords = np.nonzero(ws == np.uint64(pick))
        row = morpho[np.searchsorted(ids, np.uint64(pick))]
        com = np.array([c.mean() for c in coords])
        bb = np.array([c.min() for c in coords] + [c.max() + 1 for c in coords], dtype=np.float64)
        if np.abs(row[2:5] - com).max() > 1e-9 or not np.array_equal(row[5:11], bb):
            raise AssertionError(f"MorphologyWorkflow: fragment {pick}: com {row[2:5]} bb "
                                 f"{row[5:11]}, numpy {com} {bb}")
    log(f"morphology: {ids.size} rows; sizes equal numpy's bincount, fragments {picks}: centres "
        f"of mass within 1e-9 and bounding boxes equal numpy's (checked in "
        f"{time.perf_counter() - t0:.1f} s)")

    block = BlockNodeLabelsTask(mc_tmp, config_dir, input_path=path, input_key="ws",
                                labels_path=mc["path"], labels_key="mc_seg_host")
    merge = MergeNodeLabelsTask(mc_tmp, config_dir, dependencies=[block], input_path=path,
                                input_key="ws")
    run_workflow(merge, "node labels (block + merge)", vox, card, walls)
    labels = np.load(os.path.join(mc_tmp, NODE_LABELS_NAME))
    seg_table = mc["table"]
    if not np.array_equal(labels[labels[:, 0] > 0, 0], frag) or not np.array_equal(
            labels[labels[:, 0] > 0, 1], seg_table[np.searchsorted(seg_table[:, 0], frag), 1]):
        raise AssertionError("node labels: a fragment's label is not its phase 8 segment")
    log(f"node labels: each of {labels.shape[0]} fragments labelled with its segment in phase 8 "
        f"run 1's table")

    raw = cut_np
    for sigma in (0.0, 2.0):
        cfg.write_config(config_dir, "threshold", {"threshold": THRESHOLD, "sigma": sigma})
        key = f"mask_sigma{sigma:g}"
        task = ThresholdTask(os.path.join(work, f"tmp_threshold_{sigma:g}"), config_dir,
                             input_path=path, input_key="raw", output_path=path, output_key=key)
        run_workflow(task, f"ThresholdTask sigma {sigma:g}", vox, card, walls)
        out = read_volume(f[key], blocking)
        if sigma == 0:
            if not np.array_equal(out, (raw > THRESHOLD).astype(np.uint8)):
                raise AssertionError("ThresholdTask sigma 0: not raw > 0.5 byte for byte")
            continue
        for bid in (0, blocking.n_blocks - 1):
            bh = blocking.block_with_halo(bid, [0, 0, 0])
            x = np.zeros(BLOCK, np.float32)
            x[tuple(slice(0, s) for s in bh.outer.shape)] = raw[bh.outer.slicing]
            cpu = _threshold_batch(torch.from_numpy(x)[None], THRESHOLD, "greater", sigma)[0]
            if not np.array_equal(out[bh.inner.slicing], cpu.numpy()[bh.inner_local.slicing]):
                raise AssertionError(f"ThresholdTask sigma {sigma}: block {bid} differs from "
                                     "the CPU's")
    log(f"threshold: sigma 0 equals raw > {THRESHOLD} byte for byte; sigma 2 blocks 0 and "
        f"{blocking.n_blocks - 1} equal the port's CPU recompute")
    return {"walls": walls, "shape": shape, "ws": ws, "frag": frag, "sizes": sizes,
            "morpho": morpho, "config_dir": config_dir, "tmp": mc_tmp}


def postprocess_phase(cut_np, path: str, work: str, card: str, bk: dict) -> dict:
    """Phase 19, the postprocessing workflows on phase 18's watershed,
    ``min_size`` the 30th percentile of the morphology's fragment sizes.
    ``SizeFilterWorkflow`` to background, then with filling over the
    boundary map (``relabel=True``, ``CTT_FLOOD_TILE`` pinned to
    ``FLOOD_TILE``); the problem (graph, boundary features, costs) of the
    watershed; ``SizeFilterAndGraphWatershedWorkflow``,
    ``FilterOrphansWorkflow`` and ``ConnectedComponentsWorkflow`` (all in
    phase 18's tmp folder: morphology, size filter, graph and costs
    reused), ``FilterLabelsWorkflow`` (every tenth fragment) and
    ``FilterByThresholdWorkflow`` (mean boundary value under the fragments'
    median).  Gates: kernel 3 and the 3d flood launched in the filling run,
    once per block with discarded ids; no discarded id left; kept voxels
    keep their ids; the relabelled output is the consecutive map of the
    filled one; two blocks with discarded ids re-run through the plain
    flood on the card equal the output byte for byte; every output is its
    table applied to the watershed; every fragment the graph watershed
    reassigns has a RAG neighbour with its new id.  The kernels' ms at the
    filling filter's shape, with their bounds."""
    from cluster_tools_tpu_torch.ops import cuda_flood
    from cluster_tools_tpu_torch.tasks import FillingSizeFilterTask, ProbsToCostsTask
    from cluster_tools_tpu_torch.tasks.graph import load_graph
    from cluster_tools_tpu_torch.tasks.postprocess import (
        GRAPH_CC_NAME, GRAPH_WS_NAME, ORPHANS_NAME, SIZE_FILTER_DISCARD_NAME)
    from cluster_tools_tpu_torch.tasks.relabel import LABELING_NAME
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking
    from cluster_tools_tpu_torch.workflows import (
        ConnectedComponentsWorkflow, EdgeFeaturesWorkflow, FilterByThresholdWorkflow,
        FilterLabelsWorkflow, FilterOrphansWorkflow, GraphWorkflow,
        SizeFilterAndGraphWatershedWorkflow, SizeFilterWorkflow)

    shape = cut_np.shape
    vox = int(np.prod(shape))
    blocking = Blocking(shape, BLOCK)
    unit = int(np.prod(BLOCK))
    ws, frag, sizes = bk["ws"], bk["frag"], bk["sizes"]
    config_dir, mc_tmp = bk["config_dir"], bk["tmp"]
    f = file_reader(path, "r")
    walls = {}
    min_size = int(np.percentile(bk["morpho"][bk["morpho"][:, 0] > 0, 1], MIN_SIZE_PERCENTILE))
    io = {"input_path": path, "input_key": "ws", "output_path": path}
    run_workflow(SizeFilterWorkflow(mc_tmp, config_dir, output_key="sf_background",
                                    min_size=min_size, **io),
                 "SizeFilterWorkflow background", vox, card, walls)
    discard = np.load(os.path.join(mc_tmp, SIZE_FILTER_DISCARD_NAME)).astype(np.uint64)
    if not np.array_equal(discard, frag[sizes < min_size]):
        raise AssertionError("size filter: the discarded ids are not the fragments under min_size")
    log(f"size filter: min_size {min_size} (the {MIN_SIZE_PERCENTILE}th percentile of the "
        f"fragment sizes) discards {discard.size} of {frag.size} fragments "
        f"({discard.size / frag.size:.4f}), {int(sizes[sizes < min_size].sum())} voxels")
    t0 = time.perf_counter()
    zero_discard = np.stack([discard, np.zeros_like(discard)], axis=1)
    check_applied(ws, read_volume(f["sf_background"], blocking), zero_discard, blocking,
                  "SizeFilterWorkflow background", identity=True)
    log(f"size filter background: no discarded id left, kept voxels unchanged (checked in "
        f"{time.perf_counter() - t0:.1f} s)")

    # the filling filter: kernel 3 and the 3d flood on the card
    reset_counts(cuda_flood.flood_tiles_warm, cuda_flood.flood_volume)
    os.environ["CTT_FLOOD_TILE"] = FLOOD_TILE
    try:
        run_workflow(SizeFilterWorkflow(mc_tmp, config_dir, output_key="sf_filled",
                                        min_size=min_size, hmap_path=path, hmap_key="raw",
                                        relabel=True, **io),
                     "SizeFilterWorkflow filling", vox, card, walls)
    finally:
        del os.environ["CTT_FLOOD_TILE"]
    launches = {"flood_tiles_warm": cuda_flood.flood_tiles_warm.launches,
                "flood_volume": cuda_flood.flood_volume.launches}
    unit_discard = (discard - np.uint64(1)) // np.uint64(unit)
    with_discard = np.unique(unit_discard).astype(np.int64)
    if launches != {"flood_tiles_warm": with_discard.size, "flood_volume": with_discard.size}:
        raise AssertionError(f"filling filter: launches {launches}, not one each per block with "
                             f"discarded ids ({with_discard.size})")
    log(f"filling filter: launches {launches}, one each per block with discarded ids "
        f"({with_discard.size} of {blocking.n_blocks})")
    t0 = time.perf_counter()
    filled = read_volume(f["sf_filled_unrelabeled"], blocking)
    if np.isin(filled, discard).any():
        raise AssertionError("filling filter: a discarded id is left")
    kept = (ws > 0) & ~np.isin(ws, discard)
    if not np.array_equal(filled[kept], ws[kept]):
        raise AssertionError("filling filter: kept voxels changed their ids")
    table = np.load(os.path.join(mc_tmp, LABELING_NAME))
    if not np.array_equal(table[:, 1], np.arange(1, table.shape[0] + 1, dtype=np.uint64)):
        raise AssertionError("filling filter: the relabelling is not consecutive")
    check_applied(filled, read_volume(f["sf_filled"], blocking), table, blocking,
                  "SizeFilterWorkflow filling (relabel)")
    task = FillingSizeFilterTask(
        mc_tmp, config_dir, input_path=path, input_key="ws", output_path=path,
        output_key="sf_filled_plain", hmap_path=path, hmap_key="raw",
        res_path=os.path.join(mc_tmp, SIZE_FILTER_DISCARD_NAME))
    config = {**task.global_config(), **task.get_task_config()}
    task.prepare(blocking, config)
    checks = sorted({int(with_discard[0]), int(with_discard[-1])})
    with plain_kernels():
        for bid in checks:
            task.process_block(bid, blocking, config)
    torch.cuda.synchronize()
    for bid in checks:
        bb = blocking.block(bid).slicing
        if not np.array_equal(f["sf_filled_plain"][bb], filled[bb]):
            raise AssertionError(f"filling filter block {bid}: the plain flood differs")
    log(f"filling filter: no discarded id left, {int(kept.sum())} kept voxels keep their ids, "
        f"the output relabelled to 1..{table.shape[0]}; blocks {checks} re-run through the "
        f"plain flood on the card byte-identical (checked in {time.perf_counter() - t0:.1f} s)")
    kernels = filling_kernels(cut_np, ws, discard, blocking, int(checks[0]), launches, card)

    graph = GraphWorkflow(mc_tmp, config_dir, input_path=path, input_key="ws")
    feats = EdgeFeaturesWorkflow(mc_tmp, config_dir, input_path=path, input_key="raw",
                                 labels_path=path, labels_key="ws", dependencies=[graph])
    run_workflow(ProbsToCostsTask(mc_tmp, config_dir, dependencies=[feats]),
                 "problem (graph, boundary features, costs)", vox, card, walls)

    run_workflow(SizeFilterAndGraphWatershedWorkflow(mc_tmp, config_dir, output_key="sf_graph_ws",
                                                     min_size=min_size, **io),
                 "SizeFilterAndGraphWatershedWorkflow", vox, card, walls)
    t0 = time.perf_counter()
    gtable = np.load(os.path.join(mc_tmp, GRAPH_WS_NAME))
    check_applied(ws, read_volume(f["sf_graph_ws"], blocking), gtable, blocking,
                  "SizeFilterAndGraphWatershedWorkflow", identity=True)
    nodes, edges = load_graph(file_reader(os.path.join(mc_tmp, "data.zarr"), "r"))
    if not np.array_equal(gtable[:, 0], nodes):
        raise AssertionError("graph watershed: the table's rows are not the graph's nodes")
    final = gtable[:, 1]
    same = final[edges[:, 0]] == final[edges[:, 1]]
    has_same = np.zeros(nodes.size, bool)
    has_same[edges[same, 0]] = True
    has_same[edges[same, 1]] = True
    moved = np.isin(nodes, discard) & (final != 0) & (final != nodes)
    if not moved.any() or not has_same[moved].all():
        raise AssertionError("graph watershed: a reassigned fragment has no RAG neighbour with "
                             "its new id")
    log(f"graph watershed: {int(moved.sum())} of {discard.size} discarded fragments reassigned, "
        f"each to the id of a RAG neighbour; the output is its table applied to the watershed "
        f"(checked in {time.perf_counter() - t0:.1f} s)")

    drop = frag[::10]
    run_workflow(FilterLabelsWorkflow(os.path.join(work, "tmp_filter_labels"), config_dir,
                                      output_key="filter_labels", filter_labels=drop.tolist(),
                                      **io), "FilterLabelsWorkflow", vox, card, walls)
    check_applied(ws, read_volume(f["filter_labels"], blocking),
                  np.stack([drop, np.zeros_like(drop)], axis=1), blocking,
                  "FilterLabelsWorkflow", identity=True)

    def block_means(bid):
        bb = blocking.block(bid).slicing
        local = local_ids(ws[bb], bid, unit).reshape(-1)
        s = np.bincount(local, weights=cut_np[bb].reshape(-1).astype(np.float64),
                        minlength=unit + 1)
        c = np.bincount(local, minlength=unit + 1)
        return s[1:][c[1:] > 0] / c[1:][c[1:] > 0]

    threshold = float(np.median(np.concatenate(over_blocks(block_means, blocking))))
    tmp = os.path.join(work, "tmp_filter_threshold")
    run_workflow(FilterByThresholdWorkflow(tmp, config_dir, input_path=path, input_key="raw",
                                           seg_path=path, seg_key="ws", output_path=path,
                                           output_key="filter_threshold", threshold=threshold,
                                           threshold_mode="less", feature="mean"),
                 "FilterByThresholdWorkflow", vox, card, walls)
    ids = np.load(os.path.join(tmp, "feature_filter_ids.npy")).astype(np.uint64)
    check_applied(ws, read_volume(f["filter_threshold"], blocking),
                  np.stack([ids, np.zeros_like(ids)], axis=1), blocking,
                  "FilterByThresholdWorkflow", identity=True)
    log(f"feature filter: mean boundary value under {threshold:.6g} (the fragments' median) "
        f"drops {ids.size} of {frag.size}; FilterLabelsWorkflow drops {drop.size}; each output "
        f"is its table applied to the watershed")

    for tag, cls, name, key in (
            ("FilterOrphansWorkflow", FilterOrphansWorkflow, ORPHANS_NAME, "orphans"),
            ("ConnectedComponentsWorkflow", ConnectedComponentsWorkflow, GRAPH_CC_NAME, "graph_cc")):
        run_workflow(cls(mc_tmp, config_dir, output_key=key, **io), tag, vox, card, walls)
        table = np.load(os.path.join(mc_tmp, name))
        check_applied(ws, read_volume(f[key], blocking), table, blocking, tag, identity=True)
        log(f"{tag}: {len(np.unique(table[:, 1]))} ids for {table.shape[0]} nodes, "
            f"{int((table[:, 0] != table[:, 1]).sum())} changed; the output is its table "
            f"applied to the watershed")
    return {"walls": walls, "shape": shape, "kernels": kernels, "launches": launches}


def filling_kernels(cut_np, ws, discard, blocking, bid: int, launches: dict, card: str) -> list:
    """Kernel 3 and the 3d flood timed on the card at the filling filter's
    call: block ``bid`` (un-halo'd), its kept fragments as compact int32
    seeds, the boundary map as height map, tile ``FLOOD_TILE``; against
    their plain versions on the same inputs.  Bounds: bytes (f32 height
    map, i32 seeds, byte mask in; f32 altitudes, or i32 labels, out; the 3d
    flood also reads the f32 warm start) over 3.35 TB/s."""
    from cluster_tools_tpu_torch.ops import cuda_flood
    from cluster_tools_tpu_torch.ops.watershed import resolve_flood_tile

    bb = blocking.block(bid).slicing
    labels = ws[bb].copy()
    labels[np.isin(labels, discard)] = 0
    uniq = np.unique(labels)
    h = torch.from_numpy(np.ascontiguousarray(cut_np[bb], dtype=np.float32)).cuda()[None]
    s = torch.from_numpy(np.searchsorted(uniq, labels).astype(np.int32)).cuda()[None]
    m = torch.ones_like(h, dtype=torch.bool)
    os.environ["CTT_FLOOD_TILE"] = FLOOD_TILE
    tile = resolve_flood_tile(h.shape[1:])[1:]
    del os.environ["CTT_FLOOD_TILE"]
    hw = h.shape[2:]
    flat = [t.view((-1,) + hw) for t in (h, s, m)]
    before = cuda_flood.flood_tiles_warm.launches, cuda_flood.flood_volume.launches
    warm = cuda_flood.flood_tiles_warm(*flat, tile)
    if not torch.equal(warm, cuda_flood.flood_tiles_warm_plain(*flat, tile)):
        raise AssertionError("filling filter: kernel 3 differs from its plain version")
    warm = warm.view(h.shape)
    got = cuda_flood.flood_volume(h, s, m, warm=warm)
    if not torch.equal(got, cuda_flood.flood_volume_plain(h, s, m, warm=warm)):
        raise AssertionError("filling filter: the 3d flood differs from its plain version")
    k3_ms = cuda_ms(lambda: cuda_flood.flood_tiles_warm(*flat, tile), 5)
    fv_ms = cuda_ms(lambda: cuda_flood.flood_volume(h, s, m, warm=warm), 5)
    k3_plain = cuda_ms(lambda: cuda_flood.flood_tiles_warm_plain(*flat, tile), 1)
    fv_plain = cuda_ms(lambda: cuda_flood.flood_volume_plain(h, s, m, warm=warm), 1)
    cuda_flood.flood_tiles_warm.launches, cuda_flood.flood_volume.launches = before
    vox = h.numel()
    records = [
        {"name": "flood_tiles_warm", "shape": list(h.shape), "tile": list(tile),
         "launches": launches["flood_tiles_warm"], "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": 13 * vox / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None},
        {"name": "flood_volume", "shape": list(h.shape), "launches": launches["flood_volume"],
         "ms": fv_ms, "plain_ms": fv_plain, "bound_ms": 17 * vox / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None},
    ]
    for rec in records:
        log(f"filling filter kernel on {card}: {rec}")
    return records


def stitching_phase(cut_np, path: str, work: str, card: str, bk: dict) -> dict:
    """Phase 20: ``SimpleStitchingWorkflow`` (its own tmp folder: graph,
    boundary edges, merge) and ``MulticutStitchingWorkflow`` (phase 18's tmp
    folder: graph and edge features reused; beta 0.5 on the boundary edges,
    0.75 inside) on phase 18's watershed with the boundary map.  Gates:
    each output is its table applied to the watershed, with 1 < segments <
    fragments; the simple stitch's segments are the components of the
    fragment pairs that touch across a block face (numpy over the face
    planes, scipy's graph components), so every merged pair touches across
    a face.  Printed: the face agreement per axis."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from cluster_tools_tpu_torch.tasks.stitching import SIMPLE_STITCH_NAME, STITCH_MC_NAME
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking
    from cluster_tools_tpu_torch.workflows import MulticutStitchingWorkflow, SimpleStitchingWorkflow

    shape = cut_np.shape
    vox = int(np.prod(shape))
    blocking = Blocking(shape, BLOCK)
    ws, frag = bk["ws"], bk["frag"]
    config_dir = bk["config_dir"]
    f = file_reader(path, "r")
    walls, agree = {}, {}
    io = {"input_path": path, "input_key": "raw", "labels_path": path, "labels_key": "ws",
          "output_path": path}
    runs = (("SimpleStitchingWorkflow", SimpleStitchingWorkflow, os.path.join(work, "tmp_stitch"),
             SIMPLE_STITCH_NAME, "stitch_simple"),
            ("MulticutStitchingWorkflow", MulticutStitchingWorkflow, bk["tmp"], STITCH_MC_NAME,
             "stitch_mc"))
    for tag, cls, tmp, name, key in runs:
        run_workflow(cls(tmp, config_dir, output_key=key, **io), tag, vox, card, walls)
        t0 = time.perf_counter()
        table = np.load(os.path.join(tmp, name))
        out = read_volume(f[key], blocking)
        check_applied(ws, out, table, blocking, tag)
        seg = table[np.isin(table[:, 0], frag), 1]
        n_seg = len(np.unique(seg))
        if not 1 < n_seg < frag.size:
            raise AssertionError(f"{tag}: {n_seg} segments of {frag.size} fragments")
        agree[tag] = [face_agreement(out, [axis]) for axis in range(3)]
        if tag.startswith("Simple"):
            pairs = []
            for axis in range(3):
                for pos in range(BLOCK[axis], shape[axis], BLOCK[axis]):
                    a, b = np.take(ws, pos - 1, axis), np.take(ws, pos, axis)
                    sel = (a > 0) & (b > 0) & (a != b)
                    pairs.append(np.stack([a[sel], b[sel]], axis=1))
            pairs = np.unique(np.concatenate(pairs), axis=0)
            idx = np.searchsorted(frag, pairs)
            n = frag.size
            graph = coo_matrix((np.ones(len(idx)), (idx[:, 0], idx[:, 1])), shape=(n, n))
            _, comp = connected_components(graph, directed=False)
            by_frag = table[np.searchsorted(table[:, 0], frag), 1]
            key_pairs = np.unique(np.stack([comp, by_frag], axis=1), axis=0)
            if not len(key_pairs) == len(np.unique(comp)) == len(np.unique(by_frag)):
                raise AssertionError(f"{tag}: the segments are not the components of the "
                                     "fragments touching across block faces")
            log(f"{tag}: {pairs.shape[0]} fragment pairs touch across block faces; the segments "
                f"are their components")
        log(f"{tag}: {n_seg} segments of {frag.size} fragments; the output is its table applied "
            f"to the watershed; face agreement (z, y, x) {agree[tag]} (checked in "
            f"{time.perf_counter() - t0:.1f} s)")
    return {"walls": walls, "shape": shape, "agree": agree}


# phase 23: the native and Python lifted GAEC on the nodes below this id (5,000 took the
# Python solver 27.4 s beside an NVIDIA H100 80GB HBM3, 700.00 W: PERF.md §6)
LIFTED_SUB_NODES = 1500
CLASS_WIDTH = 256  # phase 23's prior: class 1 + x // 256 (5 classes at CREMI-A's width)
H5_KEY = "volumes/boundaries"  # CREMI's own key and layout for the boundary map


def host_libraries() -> dict:
    """The optional libraries this host has: h5py (hdf5 containers),
    scikit-learn (the random forest) and the system libblosc (blosc chunks)."""
    import importlib.util

    from cluster_tools_tpu_torch.utils import blosc

    return {"h5py": importlib.util.find_spec("h5py") is not None,
            "sklearn": importlib.util.find_spec("sklearn") is not None,
            "libblosc": blosc.available()}


def codec_of(ds) -> str:
    """A chunked dataset's codec in the store's vocabulary (zarr calls its
    deflate stream zlib)."""
    comp = ds.compression
    if isinstance(comp, dict):
        return comp["id"]
    return "raw" if comp is None else "gzip" if comp in ("gzip", "zlib") else str(comp)


def scratch_codecs(tmp: str) -> dict:
    """The codec of every chunked dataset in a tmp folder's scratch store
    (ragged ``.npy`` datasets take none), by key."""
    from cluster_tools_tpu_torch.utils import file_reader

    root = os.path.join(tmp, "data.zarr")
    out = {}
    for dirpath, _, names in os.walk(root):
        if ".zarray" in names:
            key = os.path.relpath(dirpath, root)
            out[key] = codec_of(file_reader(root, "r")[key])
    return out


def write_blocks(ds, arr: np.ndarray, blocking) -> None:
    """``arr`` into ``ds`` block by block over host threads (the blocks are
    whole chunks, so the writes are disjoint)."""
    def one(bid):
        bb = blocking.block(bid).slicing
        ds[bb] = arr[bb]

    over_blocks(one, blocking)


def launches_rose(wrappers, what: str) -> dict:
    """Each wrapper's launches since ``reset_counts``; a wrapper that never
    launched fails the phase."""
    counts = {w.__name__: w.launches for w in wrappers}
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{what} never launched {name}")
    return counts


def containers_phase(shallow_np, ws_path: str, work: str, card: str, libs: dict) -> dict:
    """Phase 22: the first ``SHALLOW_Z`` planes of the boundary map in three
    containers — a blosc-lz4 byte-shuffle ``.zarr``, a blosc-zstd
    bit-shuffle ``.n5`` and, with h5py, an ``.h5`` under CREMI's
    ``volumes/boundaries`` (chunks (32, 256, 256), gzip) — and
    ``WatershedWorkflow`` (the default config) from each on the card.  A host
    without libblosc writes the ``.zarr`` and ``.n5`` with the codec that
    ``default_compression()`` names there; one without h5py leaves the
    ``.h5`` out.  Gates: kernels 2 and 1 launch in each run; each output
    equals phase 3's watershed on those planes byte for byte and stays
    gzip; every chunked scratch dataset of the runs carries
    ``default_compression()``'s codec.  Returns the walls, launches and
    the ``.zarr`` leg's path."""
    from cluster_tools_tpu_torch import WatershedWorkflow
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader, store
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    shape = shallow_np.shape
    vox = int(np.prod(shape))
    blocking = Blocking(shape, BLOCK)
    house = store.default_compression()
    blosc_ok = libs["libblosc"]
    forms = {
        ".zarr": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1, "blocksize": 0}
        if blosc_ok else house,
        ".n5": {"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 2, "blocksize": 0}
        if blosc_ok else house,
    }
    if not blosc_ok:
        log(f"phase 22: no libblosc on this host: the .zarr and .n5 legs are written with "
            f"{house!r}, the codec default_compression() names here")
    if not libs["h5py"]:
        log("phase 22: no h5py on this host: the .h5 leg is left out")
    t0 = time.perf_counter()
    paths = {}
    for ext, comp in forms.items():
        paths[ext] = os.path.join(work, f"containers{ext}")
        ds = file_reader(paths[ext]).create_dataset(
            "raw", shape=shape, dtype="float32", chunks=BLOCK, compression=comp)
        write_blocks(ds, shallow_np, blocking)
    if libs["h5py"]:
        import h5py

        paths[".h5"] = os.path.join(work, "containers.h5")
        with h5py.File(paths[".h5"], "w") as f:
            f.create_dataset(H5_KEY, data=shallow_np, chunks=BLOCK, compression="gzip")
    log(f"setup: the first {shape[0]} planes in {sorted(paths)} in "
        f"{time.perf_counter() - t0:.1f} s")
    config_dir = os.path.join(work, "configs_containers")
    cfg.write_global_config(config_dir, {"block_shape": list(BLOCK), "target": "cuda",
                                         "device": "cuda"})
    cfg.write_config(config_dir, "watershed", WatershedTask.default_task_config())
    out_path = os.path.join(work, "containers_out.n5")
    walls, launches = {}, {}
    for ext, path in paths.items():
        tag = f"WatershedWorkflow from {ext}"
        key = f"ws{ext.replace('.', '_')}"
        tmp = os.path.join(work, f"tmp_containers{ext.replace('.', '_')}")
        wf = WatershedWorkflow(tmp, config_dir, input_path=path,
                               input_key=H5_KEY if ext == ".h5" else "raw",
                               output_path=out_path, output_key=key)
        reset_counts(dtws_slices, flood_slices)
        run_workflow(wf, tag, vox, card, walls)
        launches[tag] = launches_rose((dtws_slices, flood_slices), tag)
        if ext == ".h5":
            store.release_h5_handles()
        in_codec = "gzip" if ext == ".h5" else codec_of(file_reader(path, "r")["raw"])
        out_codec = codec_of(file_reader(out_path, "r")[key])
        scratch = scratch_codecs(tmp)
        if out_codec != "gzip":
            raise AssertionError(f"{tag}: the output's codec is {out_codec}, not gzip")
        if any(c != house for c in scratch.values()):
            raise AssertionError(f"{tag}: scratch codecs {scratch}, not {house!r}")
        if not same_as_phase3(out_path, key, ws_path, shape):
            raise AssertionError(f"{tag}: the output differs from phase 3's watershed")
        log(f"{tag}: input {in_codec}, output {out_codec}, chunked scratch datasets {scratch} "
            f"(house codec {house!r}); byte-identical to phase 3's watershed on its "
            f"{shape[0]} planes; kernel launches {launches[tag]}")
    return {"walls": walls, "launches": launches, "zarr": paths[".zarr"], "house": house,
            "shape": shape}


def straddle_share(seg: np.ndarray, n_classes: int, dev) -> float:
    """The share of ``seg``'s segments with voxels in two or more of the
    class bands (``CLASS_WIDTH`` columns each), counted on the card."""
    seg_dev = torch.from_numpy(seg.view(np.int64)).to(dev)
    if bool((seg_dev < 0).any()):
        raise AssertionError("segment ids past 2**63")
    bands = [torch.unique(seg_dev[..., c * CLASS_WIDTH:(c + 1) * CLASS_WIDTH])
             for c in range(n_classes)]
    ids, n_bands = torch.unique(torch.cat([b[b > 0] for b in bands]), return_counts=True)
    return int((n_bands > 1).sum()) / max(int(ids.numel()), 1)


def lifted_phase(shallow_np, ws_path: str, work: str, card: str, cont: dict, dev) -> dict:
    """Phase 23: ``LiftedMulticutSegmentationWorkflow`` from phase 22's
    ``.zarr`` leg on the card: the 2d watershed config of phase 3, n_scales
    1, the prior a class volume made on the card from the map's shape
    (``1 + x // 256``, 5 classes, uint8), costs from node labels +4 / -4.
    Its tmp folder is ``tmp_learning/cremi`` so that phase 24 reuses its
    problem.  Gates: kernels 2 and 1 launch; the watershed equals phase 3's
    on these planes byte for byte; the output is the lifted assignment
    table applied to it; below half of the segments straddle two classes;
    the graph's and features' scratch datasets carry the house codec; the
    native lifted GAEC and ``_lifted_gaec_python`` give one partition on
    the problem's nodes below ``LIFTED_SUB_NODES``; the solution's lifted
    energy is at most 0 and at most that of the plain multicut's solution
    of the same problem."""
    from cluster_tools_tpu_torch import LiftedMulticutSegmentationWorkflow, native
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.ops.lifted import (
        _lifted_gaec_python, lifted_multicut_energy, solve_lifted_multicut,
    )
    from cluster_tools_tpu_torch.ops.multicut import solve_multicut
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks.lifted_features import dense_node_labels, load_lifted_problem
    from cluster_tools_tpu_torch.tasks.lifted_multicut import LIFTED_ASSIGNMENTS_NAME
    from cluster_tools_tpu_torch.tasks.node_labels import NODE_LABELS_NAME
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    shape = shallow_np.shape
    vox = int(np.prod(shape))
    blocking = Blocking(shape, BLOCK)
    if not native.available():
        raise AssertionError(f"the native solvers did not build: {native.load_error}")
    t0 = time.perf_counter()
    classes_path = os.path.join(work, "classes.n5")
    band = (torch.arange(shape[2], device=dev) // CLASS_WIDTH + 1).to(torch.uint8)
    classes = band.expand(shape).contiguous().cpu().numpy()
    write_blocks(file_reader(classes_path).create_dataset(
        "classes", shape=shape, dtype="uint8", chunks=BLOCK, compression="raw"), classes, blocking)
    n_classes = int(band.max())
    log(f"setup: the class prior ({n_classes} classes of {CLASS_WIDTH} columns) made on the "
        f"card and written in {time.perf_counter() - t0:.1f} s")
    config_dir = slice_config(work, "lifted")
    cfg.write_config(config_dir, "watershed", WatershedTask.default_task_config())
    cfg.write_config(config_dir, "costs_from_node_labels",
                     {"same_cost": 4.0, "different_cost": -4.0})
    tmp = os.path.join(work, "tmp_learning", "cremi")
    out_path = os.path.join(work, "lifted_out.n5")
    wf = LiftedMulticutSegmentationWorkflow(
        tmp, config_dir, input_path=cont["zarr"], input_key="raw", ws_path=out_path,
        ws_key="ws", labels_path=classes_path, labels_key="classes", output_path=out_path,
        output_key="seg", n_scales=1)
    walls = {}
    reset_counts(dtws_slices, flood_slices)
    run_workflow(wf, "LiftedMulticutSegmentationWorkflow", vox, card, walls)
    launches = launches_rose((dtws_slices, flood_slices), "the lifted multicut")

    t0 = time.perf_counter()
    if not same_as_phase3(out_path, "ws", ws_path, shape):
        raise AssertionError("the lifted multicut's watershed differs from phase 3's")
    f = file_reader(out_path, "r")
    ws = read_volume(f["ws"], blocking)
    seg = read_volume(f["seg"], blocking)
    table = np.load(os.path.join(tmp, LIFTED_ASSIGNMENTS_NAME))
    check_applied(ws, seg, table, blocking, "the lifted multicut")
    straddle = straddle_share(seg, n_classes, dev)
    node_class = dense_node_labels(None, table[:, 0], os.path.join(tmp, NODE_LABELS_NAME))
    seg_of_node = table[:, 1]
    pairs = np.unique(np.stack([seg_of_node, node_class.astype(np.uint64)], axis=1), axis=0)
    seg_ids, n_node_classes = np.unique(pairs[:, 0], return_counts=True)
    node_straddle = float((n_node_classes > 1).mean())
    _, seg_sizes = np.unique(seg[seg > 0], return_counts=True)
    log(f"lifted multicut: {seg_ids.size} segments (largest {np.sort(seg_sizes)[::-1][:5]} "
        f"voxels); {straddle:.4f} of them have voxels in two class bands, {node_straddle:.4f} "
        f"hold fragments of two classes (the node labels)")
    if not straddle < 0.5:
        raise AssertionError(f"{straddle:.4f} of the segments straddle two classes")
    scratch = scratch_codecs(tmp)
    if not scratch or any(c != cont["house"] for c in scratch.values()):
        raise AssertionError(f"scratch codecs {scratch}, not {cont['house']!r}")

    scratch_store = file_reader(os.path.join(tmp, "data.zarr"), "r")
    nodes, edges = scratch_store["graph/nodes"][:], scratch_store["graph/edges"][:]
    costs = np.load(os.path.join(tmp, "costs.npy"))
    luv, lcosts = load_lifted_problem(tmp, "lifted")
    if not np.array_equal(table[:, 0], nodes):
        raise AssertionError("the table's rows are not the graph's nodes")
    labels = table[:, 1].astype(np.int64)
    energy = lifted_multicut_energy(edges, costs, luv, lcosts, labels)
    t1 = time.perf_counter()
    plain = solve_multicut(nodes.size, edges, costs)
    plain_energy = lifted_multicut_energy(edges, costs, luv, lcosts, plain)
    plain_s = time.perf_counter() - t1
    if not (energy <= 0 and energy <= plain_energy):
        raise AssertionError(f"lifted energy {energy:.6g}, the plain multicut's {plain_energy:.6g}")
    n_sub = min(LIFTED_SUB_NODES, nodes.size)
    sub = (edges < n_sub).all(axis=1)
    lsub = (luv < n_sub).all(axis=1)
    t1 = time.perf_counter()
    by_native = solve_lifted_multicut(n_sub, edges[sub], costs[sub], luv[lsub], lcosts[lsub])
    native_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    by_python = _lifted_gaec_python(n_sub, edges[sub], costs[sub], luv[lsub], lcosts[lsub])
    python_s = time.perf_counter() - t1
    if not same_partition(by_native, by_python):
        raise AssertionError(f"native and Python lifted GAEC differ on {n_sub} nodes")
    n_seg = len(np.unique(table[:, 1]))
    log(f"lifted multicut: {nodes.size} nodes, {edges.shape[0]} edges, {luv.shape[0]} lifted "
        f"edges ({int((lcosts > 0).sum())} attractive), {n_seg} segments; {straddle:.4f} of them "
        f"straddle two classes; the output is its table applied to the watershed; scratch "
        f"codecs {scratch}; lifted energy {energy:.6g} (plain multicut's {plain_energy:.6g}, "
        f"{plain_s:.2f} s); native and Python lifted GAEC agree on {n_sub} nodes, "
        f"{int(sub.sum())} edges, {int(lsub.sum())} lifted ({native_s:.3f} s against "
        f"{python_s:.2f} s); kernel launches {launches} (checked in "
        f"{time.perf_counter() - t0:.1f} s)")
    return {"walls": walls, "launches": launches, "tmp": tmp, "classes": classes_path,
            "ws_path": out_path, "config_dir": config_dir, "shape": shape}


def learning_phase(work: str, card: str, cont: dict, lmc: dict, libs: dict) -> dict:
    """Phase 24: ``LearningWorkflow`` on phase 23's problem (its tmp folder
    is this workflow's dataset folder, so graph, features and node votes are
    reused) with the class volume as the ground truth, ``n_trees`` 10; then
    ``PredictEdgeProbabilitiesTask`` and ``ProbsToCostsTask`` with
    ``probs_path``.  A host without scikit-learn runs the workflow up to
    ``EdgeLabelsTask``.  Gates: the reused tasks did not run again; the
    labels lie in {0, 1} with both present; with the forest, the mean
    probability exceeds 0.7 on label-1 edges and stays below 0.3 on
    label-0 edges."""
    from cluster_tools_tpu_torch import LearningWorkflow
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import PredictEdgeProbabilitiesTask, ProbsToCostsTask
    from cluster_tools_tpu_torch.tasks.learning import EDGE_LABELS_NAME, EDGE_PROBS_NAME

    shape = lmc["shape"]
    vox = int(np.prod(shape))
    config_dir = lmc["config_dir"]
    cfg.write_config(config_dir, "learn_rf", {"n_trees": 10})
    tmp = lmc["tmp"]
    status = os.path.join(tmp, "status")
    before = {name: os.stat(os.path.join(status, name)).st_mtime_ns
              for name in os.listdir(status)}
    wf = LearningWorkflow(
        os.path.dirname(tmp), config_dir, input_dict={"cremi": (cont["zarr"], "raw")},
        labels_dict={"cremi": (lmc["ws_path"], "ws")},
        groundtruth_dict={"cremi": (lmc["classes"], "classes")},
        output_path=os.path.join(work, "rf.pkl"))
    walls = {}
    if libs["sklearn"]:
        run_workflow(wf, "LearningWorkflow", vox, card, walls)
    else:
        log("phase 24: no scikit-learn on this host: LearningWorkflow runs up to "
            "EdgeLabelsTask, without the forest, the prediction and its costs")
        learn = wf.requires()[0]
        for edge_labels in learn.dependencies:
            run_workflow(edge_labels, "LearningWorkflow up to EdgeLabelsTask", vox, card, walls)
    rerun = sorted(n for n, t in before.items()
                   if os.stat(os.path.join(status, n)).st_mtime_ns != t)
    if rerun:
        raise AssertionError(f"phase 23's tasks ran again: {rerun}")
    labels = np.load(os.path.join(tmp, EDGE_LABELS_NAME))
    if set(np.unique(labels).tolist()) != {0, 1}:
        raise AssertionError(f"edge labels {np.unique(labels)}, not both of 0 and 1")
    summary = (f"{labels.size} edge labels, {int(labels.sum())} across classes; phase 23's "
               f"{len(before)} tasks reused")
    if libs["sklearn"]:
        for task, tag in ((PredictEdgeProbabilitiesTask(tmp, config_dir,
                                                        rf_path=os.path.join(work, "rf.pkl")),
                           "PredictEdgeProbabilitiesTask"),
                          (ProbsToCostsTask(tmp, config_dir,
                                            probs_path=os.path.join(tmp, EDGE_PROBS_NAME)),
                           "ProbsToCostsTask (probs_path)")):
            run_workflow(task, tag, vox, card, walls)
        probs = np.load(os.path.join(tmp, EDGE_PROBS_NAME))
        p1, p0 = float(probs[labels == 1].mean()), float(probs[labels == 0].mean())
        if not (p1 > 0.7 and p0 < 0.3):
            raise AssertionError(f"mean probability {p1:.4f} on label 1, {p0:.4f} on label 0")
        summary += f"; mean probability {p1:.4f} on label-1 edges, {p0:.4f} on label-0 edges"
    log(f"learning: {summary}")
    return {"walls": walls, "shape": shape}


def slice13_phases(shallow_np, ws_path: str, work: str, card: str, libs: dict, dev,
                   t_start: float) -> dict:
    """Phases 22-24 on the first ``SHALLOW_Z`` planes; their walls, the
    kernel launches of their watershed runs, and the phases' seconds."""
    t0 = time.perf_counter()
    phase_start(22, t_start)
    cont = containers_phase(shallow_np, ws_path, work, card, libs)
    phase_start(23, t_start)
    lmc = lifted_phase(shallow_np, ws_path, work, card, cont, dev)
    phase_start(24, t_start)
    learn = learning_phase(work, card, cont, lmc, libs)
    seconds = time.perf_counter() - t0
    log(f"phases 22-24 done at {time.perf_counter() - t_start:.1f} s ({seconds:.1f} s)")
    return {"walls": {**cont["walls"], **lmc["walls"], **learn["walls"]},
            "launches": {**cont["launches"], "LiftedMulticutSegmentationWorkflow":
                         lmc["launches"]},
            "seconds": seconds}


# -- phase 25: volume ops and export --------------------------------------------
# On the first SHALLOW_Z planes at full width (25 blocks of BLOCK), the cuda
# target: a uint8 paintera pyramid and its bdv.n5 copy, label down/upscaling,
# the refit onto the boundary map (the 3d flood and kernel 3), copy, masks,
# the per-slice affine step and the paintera label container.

VOLUME_FACTORS = [[1, 2, 2], [1, 2, 2], [2, 2, 2]]
VOLUME_SHAPES = [(32, 625, 625), (32, 313, 313), (16, 157, 157)]
VOLUME_OFFSET = 7  # ScaleToBoundariesTask's id offset
# the paintera leg's ROI, two blocks: its label-to-block mapping walks every id
# up to the largest in host Python (as JAX's does), and the watershed's ids
# carry block offsets of 2**21 per block
PAINTERA_ROI = ([0, 0, 0], [SHALLOW_Z, 256, 512])
ROUNDING_MARGIN = 1e-3  # phase 25's pyramid: card and CPU may differ this close to a .5


def fma_np(a: np.ndarray, x: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Correctly rounded float32 ``a*x + b`` in numpy (the exact product in
    float64, the sum's error recovered and folded in by rounding to odd)."""
    p = a.astype(np.float64) * x.astype(np.float64)
    c = b.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def volume_config(work: str, tag: str, tasks=None, **glob) -> str:
    """A config dir of phase 25 (``slice_config``'s, plus global keys and
    task configs)."""
    from cluster_tools_tpu_torch.runtime import config as cfg

    config_dir = slice_config(work, tag)
    if glob:
        cfg.write_global_config(config_dir, {**cfg.global_config(config_dir), **glob})
    for name, conf in (tasks or {}).items():
        cfg.write_config(config_dir, name, conf)
    return config_dir


def pyramid_block_check(f, in_key: str, out_key: str, sf, bid: int) -> tuple:
    """Block ``bid`` of the card's ``out_key`` against the CPU's resampling
    of the same input footprint: equal byte for byte except where the CPU's
    float value lies within ``ROUNDING_MARGIN`` of a .5.  Returns (voxels
    within the margin, voxels that differ)."""
    from cluster_tools_tpu_torch.ops import resample
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    in_ds, out_ds = f[in_key], f[out_key]
    blk = Blocking(out_ds.shape, BLOCK).block(bid)
    in_bb = tuple(slice(b.start * k, min(b.stop * k, s))
                  for b, k, s in zip(blk.slicing, sf, in_ds.shape))
    ref = resample.downscale(torch.from_numpy(in_ds[in_bb]), sf, "interpolate")
    ref = ref[tuple(slice(0, b.stop - b.start) for b in blk.slicing)].numpy()
    got = out_ds[blk.slicing]
    near = np.abs(ref - np.floor(ref) - 0.5) < ROUNDING_MARGIN
    differ = got != resample.cast_resampled(ref, np.uint8)
    if (differ & ~near).any():
        raise AssertionError(f"{out_key} block {bid}: {int((differ & ~near).sum())} voxels differ "
                             f"from the CPU's resampling away from a rounding boundary")
    return int(near.sum()), int(differ.sum())


def check_refit(fitted: np.ndarray, coarse: np.ndarray, what: str, need_ids: bool = False):
    """Every id ``ScaleToBoundariesTask`` wrote is a coarse id plus
    ``VOLUME_OFFSET`` (and, with ``need_ids``, it wrote some)."""
    written = np.unique(fitted[fitted > 0]) - np.uint64(VOLUME_OFFSET)
    if not np.isin(written, np.unique(coarse)).all():
        raise AssertionError(f"{what} wrote ids that are no coarse id plus the offset")
    if need_ids and written.size == 0:
        raise AssertionError(f"{what} wrote no object")
    log(f"{what}: {written.size} ids written, each a coarse id + {VOLUME_OFFSET}; foreground "
        f"{float((fitted > 0).mean()):.4f}")


def volume_phase(shallow_np, shallow_path: str, ws_path: str, work: str, card: str, libs: dict,
                 dev) -> dict:
    """Phase 25 on the first ``SHALLOW_Z`` planes.  (a) ``round(255·b)`` as a
    uint8 n5 (raw chunks) into ``DownscalingWorkflow`` (paintera,
    ``VOLUME_FACTORS``, "interpolate"), a second prefix with "skimage" (mean)
    at [1, 2, 2], then ``PainteraToBdvWorkflow`` to ``bdv.n5``.  Gates: the
    scales' shapes and JAX's attributes; three blocks of s1 and one of s3
    equal the CPU's resampling of the same blocks off rounding boundaries;
    the mean's block 0 equal to the CPU's; every bdv scale equal to the
    paintera one.  (b) phase 3's watershed down by [1, 2, 2] (nearest, forced
    for labels) and up again: equal to ``np.repeat`` of the coarse labels.
    (c) ``ScaleToBoundariesTask`` from the coarse labels onto the boundary
    map, ``CTT_FLOOD_TILE`` pinned, at its defaults (``erode_by`` 12 in 3d,
    which leaves these planes no object seed) and in plane by 2: the 3d
    flood and kernel 3 launch in both; every id is a coarse id plus the
    offset; the in-plane run writes objects, and its blocks 0 and last hold
    objects and equal a re-run through the plain floods on the card.  (d)
    ``CopyVolumeTask`` float32 to uint8 over a block-aligned ROI (equal to
    ``cast_type`` per block), ``BlocksFromMaskTask`` and ``MinfilterTask``
    on ``b < 0.5`` at half resolution (numpy's block list, scipy's minimum
    filter on three blocks), ``LinearTransformationTask`` with per-slice
    coefficients under that mask (numpy's fused multiply-add on three
    blocks).  (e) ``PainteraConversionWorkflow`` (multisets [[1, 2, 2],
    [1, 2, 2]]) on phase 3's watershed over ``PAINTERA_ROI``: the s0
    multiset's argmax equals the labels, three blocks' unique labels equal
    numpy's, the label-to-block mapping inverts them.  Without h5py the
    ``.h5`` legs print a cut line.  Returns walls, launches, the device
    functions' records and the phase's seconds."""
    from scipy import ndimage

    from cluster_tools_tpu_torch import tasks as T
    from cluster_tools_tpu_torch import workflows as W
    from cluster_tools_tpu_torch.ops import resample
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_tiles_warm, flood_volume
    from cluster_tools_tpu_torch.ops.filters import minimum_filter
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.tasks import label_multisets as LM
    from cluster_tools_tpu_torch.tasks import paintera as PT
    from cluster_tools_tpu_torch.tasks.copy_volume import cast_type
    from cluster_tools_tpu_torch.tasks.masking import resize_nearest
    from cluster_tools_tpu_torch.tasks.transformations import linear_batch
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    t_phase = time.perf_counter()
    shape = shallow_np.shape
    vox = int(np.prod(shape))
    blocking = Blocking(shape, BLOCK)
    path = os.path.join(work, "volume.n5")
    f = file_reader(path)
    t0 = time.perf_counter()
    raw8 = np.round(255 * shallow_np).astype(np.uint8)
    mask = (shallow_np < THRESHOLD).astype(np.uint8)
    ws = read_volume(file_reader(ws_path, "r")["ws"], blocking)
    for key, arr in (("raw8", raw8), ("mask", mask), ("ws", ws)):
        write_blocks(f.create_dataset(key, shape=shape, dtype=arr.dtype, chunks=BLOCK,
                                      compression="raw"), arr, blocking)
    mask_half = np.ascontiguousarray(mask[:, ::2, ::2])
    f.create_dataset("mask_half", data=mask_half, chunks=BLOCK, compression="raw")
    log(f"setup: phase 25's inputs (uint8 map, mask, half-resolution mask, the watershed's "
        f"first {shape[0]} planes) in {time.perf_counter() - t0:.1f} s")
    walls, launches = {}, {}

    # (a) the pyramid, its mean prefix and the bdv.n5 copy
    conf = volume_config(work, "pyramid", {"downscaling": {"library": "interpolate"}})
    reset_counts(resample.downscale)
    run_workflow(W.DownscalingWorkflow(
        os.path.join(work, "tmp_pyramid"), conf, input_path=path, input_key="raw8",
        scale_factors=VOLUME_FACTORS, metadata_format="paintera",
        metadata_dict={"resolution": [40.0, 4.0, 4.0]}, output_path=path,
        output_key_prefix="pyramid"), "DownscalingWorkflow paintera interpolate", vox, card, walls)
    launches["downscale interpolate"] = launches_rose((resample.downscale,), "the pyramid")
    g = f["pyramid"]
    got_shapes = [f[f"pyramid/s{s}"].shape for s in range(4)]
    if got_shapes != [shape] + VOLUME_SHAPES:
        raise AssertionError(f"pyramid shapes {got_shapes}")
    factors = [f[f"pyramid/s{s}"].attrs["downsamplingFactors"] for s in (1, 2, 3)]
    if factors != [[2, 2, 1], [4, 4, 1], [8, 8, 2]] or g.attrs["multiScale"] is not True \
            or g.attrs["resolution"] != [4.0, 4.0, 40.0] or g.attrs["offset"] != [0.0, 0.0, 0.0]:
        raise AssertionError(f"pyramid attributes {factors} {dict((k, g.attrs[k]) for k in g.attrs.keys())}")
    n1 = Blocking(VOLUME_SHAPES[0], BLOCK).n_blocks
    checks = [("pyramid/s0", "pyramid/s1", [1, 2, 2], b) for b in (0, n1 // 2, n1 - 1)]
    checks.append(("pyramid/s2", "pyramid/s3", [2, 2, 2], 0))
    near = [pyramid_block_check(f, *c) for c in checks]
    log(f"pyramid: shapes {got_shapes}, attributes JAX's; s1 blocks 0, {n1 // 2}, {n1 - 1} and s3 "
        f"block 0 equal "
        f"the CPU's resampling off rounding boundaries: (within {ROUNDING_MARGIN} of a .5, "
        f"differing) voxels per block {near}")
    conf_mean = volume_config(work, "pyramid_mean", {"downscaling": {"library": "skimage"}})
    reset_counts(resample.downscale)
    run_workflow(W.DownscalingWorkflow(
        os.path.join(work, "tmp_pyramid_mean"), conf_mean, input_path=path, input_key="raw8",
        scale_factors=[[1, 2, 2]], metadata_format="paintera", output_path=path,
        output_key_prefix="pyramid_mean"), "DownscalingWorkflow paintera mean", vox, card, walls)
    launches["downscale mean"] = launches_rose((resample.downscale,), "the mean pyramid")
    zb, yb, xb = BLOCK
    want = resample.cast_resampled(
        resample.downscale(torch.from_numpy(raw8[:zb, :2 * yb, :2 * xb]), [1, 2, 2], "mean"),
        np.uint8)
    if not np.array_equal(f["pyramid_mean/s1"][blocking.block(0).slicing], want):
        raise AssertionError("mean pyramid: block 0 differs from the CPU's")
    bdv = os.path.join(work, "volume_bdv.n5")
    run_workflow(W.PainteraToBdvWorkflow(
        os.path.join(work, "tmp_bdv"), conf, input_path=path, input_key_prefix="pyramid",
        output_path=bdv), "PainteraToBdvWorkflow bdv.n5", vox, card, walls)
    fb = file_reader(bdv, "r")
    for s in range(4):
        if not np.array_equal(fb[f"setup0/timepoint0/s{s}"][:], f[f"pyramid/s{s}"][:]):
            raise AssertionError(f"bdv.n5 scale {s} differs from the paintera scale")
    if not os.path.exists(os.path.join(work, "volume_bdv.xml")):
        raise AssertionError("bdv.n5: no XML")
    log("mean pyramid block 0 equal to the CPU's; every bdv.n5 scale equal to the paintera one")

    # (b) labels down and up
    conf_l = volume_config(work, "volume_labels",
                           {"upscaling": {"library_kwargs": {"order": 0}}})
    run_workflow(T.DownscalingTask(os.path.join(work, "tmp_labels_down"), conf_l, input_path=path,
                                   input_key="ws", output_path=path, output_key="ws_s1",
                                   scale_factor=[1, 2, 2]),
                 "DownscalingTask labels nearest", vox, card, walls)
    coarse = f["ws_s1"][:]
    if not np.array_equal(coarse, ws[:, ::2, ::2]):
        raise AssertionError("labels: the nearest downscale is not the strided slice")
    run_workflow(T.UpscalingTask(os.path.join(work, "tmp_labels_up"), conf_l, input_path=path,
                                 input_key="ws_s1", output_path=path, output_key="ws_up",
                                 scale_factor=[1, 2, 2]),
                 "UpscalingTask labels nearest", vox, card, walls)
    if not np.array_equal(f["ws_up"][:], np.repeat(np.repeat(coarse, 2, 1), 2, 2)):
        raise AssertionError("labels: the nearest upscale is not np.repeat of the coarse labels")
    log("labels: down by [1, 2, 2] the strided slice, up again np.repeat of it, byte for byte")

    # (c) the refit onto the boundary map: at the defaults, then in plane by 2
    os.environ["CTT_FLOOD_TILE"] = FLOOD_TILE
    from cluster_tools_tpu_torch.ops import watershed as ws_ops

    try:
        reset_counts(flood_volume, flood_tiles_warm, minimum_filter)
        run_workflow(T.ScaleToBoundariesTask(
            os.path.join(work, "tmp_stb"), conf_l, input_path=path, input_key="ws_s1",
            boundaries_path=shallow_path, boundaries_key="raw", output_path=path,
            output_key="fitted", offset=VOLUME_OFFSET), "ScaleToBoundariesTask", vox, card, walls)
        launches["ScaleToBoundariesTask"] = launches_rose((flood_volume, flood_tiles_warm),
                                                          "ScaleToBoundariesTask")
        launches["minimum_filter (fit_to_hmap)"] = minimum_filter.launches
    finally:
        del os.environ["CTT_FLOOD_TILE"]
    check_refit(f["fitted"][:], coarse, "ScaleToBoundariesTask")
    # the defaults erode by 12 in 3d, more than a 2d watershed's fragments
    # span in z: no object seed survives on these planes; in plane by 2, most
    # do, so this run is the one held to the plain floods and timed
    conf_2d = volume_config(work, "volume_refit_2d",
                            {"scale_to_boundaries": {"erode_by": 2, "erode_3d": False}})
    stb_args = dict(input_path=path, input_key="ws_s1", boundaries_path=shallow_path,
                    boundaries_key="raw", offset=VOLUME_OFFSET)
    refit_call = {}  # the flood's inputs at the first full-size block with object seeds
    seeded_watershed = ws_ops.seeded_watershed

    def keep_args(hmap, seeds, *args, **kwargs):
        if objects_in(seeds) and (not refit_call or hmap.numel() > refit_call["hmap"].numel()):
            refit_call.update(hmap=hmap, seeds=seeds)
        return seeded_watershed(hmap, seeds, *args, **kwargs)

    def objects_in(seeds):  # seeds other than the background's (the largest id)
        return int(torch.unique(seeds[seeds > 0]).numel()) > 1

    os.environ["CTT_FLOOD_TILE"] = FLOOD_TILE
    ws_ops.seeded_watershed = keep_args
    try:
        reset_counts(flood_volume, flood_tiles_warm)
        run_workflow(T.ScaleToBoundariesTask(os.path.join(work, "tmp_stb_2d"), conf_2d,
                                             output_path=path, output_key="fitted_2d", **stb_args),
                     "ScaleToBoundariesTask erode_by 2 in plane", vox, card, walls)
        ws_ops.seeded_watershed = seeded_watershed
        launches["ScaleToBoundariesTask in plane"] = launches_rose(
            (flood_volume, flood_tiles_warm), "ScaleToBoundariesTask in plane")
        plain = T.ScaleToBoundariesTask(os.path.join(work, "tmp_stb_plain"), conf_2d,
                                        output_path=path, output_key="fitted_plain", **stb_args)
        config = {**cfg.global_config(conf_2d), **plain.get_task_config()}
        plain.prepare(blocking, config)
        check_ids = [0, blocking.n_blocks - 1]
        with plain_kernels():
            for bid in check_ids:
                plain.process_block(bid, blocking, config)
    finally:
        ws_ops.seeded_watershed = seeded_watershed
        del os.environ["CTT_FLOOD_TILE"]
    fitted = f["fitted_2d"][:]
    check_refit(fitted, coarse, "ScaleToBoundariesTask in plane", need_ids=True)
    for bid in check_ids:
        bb = blocking.block(bid).slicing
        n_ids = np.unique(fitted[bb][fitted[bb] > 0]).size
        if n_ids == 0:
            raise AssertionError(f"ScaleToBoundariesTask in plane: block {bid} holds no object")
        if not np.array_equal(fitted[bb], f["fitted_plain"][bb]):
            raise AssertionError(f"ScaleToBoundariesTask in plane: block {bid} differs from the "
                                 f"plain floods'")
        log(f"ScaleToBoundariesTask in plane: block {bid} ({n_ids} ids) equal to the plain "
            f"floods' on the card")
    if not refit_call:
        raise AssertionError("ScaleToBoundariesTask in plane: no block with object seeds to time")

    # (d) copy, masks, the affine step
    roi = ([0, BLOCK[1], BLOCK[2]], [SHALLOW_Z, 3 * BLOCK[1], 3 * BLOCK[2]])
    conf_c = volume_config(work, "volume_copy", roi_begin=roi[0], roi_end=roi[1])
    run_workflow(T.CopyVolumeTask(os.path.join(work, "tmp_copy"), conf_c,
                                  input_path=shallow_path, input_key="raw", output_path=path,
                                  output_key="copy_u8", dtype="uint8", fit_to_roi=True),
                 "CopyVolumeTask float32 to uint8 (ROI)",
                 int(np.prod([e - b for b, e in zip(*roi)])), card, walls)
    copy = f["copy_u8"][:]
    for bid in blocking.blocks_overlapping_roi(*roi):
        bb = blocking.block(bid).slicing
        out_bb = tuple(slice(b.start - o, b.stop - o) for b, o in zip(bb, roi[0]))
        if not np.array_equal(copy[out_bb], cast_type(shallow_np[bb], np.uint8)):
            raise AssertionError(f"CopyVolumeTask block {bid} differs from cast_type")
    blocks_json = os.path.join(work, "blocks_in_mask.json")
    run_workflow(T.BlocksFromMaskTask(os.path.join(work, "tmp_bfm"), conf_l, mask_path=path,
                                      mask_key="mask_half", shape=list(shape),
                                      output_path=blocks_json),
                 "BlocksFromMaskTask", vox, card, walls)
    full = resize_nearest(mask_half.astype(bool), shape)
    want = [b for b in range(blocking.n_blocks) if full[blocking.block(b).slicing].any()]
    with open(blocks_json) as fj:
        if json.load(fj) != want:
            raise AssertionError("BlocksFromMaskTask: the block list differs from numpy's")
    reset_counts(minimum_filter)
    mf = T.MinfilterTask(os.path.join(work, "tmp_minfilter"), conf_l, input_path=path,
                         input_key="mask_half", output_path=path, output_key="minfilter")
    run_workflow(mf, "MinfilterTask", int(mask_half.size), card, walls)
    launches["minimum_filter (MinfilterTask)"] = launches_rose((minimum_filter,), "MinfilterTask")
    filter_shape = mf.get_task_config()["filter_shape"]
    halo = [s // 2 + 1 for s in filter_shape]
    half_blocking = Blocking(mask_half.shape, BLOCK)
    mf_out = f["minfilter"]
    pads = {}
    for bid in (0, half_blocking.n_blocks // 2, half_blocking.n_blocks - 1):
        bh = half_blocking.block_with_halo(bid, halo)
        full_shape = tuple(b + 2 * h for b, h in zip(BLOCK, halo))
        x = mask_half[bh.outer.slicing].astype(np.float32)
        x = np.pad(x, [(0, s - n) for s, n in zip(full_shape, x.shape)], mode="edge")
        pads[bid] = x
        want = ndimage.minimum_filter(x, size=filter_shape, mode="nearest")[bh.inner_local.slicing]
        if not np.array_equal(mf_out[bh.inner.slicing], want.astype(np.uint8)):
            raise AssertionError(f"MinfilterTask block {bid} differs from scipy's")
    trafo = {str(z): {"a": 0.5 + z / 64, "b": 0.01 * z - 0.1} for z in range(shape[0])}
    trafo_path = os.path.join(work, "trafo.json")
    with open(trafo_path, "w") as fj:
        json.dump(trafo, fj)
    reset_counts(linear_batch)
    run_workflow(T.LinearTransformationTask(os.path.join(work, "tmp_linear"), conf_l,
                                            input_path=shallow_path, input_key="raw",
                                            output_path=path, output_key="linear",
                                            transformation=trafo_path, mask_path=path,
                                            mask_key="mask"),
                 "LinearTransformationTask per slice, masked", vox, card, walls)
    launches["linear_batch"] = launches_rose((linear_batch,), "LinearTransformationTask")
    a = np.asarray([trafo[str(z)]["a"] for z in range(shape[0])], np.float32)[:, None, None]
    b = np.asarray([trafo[str(z)]["b"] for z in range(shape[0])], np.float32)[:, None, None]
    for bid in (0, blocking.n_blocks // 2, blocking.n_blocks - 1):
        bb = blocking.block(bid).slicing
        x = shallow_np[bb]
        want = np.where(mask[bb] > 0, fma_np(np.broadcast_to(a[bb[0]], x.shape), x,
                                             np.broadcast_to(b[bb[0]], x.shape)), x)
        if not np.array_equal(f["linear"][bb], want):
            raise AssertionError(f"LinearTransformationTask block {bid} differs from numpy's "
                                 f"fused multiply-add")
    log("copy equal to cast_type per block; the block list numpy's; the minimum filter scipy's "
        "on three blocks; the affine step numpy's fused multiply-add on three blocks")

    # (e) the paintera label container over its ROI
    conf_p = volume_config(work, "volume_paintera", roi_begin=PAINTERA_ROI[0],
                           roi_end=PAINTERA_ROI[1])
    out_p = os.path.join(work, "volume_paintera.n5")
    roi_bb = tuple(slice(b, e) for b, e in zip(*PAINTERA_ROI))
    run_workflow(W.PainteraConversionWorkflow(
        os.path.join(work, "tmp_paintera"), conf_p, input_path=path, input_key="ws",
        output_path=out_p, label_group="paintera", scale_factors=[[1, 2, 2], [1, 2, 2]],
        resolution=[40, 4, 4]), "PainteraConversionWorkflow (ROI)",
        int(np.prod([e - b for b, e in zip(*PAINTERA_ROI)])), card, walls)
    fp = file_reader(out_p, "r")
    m = LM.read_multiset_region(fp["paintera/data/s0"], roi_bb)
    if not np.array_equal(m.argmax.reshape(ws[roi_bb].shape), ws[roi_bb]):
        raise AssertionError("paintera: the s0 multiset's argmax differs from the labels")
    uniq0 = fp["paintera/unique-labels/s0"]
    roi_blocks = [b for b in range(blocking.n_blocks)
                  if all(s.start >= lo and s.stop <= hi for s, lo, hi in
                         zip(blocking.block(b).slicing, *PAINTERA_ROI))]
    for bid in roi_blocks:
        got = uniq0.read_chunk_varlen(blocking.block_grid_position(bid))
        if not np.array_equal(got, np.unique(ws[blocking.block(bid).slicing])):
            raise AssertionError(f"paintera: unique labels of s0 block {bid} differ from numpy's")
    s1_region = ws[:BLOCK[0], :2 * BLOCK[1], :2 * BLOCK[2]].copy()  # s1 block 0's footprint
    s1_region[:, PAINTERA_ROI[1][1]:] = 0  # s0 chunks outside the ROI are unwritten: background
    s1_region[:, :, PAINTERA_ROI[1][2]:] = 0
    if not np.array_equal(fp["paintera/unique-labels/s1"].read_chunk_varlen((0, 0, 0)),
                          np.unique(s1_region)):
        raise AssertionError("paintera: unique labels of s1 block 0 differ from numpy's")
    mapping = PT.read_label_block_mapping(out_p, "paintera/label-to-block-mapping/s0")
    for bid in roi_blocks:
        for label in np.unique(ws[blocking.block(bid).slicing]).tolist():
            if bid not in mapping.get(int(label), []):
                raise AssertionError(f"paintera: label {label} of block {bid} not in the mapping")
    if sum(len(v) for v in mapping.values()) != sum(
            np.unique(ws[blocking.block(b).slicing]).size for b in roi_blocks):
        raise AssertionError("paintera: the mapping lists blocks that do not hold the label")
    log(f"paintera over {PAINTERA_ROI}: s0 argmax equals the labels; unique labels of s0 blocks "
        f"{roi_blocks} and s1 block 0 equal numpy's; the mapping inverts them ({len(mapping)} ids)")
    if libs["h5py"]:
        h5 = os.path.join(work, "volume_bdv.h5")
        run_workflow(W.PainteraToBdvWorkflow(os.path.join(work, "tmp_bdv_h5"), conf,
                                             input_path=path, input_key_prefix="pyramid",
                                             output_path=h5),
                     "PainteraToBdvWorkflow bdv.hdf5", vox, card, walls)
        from cluster_tools_tpu_torch.utils import store

        fh = file_reader(h5, "r")
        for s in range(4):
            if not np.array_equal(fh[f"t00000/s00/{s}/cells"][:], f[f"pyramid/s{s}"][:]):
                raise AssertionError(f"bdv.hdf5 scale {s} differs from the paintera scale")
        store.release_h5_handles()
        import h5py

        big = os.path.join(work, "volume_bigcat.h5")
        with h5py.File(big, "w") as fh5:
            fh5.create_dataset("volumes/raw", data=raw8[roi_bb])
            fh5.create_dataset("volumes/labels/fragments", data=ws[roi_bb])
        n_frag = int(ws[roi_bb].max()) + 1
        assignments = (np.arange(n_frag) % 7).astype(np.uint64)
        f.create_dataset("assignments", data=assignments, chunks=(n_frag,))
        run_workflow(W.BigcatWorkflow(os.path.join(work, "tmp_bigcat"), conf_l,
                                      assignment_path=path, assignment_key="assignments",
                                      output_path=big, resolution=[40, 4, 4]),
                     "BigcatWorkflow (ROI)", int(ws[roi_bb].size), card, walls)
        with h5py.File(big, "r") as fh5:
            lut = fh5["fragment_segment_lut"][:]
            if not (np.array_equal(lut[0], np.arange(n_frag)) and
                    np.array_equal(lut[1], assignments + np.uint64(n_frag))
                    and int(fh5.attrs["next_id"]) == int(lut.max()) + 1):
                raise AssertionError("bigcat: the fragment-segment table or next_id is wrong")
        log("bdv.hdf5: every scale equal to the paintera one; bigcat: the table and next_id right")
    else:
        log("phase 25: no h5py on this host: the bdv.hdf5 and bigcat legs are left out")

    # the device functions at the phase's shapes (CUDA events)
    records = volume_device_functions(raw8, pads[0], shallow_np, mask, a, b, launches, card, dev)
    records += refit_kernel_times(refit_call, launches["ScaleToBoundariesTask in plane"],
                                  card)
    seconds = time.perf_counter() - t_phase
    log(f"phase 25 done ({seconds:.1f} s)")
    return {"walls": walls, "launches": launches, "records": records, "seconds": seconds,
            "shape": shape}


def refit_kernel_times(call: dict, launches: dict, card: str) -> list:
    """Kernel 3 and the 3d flood timed (``cuda_ms``) on the inputs of the
    largest block of ``ScaleToBoundariesTask``'s in-plane run whose seeds
    hold objects (an interior block, halo'd in y and x), with the arguments
    ``seeded_watershed`` gives them under ``FLOOD_TILE``; bounds as phase
    5's, 13 and 17 bytes per voxel.  The launches counted here are not the
    run's."""
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_tiles_warm, flood_volume
    from cluster_tools_tpu_torch.ops.cc import parse_tile_spec
    from cluster_tools_tpu_torch.ops.watershed import resolve_flood_tile

    hmap, seeds = call["hmap"], call["seeds"]
    h, w = hmap.shape[-2:]
    mask = torch.ones(hmap.shape, dtype=torch.bool, device=hmap.device)
    tile = resolve_flood_tile(tuple(hmap.shape[-3:]), parse_tile_spec(FLOOD_TILE, 3))
    k3_args = (hmap.reshape(-1, h, w), seeds.reshape(-1, h, w), mask.reshape(-1, h, w), tile[1:])
    saved = (flood_tiles_warm.launches, flood_volume.launches)
    warm = flood_tiles_warm(*k3_args).view((1,) + tuple(hmap.shape))
    fv_args = tuple(t.reshape((1,) + tuple(hmap.shape)) for t in (hmap, seeds, mask))
    records = []
    for name, fn, args, kwargs, per_voxel in (
            ("flood_tiles_warm", flood_tiles_warm, k3_args, {}, 13),
            ("flood_volume", flood_volume, fv_args, {"warm": warm}, 17)):
        ms = cuda_ms(lambda: fn(*args, **kwargs), 5)
        vox = args[0].numel()
        records.append({"name": f"{name} at ScaleToBoundariesTask's block", "shape":
                        list(args[0].shape), "ms": ms, "launches": launches[name],
                        "bound_ms": per_voxel * vox / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                        "library_ms": None})
        log(f"kernel on {card}: {records[-1]}")
    flood_tiles_warm.launches, flood_volume.launches = saved
    return records


def volume_device_functions(raw8, minfilter_block, raw, mask, a, b, launches: dict, card: str,
                            dev) -> list:
    """Phase 25's device functions timed on the card at the phase's shapes
    (``cuda_ms``, CUDA events): ``downscale`` "interpolate" and "mean" on one
    s1 block's input (32, 512, 512) uint8 ([1, 2, 2]), the minimum filter on
    one halo'd block of the half-resolution mask, the affine step on one
    block.  Bounds: bytes (inputs read once, outputs written once) over
    3.35 TB/s against float32 operations over 67 TFLOP/s — the interpolation
    a multiply-add per nonzero tap of its weight matrices, the mean 4 adds
    and a division per output, the minimum filter one comparison per window
    tap of each separable pass, the affine step one multiply-add.  Library:
    ``F.interpolate`` (bilinear, antialiased) for the interpolation, its
    largest difference printed; ``F.avg_pool3d`` for the mean (the shape
    divides); none for the rest."""
    from cluster_tools_tpu_torch.ops import resample
    from cluster_tools_tpu_torch.ops.filters import minimum_filter
    from cluster_tools_tpu_torch.tasks.transformations import linear_batch

    def bound(nbytes, ops):
        bb, oo = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (bb, "bytes") if bb >= oo else (oo, "operations")

    saved = {fn: fn.launches for fn in (resample.downscale, minimum_filter, linear_batch)}
    zb, yb, xb = BLOCK
    x = torch.from_numpy(raw8[:zb, :2 * yb, :2 * xb]).to(dev)
    n_in, n_out = x.numel(), x.numel() // 4
    records = []
    interp = resample.downscale(x, [1, 2, 2], "interpolate")
    interp_ms = cuda_ms(lambda: resample.downscale(x, [1, 2, 2], "interpolate"), 5)
    # the triangle's taps: a multiply-add for each nonzero weight of the y
    # pass (over every x) and of the x pass (over the halved y)
    z, y, xw = x.shape
    y2 = -(-y // 2)
    taps_y = int((resample.weight_matrix(y, y2, dev) != 0).sum())
    taps_x = int((resample.weight_matrix(xw, -(-xw // 2), dev) != 0).sum())
    b_ms, b_by = bound(n_in + 4 * n_out, 2 * z * (xw * taps_y + y2 * taps_x))
    # z is unchanged, so one antialiased bilinear resize of the planes is the
    # same function (the half-pixel triangle widened by the factor, renormalised)
    xf = x.float()[None]

    def library():
        return torch.nn.functional.interpolate(xf, size=tuple(interp.shape[1:]),
                                               mode="bilinear", antialias=True)

    lib_err = float((library()[0] - interp).abs().max())
    lib_ms = cuda_ms(library, 5)
    records.append({"name": "downscale interpolate ([1, 2, 2], antialiased linear; "
                            "DownscalingTask)", "shape": list(x.shape), "ms": interp_ms,
                    "launches": launches["downscale interpolate"]["downscale"],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                    "library_max_abs_err": lib_err})
    del interp
    mean_ms = cuda_ms(lambda: resample.downscale(x, [1, 2, 2], "mean"), 5)
    xf = x.float()
    lib_ms = cuda_ms(lambda: torch.nn.functional.avg_pool3d(xf[None, None], (1, 2, 2)), 5)
    b_ms, b_by = bound(n_in + 4 * n_out, 5 * n_out)
    records.append({"name": "downscale mean ([1, 2, 2]; DownscalingTask, skimage)",
                    "shape": list(x.shape), "ms": mean_ms,
                    "launches": launches["downscale mean"]["downscale"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms})
    del x, xf
    m = torch.from_numpy(minfilter_block[None]).to(dev)
    size = [10, 100, 100]
    mf_ms = cuda_ms(lambda: minimum_filter(m, size), 3)
    b_ms, b_by = bound(8 * m.numel(), sum(size) * m.numel())
    records.append({"name": "minimum_filter ((10, 100, 100); MinfilterTask)",
                    "shape": list(m.shape), "ms": mf_ms,
                    "launches": launches["minimum_filter (MinfilterTask)"]["minimum_filter"],
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    del m
    xs = torch.from_numpy(np.ascontiguousarray(raw[:zb, :yb, :xb])[None]).to(dev)
    ms_ = torch.from_numpy(mask[:zb, :yb, :xb][None] > 0).to(dev)
    az = torch.from_numpy(a[:zb, 0, 0][None].copy()).to(dev)
    bz = torch.from_numpy(b[:zb, 0, 0][None].copy()).to(dev)
    lin_ms = cuda_ms(lambda: linear_batch(xs, az, bz, ms_), 5)
    b_ms, b_by = bound(9 * xs.numel(), 2 * xs.numel())
    records.append({"name": "linear_batch (masked a*x + b, one rounding; "
                            "LinearTransformationTask)", "shape": list(xs.shape), "ms": lin_ms,
                    "launches": launches["linear_batch"]["linear_batch"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    for fn, n in saved.items():
        fn.launches = n
    for rec in records:
        rec["gap_ms"] = rec["ms"] - rec["bound_ms"]
        log(f"device function on {card}: {rec}")
    return records


# -- phase 26: inference and analysis -------------------------------------------
# On the first SHALLOW_Z planes at full width (25 blocks of BLOCK), the cuda
# target: the JAX package's full-width U-Net with random seeded weights through
# InferenceTask, the 2d watershed of its boundary channel (kernels 2 and 1),
# EvaluationWorkflow against phase 3's watershed, then skeletons, meshes and
# object distances on crops of phase 3's watershed.

UNET_CONFIG = {"model": "UNet3D", "in_channels": 1, "out_channels": 3, "initial_features": 16,
               "depth": 3, "scale_factors": [[1, 2, 2], [1, 2, 2]]}
UNET_HALO = [4, 32, 32]  # each input (40, 320, 320)
BF16_DENSE_OPS_PER_S = 989e12  # H100 SXM tensor cores, dense bf16
ANALYSIS_RESOLUTION = [40.0, 4.0, 4.0]  # CREMI's voxel pitch (nm)
# skeletons and meshes: the crop's largest objects (their size filter); 48 took 17.1 and 7.2 s
# of host Python in a 952.7 s script on one host
SKELETON_OBJECTS = 16
DISTANCE_CROP = (SHALLOW_Z, 64, 64)  # the distance workflow has no id filter: a smaller crop
MAX_DISTANCE = 50.0  # nm: objects one plane apart (40 nm) are in reach


def check_prediction_block(model, raw_ds, f, bid: int, blocking, preprocess, dev) -> None:
    """Block ``bid`` re-predicted by calling the module on the same
    reflect-padded, preprocessed input: the written bytes must equal it."""
    from cluster_tools_tpu_torch.models.unet import unet_forward
    from cluster_tools_tpu_torch.tasks.inference import load_input_with_halo, to_uint8

    block = blocking.block(bid)
    x = preprocess(load_input_with_halo(raw_ds, block.begin, BLOCK, UNET_HALO))
    saved = unet_forward.launches
    out = unet_forward(model, torch.from_numpy(x)[None, None].to(dev))[0].float().cpu().numpy()
    unet_forward.launches = saved
    crop = (slice(None),) + tuple(slice(h, h + e - b) for h, b, e in
                                  zip(UNET_HALO, block.begin, block.end))
    want = to_uint8(out[crop])
    if not (np.array_equal(f["pred"][(slice(None),) + block.slicing], want)
            and np.array_equal(f["bmap"][block.slicing], want[0])):
        raise AssertionError(f"inference block {bid}: the written bytes differ from the module's")


def analysis_crops(ws3: np.ndarray) -> tuple:
    """Phase 3's watershed cut to the analysis crops: block 0 for skeletons
    and meshes, ``DISTANCE_CROP`` for distances; the skeleton size filter
    that keeps the crop's ``SKELETON_OBJECTS`` largest objects."""
    crop = np.ascontiguousarray(ws3[tuple(slice(0, s) for s in BLOCK)])
    ids, sizes = np.unique(crop[crop > 0], return_counts=True)
    size_threshold = int(np.sort(sizes)[::-1][min(SKELETON_OBJECTS, sizes.size) - 1])
    dist_crop = np.ascontiguousarray(crop[tuple(slice(0, s) for s in DISTANCE_CROP)])
    return crop, dist_crop, ids, sizes, size_threshold


def check_skeletons(tmp: str, crop: np.ndarray, expected: set, dev) -> int:
    """Every skeleton of an id the size filter keeps, its nodes inside its
    object; three ids re-skeletonised on the host (the EDT on the CPU) must
    equal the task's."""
    from cluster_tools_tpu_torch.ops.skeleton import skeletonize
    from cluster_tools_tpu_torch.tasks.morphology import load_morphology
    from cluster_tools_tpu_torch.tasks.skeletons import load_skeletons

    skels = load_skeletons(tmp)
    if set(skels) != expected:
        raise AssertionError(f"skeletons of {sorted(set(skels) ^ expected)[:8]} missing or extra")
    res = np.asarray(ANALYSIS_RESOLUTION)
    n_nodes = 0
    for sid, (nodes, _) in skels.items():
        vox = np.round(nodes / res).astype(np.int64)
        if not (crop[tuple(vox.T)] == sid).all():
            raise AssertionError(f"skeleton {sid}: nodes outside the object")
        n_nodes += len(nodes)
    rows = {int(r[0]): r for r in load_morphology(tmp)}
    for sid in sorted(skels)[:3]:
        row = rows[sid]
        bb = tuple(slice(max(int(lo) - 2, 0), min(int(hi) + 2, s))
                   for lo, hi, s in zip(row[5:8], row[8:11], crop.shape))
        nodes, edges = skeletonize(crop[bb] == sid, device="cpu")
        nodes = (nodes + [b.start for b in bb]) * res
        if not (np.array_equal(nodes, skels[sid][0]) and np.array_equal(edges, skels[sid][1])):
            raise AssertionError(f"skeleton {sid}: the host's recomputation differs")
    return n_nodes


def check_meshes(out_dir: str, tmp: str, crop: np.ndarray, expected: set) -> int:
    """Every mesh of an id the size filter keeps, its vertices inside the
    object's bounding box (half a voxel around the surface); three ids
    re-meshed on the host must equal the files."""
    from cluster_tools_tpu_torch.ops.mesh import marching_cubes, read_obj
    from cluster_tools_tpu_torch.tasks.morphology import load_morphology

    files = {int(name.split(".")[0]) for name in os.listdir(out_dir)}
    if files != expected:
        raise AssertionError(f"meshes of {sorted(files ^ expected)[:8]} missing or extra")
    res = np.asarray(ANALYSIS_RESOLUTION)
    rows = {int(r[0]): r for r in load_morphology(tmp)}
    n_faces = 0
    recompute = sorted(files)[:3]
    for sid in sorted(files):
        verts, faces, _ = read_obj(os.path.join(out_dir, f"{sid}.obj"))
        lo, hi = rows[sid][5:8] - 0.5, rows[sid][8:11] - 0.5
        vox = verts / res
        if not ((vox >= lo - 1e-9) & (vox <= hi + 1e-9)).all():
            raise AssertionError(f"mesh {sid}: vertices outside the bounding box")
        n_faces += len(faces)
        if sid in recompute:
            bb = tuple(slice(int(a), int(b)) for a, b in zip(rows[sid][5:8], rows[sid][8:11]))
            v, fc, _ = marching_cubes(crop[bb] == sid)
            v = (v + [b.start for b in bb]) * res
            if not (np.array_equal(v, verts) and np.array_equal(fc, faces)):
                raise AssertionError(f"mesh {sid}: the host's recomputation differs")
    return n_faces


def check_distances(tmp: str, dist_crop: np.ndarray) -> int:
    """For five ids, every other id's distance is the minimum of scipy's EDT
    of the id's complement (``sampling`` = the resolution) over the other
    id, in float32: present where below ``MAX_DISTANCE``, absent elsewhere."""
    from scipy import ndimage

    from cluster_tools_tpu_torch.tasks.distances import load_object_distances

    got = load_object_distances(tmp)
    ids = np.unique(dist_crop[dist_crop > 0])
    for a in ids[:: max(1, ids.size // 5)][:5]:
        edt = ndimage.distance_transform_edt(dist_crop != a, sampling=ANALYSIS_RESOLUTION)
        for b in ids[ids > a]:
            d = edt[dist_crop == b].min()
            key = (int(a), int(b))
            if d < MAX_DISTANCE:
                if key not in got or np.float32(got[key]) != np.float32(d):
                    raise AssertionError(f"distance {key}: {got.get(key)} against scipy's {d}")
            elif key in got:
                raise AssertionError(f"distance {key}: {got[key]} is beyond {MAX_DISTANCE}")
    return len(got)


def inference_phase(shallow_path: str, ws_path: str, work: str, card: str, libs: dict,
                    dev, seed: int) -> dict:
    """Phase 26 on the first ``SHALLOW_Z`` planes.  (a) ``UNet3D``
    (``UNET_CONFIG``: the JAX class's full width and depth, CREMI's
    anisotropy) with flax's initialisation drawn from a seeded generator,
    saved with ``save_checkpoint``, through ``InferenceTask`` on the map
    (halo ``UNET_HALO``, ``{"pred": [0, 3], "bmap": [0, 1]}``, uint8).
    Gates: a corner and an interior block re-predicted by calling the module
    on the same input equal the written bytes; the bf16 and the float32
    forward of one block within the JAX test's 0.05 + 0.05·|f32|;
    ``augmentation_mode="all"`` on one block equal to the average of the
    module's forward of the 8 mirrored inputs (one batch, mirrored back on
    the host, summed in ``mirror_flip_sets``' order); a mask over the first
    two block columns leaves the other 15 blocks zero and the 10 it covers
    equal to the full run.  (b) ``WatershedWorkflow`` on ``bmap`` (threshold
    at the map's median): kernels 2 and 1 launch, down the cluster route.
    (c) ``EvaluationWorkflow`` of that watershed against phase 3's on the
    same planes: Rand and VoI equal ``ops/evaluation.py`` on one contingency
    table of the whole crop.  (d) ``SkeletonWorkflow`` and ``MeshWorkflow``
    (one tmp folder, one morphology) on block 0 of phase 3's watershed,
    the size filter at its ``SKELETON_OBJECTS``-th largest object, and
    ``DistanceWorkflow`` on ``DISTANCE_CROP``, all at CREMI's resolution;
    gates in ``check_skeletons``, ``check_meshes``, ``check_distances``.
    Without h5py the ilastik carving leg prints a cut line; the prediction
    leg needs an ilastik install, which no host here has.  Returns walls,
    launches, the U-Net's device-function record and the seconds."""
    from cluster_tools_tpu_torch import workflows as W
    from cluster_tools_tpu_torch.models import unet
    from cluster_tools_tpu_torch.ops import evaluation
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.ops.segment import contingency_table
    from cluster_tools_tpu_torch.tasks import InferenceTask
    from cluster_tools_tpu_torch.tasks.evaluation import load_measures
    from cluster_tools_tpu_torch.tasks.frameworks import (
        get_preprocessor, mirror_flip_sets, JaxPredictor)
    from cluster_tools_tpu_torch.tasks.inference import load_input_with_halo
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    t_phase = time.perf_counter()
    walls, launches = {}, {}
    path = os.path.join(work, "inference.n5")
    f = file_reader(path)
    raw_ds = file_reader(shallow_path, "r")["raw"]
    shape = tuple(raw_ds.shape)
    blocking = Blocking(shape, BLOCK)
    vox = int(np.prod(shape))
    t0 = time.perf_counter()
    ws3 = read_volume(file_reader(ws_path, "r")["ws"], blocking)
    write_blocks(f.create_dataset("ws3", shape=shape, dtype="uint64", chunks=BLOCK,
                                  compression="raw"), ws3, blocking)
    mask = np.zeros(shape, np.uint8)
    mask[:, :, :2 * BLOCK[2]] = 1
    write_blocks(f.create_dataset("mask", shape=shape, dtype="uint8", chunks=BLOCK,
                                  compression="raw"), mask, blocking)
    ckpt = os.path.join(work, "unet")
    model = unet.init_flax_like(unet.model_from_config(UNET_CONFIG),
                                torch.Generator().manual_seed(seed))
    unet.save_checkpoint(ckpt, model, UNET_CONFIG)
    model = unet.load_checkpoint(ckpt, dev)
    log(f"setup: phase 26's inputs (phase 3's first {shape[0]} planes, a mask) and "
        f"a U-Net checkpoint ({sum(p.numel() for p in model.parameters())} parameters) in "
        f"{time.perf_counter() - t0:.1f} s")

    # (a) the inference run
    conf = volume_config(work, "inference", {"inference": {"prefetch_threads": 4}})
    reset_counts(unet.unet_forward)
    run_workflow(InferenceTask(os.path.join(work, "tmp_inference"), conf,
                               input_path=shallow_path, input_key="raw", output_path=path,
                               output_key={"pred": [0, 3], "bmap": [0, 1]},
                               checkpoint_path=ckpt, halo=UNET_HALO), "InferenceTask", vox,
                 card, walls)
    launches["unet_forward"] = launches_rose([unet.unet_forward], "InferenceTask")["unet_forward"]
    preprocess = get_preprocessor("zero_mean_unit_variance")
    inner = blocking.n_blocks // 2
    for bid in (0, inner):
        check_prediction_block(model, raw_ds, f, bid, blocking, preprocess, dev)
    bmap = read_volume(f["bmap"], blocking)
    log(f"inference: {launches['unet_forward']} forwards; blocks 0 and {inner} re-predicted "
        f"by the module: equal bytes; bmap mean {float(bmap.mean()) / 255:.4f}, "
        f"quartiles {np.percentile(bmap, [25, 50, 75]).tolist()}")

    # bf16 against float32, one block
    block = blocking.block(inner)
    x = torch.from_numpy(preprocess(load_input_with_halo(raw_ds, block.begin, BLOCK,
                                                         UNET_HALO)))[None, None].to(dev)
    saved = unet.unet_forward.launches
    f32 = unet.model_from_config({**UNET_CONFIG, "dtype": "float32"})
    f32.load_state_dict(model.state_dict())
    f32 = f32.to(dev).eval()
    y16 = unet.unet_forward(model, x).float()
    y32 = unet.unet_forward(f32, x)
    err = (y16 - y32).abs()
    if not bool((err <= 0.05 + 0.05 * y32.abs()).all()):
        raise AssertionError(f"bf16 and float32 forwards differ by up to {float(err.max())}")
    log(f"bf16 against float32 forward on block {inner}: max abs difference "
        f"{float(err.max()):.3e}, mean {float(err.mean()):.3e} (allowed 0.05 + 0.05 |f32|)")
    del f32, y32, err

    # mirror TTA, one block: the predictor against the module on the 8 mirrors
    tta = JaxPredictor(ckpt, UNET_HALO, augmentation_mode="all",
                       config={"device": str(dev)})
    got = tta(x)
    flips = mirror_flip_sets(3)
    xs = torch.cat([torch.flip(x, axes) if axes else x for axes in flips])
    outs = unet.unet_forward(model, xs).float().cpu().numpy()
    acc = np.zeros_like(outs[:1])
    for i, axes in enumerate(flips):
        part = outs[i:i + 1]
        acc += np.flip(part, axes) if axes else part
    want = (acc / len(flips))[(Ellipsis,) + tuple(slice(h, -h) for h in UNET_HALO)]
    if not np.array_equal(got, want):
        raise AssertionError(f"TTA differs from the manual average by up to "
                             f"{float(np.abs(got - want).max())}")
    log(f"TTA on block {inner}: one batched forward of {len(flips)} mirrors equals the manual "
        f"average")
    unet.unet_forward.launches = saved
    del tta, xs, outs

    # the masked run
    reset_counts(unet.unet_forward)
    run_workflow(InferenceTask(os.path.join(work, "tmp_inference_mask"), conf,
                               input_path=shallow_path, input_key="raw", output_path=path,
                               output_key={"bmap_masked": [0, 1]}, checkpoint_path=ckpt,
                               halo=UNET_HALO, mask_path=path, mask_key="mask"),
                 "InferenceTask (mask)", vox, card, walls)
    masked = read_volume(f["bmap_masked"], blocking)
    covered = [bid for bid in range(blocking.n_blocks)
               if mask[blocking.block(bid).slicing].any()]
    for bid in range(blocking.n_blocks):
        bb = blocking.block(bid).slicing
        if bid in covered and not np.array_equal(masked[bb], bmap[bb]):
            raise AssertionError(f"masked run block {bid}: differs from the full run")
        if bid not in covered and masked[bb].any():
            raise AssertionError(f"masked run block {bid}: written outside the mask")
    if unet.unet_forward.launches != len(covered):
        raise AssertionError(f"masked run: {unet.unet_forward.launches} forwards for "
                             f"{len(covered)} covered blocks")
    log(f"mask: {len(covered)} blocks predicted (equal to the full run), "
        f"{blocking.n_blocks - len(covered)} left zero")
    del masked

    # (b) the watershed of the prediction
    threshold = float(np.median(bmap)) / 255.0
    conf_ws = volume_config(work, "inference_ws",
                            {"watershed": {**WatershedTask.default_task_config(),
                                           "threshold": threshold}})
    reset_counts(dtws_slices, flood_slices)
    run_workflow(W.WatershedWorkflow(os.path.join(work, "tmp_inference_ws"), conf_ws,
                                     input_path=path, input_key="bmap", output_path=path,
                                     output_key="ws_pred"),
                 "WatershedWorkflow on the prediction", vox, card, walls)
    for name, wrapper in (("dtws_slices", dtws_slices), ("flood_slices", flood_slices)):
        if wrapper.launches == 0 or wrapper.launches_by_route["cluster"] != wrapper.launches:
            raise AssertionError(f"{name}: launches {wrapper.launches}, by route "
                                 f"{dict(wrapper.launches_by_route)}")
        launches[name] = wrapper.launches
    ws_pred = read_volume(f["ws_pred"], blocking)
    log(f"watershed of the prediction (threshold {threshold:.4f}): "
        f"{len(np.unique(ws_pred)) - 1} segments; launches {launches}")

    # (c) evaluation against phase 3's watershed
    tmp_eval = os.path.join(work, "tmp_evaluation")
    run_workflow(W.EvaluationWorkflow(tmp_eval, conf, seg_path=path, seg_key="ws_pred",
                                      gt_path=path, gt_key="ws3"),
                 "EvaluationWorkflow", vox, card, walls)
    got = load_measures(tmp_eval)
    ia, ib, counts = contingency_table(ws_pred, ws3)
    keep = ib != 0
    want = evaluation.rand_scores(ia[keep], ib[keep], counts[keep])
    want.update(evaluation.vi_scores(ia[keep], ib[keep], counts[keep]))
    if got != want:
        raise AssertionError(f"EvaluationWorkflow {got} differs from one table's {want}")
    log(f"evaluation: {got} (equal to one contingency table of the crop, {ia.size} pairs)")
    del ws_pred, bmap

    # (d) skeletons, meshes and distances on crops of phase 3's watershed
    crop, dist_crop, ids, sizes, size_threshold = analysis_crops(ws3)
    f.create_dataset("ws_crop", data=crop, chunks=BLOCK, compression="raw")
    f.create_dataset("ws_dist", data=dist_crop, chunks=BLOCK, compression="raw")
    expected = {int(i) for i, n in zip(ids, sizes) if n >= size_threshold}
    conf_an = volume_config(work, "analysis", {
        "skeletonize": {"size_threshold": size_threshold, "resolution": ANALYSIS_RESOLUTION},
        "compute_meshes": {"size_threshold": size_threshold,
                           "resolution": ANALYSIS_RESOLUTION},
        "object_distances": {"max_distance": MAX_DISTANCE,
                             "resolution": ANALYSIS_RESOLUTION}})
    tmp_an = os.path.join(work, "tmp_analysis")
    crop_vox = int(crop.size)
    run_workflow(W.SkeletonWorkflow(tmp_an, conf_an, input_path=path, input_key="ws_crop"),
                 "SkeletonWorkflow", crop_vox, card, walls)
    n_nodes = check_skeletons(tmp_an, crop, expected, dev)
    mesh_dir = os.path.join(work, "meshes")
    run_workflow(W.MeshWorkflow(tmp_an, conf_an, input_path=path, input_key="ws_crop",
                                output_dir=mesh_dir), "MeshWorkflow", crop_vox, card, walls)
    n_faces = check_meshes(mesh_dir, tmp_an, crop, expected)
    tmp_dist = os.path.join(work, "tmp_distances")
    run_workflow(W.DistanceWorkflow(tmp_dist, conf_an, input_path=path, input_key="ws_dist"),
                 "DistanceWorkflow", int(dist_crop.size), card, walls)
    n_pairs = check_distances(tmp_dist, dist_crop)
    log(f"analysis: block 0 holds {ids.size} objects, {len(expected)} of at least "
        f"{size_threshold} voxels skeletonised ({n_nodes} nodes) and meshed ({n_faces} "
        f"faces), host recomputations equal; {n_pairs} object pairs within {MAX_DISTANCE} nm "
        f"on the {DISTANCE_CROP} crop, five ids held to scipy's EDT")
    if libs["h5py"]:
        out = os.path.join(work, "carving.ilp")
        raw_crop = raw_ds[tuple(slice(0, s) for s in BLOCK)]
        f.create_dataset("raw_crop", data=raw_crop, chunks=BLOCK, compression="raw")
        run_workflow(W.IlastikCarvingWorkflow(os.path.join(work, "tmp_carving"), conf,
                                              input_path=path, input_key="raw_crop",
                                              watershed_path=path, watershed_key="ws_crop",
                                              output_path=out),
                     "IlastikCarvingWorkflow", crop_vox, card, walls)
        import h5py

        with h5py.File(out, "r") as fh:
            header = fh["preprocessing/graph/graph"][:4]
        if int(header[0]) != int(ids.max()) + 1:
            raise AssertionError(f"carving: {int(header[0])} nodes for ids up to {ids.max()}")
        log(f"carving: {int(header[0])} nodes, {int(header[1])} edges")
    else:
        log("phase 26: no h5py on this host: the ilastik carving leg is left out")
    log("phase 26: no ilastik install on this host: IlastikPredictionWorkflow is left out "
        "(the CPU tests drive it with a stand-in)")

    # the U-Net forward timed on the card (CUDA events), at batch 1 and 4
    records = []
    for batch in (1, 4):
        xb = x.expand(batch, -1, -1, -1, -1).contiguous()
        ms = cuda_ms(lambda: unet.unet_forward(model, xb), 3)
        flops = model.flops(tuple(x.shape[2:]), batch)
        records.append({
            "name": f"UNet3D forward (bf16, {UNET_CONFIG['initial_features']} features, depth "
                    f"{UNET_CONFIG['depth']}; InferenceTask)",
            "shape": list(xb.shape), "ms": ms, "launches": launches["unet_forward"],
            "bound_ms": flops / BF16_DENSE_OPS_PER_S * 1e3, "bound_by": "operations",
            "library_ms": None, "flops": flops,
            "achieved_tflops": flops / (ms * 1e-3) / 1e12})
    unet.unet_forward.launches = saved
    for rec in records:
        rec["gap_ms"] = rec["ms"] - rec["bound_ms"]
        log(f"device function on {card}: {rec}")
    seconds = time.perf_counter() - t_phase
    log(f"phase 26 done ({seconds:.1f} s)")
    return {"walls": walls, "launches": launches, "records": records, "seconds": seconds,
            "shape": shape}


HIER_QUANTILES = (0.25, 0.5, 0.9)  # phase 27(b)'s re-cut thresholds, quantiles of the saddles
EVENT_FRAMES = (2048, 256, 256)  # phase 27(c): frames of a Timepix-class 256 x 256 sensor
EVENT_BLOCK = (64, 256, 256)
EVENT_CHECK_EVERY = 32  # every 32nd frame is held to scipy's labels
HIER_CORNER = (0, 512, 512)  # phase 27(d)'s halo'd block: an interior one
HIER_CROP = (16, 64, 64)  # phase 27(d)'s capped and 26-connected floods, held to the CPU
HIER_TILE_CROP = (8, 32, 32)  # its corner: seeded_watershed_hier held to the CPU (the CPU's
HIER_CROP_TILE = (4, 16, 16)  # sweep schedule walks voxel by voxel, so a smaller crop)


def status_timings(task) -> dict:
    """A task's recorded timings (label -> seconds) from its status file."""
    return {t["label"]: t["seconds"] for t in task.output().read().get("timings", [])}


def detector_frames(shape, seed: int, dev) -> torch.Tensor:
    """``tests/test_events.py::_frame_stack``'s recipe on the card, from
    ``seed``: uniform noise smoothed in plane (sigma 1) and kept above its
    97th percentile (zero below), then 1% of the pixels made hot pixels of
    1 to 2."""
    from cluster_tools_tpu_torch.ops.filters import gaussian

    g = torch.Generator(device=dev).manual_seed(seed)
    raw = gaussian(torch.rand(shape, generator=g, device=dev), (0.0, 1.0, 1.0))
    flat = raw.reshape(-1)
    thr = torch.sort(flat).values[int(0.97 * (flat.numel() - 1))]
    frames = torch.where(raw > thr, raw, torch.zeros_like(raw))
    hits = torch.rand(shape, generator=g, device=dev) > 0.99
    frames[hits] = torch.rand(int(hits.sum()), generator=g, device=dev) + 1.0
    return frames


def device_record(name: str, shape, ms: float, launches: int, nbytes: int) -> dict:
    """A ``device_functions`` record of a plain PyTorch device function
    bounded by the bytes it must move."""
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"name": name, "shape": list(shape), "ms": ms, "launches": launches,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None, "gap_ms": ms - bound}


def hier_phase(shallow_path: str, vol_np, work: str, card: str, dev, seed: int) -> dict:
    """Phase 27.  (a) ``HierarchyWorkflow`` on the first ``SHALLOW_Z``
    planes (25 blocks of ``BLOCK``) with the default ``hierarchy_blocks``
    config: kernels 2 and 1 launch, all down the cluster route, and the
    merge table on the card; blocks 0 and last re-run through the plain
    versions equal the block labels byte for byte and their reduced tables
    the saved ones; the artifact is sorted by saddle (``load_hierarchy``),
    its ``n_labels`` is the sum of the blocks' max ids and the labels volume
    is the blocks' labels plus their offsets; ``ResegmentWorkflow`` at the
    median saddle equals ``resegment_np`` of the whole labels volume.
    (b) ``ResegmentWorkflow`` at the ``HIER_QUANTILES`` of the saddles: the
    segment counts do not rise with the threshold; at the median the table
    mode (``write_volume: false``) applied by ``apply_cut_np`` equals the
    volume mode byte for byte; the cut's and the gather's times.  (c)
    ``EventBuildingWorkflow`` on ``EVENT_FRAMES`` detector-like frames
    (``detector_frames``) in blocks of ``EVENT_BLOCK``, connectivity 2:
    labels and counts equal ``build_events_np`` on every
    ``EVENT_CHECK_EVERY``-th frame, the property rows within 1e-4; the
    labelling's rounds, ms per batch and frames/s.  (d) ``flood_with_stats``
    at the pinned tile (``FLOOD_TILE``) on the halo'd block at
    ``HIER_CORNER``: kernel 3 and the 3d flood launch, labels and altitudes
    equal the flood's plain schedule (``flood_volume_scan``) and the
    untiled call's counters equal its rounds; ``seeded_watershed_hier``'s
    labels equal ``seeded_watershed``'s; on a ``HIER_CROP`` crop the tiled
    counters and merge table, a capped flood (``max_iter`` 3) and a
    26-connected flood equal the same calls on the CPU.  Returns walls,
    launches, the device-function records and the seconds."""
    from cluster_tools_tpu_torch import workflows as W
    from cluster_tools_tpu_torch.ops import events, hier
    from cluster_tools_tpu_torch.ops import watershed as ws_ops
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import (
        flood_slices, flood_tiles_warm, flood_volume, flood_volume_scan)
    from cluster_tools_tpu_torch.tasks.events import read_event_tables
    from cluster_tools_tpu_torch.obs import metrics
    from cluster_tools_tpu_torch.tasks.hier import (
        HIER_OFFSETS_NAME, HIER_PAIRS_KEY, HIER_SADDLES_KEY, HierarchyBlocksTask,
        default_hierarchy_path)
    from cluster_tools_tpu_torch.utils import file_reader
    from cluster_tools_tpu_torch.utils.blocking import Blocking

    t_phase = time.perf_counter()
    walls, launches, records = {}, {}, []
    path = os.path.join(work, "hier.n5")
    raw_ds = file_reader(shallow_path, "r")["raw"]
    shape = tuple(raw_ds.shape)
    blocking = Blocking(shape, BLOCK)
    vox = int(np.prod(shape))

    # (a) the hierarchy build
    conf = volume_config(work, "hier", {"hierarchy_blocks":
                                        HierarchyBlocksTask.default_task_config()})
    reset_counts(dtws_slices, flood_slices, hier.block_merge_table)
    tmp = os.path.join(work, "tmp_hier")
    before = metrics.snapshot()
    run_workflow(W.HierarchyWorkflow(tmp, conf, input_path=shallow_path, input_key="raw",
                                     output_path=path, output_key="seg"),
                 "HierarchyWorkflow", vox, card, walls)
    stream_gate(metrics.delta(before, metrics.snapshot()), "HierarchyWorkflow (fused)")
    for name, wrapper in (("dtws_slices", dtws_slices), ("flood_slices", flood_slices)):
        if wrapper.launches == 0 or wrapper.launches_by_route["cluster"] != wrapper.launches:
            raise AssertionError(f"HierarchyWorkflow {name}: launches {wrapper.launches}, by "
                                 f"route {dict(wrapper.launches_by_route)}")
        launches[name] = wrapper.launches
    launches.update(launches_rose([hier.block_merge_table], "HierarchyWorkflow"))
    t0 = time.perf_counter()
    f = file_reader(path, "r")
    blocks_vol = read_volume(f["seg_blocks"], blocking)
    seg = read_volume(f["seg"], blocking)
    art = hier.load_hierarchy(default_hierarchy_path(path, "seg"))
    max_ids = np.array([int(blocks_vol[blocking.block(b).slicing].max())
                        for b in range(blocking.n_blocks)], np.int64)
    if int(art["n_labels"]) != int(max_ids.sum()):
        raise AssertionError(f"hierarchy n_labels {int(art['n_labels'])}, blocks' max ids sum "
                             f"to {int(max_ids.sum())}")
    offsets = np.concatenate([[0], np.cumsum(max_ids)[:-1]]).astype(np.uint64)

    def global_ids(bid):
        bb = blocking.block(bid).slicing
        lab = blocks_vol[bb]
        if not np.array_equal(seg[bb], np.where(lab > 0, lab + offsets[bid], 0)):
            raise AssertionError(f"hierarchy block {bid}: labels are not the block's plus "
                                 f"its offset")

    over_blocks(global_ids, blocking)
    task = HierarchyBlocksTask(tmp, conf, input_path=shallow_path, input_key="raw",
                               output_path=path, output_key="seg_blocks")
    config = {**task.global_config(), **task.get_task_config()}
    check_ids = [0, blocking.n_blocks - 1]
    saved = hier.block_merge_table.launches
    with plain_kernels():
        batch, labels, tables, _ = task.compute_batch(
            task.read_batch(check_ids, blocking, config), blocking, config)
    hier.block_merge_table.launches = saved
    tmp_store = file_reader(os.path.join(tmp, "data.zarr"), "r")
    for bid, bh, lab, table in zip(check_ids, batch.blocks, labels, tables):
        if not np.array_equal(lab[bh.inner_local.slicing].astype(np.uint64),
                              blocks_vol[bh.inner.slicing]):
            raise AssertionError(f"hierarchy block {bid}: plain re-run differs")
        pairs, saddles = hier.reduce_merge_table(*table)
        if not (np.array_equal(pairs.reshape(-1), tmp_store[HIER_PAIRS_KEY].read_chunk((bid,)))
                and np.array_equal(saddles, tmp_store[HIER_SADDLES_KEY].read_chunk((bid,)))):
            raise AssertionError(f"hierarchy block {bid}: plain re-run's table differs")
    log(f"hierarchy: {int(art['n_labels'])} regions, {art['a'].size} saddle edges; kernel "
        f"launches {launches}; blocks {check_ids} re-run through the plain versions: labels "
        f"and tables equal (checks {time.perf_counter() - t0:.1f} s)")
    # the same build unfused: the chain's carry stands in for the offsets
    # and faces tasks, byte for byte
    conf_u = volume_config(work, "hier_unfused", {"hierarchy_blocks":
                                                  HierarchyBlocksTask.default_task_config()},
                           stream_fusion=False)
    tmp_u = os.path.join(work, "tmp_hier_unfused")
    run_workflow(W.HierarchyWorkflow(tmp_u, conf_u, input_path=shallow_path, input_key="raw",
                                     output_path=path, output_key="seg_unfused"),
                 "HierarchyWorkflow (stream_fusion false)", vox, card, walls)
    for key in ("seg", "seg_blocks"):
        if chunk_files(os.path.join(path, key)) != chunk_files(
                os.path.join(path, key.replace("seg", "seg_unfused"))):
            raise AssertionError(f"HierarchyWorkflow {key}: fused and unfused runs differ")
    for name, (a, b) in {
        "offsets": (os.path.join(tmp, HIER_OFFSETS_NAME), os.path.join(tmp_u, HIER_OFFSETS_NAME)),
        "artifact": (default_hierarchy_path(path, "seg"),
                     default_hierarchy_path(path, "seg_unfused")),
    }.items():
        with np.load(a) as fa, np.load(b) as fb:
            if sorted(fa.files) != sorted(fb.files) or not all(
                    fa[k].dtype == fb[k].dtype and fa[k].tobytes() == fb[k].tobytes()
                    for k in fa.files):
                raise AssertionError(f"HierarchyWorkflow {name}: fused and unfused runs differ")
    log(f"HierarchyWorkflow fused ({walls['HierarchyWorkflow']:.3f} s) and unfused "
        f"({walls['HierarchyWorkflow (stream_fusion false)']:.3f} s): labels, block labels, "
        f"offsets and artifact byte-identical")

    # (a, b) re-cuts
    raw = read_volume(raw_ds, blocking)
    thresholds = [float(t) for t in np.quantile(art["saddle"], HIER_QUANTILES)]
    cuts, counts, cut_launches = {}, [], 0
    for i, t in enumerate(thresholds):
        tag = f"cut{i}"
        conf_rs = volume_config(work, f"hier_{tag}", {"resegment": {"threshold": t}})
        reset_counts(hier.recut_labels)
        wf = W.ResegmentWorkflow(os.path.join(work, f"tmp_hier_{tag}"), conf_rs,
                                 labels_path=path, labels_key="seg", output_path=path,
                                 output_key=f"seg_{tag}")
        run_workflow(wf, f"ResegmentWorkflow q{HIER_QUANTILES[i]}", vox, card, walls)
        cut_launches = launches_rose([hier.recut_labels], "ResegmentWorkflow")["recut_labels"]
        timings = status_timings(wf.requires()[0])
        out = read_volume(file_reader(path, "r")[f"seg_{tag}"], blocking)
        n = int(torch.unique(torch.from_numpy(out.view(np.int64)).to(dev)).numel())
        counts.append(n)
        cuts[t] = out
        log(f"re-cut at {t:.6f} (quantile {HIER_QUANTILES[i]}): {n} ids with background; cut "
            f"{timings['cut_table'] * 1e3:.2f} ms, gather stage {timings['stage_compute_total']:.3f}"
            f" s over {cut_launches} batches")
    launches["recut_labels"] = cut_launches
    if counts != sorted(counts, reverse=True) or counts[-1] >= counts[0]:
        raise AssertionError(f"re-cut segment counts {counts} rise with the threshold")
    t_med = thresholds[HIER_QUANTILES.index(0.5)]
    t0 = time.perf_counter()
    oracle = hier.resegment_np(seg, raw, t_med)
    if not np.array_equal(cuts[t_med].astype(np.int64), oracle):
        raise AssertionError("the re-cut at the median saddle differs from resegment_np")
    log(f"re-cut at the median equals resegment_np of the whole volume "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    del oracle
    t0 = time.perf_counter()
    conf_tm = volume_config(work, "hier_table", {"resegment": {"threshold": t_med,
                                                               "write_volume": False}})
    run_workflow(W.ResegmentWorkflow(os.path.join(work, "tmp_hier_table"), conf_tm,
                                     labels_path=path, labels_key="seg", output_path=path,
                                     output_key="seg_table"),
                 "ResegmentWorkflow (table mode)", vox, card, walls)
    table = hier.load_cut_table(os.path.join(path, "seg_table_cut.npz"))
    if not np.array_equal(hier.apply_cut_np(seg, table["vals"], table["roots"]).astype(np.uint64),
                          cuts[t_med]):
        raise AssertionError("table mode applied on the host differs from the volume mode")
    log(f"re-cuts: ids {counts} at quantiles {HIER_QUANTILES}; table mode ({table['vals'].size} "
        f"table entries) equals the volume mode ({time.perf_counter() - t0:.1f} s)")
    del cuts, raw

    # device functions of (a, b): the merge table and the gather at 8 blocks
    region = (slice(0, BLOCK[0]), slice(0, 2 * BLOCK[1]), slice(0, 4 * BLOCK[2]))

    def as_blocks(arr):
        a = torch.from_numpy(np.ascontiguousarray(arr[region])).to(dev)
        return a.reshape(BLOCK[0], 2, BLOCK[1], 4, BLOCK[2]).permute(1, 3, 0, 2, 4).reshape(
            (8,) + BLOCK)

    lab8 = as_blocks(blocks_vol.astype(np.int32))
    h8 = as_blocks(np.ascontiguousarray(raw_ds[region]))
    saved = hier.block_merge_table.launches
    ms = cuda_ms(lambda: hier.block_merge_table(lab8, h8), 3)
    hier.block_merge_table.launches = saved
    records.append(device_record("block_merge_table (HierarchyBlocksTask)", lab8.shape, ms,
                                 launches["block_merge_table"], lab8.numel() * (4 + 4 + 3 * 3 * 4)))
    cut = hier.cut_table(art["a"], art["b"], art["saddle"], t_med, device=dev)
    seg8 = as_blocks(seg.astype(np.int32))
    vals, roots = (torch.from_numpy(c).to(dev) for c in cut)
    saved = hier.recut_labels.launches
    ms = cuda_ms(lambda: hier.recut_labels(seg8, vals, roots), 5)
    hier.recut_labels.launches = saved
    records.append(device_record("recut_labels (ResegmentTask's gather)", seg8.shape, ms,
                                 launches["recut_labels"], seg8.numel() * 8 + vals.numel() * 8))
    del blocks_vol, seg, lab8, h8, seg8

    # (c) event building
    t0 = time.perf_counter()
    frames_t = detector_frames(EVENT_FRAMES, seed, dev)
    frames = frames_t.cpu().numpy()
    ev_path = os.path.join(work, "events.n5")
    ev_blocking = Blocking(EVENT_FRAMES, EVENT_BLOCK)
    write_blocks(file_reader(ev_path).create_dataset("frames", shape=EVENT_FRAMES, dtype="float32",
                                                     chunks=EVENT_BLOCK, compression="raw"),
                 frames, ev_blocking)
    log(f"setup: {EVENT_FRAMES[0]} detector frames {EVENT_FRAMES[1:]}, "
        f"{float((frames > 0).mean()):.4f} of the pixels lit, in {time.perf_counter() - t0:.1f} s")
    conf_ev = volume_config(work, "events", {"events": {"threshold": 0.0, "connectivity": 2}},
                            block_shape=list(EVENT_BLOCK))
    reset_counts(events.build_events_device)
    events.build_events_device.rounds = 0
    run_workflow(W.EventBuildingWorkflow(os.path.join(work, "tmp_events"), conf_ev,
                                         input_path=ev_path, input_key="frames",
                                         output_path=ev_path, output_key="ev"),
                 "EventBuildingWorkflow", frames.size, card, walls)
    launches.update(launches_rose([events.build_events_device], "EventBuildingWorkflow"))
    rounds = events.build_events_device.rounds
    check = np.arange(0, EVENT_FRAMES[0], EVENT_CHECK_EVERY)
    ev_labels = read_volume(file_reader(ev_path, "r")["ev"], ev_blocking)[check]
    tables = read_event_tables(ev_path, "ev", ev_blocking.n_blocks)
    t1 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(slice_threads()) as pool:  # the oracle runs frame by frame
        parts = list(pool.map(lambda part: (part, events.build_events_np(frames[check[part]])),
                              np.array_split(np.arange(len(check)), slice_threads())))
    worst = 0.0
    for part, (ref_l, ref_c, ref_p) in parts:
        if not np.array_equal(ev_labels[part], ref_l):
            raise AssertionError("event labels differ from scipy's on the checked frames")
        for i, fidx in enumerate(check[part]):
            rows = tables[tables[:, 0] == fidx, 1:]
            if rows.shape[0] != ref_c[i]:
                raise AssertionError(f"frame {fidx}: {rows.shape[0]} events, scipy {ref_c[i]}")
            np.testing.assert_allclose(rows, ref_p[i, :ref_c[i]], rtol=1e-4, atol=1e-4,
                                       err_msg=f"event properties of frame {fidx}")
            if rows.size:
                worst = max(worst, float(np.abs(rows - ref_p[i, :ref_c[i]]).max()))
    t_oracle = time.perf_counter() - t1
    batch = EVENT_BLOCK[0] * 8  # the cuda target's default batch of blocks
    saved = events.build_events_device.launches, events.build_events_device.rounds
    ms = cuda_ms(lambda: events.build_events_device(frames_t[:batch], 0.0, 2), 2)
    events.build_events_device.launches, events.build_events_device.rounds = saved
    wall = walls["EventBuildingWorkflow"]
    log(f"events: {len(tables)} events in {EVENT_FRAMES[0]} frames, {len(check)} frames equal to "
        f"scipy (properties within {worst:.2e}; the oracle {t_oracle:.1f} s); {launches['build_events_device']} labellings, "
        f"{rounds / launches['build_events_device']:.1f} rounds each, {ms:.2f} ms per batch of "
        f"{batch} frames; {EVENT_FRAMES[0] / wall:.1f} frames/s end to end")
    records.append(device_record(
        f"build_events_device (event labelling and properties, {batch} frames)",
        (batch,) + EVENT_FRAMES[1:], ms, launches["build_events_device"],
        batch * EVENT_FRAMES[1] * EVENT_FRAMES[2] * (4 + 4)))
    del frames_t, frames, ev_labels, tables

    # (d) the flood's entry points on a halo'd block and a crop
    sub = torch.from_numpy(np.ascontiguousarray(
        vol_np[:BLOCK[0] + 2 * HALO[0]])).to(dev)
    h, s, m = halo_block(sub, HIER_CORNER, dev)
    del sub
    pinned = os.environ.get("CTT_FLOOD_TILE")
    os.environ["CTT_FLOOD_TILE"] = FLOOD_TILE
    try:
        tile = ws_ops.resolve_flood_tile(tuple(h.shape))
        reset_counts(flood_tiles_warm, flood_volume)
        t0 = time.perf_counter()
        (lab, alt, stats), ms = timed_call(lambda: ws_ops.flood_with_stats(h, s, m, tile=tile))
        launches.update({f"flood_with_stats {k}": v for k, v in launches_rose(
            [flood_tiles_warm, flood_volume], "flood_with_stats").items()})
        lab_h, table_h, stats_h = ws_ops.seeded_watershed_hier(h, s, m)
        lab_sw = ws_ops.seeded_watershed(h, s, m)
    finally:
        if pinned is None:
            os.environ.pop("CTT_FLOOD_TILE")
        else:
            os.environ["CTT_FLOOD_TILE"] = pinned
    plain_l, plain_a, plain_r = flood_volume_scan(h[None], s[None], m[None])
    if not (torch.equal(lab, plain_l[0]) and torch.equal(alt, plain_a[0])):
        raise AssertionError("flood_with_stats: labels or altitudes differ from the plain schedule")
    _, _, flat = ws_ops.flood_with_stats(h, s, m)
    if (flat["flood_alt_iters"], flat["flood_assign_iters"]) != tuple(plain_r):
        raise AssertionError(f"flood_with_stats untiled counters {flat}, plain schedule {plain_r}")
    if not torch.equal(lab_h, lab_sw):
        raise AssertionError("seeded_watershed_hier's labels differ from seeded_watershed's")
    log(f"flood_with_stats at tile {tile} on {tuple(h.shape)}: {stats} in {ms:.1f} ms (the "
        f"untiled {flat}); labels and altitudes equal the plain schedule's; "
        f"seeded_watershed_hier's labels equal seeded_watershed's, "
        f"{int((table_h[0] > 0).sum())} of {table_h[0].numel()} tile-face slots are edges "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    crop = tuple(slice(0, c) for c in HIER_CROP)
    hc, sc = (t[crop].contiguous() for t in (h, s))
    mc = hc < torch.quantile(hc.reshape(-1), 0.9)
    cpu = tuple(t.cpu() for t in (hc, sc, mc))
    corner = tuple(slice(0, c) for c in HIER_TILE_CROP)
    got = ws_ops.seeded_watershed_hier(*(t[corner].contiguous() for t in (hc, sc, mc)),
                                       coarse_tile=HIER_CROP_TILE)
    want = ws_ops.seeded_watershed_hier(*(t[corner].contiguous() for t in cpu),
                                        coarse_tile=HIER_CROP_TILE)
    if not (torch.equal(got[0].cpu(), want[0]) and got[2] == want[2]
            and all(torch.equal(g.cpu(), w) for g, w in zip(got[1], want[1]))):
        raise AssertionError(f"crop seeded_watershed_hier: card {got[2]}, CPU {want[2]}")
    capped = ws_ops.seeded_watershed(hc, sc, mc, max_iter=3)
    if not torch.equal(capped.cpu(), ws_ops.seeded_watershed(*cpu, max_iter=3)):
        raise AssertionError("crop capped flood: card and CPU differ")
    reset_counts(ws_ops._seeded_watershed_sweep)
    c26, ms = timed_call(lambda: ws_ops.seeded_watershed(hc, sc, mc, connectivity=3))
    launches.update(launches_rose([ws_ops._seeded_watershed_sweep], "the crop's 26-connected flood"))
    if not torch.equal(c26.cpu(), ws_ops.seeded_watershed(*cpu, connectivity=3)):
        raise AssertionError("crop 26-connected flood: card and CPU differ")
    log(f"crop {HIER_CROP}: a capped flood (max_iter 3) and the 26-connected flood ({ms:.1f} ms "
        f"on the card) equal the CPU's; on its {HIER_TILE_CROP} corner seeded_watershed_hier's "
        f"labels, merge table and counters {got[2]} equal the CPU's "
        f"({time.perf_counter() - t0:.1f} s)")
    records.append(device_record("_seeded_watershed_sweep (connectivity 3, a crop)", hc.shape, ms,
                                 launches["_seeded_watershed_sweep"], hc.numel() * (4 + 4 + 1 + 4)))
    for rec in records:
        log(f"device function on {card}: {rec}")
    seconds = time.perf_counter() - t_phase
    log(f"phase 27 done ({seconds:.1f} s)")
    return {"walls": walls, "launches": launches, "records": records, "seconds": seconds}


STREAM_CACHE_MB = 1024  # phase 28's CTT_HBM_CACHE_MB: the 25 blocks' uploads, ~262 MB
# phase 28(a)'s blocks per batch: a row of the 5 x 5 grid, so that the
# chain reads a batch's halo'd region as one bounding box
STREAM_BATCH = 5


def stream_gate(delta: dict, what: str) -> None:
    """A fused run: exactly one chain ran and none fell back, so a chain
    that fails on the card cannot pass as an unfused run."""
    if delta.get("stream.chains", 0) != 1 or delta.get("stream.fallbacks", 0) != 0:
        raise AssertionError(f"{what}: stream.chains {delta.get('stream.chains', 0)}, "
                             f"stream.fallbacks {delta.get('stream.fallbacks', 0)}")


def stage_seconds(task) -> dict:
    """The ``stage_*`` sums of a task's status (s)."""
    return {k: round(v, 3) for k, v in status_timings(task).items() if k.startswith("stage_")}


def stream_phase(shallow_np, work: str, card: str, dev) -> dict:
    """Phase 28, stream fusion and device residency, on the first
    ``SHALLOW_Z`` planes at CREMI-A's in-plane shape in gzip n5 (the card's
    host has no libblosc), blocks ``BLOCK``, the decoded-chunk cache off
    (budget 0), so that the store counters see every chunk.  (a)
    ``StreamingSegmentationWorkflow`` (threshold ``< THRESHOLD`` →
    components → the 2d watershed with halo ``HALO``) fused, then with
    ``stream_fusion: false``: components, block labels and watershed byte
    for byte equal; one chain and no fallback in the fused run, no mask
    dataset after it; the unfused run reads at least twice the store
    bytes; kernels 4 and 2 launched inside the fused chain.  The batches
    are rows of ``STREAM_BATCH`` blocks.  (b) the 2d
    ``WatershedWorkflow`` (no halo, as phase 3's: at budget 0 a halo'd
    block read decodes up to nine chunks, for time) with
    the device-buffer cache off at ``hbm_stack``
    1 (the reference), with ``CTT_HBM_CACHE_MB`` set twice (the second run
    serves every batch from the cache) and at ``hbm_stack`` 2 (half the
    dispatches): every output byte-equal to the reference.  Returns walls,
    bytes, the fused run's kernel launches and the seconds."""
    from cluster_tools_tpu_torch import WatershedWorkflow, build
    from cluster_tools_tpu_torch.obs import metrics
    from cluster_tools_tpu_torch.ops.cuda_cc import cc_slices
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices
    from cluster_tools_tpu_torch.runtime import config as cfg
    from cluster_tools_tpu_torch.runtime import hbm
    from cluster_tools_tpu_torch.tasks.watershed import WatershedTask
    from cluster_tools_tpu_torch.utils import file_reader, store
    from cluster_tools_tpu_torch.utils.blocking import Blocking
    from cluster_tools_tpu_torch.workflows import StreamingSegmentationWorkflow

    t_phase = time.perf_counter()
    path = os.path.join(work, "stream.n5")
    blocking = Blocking(shallow_np.shape, BLOCK)
    write_blocks(file_reader(path).create_dataset("raw", shape=shallow_np.shape, dtype="float32",
                                                  chunks=BLOCK, compression="gzip"),
                 shallow_np, blocking)
    vox = int(np.prod(shallow_np.shape))
    log(f"setup: {shallow_np.shape} as gzip n5 in {time.perf_counter() - t_phase:.1f} s")
    walls, runs = {}, {}

    def config(tag, halo=HALO, **glob):
        config_dir = os.path.join(work, f"configs_stream_{tag}")
        cfg.write_global_config(config_dir, {"block_shape": list(BLOCK), "target": "cuda",
                                             "device": dev.type, **glob})
        cfg.write_config(config_dir, "threshold", {"threshold": THRESHOLD,
                                                   "threshold_mode": "less"})
        cfg.write_config(config_dir, "watershed", {**WatershedTask.default_task_config(),
                                                   "halo": list(halo)})
        return config_dir

    def run(wf, tag, wrappers=()):
        reset_counts(*wrappers)
        before = metrics.snapshot()
        run_workflow(wf, tag, vox, card, walls)
        delta = metrics.delta(before, metrics.snapshot())
        runs[tag] = {"wall_s": walls[tag],
                     **{k: int(delta.get(k, 0)) for k in (
                         "store.bytes_read", "store.bytes_written", "device.dispatches",
                         "device.upload_bytes", "device.uploads_skipped")},
                     "stream.carry_bytes": metrics.snapshot()["gauges"].get(
                         "stream.carry_bytes", 0) if delta.get("stream.chains") else 0}
        return delta

    prev_budget = store.set_chunk_cache_budget(0)
    prev_env = os.environ.get("CTT_HBM_CACHE_MB")
    try:
        # (a) the fused chain against the tasks one at a time
        wfs = {}
        for tag, fused in (("fused", True), ("unfused", False)):
            wfs[tag] = StreamingSegmentationWorkflow(
                os.path.join(work, f"tmp_stream_{tag}"),
                config(tag, stream_fusion=fused, device_batch_size=STREAM_BATCH),
                input_path=path, input_key="raw", output_path=path, output_key=f"cc_{tag}")
            delta = run(wfs[tag], f"StreamingSegmentationWorkflow {tag}",
                        (cc_slices, dtws_slices, flood_slices))
            if fused:
                stream_gate(delta, "StreamingSegmentationWorkflow")
                launches = launches_rose([cc_slices, dtws_slices], "the fused chain")
                launches["flood_slices"] = flood_slices.launches
                if "cc_fused_mask" in file_reader(path, "r"):
                    raise AssertionError("the fused chain wrote the elided mask")
            for name, task in (("threshold", wfs[tag]._tasks()[0]),
                               ("components", wfs[tag]._tasks()[1]),
                               ("watershed", wfs[tag]._tasks()[-1])):
                log(f"  {tag} {name} stages {stage_seconds(task)}")
        for key in ("", "_blocks", "_ws"):
            if chunk_files(os.path.join(path, f"cc_fused{key}")) != chunk_files(
                    os.path.join(path, f"cc_unfused{key}")):
                raise AssertionError(f"cc{key}: the fused and unfused runs differ")
        read_f = runs["StreamingSegmentationWorkflow fused"]["store.bytes_read"]
        read_u = runs["StreamingSegmentationWorkflow unfused"]["store.bytes_read"]
        if not 0 < 2 * read_f <= read_u:
            raise AssertionError(f"store bytes read: fused {read_f}, unfused {read_u}")
        log(f"{card}: StreamingSegmentationWorkflow fused equals unfused byte for byte; store "
            f"bytes read {read_f} fused, {read_u} unfused ({read_u / read_f:.2f}x); kernel "
            f"launches in the fused run {launches}")

        # (b) the device-buffer cache and the stacked dispatch on the 2d watershed
        os.environ.pop("CTT_HBM_CACHE_MB", None)
        hbm.set_cache_budget(None)
        for tag, glob in (("ws cache off", {}), ("ws cache cold", {}), ("ws cache warm", {}),
                          ("ws hbm_stack 2", {"hbm_stack": 2})):
            if tag == "ws cache cold":
                os.environ["CTT_HBM_CACHE_MB"] = str(STREAM_CACHE_MB)
                hbm.set_cache_budget(None)
            if tag == "ws hbm_stack 2":
                os.environ.pop("CTT_HBM_CACHE_MB")
                hbm.set_cache_budget(None)
            key = "ws_" + tag.split(" ", 1)[1].replace(" ", "_")
            wf = WatershedWorkflow(os.path.join(work, f"tmp_stream_{key}"),
                                   config(key, halo=(0, 0, 0), **glob), input_path=path,
                                   input_key="raw",
                                   output_path=path, output_key=key)
            run(wf, f"WatershedWorkflow {tag}", (dtws_slices,))
            log(f"  {tag} stages {stage_seconds(wf.requires()[0])}")
            if key != "ws_cache_off" and chunk_files(os.path.join(path, key)) != chunk_files(
                    os.path.join(path, "ws_cache_off")):
                raise AssertionError(f"WatershedWorkflow {tag}: output differs from the run "
                                     "with the cache off")
        ref, warm = runs["WatershedWorkflow ws cache off"], runs["WatershedWorkflow ws cache warm"]
        stacked = runs["WatershedWorkflow ws hbm_stack 2"]
        if warm["device.upload_bytes"] or warm["device.uploads_skipped"] != ref["device.dispatches"]:
            raise AssertionError(f"the warm run did not serve every batch from the cache: {warm}")
        if 2 * stacked["device.dispatches"] != ref["device.dispatches"]:
            raise AssertionError(f"hbm_stack 2: {stacked['device.dispatches']} dispatches, "
                                 f"{ref['device.dispatches']} at 1")
        log(f"{card}: WatershedWorkflow outputs equal with the cache off, cold, warm (every "
            f"batch from the cache) and at hbm_stack 2 ({stacked['device.dispatches']} "
            f"dispatches for {ref['device.dispatches']})")
    finally:
        store.set_chunk_cache_budget(prev_budget)
        if prev_env is None:
            os.environ.pop("CTT_HBM_CACHE_MB", None)
        else:
            os.environ["CTT_HBM_CACHE_MB"] = prev_env
        hbm.set_cache_budget(None)
    seconds = time.perf_counter() - t_phase
    log(f"{card}: phase 28 runs {json.dumps(runs)}")
    log(f"phase 28 done ({seconds:.1f} s)")
    return {"walls": walls, "runs": runs, "launches": launches, "seconds": seconds}


@contextlib.contextmanager
def failed_blocks_printed(work: str):
    """On any failure inside, print the failed-block tracebacks of every
    task log under ``work`` (the folder is gone afterwards), then raise."""
    try:
        yield
    except Exception:
        log_failed_blocks(work)
        raise


def log_failed_blocks(work: str) -> None:
    """The failed-block tracebacks of every task log under ``work``."""
    import glob

    for path in sorted(glob.glob(os.path.join(work, "*", "logs", "*.log"))):
        with open(path) as f:
            text = f.read()
        at = text.find("failed: ")
        if at >= 0:
            log(f"--- {os.path.basename(path)}:\n{text[max(0, at - 200):at + 6000]}")


def label_phases(cut_np, path: str, ws_path: str, work: str, card: str, mc: dict,
                 t_start: float) -> dict:
    """Phases 18-20 on the first planes of phase 3's watershed
    (``ws_path/ws``) and phase 8 run 1's segmentation; their walls, the
    filling filter's kernel records, and the phases' seconds."""
    t0 = time.perf_counter()
    phase_start(18, t_start)
    bk = bookkeeping_phase(cut_np, path, ws_path, work, card, mc)
    phase_start(19, t_start)
    pp = postprocess_phase(cut_np, path, work, card, bk)
    phase_start(20, t_start)
    st = stitching_phase(cut_np, path, work, card, bk)
    seconds = time.perf_counter() - t0
    log(f"phases 18-20 done at {time.perf_counter() - t_start:.1f} s ({seconds:.1f} s)")
    return {"walls": {**bk["walls"], **pp["walls"], **st["walls"]}, "kernels": pp["kernels"],
            "seconds": seconds}


def phase_start(name, t_start: float) -> None:
    """A flushed line before each phase: where a hang happened shows."""
    log(f"phase {name} start at {time.perf_counter() - t_start:.1f} s")


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
    ap.add_argument("--filter-bank-exact", action="store_true",
                    help="only phase 16 with the filter bank's default quantile mode, the exact "
                         "raw-sample merge (the build and the volume first; no result line)")
    ap.add_argument("--mws-scaling", action="store_true",
                    help="only the device MWS's rounds and round cost on growing centres of a "
                         "halo'd block, up to the whole block (no build, no result line)")
    ap.add_argument("--label-phases", action="store_true",
                    help="only the build, the volume, phases 3 and 8 and phases 18-20 (no "
                         "result line)")
    ap.add_argument("--container-phases", action="store_true",
                    help="only the build, the volume, phase 3 and phases 22-24 (no result "
                         "line)")
    ap.add_argument("--volume-phases", action="store_true",
                    help="only the build, the volume, phase 3 and phase 25 (no result line)")
    ap.add_argument("--inference-phases", action="store_true",
                    help="only the build, the volume, phase 3 and phase 26 (no result line)")
    ap.add_argument("--hier-phases", action="store_true",
                    help="only the build, the volume and phase 27 (no result line)")
    ap.add_argument("--stream-phases", action="store_true",
                    help="only the build, the volume and phase 28 (no result line)")
    ap.add_argument("--fixpoint-paths", action="store_true",
                    help="phases 2 and 5 also time the plain floods down each card path of "
                         "their fixpoint loop (CUDA graphs after the first rounds, from the "
                         "first round, never)")
    args = ap.parse_args()
    global FIXPOINT_PATHS
    FIXPOINT_PATHS = args.fixpoint_paths
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cluster_tools_tpu_torch.ops import _build

    # a hang shows where it is: every thread's stack, once, if the script
    # still runs after STACK_DUMP_S (it only prints)
    faulthandler.dump_traceback_later(STACK_DUMP_S, exit=False)
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    libs = host_libraries()
    log("host libraries: " + ", ".join(f"{name} {'found' if ok else 'missing'}"
                                       for name, ok in libs.items()))
    if args.mws_scaling:
        log(json.dumps({"mws_scaling": mws_scaling_phase(card, torch.device("cuda"), args.seed)}))
        log(f"script: {time.perf_counter() - t_start:.1f} s")
        faulthandler.cancel_dump_traceback_later()
        return 0
    phase_start(1, t_start)
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
    if args.filter_bank_exact:
        vol_np = vol.cpu().numpy()
        del vol
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work, \
                failed_blocks_printed(work):
            t0 = time.perf_counter()
            fb = filter_bank_phase(vol_np, work, card, quantile_mode=None)
            log(f"phase 16 (exact merge): {time.perf_counter() - t0:.1f} s; walls {fb['walls']}")
        log(f"script: {time.perf_counter() - t_start:.1f} s")
        faulthandler.cancel_dump_traceback_later()
        return 0
    if not (args.label_phases or args.container_phases or args.volume_phases
            or args.inference_phases or args.hier_phases or args.stream_phases):
        phase_start(2, t_start)
        records = kernel_phase(vol, dev, args.batch)
        records.update(cc_kernel_phase(vol, dev, args.batch, args.compare))
        phase_start(5, t_start)
        records.update(flood3d_kernel_phase(vol, dev, args.compare))
        log(f"phases 1-5 done at {time.perf_counter() - t_start:.1f} s")
    if args.kernels_only:
        log("kernels only: no workflow run")
        faulthandler.cancel_dump_traceback_later()
        return 0
    vol_np = vol.cpu().numpy()
    del vol
    torch.cuda.empty_cache()
    # phases 18-20 run on the first EARLY_Z planes, 4, 6, 7, 9, 10, 14 and 15
    # on the first SHALLOW_Z, so that the script fits its time; 3, 8, 11 and
    # 12's affinities on the whole
    cut_np = vol_np[:EARLY_Z]
    shallow_np = vol_np[:SHALLOW_Z]
    from scipy import ndimage

    from cluster_tools_tpu_torch.utils import file_reader

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work, \
            failed_blocks_printed(work):
        path = os.path.join(work, "cremi_a.n5")
        cut_path = os.path.join(work, "cremi_a_cut.n5")
        shallow_path = os.path.join(work, "cremi_a_shallow.n5")
        t0 = time.perf_counter()
        file_reader(path).create_dataset("raw", data=vol_np, chunks=BLOCK, compression="raw")
        file_reader(cut_path).create_dataset("raw", data=cut_np, chunks=BLOCK, compression="raw")
        file_reader(shallow_path).create_dataset("raw", data=shallow_np, chunks=BLOCK,
                                                 compression="raw")
        log(f"setup: wrote the raw n5 in {time.perf_counter() - t0:.1f} s")
        if args.label_phases:
            phase_start(3, t_start)
            workflow_phase(vol_np, path, work, card)
            phase_start(8, t_start)
            mc = multicut_phase(vol_np, path, work, card)
            slice_walls = label_phases(cut_np, cut_path, path, work, card, mc, t_start)
            log(f"label phases: {slice_walls}")
            log(f"script: {time.perf_counter() - t_start:.1f} s")
            faulthandler.cancel_dump_traceback_later()
            return 0
        if args.container_phases:
            phase_start(3, t_start)
            workflow_phase(vol_np, path, work, card)
            new_walls = slice13_phases(shallow_np, path, work, card, libs, dev, t_start)
            log(f"container, lifted and learning phases: {new_walls}")
            log(f"script: {time.perf_counter() - t_start:.1f} s")
            faulthandler.cancel_dump_traceback_later()
            return 0
        if args.volume_phases:
            phase_start(3, t_start)
            workflow_phase(vol_np, path, work, card)
            phase_start(25, t_start)
            vp = volume_phase(shallow_np, shallow_path, path, work, card, libs, dev)
            log(f"volume phase: walls {vp['walls']}; launches {vp['launches']}")
            log(f"script: {time.perf_counter() - t_start:.1f} s")
            faulthandler.cancel_dump_traceback_later()
            return 0
        if args.inference_phases:
            phase_start(3, t_start)
            workflow_phase(vol_np, path, work, card)
            phase_start(26, t_start)
            ip = inference_phase(shallow_path, path, work, card, libs, dev, args.seed)
            log(f"inference phase: walls {ip['walls']}; launches {ip['launches']}")
            log(json.dumps({"device_functions": ip["records"]}))
            log(f"script: {time.perf_counter() - t_start:.1f} s")
            faulthandler.cancel_dump_traceback_later()
            return 0
        if args.stream_phases:
            phase_start(28, t_start)
            sp = stream_phase(shallow_np, work, card, dev)
            log(f"stream phase: walls {sp['walls']}; launches {sp['launches']}")
            log(f"script: {time.perf_counter() - t_start:.1f} s")
            faulthandler.cancel_dump_traceback_later()
            return 0
        if args.hier_phases:
            phase_start(27, t_start)
            hp = hier_phase(shallow_path, vol_np, work, card, dev, args.seed)
            log(f"hierarchy and events phase: walls {hp['walls']}; launches {hp['launches']}")
            log(json.dumps({"device_functions": hp["records"]}))
            log(f"script: {time.perf_counter() - t_start:.1f} s")
            faulthandler.cancel_dump_traceback_later()
            return 0
        phase_start(3, t_start)
        launches, wall, rate = workflow_phase(vol_np, path, work, card)
        phase_start(4, t_start)
        t0 = time.perf_counter()
        fg = shallow_np < THRESHOLD
        ref, n_ref = ndimage.label(fg)
        log(f"setup: scipy labelled vol < {THRESHOLD} on the first {SHALLOW_Z} planes: {n_ref} "
            f"components in {time.perf_counter() - t0:.1f} s")
        rates = {}
        for block, kernel in ((BLOCK, "cc_slices"), (BLOCK_WIDE, "cc_tiles")):
            cc_launches, cc_wall, cc_rate = components_phase(
                shallow_path, work, block, card, fg, ref, n_ref, kernel)
            launches[kernel] = cc_launches[kernel]
            rates[block] = (cc_wall, cc_rate)
        del ref, fg
        cache_budget_phase(shallow_path, work, BLOCK)
        log(f"phases 3-4 done at {time.perf_counter() - t_start:.1f} s")
        phase_start(6, t_start)
        seed_launches, seeds_wall, seeds_rate = seeds_phase(shallow_np, shallow_path, work, card)
        for name in ("flood_tiles_warm", "flood_volume"):
            launches[name] = seed_launches[name]
        phase_start(7, t_start)
        ws3d_wall, ws3d_rate = ws3d_phase(shallow_np, shallow_path, work, card)
        log(f"phases 6-7 done at {time.perf_counter() - t_start:.1f} s")
        phase_start(8, t_start)
        mc = multicut_phase(vol_np, path, work, card)
        log(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")
        phase_start(9, t_start)
        agglo_launches, agglo_wall, agglo_rate = agglomeration_phase(
            shallow_np, shallow_path, work, card, ws_path=path)
        phase_start(10, t_start)
        tp_launches, tp_wall, tp_rate = two_pass_phase(
            shallow_np, shallow_path, work, card, file_reader(path, "r")["ws"][:SHALLOW_Z])
        phase_start(11, t_start)
        ac_wall, ac_rate = clustering_phase(vol_np, path, work, card, mc)
        log(f"phases 9-11 done at {time.perf_counter() - t_start:.1f} s")
        phase_start(12, t_start)
        mws = mws_phase(vol_np, work, card, dev)
        log(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
        phase_start("12b", t_start)
        device_mws = device_mws_phase(mws["affs"], card, dev)
        log(f"phase 12b done at {time.perf_counter() - t_start:.1f} s")
        phase_start(13, t_start)
        tp_mws = two_pass_mws_phase(mws["affs"], mws["path"], work, card, dev,
                                    min(TWO_PASS_MWS_Z, vol_np.shape[0]))
        log(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
        phase_start(14, t_start)
        mc_aff = affinity_multicut_phase(mws["affs"][:, :SHALLOW_Z], work, card)
        log(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
        phase_start(15, t_start)
        sol_walls = solutions_phase(mc_aff, card)
        log(f"phase 15 done at {time.perf_counter() - t_start:.1f} s")
        phase_start(16, t_start)
        fb = filter_bank_phase(vol_np, work, card)
        log(f"phase 16 done at {time.perf_counter() - t_start:.1f} s")
        phase_start(17, t_start)
        at = affinity_tasks_phase(mws["affs"], vol_np, shallow_path, work, card)
        log(f"phase 17 done at {time.perf_counter() - t_start:.1f} s")
        slice_walls = label_phases(cut_np, cut_path, path, work, card, mc, t_start)
        new_walls = slice13_phases(shallow_np, path, work, card, libs, dev, t_start)
        phase_start(25, t_start)
        vp = volume_phase(shallow_np, shallow_path, path, work, card, libs, dev)
        phase_start(26, t_start)
        ip = inference_phase(shallow_path, path, work, card, libs, dev, args.seed)
        phase_start(27, t_start)
        hp = hier_phase(shallow_path, vol_np, work, card, dev, args.seed)
        phase_start(28, t_start)
        sp = stream_phase(shallow_np, work, card, dev)
        phase_start(21, t_start)
        slice_records = slice_device_functions(fb, at, card)
    for name, rec in records.items():
        rec["launches"] = launches[name]
        log(f"kernel {name}: {rec['launches']} launches in its workflow run, {rec['ms']:.3f} ms "
            f"per launch, plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), max abs err {rec['max_abs_err']}")
    log(f"{card}: WatershedWorkflow {vol_np.shape} {rate:.6g} voxels/s ({wall:.3f} s)")
    for block, (cc_wall, cc_rate) in rates.items():
        log(f"{card}: ThresholdedComponentsWorkflow {shallow_np.shape} blocks {block} "
            f"{cc_rate:.6g} voxels/s ({cc_wall:.3f} s)")
    log(f"{card}: ThresholdAndWatershedWorkflow {shallow_np.shape} {seeds_rate:.6g} voxels/s "
        f"({seeds_wall:.3f} s)")
    log(f"{card}: WatershedWorkflow 3d {shallow_np.shape} {ws3d_rate:.6g} voxels/s ({ws3d_wall:.3f} s)")
    for tag, wall in mc["walls"].items():
        log(f"{card}: MulticutSegmentationWorkflow {tag} {vol_np.shape} "
            f"{int(np.prod(vol_np.shape)) / wall:.6g} voxels/s ({wall:.3f} s)")
    log(f"multicut run 1 kernel launches {mc['launches']}")
    log(f"{card}: WatershedWorkflow agglomeration {shallow_np.shape} {agglo_rate:.6g} voxels/s "
        f"({agglo_wall:.3f} s); kernel launches {agglo_launches}")
    log(f"{card}: WatershedWorkflow two-pass {shallow_np.shape} {tp_rate:.6g} voxels/s "
        f"({tp_wall:.3f} s); kernel launches {tp_launches}")
    log(f"{card}: AgglomerativeClusteringWorkflow {vol_np.shape} {ac_rate:.6g} voxels/s "
        f"({ac_wall:.3f} s, graph and features reused)")
    log(f"{card}: MwsWorkflow {mws['shape']} {mws['rate']:.6g} voxels/s ({mws['wall']:.3f} s)")
    log(f"{card}: TwoPassMwsWorkflow ({tp_mws['shape']}) {tp_mws['rate']:.6g} voxels/s "
        f"({tp_mws['wall']:.3f} s; pass 0 {tp_mws['passes'][0]:.3f} s, pass 1 "
        f"{tp_mws['passes'][1]:.3f} s)")
    log(f"{card}: MulticutSegmentationWorkflow from affinities {mc_aff['shape']} "
        f"{mc_aff['rate']:.6g} voxels/s ({mc_aff['wall']:.3f} s); kernel launches "
        f"{mc_aff['launches']}")
    for tag, wall in sol_walls.items():
        log(f"{card}: {tag} solution workflow (scale 1, phase 14's problem) {mc_aff['shape']} "
            f"{int(np.prod(mc_aff['shape'])) / wall:.6g} voxels/s ({wall:.3f} s)")
    for tag, wall in {**fb["walls"], **at["walls"]}.items():
        shape = fb["roi_shape"] if tag in fb["walls"] else at["shape"]
        log(f"{card}: {tag} {shape} {int(np.prod(shape)) / wall:.6g} voxels/s ({wall:.3f} s)")
    for tag, wall in slice_walls["walls"].items():
        log(f"{card}: {tag} {cut_np.shape} {int(np.prod(cut_np.shape)) / wall:.6g} voxels/s "
            f"({wall:.3f} s)")
    for tag, wall in new_walls["walls"].items():
        log(f"{card}: {tag} {shallow_np.shape} {int(np.prod(shallow_np.shape)) / wall:.6g} "
            f"voxels/s ({wall:.3f} s)")
    log(f"phases 22-24 kernel launches {new_walls['launches']}")
    log(f"{card}: phase 25 walls (s; voxels/s in each run's line above) {vp['walls']}; "
        f"launches {vp['launches']}; {vp['seconds']:.1f} s")
    log(f"{card}: phase 26 walls (s; voxels/s in each run's line above) {ip['walls']}; "
        f"launches {ip['launches']}; {ip['seconds']:.1f} s")
    log(f"{card}: phase 27 walls (s; voxels/s in each run's line above) {hp['walls']}; "
        f"launches {hp['launches']}; {hp['seconds']:.1f} s")
    log(f"{card}: phase 28 walls (s; voxels/s in each run's line above) {sp['walls']}; "
        f"fused-chain launches {sp['launches']}; {sp['seconds']:.1f} s")
    faulthandler.cancel_dump_traceback_later()
    log(f"script: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"device_functions": [mc["accumulator"], device_mws] + slice_records
                    + vp["records"] + ip["records"] + hp["records"]}))
    log(json.dumps({"filling_filter_kernels": slice_walls["kernels"]}))
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
