#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--z 125] [--batch 8] [--seed 0]

Phases (any failure exits non-zero; nothing is caught and carried on from):

  1. device and build: the card's name and power limit (nvidia-smi), the
     CUDA kernels built from ``cluster_tools_tpu_torch/csrc`` with nvcc, one
     compiler per source, all started together;
  2. kernels against their plain PyTorch versions on the card.  Kernels 1-2
     (watershed) on a batch of (32, 256, 256) blocks of the synthetic volume
     (the workflow's batch), a ragged edge block (29, 226, 226) and a
     serpentine corridor: labels and seed roots exactly, the height map
     exactly (the kernels round every float operation as the plain versions
     do).  Kernels 4-5 (CC) on the same blocks thresholded (``vol < 0.5``)
     and their complement, the ragged block, a serpentine corridor and,
     for kernel 5, the (32, 640, 640) blocks of the second components run
     and their complement: labels exactly.
     Kernel and plain times at the workflows' batch shapes;
  3. the watershed workflow: a seeded synthetic boundary volume at CREMI
     sample A's shape (125, 1250, 1250), made the way ``bench.make_volume``
     makes it, written to n5 with raw chunks; ``build([WatershedWorkflow(...)])``
     on the ``cuda`` target with the default watershed config and blocks
     (32, 256, 256).  Both kernels' launch counts must rise in this run; the
     output is checked (shape, labels only on the foreground, ids unique per
     block through the offsets) and two blocks re-run through the plain
     versions on the card must equal it byte for byte;
  4. the thresholded-components workflow on the same volume
     (``threshold_mode="less"``: the cell interior), ``cuda`` target, twice:
     blocks (32, 256, 256), whose slices take kernel 4, and blocks
     (32, 640, 640), whose slices exceed the whole-slice limit and take
     kernel 5.  The kernel's launch count must rise in its run; the output
     must have scipy's 6-connected partition of ``vol < 0.5`` with ids
     1..n, and every block's local labels (before the merge) must equal
     scipy's labels of that block;
  5. one JSON line listing the four kernels, then the result line.

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
CREMI_A = (125, 1250, 1250)
BLOCK = (32, 256, 256)
BLOCK_WIDE = (32, 640, 640)  # 640 x 640 slices exceed the whole-slice limit
THRESHOLD = 0.5


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

    saved = cuda_dtws.dtws_slices, watershed.flood_slices
    cuda_dtws.dtws_slices = cuda_dtws.dtws_slices_plain
    watershed.flood_slices = cuda_flood.flood_slices_plain
    try:
        yield
    finally:
        cuda_dtws.dtws_slices, watershed.flood_slices = saved


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


def serpentine(h, w, dev):
    from cluster_tools_tpu_torch.ops.cc import serpentine_mask

    m = torch.from_numpy(serpentine_mask((1, h, w))).to(dev)
    seeds = torch.zeros((1, h, w), dtype=torch.int32, device=dev)
    seeds[0, 0, 0] = 1
    return torch.full((1, h, w), 0.5, device=dev), seeds, m


def kernel_phase(vol, dev, batch: int):
    """Phase 2: both kernels against their plain versions.  Returns the
    per-kernel records of the kernels line (without the launch counts)."""
    from cluster_tools_tpu_torch.ops.cuda_dtws import dtws_slices, dtws_slices_plain
    from cluster_tools_tpu_torch.ops.cuda_flood import flood_slices, flood_slices_plain

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

    cases = {
        "main": (x_main, ones, ones),
        "ragged": (ragged, rones, rones),
        "serpentine": (serp_x, sones, sones),
    }
    dt_err = 0.0
    main_out = None
    for name, (x, m, v) in cases.items():
        got = dtws_slices(x, m, v, threshold=THRESHOLD)
        want = dtws_slices_plain(x, m, v, threshold=THRESHOLD)
        torch.cuda.synchronize()
        for what, g, w in zip(("labels", "roots", "hmap"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"dtws_slices {name}: {what} differs from the plain version "
                    f"(max abs err {(g.double() - w.double()).abs().max().item()})"
                )
        dt_err = max(dt_err, (got[2] - want[2]).abs().max().item())
        log(f"dtws_slices {name} {tuple(x.shape)}: equal to plain")
        if name == "main":
            main_out = got

    flood_err = 0.0
    flood_main = size_filter_inputs(x_main, ones, ones, *main_out)
    rlab, rroots, rhmap = dtws_slices(ragged, rones, rones, threshold=THRESHOLD)
    flood_cases = {
        "main": flood_main,
        "ragged": size_filter_inputs(ragged, rones, rones, rlab, rroots, rhmap),
        "serpentine": (sh, ss, sm),
    }
    for name, (h, s, m) in flood_cases.items():
        got = flood_slices(h, s, m)
        want = flood_slices_plain(h, s, m)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"flood_slices {name}: differs from the plain version")
        flood_err = max(flood_err, (got - want).abs().max().item())
        if name == "serpentine" and not bool((got[m] == 1).all()):
            raise AssertionError("flood_slices serpentine: corridor not flooded to its end")
        log(f"flood_slices {name} {tuple(h.shape)}: equal to plain")

    # times and fixpoint rounds at the workflow's batch shape
    n_sl = x_main.shape[0] * x_main.shape[1]
    d_rounds = torch.zeros((n_sl, 3), dtype=torch.int32, device=dev)
    f_rounds = torch.zeros((n_sl, 2), dtype=torch.int32, device=dev)
    dtws_ms = cuda_ms(lambda: dtws_slices(x_main, ones, ones, threshold=THRESHOLD, rounds=d_rounds), 3)
    dtws_plain_ms = cuda_ms(lambda: dtws_slices_plain(x_main, ones, ones, threshold=THRESHOLD), 1)
    flood_ms = cuda_ms(lambda: flood_slices(*flood_main, rounds=f_rounds), 3)
    flood_plain_ms = cuda_ms(lambda: flood_slices_plain(*flood_main), 1)
    vox = x_main.numel()
    d_bytes, f_bytes = 24 * vox, 16 * vox
    d_ops = 2 * x_main.shape[-1] * vox
    d_bound = max(d_bytes / HBM_BYTES_PER_S, d_ops / FP32_OPS_PER_S) * 1e3
    f_bound = f_bytes / HBM_BYTES_PER_S * 1e3
    dr, fr = d_rounds.float(), f_rounds.float()
    log(
        f"dtws_slices {tuple(x_main.shape)}: {dtws_ms:.3f} ms/launch, plain "
        f"{dtws_plain_ms:.1f} ms, bound {d_bound:.4f} ms "
        f"({'operations' if d_ops / FP32_OPS_PER_S > d_bytes / HBM_BYTES_PER_S else 'bytes'}); "
        f"rounds per slice cc/alt/assign max {dr.max(0).values.tolist()} "
        f"mean {[round(v, 2) for v in dr.mean(0).tolist()]}"
    )
    log(
        f"flood_slices {tuple(flood_main[0].shape)}: {flood_ms:.3f} ms/launch, plain "
        f"{flood_plain_ms:.1f} ms, bound {f_bound:.4f} ms (bytes); rounds per slice "
        f"alt/assign max {fr.max(0).values.tolist()} mean {[round(v, 2) for v in fr.mean(0).tolist()]}"
    )
    return {
        "dtws_slices": dict(
            name="dtws_slices", route="cuda",
            source="cluster_tools_tpu_torch/csrc/dtws.cuh",
            replaces="cluster_tools_tpu/ops/pallas_dtws.py:265",
            max_abs_err=dt_err, ms=dtws_ms, plain_ms=dtws_plain_ms, bound_ms=d_bound,
            bound_by="operations" if d_ops / FP32_OPS_PER_S > d_bytes / HBM_BYTES_PER_S else "bytes",
            library_ms=None,
        ),
        "flood_slices": dict(
            name="flood_slices", route="cuda",
            source="cluster_tools_tpu_torch/csrc/flood.cuh",
            replaces="cluster_tools_tpu/ops/pallas_flood.py:186",
            max_abs_err=flood_err, ms=flood_ms, plain_ms=flood_plain_ms, bound_ms=f_bound,
            bound_by="bytes", library_ms=None,
        ),
    }


def cc_kernel_phase(vol, dev, batch: int):
    """Phase 2, kernels 4-5: each against its plain version on the card.
    Returns the per-kernel records of the kernels line."""
    from cluster_tools_tpu_torch.ops.cc import serpentine_mask
    from cluster_tools_tpu_torch.ops.cuda_cc import (
        WHOLE_SLICE_MAX, cc_slices, cc_slices_plain, cc_tiles, cc_tiles_plain, default_tile,
    )

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
    for name, (m, depth) in cases.items():
        runs = [("cc_tiles", cc_tiles, cc_tiles_plain, (default_tile(*m.shape[1:]),))]
        if m.shape[1] * m.shape[2] <= WHOLE_SLICE_MAX:
            runs.insert(0, ("cc_slices", cc_slices, cc_slices_plain, ()))
        for kname, kernel, plain, extra in runs:
            got = kernel(m, *extra, depth=depth)
            want = plain(m, *extra, depth)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{kname} {name}: labels differ from the plain version "
                                     f"({int((got != want).sum())} voxels)")
            pieces = int(torch.unique(got[got >= 0]).numel())
            log(f"{kname} {name} {tuple(m.shape)}: equal to plain "
                f"({pieces} in-{'slice' if kname == 'cc_slices' else 'tile'} components)")

    records = {}
    for kname, kernel, plain, m, depth, extra, replaces in (
        ("cc_slices", cc_slices, cc_slices_plain, main, zb, (), "cluster_tools_tpu/ops/pallas_cc.py:89"),
        ("cc_tiles", cc_tiles, cc_tiles_plain, wide, wz, (default_tile(wy, wx),),
         "cluster_tools_tpu/ops/pallas_cc.py:143"),
    ):
        n_rounds = m.shape[0] if kname == "cc_slices" else (
            m.shape[0] * -(-wy // extra[0][0]) * -(-wx // extra[0][1]))
        rounds = torch.zeros(n_rounds, dtype=torch.int32, device=dev)
        ms = cuda_ms(lambda: kernel(m, *extra, depth=depth, rounds=rounds), 3)
        plain_ms = cuda_ms(lambda: plain(m, *extra, depth), 1)
        bound = 5 * m.numel() / HBM_BYTES_PER_S * 1e3  # bool mask in, int32 labels out
        r = rounds.float()
        log(f"{kname} {tuple(m.shape)}{' tile ' + str(extra[0]) if extra else ''}: "
            f"{ms:.3f} ms/launch, plain {plain_ms:.1f} ms, bound {bound:.4f} ms (bytes); "
            f"rounds per {'slice' if kname == 'cc_slices' else 'tile'} max {int(r.max())} "
            f"mean {r.mean().item():.2f}")
        records[kname] = dict(
            name=kname, route="cuda", source="cluster_tools_tpu_torch/csrc/cc.cuh",
            replaces=replaces, max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes", library_ms=None,
        )
    return records


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
    cc_slices.launches = 0
    cc_tiles.launches = 0
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("components workflow build failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"cc_slices": cc_slices.launches, "cc_tiles": cc_tiles.launches}
    if launches[kernel] == 0:
        raise AssertionError(f"the components run at blocks {block} never launched {kernel}")
    vox = int(np.prod(ref.shape))
    log(f"components {tag}: {ref.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on {card}; "
        f"launches {launches}")
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
    dtws_slices.launches = 0
    flood_slices.launches = 0
    t0 = time.perf_counter()
    if not build([wf]):
        raise AssertionError("workflow build failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dtws_slices": dtws_slices.launches, "flood_slices": flood_slices.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the workflow never launched {name}")
    vox = int(np.prod(vol_np.shape))
    log(f"workflow: {vol_np.shape} in {wall:.2f} s = {vox / wall:.4g} voxels/s on {card}; "
        f"launches {launches}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--z", type=int, default=CREMI_A[0], help="volume depth (cut z only)")
    ap.add_argument("--batch", type=int, default=8, help="blocks per kernel-phase batch")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cluster_tools_tpu_torch.ops import _build

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
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
    records.update(cc_kernel_phase(vol, dev, args.batch))
    vol_np = vol.cpu().numpy()
    del vol
    torch.cuda.empty_cache()
    from scipy import ndimage

    from cluster_tools_tpu_torch.utils import file_reader

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        path = os.path.join(work, "cremi_a.n5")
        t0 = time.perf_counter()
        file_reader(path).create_dataset("raw", data=vol_np, chunks=BLOCK, compression="raw")
        log(f"setup: wrote {vol_np.shape} raw n5 in {time.perf_counter() - t0:.1f} s")
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
    for name, rec in records.items():
        rec["launches"] = launches[name]
        log(f"kernel {name}: {rec['launches']} launches in its workflow run, {rec['ms']:.3f} ms "
            f"per launch, plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), max abs err {rec['max_abs_err']}")
    log(f"{card}: WatershedWorkflow {vol_np.shape} {rate:.6g} voxels/s ({wall:.3f} s)")
    for block, (cc_wall, cc_rate) in rates.items():
        log(f"{card}: ThresholdedComponentsWorkflow {vol_np.shape} blocks {block} "
            f"{cc_rate:.6g} voxels/s ({cc_wall:.3f} s)")
    log(json.dumps({"kernels": [records[k] for k in (
        "flood_slices", "dtws_slices", "cc_slices", "cc_tiles")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
