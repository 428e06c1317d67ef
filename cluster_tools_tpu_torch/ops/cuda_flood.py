"""The seeded flood on the card: kernel 1 (per slice), kernel 3 (tile-local
altitude warm start) and the 3d sweep flood, written in CUDA for Hopper.

``flood_slices`` replaces ``cluster_tools_tpu/ops/pallas_flood.py::flood_slices``:
the kernel floods each (H, W) slice of an (N, H, W) stack, by one of two
routes chosen by the slice's size before launch (``flood_route``): a
thread-block cluster of 8 CTAs per slice with the slice's state in shared
memory and the line sweeps as warp scans (``csrc/flood_cluster.cuh``), or,
for slices whose state does not fit the cluster, one thread block per slice
over device scratch (``csrc/flood.cuh``).  ``flood_tiles_warm`` replaces
``pallas_flood.py::flood_tiles_warm``: the phase-1 altitude fixpoint of each
in-plane (th, tw) tile of each slice (``csrc/flood3d.cuh``, its sweeps warp
scans of ``csrc/tile_scan.cuh``), ragged edge tiles cut to the slice;
``flood_tiles_warm_scan`` is its schedule in PyTorch, with its rounds.
``flood_volume`` is the 3d flood of a (B, Z, H, W)
batch of blocks over 6 neighbours, the counterpart of the JAX package's XLA
``_flood_scan_impl`` (no Pallas kernel there): one cooperative kernel that
runs the rounds of directional sweeps on the card, each sweep a scan
(``csrc/flood3d.cuh``), optionally from kernel 3's warm altitudes.
``flood_volume_scan`` is that schedule in PyTorch, with its round counts.

The ``*_plain`` functions compute the same functions with PyTorch ops, the
JAX package's fixpoints written as Jacobi neighbour relaxation.  Every
fixpoint is unique (see ``csrc/flood.cuh``), so labels and altitudes are
equal exactly.  The wrappers take the plain versions only for tensors on
the CPU; for a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .cc import shift
from .scan import clamp_apply, clamp_compose, scan_sweep
from .tile_scan import TILE_PHASES, tile_rounds, tiles_of, untile

BIG = 3.0e38
BIG_DIST = 2**31 - 2
FLOOD_STAMPS = 4  # kernel 1's phase stamps per slice: start, set-up, phase 1, phase 2
# what the 3d flood's stamps hold (csrc/flood3d.cuh, CTT_F3_STAMPS): ns per
# phase, then the lines swept in all rounds per phase and axis
FLOOD3D_PHASES = ("set-up", "phase 1 z", "phase 1 y", "phase 1 x", "edge bits",
                  "phase 2 z", "phase 2 y", "phase 2 x")
FLOOD3D_LINES = ("phase 1 z", "phase 1 y", "phase 1 x", "phase 2 z", "phase 2 y", "phase 2 x")
CLUSTER = 8  # CTAs per slice on the cluster routes of kernels 1 and 2


def flood_route(h: int, w: int) -> str:
    """Kernel 1's route for (h, w) slices, by size alone: ``"cluster"`` where
    the slice's state fits the shared memory of a cluster's CTAs (the rule
    is ``csrc/flood.cu::ctt_flood_cluster_smem``: 256 x 256 needs 116,896 of
    232,448 B per CTA, square slices up to 362 x 362 fit), else
    ``"global"``.  Asks the built kernel library, so it needs ``nvcc``."""
    return "cluster" if _build.cluster_smem("flood", h, w) else "global"


_OFFSETS = ((0, -1), (0, 1), (-1, 0), (1, 0))
_OFFSETS_3D = ((0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0))


# A plain flood tests for its fixpoint after every round for its first
# GRAPH_AFTER_ROUNDS rounds (on the CPU, after every round to the end).  A
# flood still moving then is a long one (a corridor: thousands of rounds of
# small launches), and on the card its further rounds run in stretches of
# CHECK_EVERY_CUDA captured once as a CUDA graph and replayed, the fixpoint
# tested after each stretch: every round is monotone (values only fall, in
# lexicographic order for phase 2), so rounds past the fixpoint change
# nothing and the result is the same as testing after every round.  The
# switch comes when the rounds launched so far cost about what a capture
# does (~0.2 s against ~1.3 ms per launched round of a small state on an
# H100: ``chip_smoke.py --fixpoint-paths``), so a flood never takes more
# than about twice its faster path's time.
GRAPH_AFTER_ROUNDS = 128
CHECK_EVERY_CUDA = 32


def _neighbours(x: torch.Tensor, offsets, fill):
    """``[shift(x, off, fill) for off in offsets]`` as views of one padded
    copy of ``x`` (each offset of the trailing ``len(off)`` axes is -1, 0
    or 1)."""
    nd = len(offsets[0])
    p = torch.nn.functional.pad(x, (1, 1) * nd, value=fill)
    lead = [slice(None)] * (x.dim() - nd)
    return [p[tuple(lead + [slice(1 + o, 1 + o + n) for o, n in zip(off, x.shape[-nd:])])]
            for off in offsets]


def _fixpoint(step, state):
    """Apply ``step`` to the tuple ``state`` until a round changes nothing:
    round by round for ``GRAPH_AFTER_ROUNDS`` rounds (on the CPU to the
    end), then on the card in graph-replayed stretches of
    ``CHECK_EVERY_CUDA`` rounds (the same operations in the same order, so
    the same values)."""
    rounds = 0
    while not state[0].is_cuda or rounds < GRAPH_AFTER_ROUNDS:
        new = step(state)
        if all(torch.equal(a, b) for a, b in zip(new, state)):
            return new
        state = new
        rounds += 1
    inp = tuple(t.clone() for t in state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(inp)  # warm-up outside the capture, as CUDA graphs need
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = inp
        for _ in range(CHECK_EVERY_CUDA):
            out = step(out)
    while True:
        graph.replay()
        if all(torch.equal(a, b) for a, b in zip(out, inp)):
            return tuple(t.clone() for t in out)
        for a, b in zip(inp, out):
            a.copy_(b)


def _altitude_plain(hmap, mask, conduct, alt, links):
    """Phase 1 to its fixpoint: ``A(p) = min(A(p), max(min_q A(q), h(p)))``
    where ``p`` conducts, over the linked neighbours ``q`` (``links``:
    ``(offset, ok)`` pairs, ``ok`` None or where the link exists)."""
    big = torch.tensor(BIG, dtype=torch.float32, device=hmap.device)
    offsets = [off for off, _ in links]

    def step(state):
        (alt,) = state
        nb = None
        for q, (_, ok) in zip(_neighbours(torch.where(mask, alt, big), offsets, BIG), links):
            q = q if ok is None else torch.where(ok, q, big)
            nb = q if nb is None else torch.minimum(nb, q)
        return (torch.where(conduct, torch.minimum(alt, torch.maximum(nb, hmap)), alt),)

    return _fixpoint(step, (alt,))[0]


def _flood_plain(hmap, seeds, mask, offsets, warm=None):
    """Both phases over the neighbour ``offsets`` (of the trailing axes).
    Returns int32 labels, 0 off the mask."""
    from .watershed import minlex

    hmap = hmap.to(torch.float32)
    mask = mask.bool()
    seeds = torch.where(mask, seeds.to(torch.int32), 0)
    is_seed = seeds > 0
    conduct = mask & ~is_seed
    big = torch.tensor(BIG, dtype=torch.float32, device=hmap.device)

    # phase 1: altitude, from the warm state where one is given
    alt = torch.where(is_seed, hmap, big)
    if warm is not None:
        alt = torch.minimum(alt, warm.to(torch.float32))
    alt = _altitude_plain(hmap, mask, conduct, alt, [(off, None) for off in offsets])

    # phase 2: (hops, label) over optimal-prefix edges, smaller label on ties
    edges = [conduct & (alt == torch.maximum(q, hmap))
             for q in _neighbours(torch.where(mask, alt, big), offsets, BIG)]

    def step(state):
        dist, label = state
        best_d, best_l = dist, label
        labs = _neighbours(torch.where(mask, label, 0), offsets, 0)
        for q_d, q_l, ok in zip(_neighbours(dist, offsets, BIG_DIST), labs, edges):
            best_d, best_l = minlex(q_d + 1, torch.where(ok, q_l, 0), best_d, best_l)
        return best_d, best_l

    dist, label = _fixpoint(step, (torch.where(is_seed, 0, BIG_DIST).to(torch.int64), seeds))
    return torch.where(mask, label, 0).to(torch.int32)


def flood_slices_plain(hmap: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Flood every z-slice of ``hmap`` (N, H, W) from ``seeds`` (0 =
    unlabeled), restricted to ``mask``.  Returns int32 labels, 0 off mask."""
    return _flood_plain(hmap, seeds, mask, _OFFSETS)


def flood_volume_plain(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    warm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """3d flood of every block of a (B, Z, H, W) batch over 6 neighbours
    (never across blocks), phase 1 from ``min(A0, warm)`` where ``warm`` is
    given.  Returns int32 labels, 0 off mask."""
    return _flood_plain(hmap, seeds, mask, _OFFSETS_3D, warm)


# -- the flood's transfers (csrc/scan.cuh) in PyTorch ----------------------
# Built over tensors of lines for ``scan.scan_sweep``: the clamp family
# (``scan.clamp_compose`` / ``clamp_apply``) for phase 1, the keyed family
# below for phase 2.


def alt_transfers(alt: torch.Tensor, hmap: torch.Tensor, mask: torch.Tensor):
    """Flood phase 1: (u, l) = (A, h) with h = +inf off the mask, so that a
    voxel off the mask (A = BIG) is the constant BIG and a seed (A = h) the
    constant A: c -> min(u, max(c, l))."""
    return alt, torch.where(mask, hmap, torch.full_like(hmap, float("inf")))


def assign_edges(alt: torch.Tensor, hmap: torch.Tensor, mask: torch.Tensor,
                 seeds: torch.Tensor) -> torch.Tensor:
    """Flood phase 2's edge bits of a forward sweep along the last axis:
    in the mask, not a seed, and A(p) == max(A(prev), h(p)), A(prev) = BIG
    before the line's first voxel (BIG off the mask too: A is BIG there)."""
    prev = torch.cat([torch.full_like(alt[..., :1], BIG), alt[..., :-1]], -1)
    return mask & (seeds == 0) & (alt == torch.maximum(prev, hmap))


def assign_transfers(dist: torch.Tensor, label: torch.Tensor, edge: torch.Tensor):
    """Flood phase 2: (d, l, s), the voxel's own key (hops, label) and s = 1
    where the sweep's edge into it exists (c -> minlex((d, l), c + (s, 0))),
    s = -1 elsewhere (the constant (d, l))."""
    return dist.long(), label.long(), torch.where(edge, 1, -1)


def _key_less(d1, l1, d2, l2):
    # label 0 is +inf (the kernel compares unsigned label - 1)
    l1 = torch.where(l1 == 0, 2**32, l1)
    l2 = torch.where(l2 == 0, 2**32, l2)
    return (d1 < d2) | ((d1 == d2) & (l1 < l2))


def _key_add(d, l, s):
    return torch.where(l == 0, BIG_DIST, d + s), l


def assign_compose(f, g):
    cd, cl = _key_add(f[0], f[1], g[2])
    take = (g[2] >= 0) & _key_less(cd, cl, g[0], g[1])
    s = torch.where((f[2] < 0) | (g[2] < 0), -1, f[2] + g[2])
    return torch.where(take, cd, g[0]), torch.where(take, cl, g[1]), s


def assign_apply(f, c):
    ad, al = _key_add(c[0], c[1], f[2])
    take = (f[2] >= 0) & _key_less(ad, al, f[0], f[1])
    return torch.where(take, ad, f[0]), torch.where(take, al, f[1])


def _clip_tile(tile_hw: Sequence[int], h: int, w: int) -> Tuple[int, int]:
    th, tw = int(tile_hw[0]), int(tile_hw[1])
    if th <= 0 or tw <= 0:
        raise ValueError(f"flood_tiles_warm: bad tile {tuple(tile_hw)}")
    return min(th, max(h, 1)), min(tw, max(w, 1))


def flood_tiles_warm_plain(
    hmap: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor, tile_hw: Sequence[int]
) -> torch.Tensor:
    """Phase-1 altitude fixpoint of every (th, tw) tile of every slice of an
    (N, H, W) stack, links cut at the tile borders (edge tiles cut to the
    slice).  Float32; seeds keep their height, voxels off the mask and
    voxels no in-tile path reaches hold ``BIG``."""
    n, h, w = hmap.shape
    th, tw = _clip_tile(tile_hw, h, w)
    gw = -(-w // tw)
    dev = hmap.device
    tid = (torch.arange(h, device=dev) // th)[:, None] * gw + (torch.arange(w, device=dev) // tw)[None, :]
    links = [(off, shift(tid, off, -1) == tid) for off in _OFFSETS]
    mask = mask.bool()
    is_seed = (seeds > 0) & mask
    hmap = hmap.to(torch.float32)
    alt = torch.where(is_seed, hmap, torch.tensor(BIG, dtype=torch.float32, device=dev))
    return _altitude_plain(hmap, mask, mask & ~is_seed, alt, links)


def flood_slices(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    rounds: Optional[torch.Tensor] = None,
    stamps: Optional[torch.Tensor] = None,
    force_global: bool = False,
) -> torch.Tensor:
    """Per-slice seeded flood of an (N, H, W) stack: the CUDA kernel for
    CUDA tensors, ``flood_slices_plain`` for CPU tensors.  The kernel's
    route is ``flood_route(H, W)`` (``force_global`` takes the global
    route, the parent design, for comparisons), counted in
    ``launches_by_route``; a launch the card refuses raises.  ``rounds`` (an
    int32 (N, 2) CUDA tensor) receives each slice's phase-1 and phase-2
    round counts; ``stamps`` (an int64 (N, FLOOD_STAMPS) CUDA tensor) the
    card's clock in ns at the start, after the set-up, after phase 1 and
    after phase 2 of each slice."""
    if hmap.dim() != 3 or seeds.shape != hmap.shape or mask.shape != hmap.shape:
        raise ValueError(f"flood_slices takes three (N, H, W) tensors, got "
                         f"{tuple(hmap.shape)}, {tuple(seeds.shape)}, {tuple(mask.shape)}")
    if hmap.device.type == "cpu":
        return flood_slices_plain(hmap, seeds, mask)
    if hmap.device.type != "cuda":
        raise ValueError(f"flood_slices: unsupported device {hmap.device}")
    n, h, w = hmap.shape
    dev = hmap.device
    if n * h * w == 0:
        return torch.zeros((n, h, w), dtype=torch.int32, device=dev)
    hm = hmap.to(torch.float32).contiguous()
    sd = seeds.to(torch.int32).contiguous()
    mk = mask.to(torch.int32).contiguous()
    if sd.device != dev or mk.device != dev:
        raise ValueError("flood_slices: all tensors must be on one device")
    out = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    route = "global" if force_global else flood_route(h, w)
    alt = dist = None
    if route == "global":
        alt = torch.empty((n, h, w), dtype=torch.float32, device=dev)
        dist = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    if rounds is not None and (rounds.shape != (n, 2) or rounds.dtype != torch.int32
                               or rounds.device != dev):
        raise ValueError("flood_slices: rounds must be an int32 (N, 2) tensor on the device")
    _build.check_stamps("flood_slices", stamps, n, FLOOD_STAMPS, dev)
    lib = _build.library("flood")
    fn = lib.ctt_flood_slices
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(
            _build.ptr(hm), _build.ptr(sd), _build.ptr(mk), _build.ptr(out),
            _build.ptr(alt) if alt is not None else None,
            _build.ptr(dist) if dist is not None else None, n, h, w,
            _build.ptr(rounds) if rounds is not None else None,
            _build.ptr(stamps) if stamps is not None else None,
            int(route == "cluster"), _build.stream_handle(dev),
        )
    _build.check(rc, f"ctt_flood_slices ({route} route)")
    _build.count_launch(flood_slices, route=route)
    return out


flood_slices.launches = 0
flood_slices.launches_by_route = {"cluster": 0, "global": 0}


def _check_same(what: str, ref: torch.Tensor, *others) -> None:
    for t in others:
        if t is not None and (t.shape != ref.shape or t.device != ref.device):
            raise ValueError(f"{what}: every tensor must have shape {tuple(ref.shape)} "
                             f"on {ref.device}, got {tuple(t.shape)} on {t.device}")


def flood_tiles_warm(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    tile_hw: Sequence[int],
    rounds: Optional[torch.Tensor] = None,
    stamps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 3: tile-local altitude warm start of an (N, H, W) stack for
    CUDA tensors, ``flood_tiles_warm_plain`` for CPU tensors.  ``rounds``
    (int32, one entry per (slice, tile), on the card) receives each tile's
    fixpoint rounds; ``stamps`` (int64 (tiles, len(TILE_PHASES)) on the
    card) the card's ns of each tile in each of ``TILE_PHASES``."""
    if hmap.dim() != 3:
        raise ValueError(f"flood_tiles_warm takes (N, H, W) tensors, got {tuple(hmap.shape)}")
    _check_same("flood_tiles_warm", hmap, seeds, mask)
    n, h, w = hmap.shape
    th, tw = _clip_tile(tile_hw, h, w)
    if hmap.device.type == "cpu":
        return flood_tiles_warm_plain(hmap, seeds, mask, (th, tw))
    if hmap.device.type != "cuda":
        raise ValueError(f"flood_tiles_warm: unsupported device {hmap.device}")
    if not _build.smem("flood3d", "ctt_flood_tiles_smem", th, tw):
        raise ValueError(f"flood_tiles_warm: tile {(th, tw)} exceeds a thread block's shared memory")
    n_tiles = n * -(-h // th) * -(-w // tw)
    if rounds is not None and (rounds.shape != (n_tiles,) or rounds.dtype != torch.int32
                               or rounds.device != hmap.device):
        raise ValueError(f"flood_tiles_warm: rounds must be an int32 ({n_tiles},) tensor on the device")
    _build.check_stamps("flood_tiles_warm", stamps, n_tiles, len(TILE_PHASES), hmap.device)
    out = torch.empty((n, h, w), dtype=torch.float32, device=hmap.device)
    if out.numel() == 0:
        return out
    hm = hmap.to(torch.float32).contiguous()
    sd = seeds.to(torch.int32).contiguous()
    mk = mask.to(torch.bool).contiguous()
    fn = _build.library("flood3d").ctt_flood_tiles_warm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(hmap.device):
        rc = fn(_build.ptr(hm), _build.ptr(sd), _build.ptr(mk), _build.ptr(out),
                n, h, w, th, tw, _build.ptr(rounds) if rounds is not None else None,
                _build.ptr(stamps) if stamps is not None else None,
                _build.stream_handle(hmap.device))
    _build.check(rc, "ctt_flood_tiles_warm")
    _build.count_launch(flood_tiles_warm)
    return out


flood_tiles_warm.launches = 0


def flood_volume(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    warm: Optional[torch.Tensor] = None,
    stats: Optional[dict] = None,
    stamps: Optional[torch.Tensor] = None,
    return_alt: bool = False,
):
    """3d seeded flood of a (B, Z, H, W) batch: the CUDA kernel for CUDA
    tensors, ``flood_volume_plain`` for CPU tensors.  ``warm`` (float32, the
    batch's shape) lowers the initial altitudes on the mask (kernel 3's
    output).  ``stats`` receives the rounds of each phase
    (``flood_alt_iters``, ``flood_assign_iters``, the JAX package's names);
    the wrapper's ``alt_rounds`` / ``assign_rounds`` sum them over the
    card's calls.  ``stamps`` (an int64 (1, 14) CUDA tensor) receives the
    card's ns spent on each of ``FLOOD3D_PHASES``, then the lines swept in
    each of ``FLOOD3D_LINES``.  ``return_alt`` returns ``(labels,
    altitudes)``.  On the CPU a call that asks for rounds or altitudes runs
    the kernel's schedule (``flood_volume_scan``), whose rounds are the
    kernel's."""
    if hmap.dim() != 4:
        raise ValueError(f"flood_volume takes (B, Z, H, W) tensors, got {tuple(hmap.shape)}")
    _check_same("flood_volume", hmap, seeds, mask, warm)
    if hmap.device.type == "cpu":
        if stats is None and not return_alt:
            return flood_volume_plain(hmap, seeds, mask, warm)
        lab, alt, rounds = flood_volume_scan(hmap, seeds, mask, warm)
        if stats is not None:
            stats["flood_alt_iters"], stats["flood_assign_iters"] = rounds
        return (lab, alt) if return_alt else lab
    if hmap.device.type != "cuda":
        raise ValueError(f"flood_volume: unsupported device {hmap.device}")
    b, z, h, w = hmap.shape
    if z * h * w >= 2**31:
        raise ValueError(f"flood_volume: blocks of {(z, h, w)} exceed int32 indices")
    dev = hmap.device
    lab = torch.empty((b, z, h, w), dtype=torch.int32, device=dev)
    if lab.numel() == 0:
        if stats is not None:
            stats["flood_alt_iters"], stats["flood_assign_iters"] = 1, 1
        return (lab, torch.empty(lab.shape, dtype=torch.float32, device=dev)) if return_alt else lab
    hm_in = hmap.to(torch.float32).contiguous()
    sd = seeds.to(torch.int32).contiguous()
    mk = mask.to(torch.bool).contiguous()
    wm = None if warm is None else warm.to(torch.float32).contiguous()
    hm = torch.empty_like(hm_in)
    alt = torch.empty_like(hm_in)
    dist = torch.empty_like(lab)
    edges = torch.empty(lab.shape, dtype=torch.uint8, device=dev)
    flags = torch.empty(b * (z * h + z * w + h * w), dtype=torch.uint8, device=dev)
    state = torch.empty(3, dtype=torch.int32, device=dev)
    _build.check_stamps("flood_volume", stamps, 1, len(FLOOD3D_PHASES) + len(FLOOD3D_LINES), dev)
    rounds = (ctypes.c_int * 2)()
    fn = _build.library("flood3d").ctt_flood3d
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(_build.ptr(hm_in), _build.ptr(sd), _build.ptr(mk),
                _build.ptr(wm) if wm is not None else None, _build.ptr(hm),
                _build.ptr(alt), _build.ptr(dist), _build.ptr(lab), _build.ptr(edges),
                _build.ptr(flags), _build.ptr(state),
                _build.ptr(stamps) if stamps is not None else None,
                b, z, h, w, ctypes.cast(rounds, ctypes.c_void_p), _build.stream_handle(dev))
    _build.check(rc, "ctt_flood3d")
    _build.count_launch(flood_volume, alt_rounds=rounds[0], assign_rounds=rounds[1])
    if stats is not None:
        stats["flood_alt_iters"], stats["flood_assign_iters"] = rounds[0], rounds[1]
    return (lab, alt) if return_alt else lab


flood_volume.launches = 0
flood_volume.alt_rounds = 0
flood_volume.assign_rounds = 0


# -- the 3d flood's schedule (csrc/flood3d.cuh) in PyTorch ----------------
RUN_3D = 17  # elements of a line one lane holds (CTT_F3_RUN)
WARPS_3D = 16  # warps per block of the 3d flood: runs of a y line


def kernel_cuts(axis: int, n: int, rev: bool = False) -> Sequence[int]:
    """Where the 3d flood's kernel cuts a line of ``n`` voxels along
    ``axis`` (0: z, 1: y, 2: x) into lanes' runs, in sweep positions of the
    forward or backward (``rev``) sweep.  A y line is spread over the 16
    warps of a block, a z or x line over the fewest lanes (a power of two,
    at most 32) whose runs of at most ``RUN_3D`` cover it; a longer line
    goes in tiles of that many runs."""
    lanes = WARPS_3D
    if axis != 1:
        lanes = 1
        while lanes < 32 and lanes * RUN_3D < n:
            lanes *= 2
    tile = lanes * RUN_3D
    cuts = set()
    for t0 in range(0, n, tile):
        run = -(-min(tile, n - t0) // lanes)
        cuts.update(range(t0, min(t0 + tile, n), run))
    cuts.discard(0)
    return sorted(n - c for c in cuts) if rev else sorted(cuts)


def volume_edges(alt: torch.Tensor, hmap: torch.Tensor, mask: torch.Tensor,
                 seeds: torch.Tensor) -> torch.Tensor:
    """Phase 2's edge byte of a (B, Z, H, W) batch: bit d (sweep d of a
    round: z forward, z backward, y forward, y backward, x forward, x
    backward) where the edge from the previous voxel of that sweep exists:
    in the mask, not a seed, and A(p) == max(A(prev), h(p)), A(prev) = BIG
    before a line's first voxel and off the mask."""
    alt_m = torch.where(mask, alt, torch.full_like(alt, BIG))
    bits = torch.zeros(alt.shape, dtype=torch.uint8, device=alt.device)
    for d, off in enumerate(((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))):
        ok = mask & (seeds <= 0) & (alt == torch.maximum(shift(alt_m, off, BIG), hmap))
        bits |= ok.to(torch.uint8) << d
    return bits


def _sweep_lines(t: torch.Tensor, axis: int, rev: bool) -> torch.Tensor:
    t = t.movedim(axis + 1, -1)
    return t.flip(-1) if rev else t


def _unsweep_lines(t: torch.Tensor, axis: int, rev: bool) -> torch.Tensor:
    return (t.flip(-1) if rev else t).movedim(-1, axis + 1)


def _sweep(d, transfers, compose, apply, identity, init, cuts):
    """Sweep ``d`` (axis ``d // 2`` of the trailing three, backward when
    ``d`` is odd) of a (B, Z, H, W) batch as ``scan_sweep`` on lines cut
    where ``cuts(axis, n, rev)`` says."""
    axis, rev = d // 2, d % 2 == 1
    n = transfers[0].shape[axis + 1]
    f = tuple(_sweep_lines(t, axis, rev) for t in transfers)
    line = f[0][..., 0]
    out = scan_sweep(compose, apply, tuple(torch.full_like(line, v) for v in identity),
                     f, tuple(torch.full_like(line, v) for v in init) if isinstance(init, tuple)
                     else torch.full_like(line, init), cuts(axis, n, rev))
    if isinstance(out, tuple):
        return tuple(_unsweep_lines(o, axis, rev) for o in out)
    return _unsweep_lines(out, axis, rev)


def _moved(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return (new != old).reshape(new.shape[0], -1).any(1)


def _rounds_loop(state, one_round, max_iter: int):
    """Apply ``one_round`` (state -> (state, moved per block)) until a round
    moves no block, or ``max_iter`` rounds when it is > 0.  Returns the state
    and each block's rounds as the JAX package counts them: one more than
    the rounds that moved it, at most ``max_iter``."""
    rounds = torch.ones(state[0].shape[0], dtype=torch.int64, device=state[0].device)
    done = 0
    while True:
        state, moved = one_round(state)
        done += 1
        if not bool(moved.any()) or (max_iter and done >= max_iter):
            break
        rounds += moved
    if max_iter:
        rounds = torch.clamp(rounds, max=max_iter)
    return state, rounds


def altitude_sweeps(alt: torch.Tensor, hmap: torch.Tensor, mask: torch.Tensor,
                    axes: Sequence[int] = (0, 1, 2), max_iter: int = 0, cuts=kernel_cuts):
    """Flood phase 1 of a (B, Z, H, W) batch on the sweep schedule: rounds
    of a forward and a backward sweep along each of ``axes`` (of z, y, x)
    from the altitudes ``alt``.  Returns the altitudes and each block's
    rounds (``_rounds_loop``)."""
    hm = torch.where(mask, hmap, torch.full_like(hmap, float("inf")))

    def one_round(state):
        (a,) = state
        moved = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
        for d in (d for d in range(6) if d // 2 in axes):
            new = _sweep(d, (a, hm), clamp_compose, clamp_apply,
                         (float("inf"), float("-inf")), BIG, cuts)
            moved |= _moved(new, a)
            a = new
        return (a,), moved

    (alt,), rounds = _rounds_loop((alt,), one_round, max_iter)
    return alt, rounds


def assign_sweeps(dist: torch.Tensor, label: torch.Tensor, edges: torch.Tensor,
                  axes: Sequence[int] = (0, 1, 2), max_iter: int = 0, cuts=kernel_cuts):
    """Flood phase 2 of a (B, Z, H, W) batch on the sweep schedule from the
    keys ``(dist, label)`` over the edge bits of ``volume_edges``.  Returns
    int64 hops and labels, and each block's rounds."""

    def one_round(state):
        dd, ll = state
        moved = torch.zeros(dd.shape[0], dtype=torch.bool, device=dd.device)
        for d in (d for d in range(6) if d // 2 in axes):
            f = assign_transfers(dd, ll, (edges >> d) & 1 == 1)
            nd, nl = _sweep(d, f, assign_compose, assign_apply, (BIG_DIST, 0, 0),
                            (BIG_DIST, 0), cuts)
            moved |= _moved(nd, dd) | _moved(nl, ll)
            dd, ll = nd, nl
        return (dd, ll), moved

    (dist, label), rounds = _rounds_loop((dist.long(), label.long()), one_round, max_iter)
    return dist, label, rounds


def flood_volume_scan(
    hmap: torch.Tensor,
    seeds: torch.Tensor,
    mask: torch.Tensor,
    warm: Optional[torch.Tensor] = None,
    cuts=kernel_cuts,
    per_item: bool = False,
    axes: Sequence[int] = (0, 1, 2),
    max_iter: int = 0,
):
    """The 3d flood of a (B, Z, H, W) batch on the kernel's schedule: rounds
    of the six sweeps (z, y, x, each forward then backward) until a round
    changes nothing, each sweep run as ``scan_sweep`` on lines cut where
    ``cuts(axis, n, rev)`` says, phase 2 from ``volume_edges``.  Returns the
    int32 labels (0 off the mask), the altitudes and the rounds of each
    phase: the counts the kernel must report.  With ``per_item`` the rounds
    are a list of each block's (phase 1, phase 2) rounds, those the kernel
    reports for that block alone: blocks never interact, a block's rounds
    are one more than the rounds that changed it, and a batch's are the
    most of its blocks' — so one call serves several gates' inputs.
    ``axes`` restricts the sweeps (``(1, 2)``: each z-slice floods on its
    own) and ``max_iter`` > 0 caps each phase's rounds, as the JAX
    package's capped flood does; a capped flood's labels depend on this
    schedule."""
    hmap = hmap.to(torch.float32)
    mask = mask.bool()
    seeds = torch.where(mask, seeds.to(torch.int32), 0)
    is_seed = seeds > 0
    alt = torch.where(is_seed, hmap, torch.full_like(hmap, BIG))
    if warm is not None:
        alt = torch.where(mask, torch.minimum(alt, warm.to(torch.float32)), alt)
    alt, r1 = altitude_sweeps(alt, hmap, mask, axes, max_iter, cuts)
    edges = volume_edges(alt, hmap, mask, seeds)
    dist = torch.where(is_seed, 0, BIG_DIST).to(torch.int64)
    _, label, r2 = assign_sweeps(dist, seeds, edges, axes, max_iter, cuts)
    rounds = list(zip(r1.tolist(), r2.tolist()))
    if not per_item:
        rounds = (max(r for r, _ in rounds), max(r for _, r in rounds))
    return torch.where(mask, label, 0).to(torch.int32), alt, rounds


def flood_tiles_warm_scan(
    hmap: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor, tile_hw: Sequence[int]
):
    """Kernel 3 on its schedule (``csrc/tile_scan.cuh``): every (th, tw) tile
    of every slice relaxed by ``tile_rounds`` with the flood's phase-1
    transfers (A, h'), h' = +inf off the mask, until the tile's round
    changes nothing.
    Returns the altitudes (``flood_tiles_warm_plain``'s) and the int32
    rounds per (slice, tile), in the kernel's order: the counts kernel 3
    must report.  A test model; the main path never calls it."""
    n, h, w = hmap.shape
    tile = _clip_tile(tile_hw, h, w)
    mask = mask.bool()
    hmap = hmap.to(torch.float32)
    inf = float("inf")
    real = tiles_of(torch.ones_like(mask), tile, False)
    hm = tiles_of(torch.where(mask, hmap, torch.full_like(hmap, inf)), tile, -inf)
    alt = tiles_of(torch.where((seeds > 0) & mask, hmap, torch.full_like(hmap, BIG)), tile, inf)
    alt, rounds = tile_rounds(alt, real, (hm,), lambda a, h: (a, h), clamp_compose, clamp_apply,
                              (inf, -inf), BIG)
    return untile(alt, (n, h, w)), rounds
