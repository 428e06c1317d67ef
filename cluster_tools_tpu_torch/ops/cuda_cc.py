"""Kernels 4 and 5: per-slice and per-tile connected components, written in
CUDA for Hopper.

Replace ``cluster_tools_tpu/ops/pallas_cc.py::cc_slices`` and ``::cc_tiles``.
Both kernels (``csrc/cc.cuh``) label an (N, H, W) mask stack: every
foreground voxel gets the minimal block-flat index of its 4-connected
component within its slice (``cc_slices``) or within its (th, tw) tile of the
slice (``cc_tiles``), background −1.  Slice s is depth z = s % ``depth`` of
its block, so a (B·Z, H, W) batch gets the ids the JAX kernels give one
(Z, H, W) volume; ``depth`` defaults to N (the stack is one block).  The
merges of ``ops/cc.py`` (``merge_slice_labels``, ``merge_tiled_labels``)
turn the output into volume components.  Kernel 4 takes one of two routes,
chosen by the slice's size before launch (``cc_route``): a thread-block
cluster of 8 CTAs per slice with the slice's labels in shared memory and
the line sweeps as warp scans (``csrc/cc_cluster.cuh``), or, for slices
that do not fit, one thread block per slice over the output buffer.
Kernel 5 holds each tile in one CTA's shared memory, its sweeps warp scans
(``csrc/tile_scan.cuh``) and its labels tile keys ``r << k | c`` during the
rounds; ``cc_tiles_scan`` is that schedule in PyTorch.

``cc_slices_plain`` and ``cc_tiles_plain`` compute the same functions with
PyTorch ops (min-label propagation plus pointer jumping, restricted to the
slice or the tile).  The fixpoint is unique, so labels are equal exactly.
The wrappers take the plain versions only for tensors on the CPU; for a CUDA
tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .scan import clamp_apply, clamp_compose
from .tile_scan import TILE_PHASES, tile_rounds, tiles_of, untile

# the JAX package's whole-slice limit (pallas_cc.py:248: ~8 full-slice int32
# buffers in a 12 MB VMEM budget); larger slices take the tiled kernel
WHOLE_SLICE_MAX = 12 * 1024 * 1024 // (4 * 8)
# kernel 5's tile: 64 x 133 int32 (row stride tw + tw/32 made odd) and the
# lines' bookkeeping, 35 KB of shared memory
TILE = (64, 128)
SENT = 2**31 - 2  # kernel 5's background label during the rounds (CTT_SENT)


def default_tile(h: int, w: int) -> Tuple[int, int]:
    """Kernel 5's tile for (h, w) slices: ``TILE`` cut to the slice."""
    return min(h, TILE[0]), min(w, TILE[1])


def _check_stack(what: str, mask: torch.Tensor, depth: Optional[int]) -> int:
    if mask.dim() != 3:
        raise ValueError(f"{what} takes an (N, H, W) mask, got {tuple(mask.shape)}")
    n, h, w = mask.shape
    depth = n if depth is None else int(depth)
    if n and (depth <= 0 or n % depth):
        raise ValueError(f"{what}: {n} slices are not whole blocks of depth {depth}")
    if depth * h * w >= 2**31:
        raise ValueError(f"{what}: block-flat ids of ({depth}, {h}, {w}) exceed int32")
    return max(depth, 1)


def _block_base(n: int, depth: int, hw: int, device) -> torch.Tensor:
    z = torch.arange(n, device=device, dtype=torch.int64) % depth
    return (z * hw).view(n, 1, 1, 1)


def _plain(mask: torch.Tensor, depth: int, partition=None) -> torch.Tensor:
    from .cc import connected_components_raw

    n, h, w = mask.shape
    m = mask.bool().view(n, 1, h, w)
    raw = connected_components_raw(m, 1, partition=partition, per_slice=True)
    out = torch.where(raw >= 0, raw + _block_base(n, depth, h * w, mask.device), -1)
    return out.view(n, h, w).to(torch.int32)


def cc_slices_plain(mask: torch.Tensor, depth: Optional[int] = None) -> torch.Tensor:
    """Per-slice 4-connected CC of an (N, H, W) mask: int32 minimal
    block-flat index of each voxel's in-slice component, −1 on background."""
    return _plain(mask, _check_stack("cc_slices", mask, depth))


def cc_tiles_plain(
    mask: torch.Tensor, tile: Tuple[int, int], depth: Optional[int] = None
) -> torch.Tensor:
    """Per-tile 4-connected CC: as ``cc_slices_plain`` with connections
    restricted to each (th, tw) tile of the slice (edge tiles cut)."""
    depth = _check_stack("cc_tiles", mask, depth)
    n, h, w = mask.shape
    th, tw = int(tile[0]), int(tile[1])
    gw = -(-w // tw)
    rows = torch.arange(h, device=mask.device) // th
    cols = torch.arange(w, device=mask.device) // tw
    part = (rows[:, None] * gw + cols[None, :] + 1).expand(n, 1, h, w).contiguous()
    return _plain(mask, depth, partition=part)


def cc_route(h: int, w: int) -> str:
    """Kernel 4's route for (h, w) slices, by size alone: ``"cluster"``
    where the slice's labels fit the shared memory of a cluster's CTAs (the
    rule is ``csrc/cc.cu::ctt_cc_cluster_smem``: 256 x 256 needs 40,576 of
    232,448 B per CTA), else ``"global"``.  Asks the built kernel library,
    so it needs ``nvcc``."""
    return "cluster" if _build.cluster_smem("cc", h, w) else "global"


def _launch_args(what: str, mask: torch.Tensor, rounds, n_rounds: int):
    if mask.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {mask.device}")
    if rounds is not None and (rounds.shape != (n_rounds,) or rounds.dtype != torch.int32
                               or rounds.device != mask.device):
        raise ValueError(f"{what}: rounds must be an int32 ({n_rounds},) tensor on the device")
    mk = mask.to(torch.bool).contiguous()
    out = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    return mk, out, _build.ptr(rounds) if rounds is not None else None


def cc_slices(
    mask: torch.Tensor,
    depth: Optional[int] = None,
    rounds: Optional[torch.Tensor] = None,
    force_global: bool = False,
) -> torch.Tensor:
    """Per-slice CC of an (N, H, W) mask: kernel 4 for CUDA tensors,
    ``cc_slices_plain`` for CPU tensors.  The kernel's route is
    ``cc_route(H, W)`` (``force_global`` takes the global route, the parent
    design, for comparisons), counted in ``launches_by_route``.  ``rounds``
    (int32 (N,) on the card) receives each slice's fixpoint rounds."""
    depth = _check_stack("cc_slices", mask, depth)
    if mask.device.type == "cpu":
        return cc_slices_plain(mask, depth)
    n, h, w = mask.shape
    mk, out, rounds_ptr = _launch_args("cc_slices", mask, rounds, n)
    if out.numel() == 0:
        return out
    route = "global" if force_global else cc_route(h, w)
    fn = _build.library("cc").ctt_cc_slices
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(mask.device):
        rc = fn(_build.ptr(mk), _build.ptr(out), n, depth, h, w, rounds_ptr,
                int(route == "cluster"), _build.stream_handle(mask.device))
    _build.check(rc, f"ctt_cc_slices ({route} route)")
    _build.count_launch(cc_slices, route=route)
    return out


cc_slices.launches = 0
cc_slices.launches_by_route = {"cluster": 0, "global": 0}


def cc_tiles(
    mask: torch.Tensor,
    tile: Tuple[int, int],
    depth: Optional[int] = None,
    rounds: Optional[torch.Tensor] = None,
    stamps: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-tile CC of an (N, H, W) mask: kernel 5 for CUDA tensors,
    ``cc_tiles_plain`` for CPU tensors.  ``rounds`` (int32, one entry per
    (slice, tile)) receives each tile's fixpoint rounds; ``stamps`` (int64
    (tiles, len(tile_scan.TILE_PHASES)) on the card) the card's ns of each
    tile in each phase."""
    depth = _check_stack("cc_tiles", mask, depth)
    th, tw = int(tile[0]), int(tile[1])
    if th <= 0 or tw <= 0:
        raise ValueError(f"cc_tiles: bad tile {tile}")
    if mask.device.type == "cpu":
        return cc_tiles_plain(mask, (th, tw), depth)
    n, h, w = mask.shape
    n_tiles = n * -(-h // th) * -(-w // tw)
    mk, out, rounds_ptr = _launch_args("cc_tiles", mask, rounds, n_tiles)
    _build.check_stamps("cc_tiles", stamps, n_tiles, len(TILE_PHASES), mask.device)
    if not _build.smem("cc", "ctt_cc_tiles_smem", th, tw):
        raise ValueError(f"cc_tiles: tile {tile} exceeds a thread block's shared memory")
    if out.numel() == 0:
        return out
    if n_tiles >= 2**31:
        raise ValueError(f"cc_tiles: {n_tiles} tiles exceed one launch")
    fn = _build.library("cc").ctt_cc_tiles
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(mask.device):
        rc = fn(_build.ptr(mk), _build.ptr(out), n, depth, h, w, th, tw, rounds_ptr,
                _build.ptr(stamps) if stamps is not None else None,
                _build.stream_handle(mask.device))
    _build.check(rc, "ctt_cc_tiles")
    _build.count_launch(cc_tiles)
    return out


cc_tiles.launches = 0


def tile_key_bits(tw: int) -> int:
    """Bits of the column in kernel 5's tile keys ``r << k | c``: the fewest
    k with 2**k >= tw."""
    return max(int(tw) - 1, 0).bit_length()


def tile_key_ids(keys: torch.Tensor, shape, tile: Tuple[int, int], depth: int) -> torch.Tensor:
    """Block-flat ids of kernel 5's tile keys: ``keys`` (T, th, tw) in the
    tile order of ``tile_scan.tiles_of`` over an (N, H, W) ``shape``, each
    key ``r << k | c`` of a voxel of its tile (``SENT`` on the background,
    which becomes −1).  The kernel's store: base + (r0 + r)·W + c0 + c."""
    n, h, w = shape
    th, tw = tile
    gh, gw = -(-h // th), -(-w // tw)
    k = tile_key_bits(tw)
    t = torch.arange(keys.shape[0], device=keys.device)
    s, ty, tx = t // (gh * gw), t // gw % gh, t % gw
    base = ((s % depth) * h * w + ty * th * w + tx * tw).view(-1, 1, 1)
    ids = base + (keys >> k) * w + (keys & ((1 << k) - 1))
    return torch.where(keys == SENT, -1, ids)


def cc_tiles_scan(
    mask: torch.Tensor, tile: Tuple[int, int], depth: Optional[int] = None
) -> torch.Tensor:
    """Kernel 5 on its schedule (``csrc/tile_scan.cuh``, ``csrc/cc.cuh``):
    labels as tile keys ``r << k | c`` (``SENT`` on the background), each
    round the four sweeps of ``tile_scan.tile_rounds`` with the min-label
    clamp transfers, then the pointer jump through the keys (here from the
    round's state at once, in the kernel in place: the rounds may differ,
    the fixpoint does not), until no tile changes; then each key decoded
    to its block-flat id (``tile_key_ids``).  Returns
    ``cc_tiles_plain``'s labels.  A test model; the main path never calls
    it."""
    depth = _check_stack("cc_tiles", mask, depth)
    th, tw = int(tile[0]), int(tile[1])
    k = tile_key_bits(tw)
    dev = mask.device
    real = tiles_of(torch.ones(mask.shape, dtype=torch.bool, device=dev), (th, tw), False)
    fg = tiles_of(mask.bool(), (th, tw), False)
    key = (torch.arange(th, device=dev)[:, None] << k) | torch.arange(tw, device=dev)[None, :]
    lab = torch.where(fg, key, SENT)
    imax, imin = 2**31 - 1, -(2**31)

    def jump(lab):
        flat = lab.flatten(1)
        at = torch.where(flat == SENT, 0, (flat >> k) * tw + (flat & ((1 << k) - 1)))
        to = torch.where(flat == SENT, SENT, torch.gather(flat, 1, at))
        return torch.minimum(flat, to).view(lab.shape)

    lab, _ = tile_rounds(lab, real, (), lambda a: (a, torch.where(a == SENT, SENT, imin)),
                         clamp_compose, clamp_apply, (imax, imin), SENT, after=jump)
    return untile(tile_key_ids(lab, mask.shape, (th, tw), depth), mask.shape).to(torch.int32)
