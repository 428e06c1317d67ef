"""The tile kernels' layout and schedule (``csrc/tile_scan.cuh``: kernel 3,
``cuda_flood.flood_tiles_warm``, and kernel 5, ``cuda_cc.cc_tiles``) in
PyTorch: the tile order, the lanes' runs of a line, the rounds of line
sweeps, and what the kernels' stamps hold.  The schedule models
``cuda_flood.flood_tiles_warm_scan`` and ``cuda_cc.cc_tiles_scan`` run on
it; the main path never does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .scan import scan_sweep

# what the tile kernels' stamps hold (CTT_TILE_STAMPS): ns per tile in each
# phase, over all rounds (kernel 3 has no jump)
TILE_PHASES = ("load", "rows", "columns", "jump", "store")
TILE_RUN = 16  # most elements of a tile's line one lane holds (CTT_TS_RUN)


def tile_lanes(n: int) -> int:
    """Lanes per line of the tile kernels for lines of ``n`` elements
    (``ctt_group_lanes(n, CTT_TS_RUN)``): the fewest, a power of two at
    most 32, whose runs of ``TILE_RUN`` cover the line."""
    lanes = 1
    while lanes < 32 and lanes * TILE_RUN < n:
        lanes *= 2
    return lanes


def tile_line_sweep(compose, apply, identity, transfers, init, lanes: int, rev: bool):
    """One sweep along the last axis as the tile kernels run it: the line
    (its nominal length n) in segments of ``lanes * E`` elements, E the
    fewest (a power of two, at most TILE_RUN) with lanes * E >= n, each cut
    into the lanes' runs of E and run as ``scan_sweep`` from the carry out
    of the segment before; backward (``rev``) the segments and their runs
    in reverse order.  A ragged line holds ``identity`` transfers past its
    end.  Returns each element's new value, in element order."""
    n = transfers[0].shape[-1]
    e = 1
    while e < TILE_RUN and e * lanes < n:
        e *= 2
    runs = sorted(set(range(0, n, e)) | {n})
    segs = sorted(set(range(0, n, lanes * e)) | {n})
    if rev:
        transfers = tuple(t.flip(-1) for t in transfers)
        runs = sorted(n - b for b in runs)
        segs = sorted(n - b for b in segs)
    carry, outs = init, []
    for a, b in zip(segs[:-1], segs[1:]):
        out = scan_sweep(compose, apply, identity, tuple(t[..., a:b] for t in transfers), carry,
                         [k - a for k in runs if a < k < b])
        carry = out[..., -1]
        outs.append(out)
    out = torch.cat(outs, -1)
    return out.flip(-1) if rev else out


def tiles_of(x: torch.Tensor, tile_hw: Sequence[int], fill) -> torch.Tensor:
    """(N, H, W) -> (N * gh * gw, th, tw) in the tile kernels' order
    (slice-major, then tile row, tile column), ragged edge tiles padded
    with ``fill``."""
    n, h, w = x.shape
    th, tw = tile_hw
    gh, gw = -(-h // th), -(-w // tw)
    full = torch.full((n, gh * th, gw * tw), fill, dtype=x.dtype, device=x.device)
    full[:, :h, :w] = x
    return full.view(n, gh, th, gw, tw).permute(0, 1, 3, 2, 4).reshape(-1, th, tw)


def untile(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """The inverse of ``tiles_of`` for an (N, H, W) ``shape``."""
    n, h, w = shape
    th, tw = t.shape[1:]
    gh, gw = -(-h // th), -(-w // tw)
    full = t.reshape(n, gh, gw, th, tw).permute(0, 1, 3, 2, 4).reshape(n, gh * th, gw * tw)
    return full[:, :h, :w]


def tile_rounds(state: torch.Tensor, real: torch.Tensor, fields, transfers, compose, apply,
                identity, init, after=None):
    """Rounds of the tile kernels over a (T, th, tw) batch of tiles until no
    tile changes: rows forward and backward, columns down and up (each line
    by ``tile_line_sweep``; ``transfers(state, *fields)`` gives the
    elements' transfers, ``fields`` being constant (T, th, tw) tensors),
    then ``after(state)`` where given (kernel 5's pointer jump).  A line of
    one segment takes, as the kernels do, the lesser of its forward sweep
    and a backward sweep of its original values; a longer one the backward
    sweep of its forward sweep.  Every line is swept in every round: the
    kernels skip only lines that would not change.  Elements outside
    ``real`` (a ragged tile's padding) hold identity transfers and keep
    their value.  Returns the final state and the rounds per tile: one more
    than the rounds in which the tile changed, the count of a kernel whose
    vote ends a tile's loop at its first unchanged round."""
    lanes = {2: tile_lanes(state.shape[2]), 1: tile_lanes(state.shape[1])}
    rounds = torch.ones(state.shape[0], dtype=torch.int32, device=state.device)
    while True:
        before = state
        for axis in (2, 1):
            a, r = state.transpose(axis, 2), real.transpose(axis, 2)
            fs = tuple(t.transpose(axis, 2) for t in fields)
            line = a[..., 0]

            def sweep(a, rev):
                f = tuple(torch.where(r, t, torch.full_like(t, i))
                          for t, i in zip(transfers(a, *fs), identity))
                return tile_line_sweep(compose, apply,
                                       tuple(torch.full_like(line, i) for i in identity), f,
                                       torch.full_like(line, init), lanes[axis], rev)

            if lanes[axis] * TILE_RUN >= a.shape[-1]:  # one segment
                a = torch.where(r, torch.minimum(sweep(a, False), sweep(a, True)), a)
            else:
                for rev in (False, True):
                    a = torch.where(r, sweep(a, rev), a)
            state = a.transpose(axis, 2)
        if after is not None:
            state = after(state)
        changed = (state != before).flatten(1).any(1)
        if not bool(changed.any()):
            return state, rounds
        rounds += changed.to(torch.int32)
