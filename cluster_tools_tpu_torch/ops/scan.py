"""The transfer algebra of ``csrc/scan.cuh`` in PyTorch, for the kernels'
schedule models (``cuda_flood.flood_volume_scan``, ``tile_scan``).

A sweep along a line is a chain of per-voxel transfers of the incoming
carry.  These functions compose and apply them elementwise over tensors of
lines the way the kernels' lanes do; the tests hold them against the JAX
package's sequential sweeps.  Transfers are tuples of tensors;
``compose(f, g)`` is f first, then g.  The clamp family is
``CttAltOp``'s (the flood's altitudes, c -> min(u, max(c, l))) and
``CttCcOp``'s (min labels, the background a constant).
"""

from __future__ import annotations

from typing import Sequence

import torch


def clamp_compose(f, g):
    return torch.minimum(g[0], torch.maximum(f[0], g[1])), torch.maximum(f[1], g[1])


def clamp_apply(f, c):
    return torch.minimum(f[0], torch.maximum(c, f[1]))


def scan_sweep(compose, apply, identity, transfers, init, cuts: Sequence[int]):
    """One forward sweep along the last axis, run as the kernel runs it: the
    line cut at ``cuts`` into runs (a lane's run, a band's segment), each
    run's transfers composed in order, an inclusive Hillis-Steele scan over
    the runs (the shuffle scan), each run's exclusive prefix applied to
    ``init``, then each run walked voxel by voxel.  Returns each voxel's
    outgoing carry (its new value), stacked along the last axis.  On the
    card, where each operation's launch costs more than its work, the runs
    of one length go side by side (``_scan_sweep_runs``); on the CPU one at
    a time (``_scan_sweep_voxels``).  Both give the same values."""
    fn = _scan_sweep_runs if transfers[0].is_cuda else _scan_sweep_voxels
    return fn(compose, apply, identity, transfers, init, cuts)


def _scan_sweep_voxels(compose, apply, identity, transfers, init, cuts: Sequence[int]):
    """``scan_sweep`` one run and one voxel at a time."""
    n = transfers[0].shape[-1]
    bounds = [0, *sorted(cuts), n]

    def at(k):
        return tuple(t[..., k] for t in transfers)

    inc = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        acc = identity
        for k in range(a, b):
            acc = compose(acc, at(k))
        inc.append(acc)
    d = 1
    while d < len(inc):
        inc = [compose(inc[i - d], inc[i]) if i >= d else inc[i] for i in range(len(inc))]
        d *= 2
    outs = []
    for r, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        c = init if r == 0 else apply(inc[r - 1], init)
        for k in range(a, b):
            c = apply(at(k), c)
            outs.append(c)
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(v, -1) for v in zip(*outs))
    return torch.stack(outs, -1)


def _scan_sweep_runs(compose, apply, identity, transfers, init, cuts: Sequence[int]):
    """``scan_sweep`` with the runs of one length side by side (an axis of
    runs beside the line's): each run's elements go through the same
    operations in the same order as one run at a time, so every value is
    the same bit for bit, and the host issues one operation per step of the
    longest run rather than one per voxel."""
    n = transfers[0].shape[-1]
    bounds = [0, *sorted(cuts), n]
    runs = list(zip(bounds[:-1], bounds[1:]))
    dev = transfers[0].device
    # runs grouped by length: their positions, (R, L) each
    groups = {}
    for r, (a, b) in enumerate(runs):
        groups.setdefault(b - a, []).append(r)
    pos = {length: torch.tensor([[runs[r][0] + k for k in range(length)] for r in rs],
                                device=dev) for length, rs in groups.items()}

    def pick(t, idx):  # t[..., idx] for a tuple of tensors or one tensor
        return tuple(x[..., idx] for x in t) if isinstance(t, tuple) else t[..., idx]

    def stack(parts):  # per-run values stacked on a new last axis
        if isinstance(parts[0], tuple):
            return tuple(torch.stack(v, -1) for v in zip(*parts))
        return torch.stack(parts, -1)

    def expand(v, r):  # one value per line, repeated for r runs
        if isinstance(v, tuple):
            return tuple(x[..., None].expand(*x.shape, r) for x in v)
        return v[..., None].expand(*v.shape, r)

    # each run's transfers composed in order, the runs of one length together
    inc_of = [None] * len(runs)
    for length, rs in groups.items():
        acc = expand(identity, len(rs))
        for k in range(length):
            acc = compose(acc, pick(transfers, pos[length][:, k]))
        for j, r in enumerate(rs):
            inc_of[r] = pick(acc, j)
    inc = stack(inc_of)
    d = 1
    while d < len(runs):
        shifted = compose(pick(inc, slice(0, len(runs) - d)), pick(inc, slice(d, None)))
        head = pick(inc, slice(0, d))
        inc = (tuple(torch.cat([h, t], -1) for h, t in zip(head, shifted))
               if isinstance(inc, tuple) else torch.cat([head, shifted], -1))
        d *= 2
    carries = [init] + [apply(pick(inc, r - 1), init) for r in range(1, len(runs))]
    out = None
    for length, rs in groups.items():
        c = stack([carries[r] for r in rs])
        walked = []
        for k in range(length):
            c = apply(pick(transfers, pos[length][:, k]), c)
            walked.append(c)
        vals = stack(walked)  # (..., R, L)
        flat = pos[length].reshape(-1)
        if out is None:
            out = (tuple(torch.empty(v.shape[:-2] + (n,), dtype=v.dtype, device=dev) for v in vals)
                   if isinstance(vals, tuple)
                   else torch.empty(vals.shape[:-2] + (n,), dtype=vals.dtype, device=dev))
        if isinstance(vals, tuple):
            for o, v in zip(out, vals):
                o[..., flat] = v.reshape(v.shape[:-2] + (-1,))
        else:
            out[..., flat] = vals.reshape(vals.shape[:-2] + (-1,))
    return out
