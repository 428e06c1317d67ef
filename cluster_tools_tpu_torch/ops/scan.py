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
    outgoing carry (its new value), stacked along the last axis."""
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
