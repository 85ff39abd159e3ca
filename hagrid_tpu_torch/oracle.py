"""Brute-force closest-hit and any-hit oracle (port of hagrid_tpu/oracle.py).

Every ray against every triangle with classic Moller-Trumbore
(core/intersect.py), chunked over rays. Ties go to the smaller
t, then the smaller tri id, as in the tracers. O(N*T): ground truth for
tests and for the on-card check, not a renderer.
"""

from __future__ import annotations

import torch

from .core.intersect import moller_trumbore
from .core.types import Hits, Rays, Triangles


def _chunks(rays: Rays, tris: Triangles, chunk: int | None):
    """(hit, t, u, v) of every ray against every triangle, `chunk` rays at
    a time (default: about 2^24 ray-tri pairs per chunk)."""
    n = rays.count
    chunk = chunk or max(1, (1 << 24) // tris.count)
    for s in range(0, n, chunk):
        sl = slice(s, min(s + chunk, n))
        yield moller_trumbore(
            rays.org[sl, None, :], rays.dir[sl, None, :], tris.v0[None],
            tris.e1[None], tris.e2[None], rays.tmin[sl, None],
            rays.tmax[sl, None])


def closest_hit(rays: Rays, tris: Triangles, chunk: int | None = None) -> Hits:
    """Closest hit of every ray, on the rays' device."""
    n, nt = rays.count, tris.count
    if nt == 0:
        return Hits.none(n, rays.device)
    outs = []
    for hit, t, u, v in _chunks(rays, tris, chunk):
        t = torch.where(hit, t, float("inf"))
        # argmin returns the first minimum: the smaller tri id on ties.
        best = torch.argmin(t, dim=1, keepdim=True)
        bt = torch.gather(t, 1, best)[:, 0]
        found = bt < float("inf")
        outs.append((torch.where(found, best[:, 0].to(torch.int32), -1),
                     bt,
                     torch.where(found, torch.gather(u, 1, best)[:, 0], 0.0),
                     torch.where(found, torch.gather(v, 1, best)[:, 0], 0.0)))
    return Hits(*(torch.cat(x) for x in zip(*outs)))


def any_hit(rays: Rays, tris: Triangles,
            chunk: int | None = None) -> torch.Tensor:
    """bool[N]: True where any triangle blocks the ray within (tmin, tmax)."""
    if tris.count == 0:
        return torch.zeros((rays.count,), dtype=torch.bool,
                           device=rays.device)
    return torch.cat([hit.any(dim=1)
                      for hit, _, _, _ in _chunks(rays, tris, chunk)])
