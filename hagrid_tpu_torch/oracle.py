"""Brute-force closest-hit oracle (port of hagrid_tpu/oracle.py).

Every ray against every triangle with classic Moller-Trumbore (the
reference's core/intersect.py), chunked over rays. Ties go to the smaller
t, then the smaller tri id, as in the tracers. O(N*T): ground truth for
tests and for the on-card check, not a renderer.
"""

from __future__ import annotations

import torch

from .core.types import Hits, Rays, Triangles

MT_EPS = 1e-9


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def moller_trumbore(org, dir, v0, e1, e2, tmin, tmax):
    """Batched Moller-Trumbore over broadcastable (..., 3) inputs;
    returns (hit, t, u, v)."""
    ox, oy, oz = org.unbind(-1)
    dx, dy, dz = dir.unbind(-1)
    px, py, pz = _cross(dx, dy, dz, *e2.unbind(-1))
    ax, ay, az = e1.unbind(-1)
    det = ax * px + ay * py + az * pz
    ok_det = det.abs() > MT_EPS
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    vx, vy, vz = v0.unbind(-1)
    tx, ty, tz = ox - vx, oy - vy, oz - vz
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx, qy, qz = _cross(tx, ty, tz, ax, ay, az)
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    bx, by, bz = e2.unbind(-1)
    t = (bx * qx + by * qy + bz * qz) * inv_det
    hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin) & (t < tmax))
    return hit, t, u, v


def closest_hit(rays: Rays, tris: Triangles, chunk: int | None = None) -> Hits:
    """Closest hit of every ray, on the rays' device. `chunk` rays are
    tested at a time (default: about 2^24 ray-tri pairs per chunk)."""
    n, nt = rays.count, tris.count
    if nt == 0:
        return Hits.none(n, rays.device)
    chunk = chunk or max(1, (1 << 24) // nt)
    outs = []
    for s in range(0, n, chunk):
        sl = slice(s, min(s + chunk, n))
        hit, t, u, v = moller_trumbore(
            rays.org[sl, None, :], rays.dir[sl, None, :], tris.v0[None],
            tris.e1[None], tris.e2[None], rays.tmin[sl, None],
            rays.tmax[sl, None])
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
