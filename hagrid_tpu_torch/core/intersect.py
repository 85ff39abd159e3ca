"""Vectorized ray/primitive intersection tests (port of
hagrid_tpu/core/intersect.py): classic Moller-Trumbore and the ray-AABB
slab test, batched over leading axes.
"""

from __future__ import annotations

import torch

# Rays parallel to the triangle plane (|det| <= MT_EPS) are misses.
MT_EPS = 1e-9


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def moller_trumbore(org, dir, v0, e1, e2, tmin, tmax):
    """Batched Moller-Trumbore, no backface culling.

    org/dir/v0/e1/e2 are f32[..., 3] broadcastable against each other;
    tmin/tmax f32[...]. Returns (hit bool[...], t, u, v). Written by
    component, so nothing of shape [..., 3] is materialised at the
    broadcast size."""
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


def slab_test(org, inv_dir, lo, hi, tmin, tmax):
    """Batched ray-AABB slab test.

    org/inv_dir f32[...,3]; lo/hi f32[...,3] broadcastable; returns
    (enter f32[...], exit f32[...], hit bool[...]). inv_dir is 1/dir with
    +-inf for zero components."""
    t0 = (lo - org) * inv_dir
    t1 = (hi - org) * inv_dir
    # 0 * inf = NaN when an origin component sits exactly on a slab plane
    # with a zero direction component: the ray lies on the plane, so that
    # axis always overlaps (-inf, +inf) instead of poisoning min/max.
    on_plane = torch.isnan(t0 * t1)
    inf = float("inf")
    tnear = torch.where(on_plane, -inf, torch.minimum(t0, t1))
    tfar = torch.where(on_plane, inf, torch.maximum(t0, t1))
    enter = torch.maximum(tnear.max(dim=-1).values, tmin)
    exit_ = torch.minimum(tfar.min(dim=-1).values, tmax)
    return enter, exit_, enter <= exit_


def safe_inv_dir(dir):
    """1/dir with exact zeros mapped to +-inf (the sign of the zero)."""
    nz = dir != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, dir, 1.0),
                       torch.copysign(torch.full_like(dir, float("inf")),
                                      dir))
