"""DDA traversal of the uniform grid: the test oracle of the wavefront
tracers (port of hagrid_tpu/grid/traverse_ref.py).

The reference runs one Amanatides-Woo DDA per ray in a while loop under
vmap: slab test, entry voxel, every ref of the cell (Moller-Trumbore),
then a step past the cell on the axis of the nearest exit. Here all rays
step in lockstep on masked tensors; a ray that is done changes no more.
The host reads the live count once per cell step and the longest ref
list once per cell step, which is fine for an oracle and keeps it off
every timed path.
"""

from __future__ import annotations

import torch

from ..core.intersect import moller_trumbore, safe_inv_dir, slab_test
from ..core.types import Hits, Rays
from ..ops.segment import take, trunc_i32
from .uniform import UniformGrid, linear_cell


def _trace(grid: UniformGrid, rays: Rays, any_hit: bool) -> Hits:
    dev = rays.org.device
    n = rays.count
    org, dirs, tmin, tmax = rays.org, rays.dir, rays.tmin, rays.tmax
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=dev)
    cs = grid.cell_size
    inv_dir = safe_inv_dir(dirs)
    enter, _, ok = slab_test(org, inv_dir, grid.bbox_lo, grid.bbox_hi,
                             tmin, tmax)
    p = org + enter[:, None] * dirs
    v = trunc_i32(torch.floor((p - grid.bbox_lo) / cs))
    v = torch.minimum(v.clamp(min=0), dims - 1)
    step = torch.where(dirs >= 0, 1, -1).to(torch.int32)
    next_bound = grid.bbox_lo + (v + (dirs >= 0)).to(torch.float32) * cs
    inf = float("inf")
    t_next = torch.where(dirs != 0.0, (next_bound - org) * inv_dir, inf)
    t_delta = torch.where(dirs != 0.0, cs * inv_dir.abs(), inf)

    tris = grid.tris
    bt = torch.full((n,), inf, device=dev)
    bid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros((n,), device=dev)
    bv = torch.zeros((n,), device=dev)
    active = ok.clone()
    if any_hit:
        active &= bid < 0
    rows = torch.arange(n, device=dev)
    while bool(active.any()):
        cell = linear_cell(v[:, 0], v[:, 1], v[:, 2], grid.dims)
        s0 = torch.where(active, take(grid.cell_starts, cell), 0)
        s1 = torch.where(active, take(grid.cell_starts, cell + 1), 0)
        for k in range(int((s1 - s0).max())):
            r = s0 + k
            m = r < s1
            if any_hit:
                m &= bid < 0
            tid = torch.where(m, take(grid.ref_ids, torch.where(m, r, 0)), 0)
            h, t, u, vv = moller_trumbore(org, dirs, take(tris.v0, tid),
                                          take(tris.e1, tid),
                                          take(tris.e2, tid), tmin, tmax)
            better = m & h & ((t < bt) | ((t == bt) & (tid < bid)))
            bt = torch.where(better, t, bt)
            bid = torch.where(better, tid, bid)
            bu = torch.where(better, u, bu)
            bv = torch.where(better, vv, bv)
        t_exit, axis = torch.min(t_next, dim=-1)
        v_new = v.clone()
        v_new[rows, axis] += step[rows, axis]
        va = v_new[rows, axis]
        out = (va < 0) | (va >= dims[axis])
        t_new = t_next.clone()
        t_new[rows, axis] += t_delta[rows, axis]
        v = torch.where(active[:, None], v_new, v)
        t_next = torch.where(active[:, None], t_new, t_next)
        done = (bt <= t_exit) | out | (t_exit >= tmax)
        active &= ~done
        if any_hit:
            active &= bid < 0
    found = bid >= 0
    return Hits(tri_id=bid, t=torch.where(found, bt, inf), u=bu, v=bv)


def closest_hit(grid: UniformGrid, rays: Rays) -> Hits:
    return _trace(grid, rays, False)


def any_hit(grid: UniformGrid, rays: Rays) -> torch.Tensor:
    """bool[N]: True where the ray hits anything within (tmin, tmax)."""
    return _trace(grid, rays, True).tri_id >= 0
