"""Uniform-grid binning helpers used by the packet build (port of
hagrid_tpu/grid/uniform.py::tri_voxel_ranges and ::tri_box_overlap)."""

from __future__ import annotations

import torch

from ..core.types import Triangles, cross
from ..ops.segment import trunc_i32


def tri_voxel_ranges(tris: Triangles, bbox_lo, bbox_hi, dims):
    """Conservative AABB binning: per-tri inclusive voxel range [lo, hi],
    each i32[T, 3] clipped to the grid."""
    dev = tris.device
    d = torch.tensor(dims, dtype=torch.float32, device=dev)
    inv_cs = d / (bbox_hi - bbox_lo)
    tlo, thi = tris.bounds()
    lo = trunc_i32(torch.floor((tlo - bbox_lo) * inv_cs))
    hi = trunc_i32(torch.floor((thi - bbox_lo) * inv_cs))
    dmax = torch.tensor(dims, dtype=torch.int32, device=dev) - 1
    zero = torch.zeros_like(dmax)
    return (torch.minimum(torch.maximum(lo, zero), dmax),
            torch.minimum(torch.maximum(hi, zero), dmax))


def tri_box_overlap(v0, v1, v2, box_lo, box_hi):
    """Exact separating-axis triangle/AABB test over pairs (N, 3) ->
    bool (N,). The box face axes are assumed satisfied (callers test only
    cells inside the tri's AABB voxel range); this tests the tri plane
    and the 9 edge cross axes."""
    c = 0.5 * (box_lo + box_hi)
    # Relative pad: f32 cancellation must err toward keeping a pair.
    h = 0.5 * (box_hi - box_lo) * 1.0001 + 1e-6
    p0 = v0 - c
    p1 = v1 - c
    p2 = v2 - c
    f0 = p1 - p0
    f1 = p2 - p1
    f2 = p0 - p2

    def sep(ax, ay, az):
        r = (h[:, 0] * ax.abs() + h[:, 1] * ay.abs()
             + h[:, 2] * az.abs())
        q0 = ax * p0[:, 0] + ay * p0[:, 1] + az * p0[:, 2]
        q1 = ax * p1[:, 0] + ay * p1[:, 1] + az * p1[:, 2]
        q2 = ax * p2[:, 0] + ay * p2[:, 1] + az * p2[:, 2]
        qmin = torch.minimum(torch.minimum(q0, q1), q2)
        qmax = torch.maximum(torch.maximum(q0, q1), q2)
        return (qmin > r) | (qmax < -r)

    z = torch.zeros_like(f0[:, 0])
    separated = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for f in (f0, f1, f2):
        separated |= sep(z, -f[:, 2], f[:, 1])
        separated |= sep(f[:, 2], z, -f[:, 0])
        separated |= sep(-f[:, 1], f[:, 0], z)
    n = cross(f0, f1)
    separated |= sep(n[:, 0], n[:, 1], n[:, 2])
    return ~separated
