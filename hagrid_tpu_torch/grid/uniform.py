"""Single-level uniform grid (port of hagrid_tpu/grid/uniform.py), and
the binning helpers the packet and irregular builds share.

The build never scatters with atomics: per-triangle voxel-range counts
are expanded into one row per (triangle, cell) pair, one stable sort by
cell id makes every cell's refs contiguous, and a histogram plus prefix
sum gives the segment starts. `dims` and the ref capacity are host
values. The device work between the host reads is one span, the
reference's jitted `_build` (`_span`): `build_uniform` runs it op by op,
a warm `RenderSession` rebuild replays it as a captured graph. The build
reads the device once for the ref total (retrying with a larger
capacity on overflow), and once more for the scene bounds when it must
derive `dims`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.types import Triangles, cross
from ..device import const
from ..ops.segment import (expand_by_counts, segment_starts, sort_pairs,
                           trunc_i32)
from ..utils.config import density_dims
from ..utils.graphs import eager


@dataclasses.dataclass
class UniformGrid:
    """SoA uniform grid. ref_ids rows >= total_refs are -1 and sorted to
    the back."""

    dims: tuple
    bbox_lo: torch.Tensor      # f32[3]
    bbox_hi: torch.Tensor      # f32[3]
    cell_starts: torch.Tensor  # i32[C+1], C = prod(dims)
    ref_ids: torch.Tensor      # i32[R_cap]
    total_refs: torch.Tensor   # i32[]: live refs; > R_cap means overflow
    tris: Triangles

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.dims))

    @property
    def fine_dims(self) -> tuple:
        return self.dims

    @property
    def cell_size(self) -> torch.Tensor:
        return (self.bbox_hi - self.bbox_lo) / const(
            self.dims, torch.float32, self.bbox_lo.device)

    def overflowed(self) -> bool:
        return int(self.total_refs) > self.ref_ids.shape[0]


def tri_voxel_ranges(tris: Triangles, bbox_lo, bbox_hi, dims):
    """Conservative AABB binning: per-tri inclusive voxel range [lo, hi],
    each i32[T, 3] clipped to the grid."""
    dev = tris.device
    dims = tuple(int(x) for x in dims)
    inv_cs = const(dims, torch.float32, dev) / (bbox_hi - bbox_lo)
    tlo, thi = tris.bounds()
    lo = trunc_i32(torch.floor((tlo - bbox_lo) * inv_cs))
    hi = trunc_i32(torch.floor((thi - bbox_lo) * inv_cs))
    dmax = const(dims, torch.int32, dev) - 1
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


def linear_cell(ix, iy, iz, dims):
    """x-fastest linearization, matching voxel -> entry indexing everywhere."""
    return (iz * dims[1] + iy) * dims[0] + ix


def bin_refs(lo, hi, dims, capacity: int):
    """One row per (triangle, voxel) pair of the inclusive voxel ranges
    lo/hi i32[T, 3], sorted by cell: (sorted cell keys, tri ids, starts
    i32[C+1], total). Rows past the total have key C and id -1."""
    span = hi - lo + 1
    counts = span[:, 0] * span[:, 1] * span[:, 2]
    tri_idx, rank, valid, total = expand_by_counts(counts, capacity)
    s = span[tri_idx.long()]
    lo_t = lo[tri_idx.long()]
    # rank -> (dx, dy, dz) within the tri's voxel box, x fastest.
    dx = rank % s[:, 0]
    rem = rank // s[:, 0]
    dy = rem % s[:, 1]
    dz = rem // s[:, 1]
    cell = linear_cell(lo_t[:, 0] + dx, lo_t[:, 1] + dy, lo_t[:, 2] + dz,
                       dims)
    num_cells = int(np.prod(dims))
    key = torch.where(valid, cell, num_cells)
    skeys, srefs = sort_pairs(key, torch.where(valid, tri_idx, -1))
    return skeys, srefs, segment_starts(skeys, num_cells), total


def scene_bounds(tris: Triangles):
    """(lo, hi) f32[3] of the scene on its device, padded as the
    reference pads them on the host, in the same f32 operations."""
    tlo, thi = tris.bounds()
    lo, hi = tlo.min(0).values, thi.max(0).values
    pad = (hi - lo) * 1e-4 + 1e-4
    return lo - pad, hi + pad


def scene_box(tris: Triangles):
    """Host (lo, hi) f32[3] of scene_bounds; one device read."""
    lo, hi = torch.stack(scene_bounds(tris)).cpu().numpy()
    return lo, hi


def _span(v0, e1, e2, n, dims, capacity):
    """The reference's `_build`: the scene bounds, the voxel ranges and
    the binned refs of the triangles (v0, e1, e2, n); returns (bbox_lo,
    bbox_hi, cell_starts, ref_ids, total)."""
    tris = Triangles(v0, e1, e2, n)
    lo, hi = scene_bounds(tris)
    vlo, vhi = tri_voxel_ranges(tris, lo, hi, dims)
    _, refs, starts, total = bin_refs(vlo, vhi, dims, capacity)
    return lo, hi, starts, refs, total


def build_spans(tris: Triangles, density: float, ref_capacity=None,
                dims=None, run=eager) -> UniformGrid:
    """The build's host side for a non-empty scene: dims (from the
    bounds, one read, when not given) and the ref capacity, then the span
    through `run` (utils/graphs.py's `Graphs.call` signature) until the
    ref total fits."""
    n = tris.count
    if dims is None:
        lo, hi = scene_box(tris)
        dims = density_dims(hi - lo, n, density)
    dims = tuple(int(d) for d in dims)
    if ref_capacity is None:
        ref_capacity = max(1024, int(n * 4))
    while True:
        lo, hi, starts, refs, total = run(
            "uniform", (n, dims, ref_capacity),
            functools.partial(_span, dims=dims, capacity=ref_capacity),
            (tris.v0, tris.e1, tris.e2, tris.n), fresh=False)
        t = int(total)
        if t <= ref_capacity:
            break
        ref_capacity = int(t * 1.25)
    return UniformGrid(dims=dims, bbox_lo=lo, bbox_hi=hi, cell_starts=starts,
                       ref_ids=refs, total_refs=total, tris=tris)


def build_uniform(tris: Triangles, density: float = 2.4,
                  ref_capacity: int | None = None,
                  dims: tuple | None = None) -> UniformGrid:
    """Derives dims and the ref capacity on the host, builds on the
    triangles' device op by op, and retries with room to spare on
    overflow."""
    dev = tris.device
    if tris.count == 0:
        # Degenerate but legal: one empty unit-box cell, every ray misses.
        return UniformGrid(
            dims=(1, 1, 1),
            bbox_lo=torch.zeros(3, dtype=torch.float32, device=dev),
            bbox_hi=torch.ones(3, dtype=torch.float32, device=dev),
            cell_starts=torch.zeros(2, dtype=torch.int32, device=dev),
            ref_ids=torch.full((1,), -1, dtype=torch.int32, device=dev),
            total_refs=torch.zeros((), dtype=torch.int32, device=dev),
            tris=tris)
    return build_spans(tris, density, ref_capacity, dims)


def uniform_lookup(grid: UniformGrid, voxel):
    """The wavefront's lookup protocol: fine voxel i32[N, 3] -> (cell,
    cmin, cmax); a uniform cell is its own voxel."""
    cell = linear_cell(voxel[:, 0], voxel[:, 1], voxel[:, 2], grid.dims)
    return cell, voxel, voxel


def trace_uniform_fast(grid: UniformGrid, rays, any_hit: bool = False,
                       coherent: bool = False):
    """Wavefront trace (ops/wavefront.trace): one launch of the march
    kernel on the card, the compacted rounds of the plain version
    (host-orchestrated) on the CPU. coherent: camera-ordered rays (picks
    the kernel's refill threshold; no result changes)."""
    from ..ops import wavefront

    return wavefront.trace(grid, uniform_lookup, rays, any_hit=any_hit,
                           coherent=coherent)


def trace_uniform(grid: UniformGrid, rays, refs_per_iter: int = 8,
                  any_hit: bool = False):
    """Wavefront traversal to completion. CUDA tensors: one launch of the
    march kernel (ops/wavefront.trace). CPU tensors: the plain version,
    trace_wavefront's lockstep march, no compaction. Any other device
    raises."""
    from ..ops import wavefront

    if rays.org.device.type != "cpu":
        return wavefront.trace(grid, uniform_lookup, rays,
                               refs_per_iter=refs_per_iter, any_hit=any_hit)

    def lookup(voxel):
        return uniform_lookup(grid, voxel)

    return wavefront.trace_wavefront(
        rays, grid.tris, lookup, grid.cell_starts, grid.ref_ids,
        grid.bbox_lo, grid.bbox_hi, grid.dims, refs_per_iter=refs_per_iter,
        any_hit=any_hit)
