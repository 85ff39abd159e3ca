"""Packet grid: slice-major acceleration structure for the sweep tracer
(port of hagrid_tpu/grid/packet.py, with its two options: adaptive slice
planes and per-row column refinement).

Per major axis a, with (b, c) = ((a+1)%3, (a+2)%3), cells are laid out
slice-major, (va * Db + vb) * Dc + vc with c fastest, so a rect row of
cells and therefore its refs is one contiguous run. The tables, kept
bit-for-bit in the reference's layout so both tracers can read one grid:

- `rs` i32: per (row, c) the absolute index (into the flat ref order) of
  the row's first ref at column >= c; a frustum rect's refs in a row are
  [rs[off + c0], rs[off + c1 + 1]) with `off` from `rowinfo`.
- `rowinfo` i32[sum_a Da*Db]: per row (rs offset | log2(m) << 28). The
  default build has m = 1 and dc + 1 entries a row; refine=True splits a
  dense row's columns by m in {2, 4} (ragged rows of m * dc + 1 entries;
  refs straddling a fine column boundary duplicate).
- `cols` f32[3*R_cap/6 + 8, 128]: group rows of 6 per-ref precomputed
  rows of 20 floats (120 lanes + 8 zero pad lanes):
  [n(3) -e2(3) -(v0 x e2)(3) e1(3) (v0 x e1)(3) v0.n tri_id 0 0 0].
  With x = (o, d, m = o x d) these make det, t*det, u*det, v*det linear
  in x:  det' = d.n,  t = (v0.n - o.n)/det',
  u = (m.(-e2) + d.(-(v0 x e2)))/det',  v = (m.e1 + d.(v0 x e1))/det'.
  The tri id in column 16 is a float VALUE (exact below 2^24), never a
  bit pattern. The trailing 8 zero rows are the dead gather target.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import Triangles, cross
from ..device import const
from ..ops.segment import (add_at_drop, cumsum_i32, expand_by_counts,
                           segment_starts, sort_pairs, trunc_i32)
from ..utils.config import density_dims
from .uniform import tri_box_overlap, tri_voxel_ranges

MT_COLS = 20       # per-ref precomputed row width
REF_GROUP = 6      # per-ref rows per 128-lane group row
GROUP_LANES = 128  # 6*20 = 120 real lanes + 8 zero pad
DEAD_ROWS = 8      # trailing zero group rows (48 refs), the dead gather target
BIG = 3e38         # finite stand-in for +inf throughout the pipeline
MAX_TRIS = 1 << 24  # ids ride in f32 rows as exact float values
_PLANE_BINS = 256  # centroid histogram of the adaptive slice planes


@dataclasses.dataclass
class PacketGrid:
    # Per-layout dims in (slice, row, col) order: dims3[a] = (Da, Db, Dc).
    dims3: tuple
    bbox_lo: torch.Tensor      # f32[3]
    bbox_hi: torch.Tensor      # f32[3]
    rs: torch.Tensor           # i32
    cols: torch.Tensor         # f32[3*R_cap/6 + 8, 128]
    total_refs: torch.Tensor   # i32[]: max SAT-surviving refs per layout
    total_pairs: torch.Tensor  # i32[]: max pre-SAT pairs (capacity-bound)
    tris: Triangles
    rowinfo: torch.Tensor      # i32[sum_a Da*Db]
    planes: torch.Tensor       # f32[3, max(Da) + 1] slice boundaries

    @property
    def ref_capacity(self) -> int:
        return (self.cols.shape[0] - DEAD_ROWS) // 3 * REF_GROUP

    @property
    def overflowed(self) -> torch.Tensor:
        """Device bool: pairs exceeded capacity (only possible when built
        with check=False); hits may then be missed."""
        return self.total_pairs > self.ref_capacity

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.dims3[0]))


def rays_to_x(org, dir, tmin, tmax) -> torch.Tensor:
    """Pack rays into the tracer's X matrix, f32[N, 16]: [0]=1,
    [1:4]=org, [4:7]=dir, [7:10]=org x dir, [10:12]=0, [12]=tmin,
    [13]=min(tmax, BIG), [14]=seed best t (0 here), [15]=0."""
    n = org.shape[0]
    f32 = dict(dtype=torch.float32, device=org.device)
    z2 = torch.zeros((n, 2), **f32)
    return torch.cat([torch.ones((n, 1), **f32), org, dir, cross(org, dir),
                      z2, tmin[:, None],
                      torch.clamp(tmax, max=BIG)[:, None], z2], dim=1)


def _axis_order(axis: int):
    return axis, (axis + 1) % 3, (axis + 2) % 3


def _slice_planes(tlo3, thi3, bbox_lo, bbox_hi, dims3, adaptive=False):
    """Per-layout slice boundaries f32[3, max(Da)+1], each row padded by
    repeating its last boundary.

    Uniform planes: lo + ((hi - lo) * k) * f32(1/da), rounded once: this
    is how the compiled reference evaluates `lo + (hi - lo) * k / da`
    (XLA turns the division by a constant into a reciprocal multiply and
    fuses the add into an FMA). Tris whose vertices sit exactly on a
    plane bin by it, so a one-ulp plane difference would move them to
    another slice.

    adaptive=True (layouts with da > 1): a 256-bin histogram of the tri
    bbox centroids along the axis, its CDF, equal-mass quantiles blended
    3:1 with the uniform planes (which keeps them strictly increasing
    when all mass lands in one bin), endpoints pinned to the bbox. The
    steps the compiled reference fuses are replayed the same way (f64,
    one rounding): the targets' division by da as a reciprocal multiply,
    `targets - c_lo` and the quantile's `lo + q * ext` as FMAs; the 3:1
    blend is not fused (0.25 * uni is exact, so either order rounds
    alike)."""
    pmax = max(d[0] for d in dims3) + 1
    dev = bbox_lo.device
    nb = _PLANE_BINS
    rows = []
    for axis in range(3):
        da = dims3[axis][0]
        lo_w, hi_w = bbox_lo[axis], bbox_hi[axis]
        ext = hi_w - lo_w
        rcp = float(np.float32(1.0 / da))
        k = torch.arange(da + 1, dtype=torch.float32, device=dev)
        uni = (lo_w.double() + (ext * k).double() * rcp).float()
        if adaptive and da > 1:
            centroid = 0.5 * (tlo3[:, axis] + thi3[:, axis])
            cb = trunc_i32((centroid - lo_w) / ext * nb).clamp(0, nb - 1)
            hist = torch.zeros((nb,), dtype=torch.float32, device=dev)
            hist.index_add_(0, cb.long(), torch.ones_like(centroid))
            cdf = torch.cumsum(hist, 0)  # integer-valued: exact
            ks = torch.arange(1, da, dtype=torch.float32, device=dev)
            nk = cdf[-1] * ks
            targets = nk * rcp
            idx = (cdf[None, :] < targets[:, None]).sum(1)
            c_lo = torch.where(idx > 0, cdf[(idx - 1).clamp(min=0)], 0.0)
            c_hi = cdf[idx.clamp(max=nb - 1)]
            # targets - c_lo contracts into one FMA in the reference.
            num = (nk.double() * rcp - c_lo.double()).float()
            frac = torch.where(c_hi > c_lo,
                               num / (c_hi - c_lo).clamp(min=1e-20), 0.5)
            q = idx.to(torch.float32) + frac
            # lo + q / nb * ext: XLA folds 1/nb into ext (exact), LLVM
            # fuses the add.
            pos = (lo_w.double()
                   + q.double() * (ext * (1.0 / nb)).double()).float()
            blend = 0.75 * pos + 0.25 * uni[1:-1]
            row = torch.cat([lo_w[None], blend, hi_w[None]])
        else:
            row = uni
        rows.append(torch.cat([row, row[-1:].expand(pmax - da - 1)]))
    return torch.stack(rows)


def _build(tris: Triangles, bbox_lo, bbox_hi, dims3, ref_capacity,
           adaptive=False, refine=False):
    """Bin tris into each layout's grid and emit (rs, rowinfo, cols,
    total_pairs, total_refs, planes)."""
    dev = tris.device
    cap = ref_capacity
    n1 = max(tris.count, 1)
    i32 = dict(dtype=torch.int32, device=dev)
    tlo3, thi3 = tris.bounds()
    planes = _slice_planes(tlo3, thi3, bbox_lo, bbox_hi, dims3, adaptive)
    # One fused per-tri row [v0 e1 e2 id 0*6]: the per-layout ref tables
    # need one row gather each. Column 9 is the tri id as a float value.
    tri_t = torch.cat(
        [tris.v0, tris.e1, tris.e2,
         torch.arange(n1, **i32).to(torch.float32)[:, None],
         torch.zeros((n1, 6), dtype=torch.float32, device=dev)], dim=1)
    j = torch.arange(cap, **i32)

    rs_parts, rowinfo_parts, cols_parts, totals, reals = [], [], [], [], []
    rs_base = 0
    for axis in range(3):
        a, b, c = _axis_order(axis)
        da, db, dc = dims3[axis]
        dims_xyz = [0, 0, 0]
        dims_xyz[a], dims_xyz[b], dims_xyz[c] = da, db, dc
        lo, hi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, tuple(dims_xyz))
        P = planes[axis]
        if da > 1:
            # Slice-axis bin = count of interior planes <= coordinate.
            lo[:, a] = (tlo3[:, a:a + 1] >= P[None, 1:da]).sum(1).to(
                torch.int32)
            hi[:, a] = (thi3[:, a:a + 1] >= P[None, 1:da]).sum(1).to(
                torch.int32)
        span = hi - lo + 1
        counts = span[:, 0] * span[:, 1] * span[:, 2]
        offsets = cumsum_i32(counts) - counts
        total = offsets[-1] + counts[-1]
        # Voxel fields ride packed, 10 bits each (dims cap at 1023):
        # the packed forward fill equals the field-wise one.
        p_lo = lo[:, 0] + (lo[:, 1] << 10) + (lo[:, 2] << 20)
        p_sp = span[:, 0] + (span[:, 1] << 10) + (span[:, 2] << 20)

        # Run owner per output slot: +1 marker at every run start,
        # prefix sum (empty runs stack markers and telescope past).
        markers = add_at_drop(cap, offsets, 1)
        tri_idx = (cumsum_i32(markers) - 1).clamp(0, n1 - 1)
        valid = j < total

        def ff1(p, offsets=offsets):
            # Forward fill of a per-tri int over its expansion run:
            # delta scatter at run starts + prefix sum.
            d = torch.diff(p, prepend=torch.zeros((1,), **i32))
            return cumsum_i32(add_at_drop(cap, offsets, d))

        # offsets never decrease, so the owner's offset is the last run
        # start at or before j: the reference's running max of the markers.
        run_start = offsets[tri_idx.long()]
        rank = j - run_start
        lo_ff = ff1(p_lo)
        sp_ff = ff1(p_sp)
        s0 = sp_ff & 1023
        s1 = (sp_ff >> 10) & 1023
        dx = rank % s0
        rem = rank // s0
        dy = rem % s1
        dz = rem // s1
        v = torch.stack([(lo_ff & 1023) + dx,
                         ((lo_ff >> 10) & 1023) + dy,
                         (lo_ff >> 20) + dz], dim=1)
        tvk = tri_t[tri_idx.long()]

        # Exact SAT pruning of (tri, cell) pairs.
        csx = (bbox_hi - bbox_lo) / const(tuple(dims_xyz), torch.float32,
                                          dev)
        cell_lo = bbox_lo[None, :] + v.to(torch.float32) * csx[None, :]
        cell_hi = cell_lo + csx[None, :]
        cell_lo[:, a] = P[v[:, a].clamp(0, da).long()]
        cell_hi[:, a] = P[(v[:, a] + 1).clamp(0, da).long()]
        tv0 = tvk[:, 0:3]
        sat = tri_box_overlap(tv0, tv0 + tvk[:, 3:6], tv0 + tvk[:, 6:9],
                              cell_lo, cell_hi)
        keep = valid & sat
        nrows = da * db
        if refine:
            starts, srefs, rs_ax, ri_ax, n_ent, n_live, ftotal = _refine(
                v, tvk, keep, tri_idx, csx, bbox_lo, a, b, c, da, db, dc,
                cap)
            rs_parts.append(rs_ax + axis * cap)
            rowinfo_parts.append(ri_ax + rs_base)
            rs_base += n_ent
            total = torch.maximum(total, ftotal)
        else:
            # One sort over cell keys; the rs table is a reshape of the
            # segment starts, rowinfo describes m=1 rows of (dc+1)
            # entries.
            num_cells = nrows * dc
            key = (v[:, a] * db + v[:, b]) * dc + v[:, c]
            key = torch.where(keep, key, num_cells)
            skeys, srefs = sort_pairs(key, torch.where(keep, tri_idx, 0))
            starts = segment_starts(skeys, num_cells)       # i32[C+1]
            n_live = starts[num_cells]
            row_start = starts[::dc]                         # i32[nrows+1]
            s_log = torch.cat([starts[:num_cells].reshape(nrows, dc),
                               row_start[1:, None]], dim=1)
            rs_parts.append((s_log + axis * cap).reshape(-1))
            rowinfo_parts.append(torch.arange(nrows, **i32) * (dc + 1)
                                 + rs_base)
            rs_base += nrows * (dc + 1)
        live = j < n_live

        # Per-ref rows: one row gather, then the linear-form coefficients.
        tk = tri_t[srefs.long()]
        v0, e1, e2 = tk[:, 0:3], tk[:, 3:6], tk[:, 6:9]
        nrm = cross(e1, e2)
        row20 = torch.cat(
            [nrm, -e2, -cross(v0, e2), e1, cross(v0, e1),
             (v0 * nrm).sum(1, keepdim=True), tk[:, 9:10],
             torch.zeros((cap, 3), dtype=torch.float32, device=dev)], dim=1)
        grp = torch.where(live[:, None], row20, 0.0).reshape(
            cap // REF_GROUP, MT_COLS * REF_GROUP)
        cols_parts.append(torch.nn.functional.pad(
            grp, (0, GROUP_LANES - MT_COLS * REF_GROUP)))
        totals.append(total)
        reals.append(n_live)
    cols_parts.append(torch.zeros((DEAD_ROWS, GROUP_LANES),
                                  dtype=torch.float32, device=dev))
    return (torch.cat(rs_parts), torch.cat(rowinfo_parts),
            torch.cat(cols_parts), torch.stack(totals).max(),
            torch.stack(reals).max(), planes)


def _refine(v, tvk, keep, tri_idx, csx, bbox_lo, a, b, c, da, db, dc, cap):
    """Per-row column refinement of one layout (build_packet(refine=True)).

    Each (slice, row) row splits its dc base columns by m in {1, 2, 4},
    chosen by the row's post-SAT ref count: the densest nrows // 8 rows
    by rank get m = 4, the next nrows // 4 m = 2 (a stable sort on the
    count, ties to the lower row), gated on an absolute need (>= 2 dc
    refs for m = 2, >= 6 dc for m = 4). A pair's fine columns are those
    its tri's c-extent covers within its base cell (bbox-conservative;
    the SAT prune stays at base resolution), so refs that straddle a fine
    boundary duplicate. One sort over fine keys orders the refs; the rs
    table is ragged, row r holding m_r * dc + 1 entries from row_off[r].

    v, tvk, keep, tri_idx: the layout's pair slots (voxel, tri row, kept
    after SAT, tri). Returns (starts, srefs, rs, rowinfo without the
    layout's rs base, rs entries reserved, live refs, fine pair total)."""
    dev = v.device
    i32 = dict(dtype=torch.int32, device=dev)
    nrows = da * db
    rowk = torch.where(keep, v[:, a] * db + v[:, b], 0)
    n4, n2 = nrows // 8, nrows // 4
    rcnt = add_at_drop(nrows, rowk, keep.to(torch.int32))
    _, order = sort_pairs(-rcnt, torch.arange(nrows, **i32))
    rank_of = torch.empty((nrows,), **i32)
    rank_of[order.long()] = torch.arange(nrows, **i32)
    m_rank = torch.where(rank_of < n4, 4,
                         torch.where(rank_of < n4 + n2, 2, 1))
    m_need = torch.where(rcnt >= 6 * dc, 4, torch.where(rcnt >= 2 * dc, 2, 1))
    m = torch.minimum(m_rank, m_need).to(torch.int32)
    cells_cap = dc * (4 * n4 + 2 * n2 + (nrows - n4 - n2))
    nc_row = m * dc
    cell_off = cumsum_i32(nc_row) - nc_row

    # Fine column span of each base pair from its tri's c-extent. icsf is
    # a real division, as in the reference (not a reciprocal multiply).
    mg = m[rowk.long()]
    v0c = tvk[:, c]
    c1v = v0c + tvk[:, 3 + c]
    c2v = v0c + tvk[:, 6 + c]
    tminc = torch.minimum(v0c, torch.minimum(c1v, c2v))
    tmaxc = torch.maximum(v0c, torch.maximum(c1v, c2v))
    icsf = mg.to(torch.float32) / csx[c]
    base0 = v[:, c] * mg
    top = base0 + mg - 1
    f_lo = torch.minimum(torch.maximum(
        trunc_i32((tminc - bbox_lo[c]) * icsf), base0), top)
    f_hi = torch.minimum(torch.maximum(
        trunc_i32((tmaxc - bbox_lo[c]) * icsf), f_lo), top)
    fcnt = torch.where(keep, f_hi - f_lo + 1, 0)

    # Expand base pairs into fine pairs; per-pair ints forward-fill by a
    # delta scatter at the fine run starts and a prefix sum.
    foffsets = cumsum_i32(fcnt) - fcnt
    ftotal = foffsets[-1] + fcnt[-1]
    _, rank2, valid2, _ = expand_by_counts(fcnt, cap)

    def ff2(p):
        d = torch.diff(p, prepend=torch.zeros((1,), **i32))
        return cumsum_i32(add_at_drop(cap, foffsets, d))

    fstart = cell_off[rowk.long()] + f_lo
    fkey = torch.where(valid2, ff2(fstart) + rank2, cells_cap)
    skeys, srefs = sort_pairs(fkey, ff2(tri_idx))
    starts = segment_starts(skeys, cells_cap)          # i32[cells_cap+1]

    # Ragged rs: row r's table occupies [row_off[r], row_off[r] +
    # nc_row[r]], the closing entry equal to the next row's first start.
    n_ent = cells_cap + nrows
    row_off = cumsum_i32(nc_row + 1) - (nc_row + 1)
    _, rank_r, valid_r, _ = expand_by_counts(nc_row + 1, n_ent)
    d_co = torch.diff(cell_off, prepend=torch.zeros((1,), **i32))
    co_ff = cumsum_i32(add_at_drop(n_ent, row_off, d_co))
    cell_idx = (co_ff + rank_r).clamp(0, cells_cap)
    rs = torch.where(valid_r, starts[cell_idx.long()], starts[cells_cap])
    lg = torch.where(m == 4, 2, torch.where(m == 2, 1, 0)).to(torch.int32)
    return (starts, srefs, rs, row_off | (lg << 28), n_ent,
            starts[cells_cap], ftotal)


def _rs_entries(dims3, refine: bool) -> int:
    """Entries of the rs table: (dc + 1) a row, or with refinement the
    reserve for the densest rows at m = 4 and the next at m = 2."""
    if not refine:
        return sum(da * db * (dc + 1) for (da, db, dc) in dims3)
    total = 0
    for da, db, dc in dims3:
        nrows = da * db
        n4, n2 = nrows // 8, nrows // 4
        total += nrows + dc * (4 * n4 + 2 * n2 + nrows - n4 - n2)
    return total


def padded_bounds(lo, hi):
    """The grid's bounds from the scene's host bounds, in float32: each
    side moved out by 1e-4 of the extent plus 1e-4."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    pad = (hi - lo) * np.float32(1e-4) + np.float32(1e-4)
    return lo - pad, hi + pad


def grid_bounds(tris: Triangles, bbox=None):
    """The grid's bounds on the host, float32: the scene's host bounds
    `bbox`, or with none the tris' bounds (one device read), each side
    padded (padded_bounds)."""
    if bbox is not None:
        lo, hi = bbox
    else:
        tlo, thi = tris.bounds()
        lo = tlo.min(0).values.cpu().numpy()
        hi = thi.max(0).values.cpu().numpy()
    return padded_bounds(lo, hi)


def build_packet(tris: Triangles, cross_density: float = 0.4,
                 slice_density: float = 0.02,
                 ref_capacity: int | None = None,
                 dims: tuple | None = None,
                 dims3: tuple | None = None,
                 bbox=None, check: bool = True,
                 adaptive: bool = False,
                 refine: bool = False) -> PacketGrid:
    """Host wrapper: dims and capacity from the density heuristic, retry
    on overflow. The grid lands on the triangles' device.

    `dims` forces one isotropic grid for all layouts (tests); `dims3`
    forces exact per-layout dims (per-frame rebuilds). Warm rebuilds pass
    `bbox` (host floats), the frame-1 `ref_capacity` and `check=False`:
    no host sync, overflow readable later via grid.overflowed."""
    if tris.count >= MAX_TRIS:
        raise ValueError(
            f"packet grid carries tri ids as f32 values, exact only "
            f"below {MAX_TRIS} tris (got {tris.count})")
    if dims3 is not None and max(max(d) for d in dims3) > 1023:
        raise ValueError("packet grid dims are capped at 1023 per axis "
                         "(voxel coords ride packed in 10-bit fields)")
    dev = tris.device
    f32 = dict(dtype=torch.float32, device=dev)
    if tris.count == 0:
        # Empty rows: one row per layout, every rs boundary 0.
        return PacketGrid(
            dims3=((1, 1, 1),) * 3, bbox_lo=torch.zeros(3, **f32),
            bbox_hi=torch.ones(3, **f32),
            rs=torch.zeros((6,), dtype=torch.int32, device=dev),
            rowinfo=torch.tensor([0, 2, 4], dtype=torch.int32, device=dev),
            cols=torch.zeros((3 * 768 // REF_GROUP + DEAD_ROWS,
                              GROUP_LANES), **f32),
            total_refs=torch.tensor(0, dtype=torch.int32, device=dev),
            total_pairs=torch.tensor(0, dtype=torch.int32, device=dev),
            tris=tris,
            planes=torch.tensor([[0.0, 1.0]] * 3, **f32))
    lo, hi = grid_bounds(tris, bbox)
    if dims3 is None and dims is None:
        cross_d = [min(d, 1023) for d in
                   density_dims(hi - lo, tris.count, cross_density)]
        slab = [min(d, 1023) for d in
                density_dims(hi - lo, tris.count, slice_density)]
        dims3 = tuple((slab[a], cross_d[(a + 1) % 3], cross_d[(a + 2) % 3])
                      for a in range(3))
    elif dims3 is None:
        dims3 = tuple((dims[a], dims[(a + 1) % 3], dims[(a + 2) % 3])
                      for a in range(3))
    dims3 = tuple(tuple(int(x) for x in d) for d in dims3)
    if _rs_entries(dims3, refine) >= (1 << 28):
        raise ValueError("rs table too large for rowinfo's 28-bit "
                         "offsets; reduce grid dims")
    if ref_capacity is None:
        ref_capacity = max(1536, int(tris.count * 2))
    # Round to 768 = lcm(block refs 6*128, unit refs 24): layout offsets
    # in rs then align to whole gather units and sweep blocks.
    ref_capacity = -(-ref_capacity // 768) * 768
    bbox_lo = torch.as_tensor(lo, **f32)
    bbox_hi = torch.as_tensor(hi, **f32)
    while True:
        grid = build_fixed(tris, bbox_lo, bbox_hi, dims3, ref_capacity,
                           adaptive=adaptive, refine=refine)
        if not check:
            return grid
        t = int(grid.total_pairs)
        if t <= ref_capacity:
            return grid
        ref_capacity = -(-int(t * 1.25) // 768) * 768


def build_fixed(tris: Triangles, bbox_lo, bbox_hi, dims3, ref_capacity,
                adaptive: bool = False, refine: bool = False) -> PacketGrid:
    """One build at fixed dims3, capacity (a multiple of 768) and bounds
    (f32[3] on the tris' device), with no host read: build_packet's
    body, and a warm rebuild, which RenderSession captures as one CUDA
    graph."""
    rs, rowinfo, cols, pairs, total, planes = _build(
        tris, bbox_lo, bbox_hi, dims3, ref_capacity, adaptive=adaptive,
        refine=refine)
    return PacketGrid(dims3=dims3, bbox_lo=bbox_lo, bbox_hi=bbox_hi,
                      rs=rs, rowinfo=rowinfo, cols=cols,
                      total_refs=total, total_pairs=pairs, tris=tris,
                      planes=planes)
