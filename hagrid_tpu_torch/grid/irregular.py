"""Two-level irregular grid (port of hagrid_tpu/grid/irregular.py), the
structure of Perard-Gayot, Kalojanov and Slusallek's irregular grids.

Each top cell stores a resolution log2 `r` and an offset into a block of
(2^r)^3 leaf entries, so a lookup is two dependent gathers. The build is
a chain of tensor stages on the triangles' device:

- top binning and the per-cell resolution (`_stage_top`);
- sub-voxel ref emission and one leaf cell per entry (`_stage_cells`);
- the air octree over empty top cells (`_stage_airboxes`);
- empty-buddy coalescing and SAH neighbour merging, matched by hash
  parity so that accepts never conflict (`_buddy_pass`, `_merge_pass`);
- compaction of dead cells, expansion of cell bboxes into empty (or
  ref-subset) neighbours, and the packed hot-path tables (`_optimize`).

Every emit is count -> scan -> expansion -> stable sort -> segment
starts, with no atomics. Three choices keep the tables bit-equal to the
reference's on any device:
- float sums that decide a cell's resolution are summed exactly (f64),
  not by a float scatter-add whose order the card does not fix;
- the uint32 hash of the merge parity is computed in int64 and masked;
- two-key sorts sort one int64 composite key.
The host reads the device where the reference does, between four spans
of device work (`build_spans`): the ref total after the top stage with
the entry total, the ref total after the cell stage (each retried with
a larger capacity on overflow) and the alive cell count; the scene
bounds only where top_dims must be derived from them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.types import Triangles
from ..device import const
from ..ops.segment import (add_at_drop, compact_indices, cumsum_i32,
                           exclusive_scan, expand_by_counts, rows_to_segments,
                           segment_starts, sort_pairs, take)
from ..utils import profiling
from ..utils.config import BuildParams, density_dims
from ..utils.graphs import eager
from .uniform import (bin_refs, linear_cell, scene_bounds, scene_box,
                      tri_voxel_ranges)

# SAH constants (cost = half_area * (C_TRAV + C_ISECT * n_refs)).
C_TRAV = 1.0
C_ISECT = 1.0


@dataclasses.dataclass
class IrregularGrid:
    top_dims: tuple
    levels: int                  # structural max sub-resolution, log2
    bbox_lo: torch.Tensor        # f32[3]
    bbox_hi: torch.Tensor        # f32[3]
    top_res_log: torch.Tensor    # i32[Ct]
    top_offset: torch.Tensor     # i32[Ct], into entries
    entries: torch.Tensor        # i32[E_cap]: leaf cell id per sub-voxel
    cell_min: torch.Tensor       # i32[C_cap, 3], inclusive, fine coords
    cell_max: torch.Tensor       # i32[C_cap, 3]
    cell_starts: torch.Tensor    # i32[C_cap + 1]
    ref_ids: torch.Tensor        # i32[R_cap]
    alive: torch.Tensor          # bool[C_cap]
    num_entries: torch.Tensor    # i32[]
    total_refs: torch.Tensor     # i32[]
    tris: Triangles
    # Cells whose bbox was pre-expanded past their owned region (air
    # cubes): merging reasons about owned regions by bboxes, so these
    # never merge.
    preexpanded: torch.Tensor    # bool[C_cap]
    # Packed hot-path tables (built by _pack_tables, read by the
    # wavefront): the lookup in two row gathers, a ref test in one.
    top_info: torch.Tensor       # i32[Ct] = offset << 3 | res_log
    erec: torch.Tensor           # i32[E_cap, 8] = [cmin, cmax, start, end]
    ref_tris: torch.Tensor       # f32[R_cap, 12] = [v0, e1, e2, id, pad]
    is_packed: bool = True

    @property
    def fine_dims(self) -> tuple:
        return tuple(d << self.levels for d in self.top_dims)

    def replace(self, **kw) -> "IrregularGrid":
        return dataclasses.replace(self, **kw)

    def lookup(self, voxel: torch.Tensor):
        """fine voxel i32[N, 3] -> (cell i32[N], cmin i32[N, 3], cmax)."""
        lv = self.levels
        top = voxel >> lv
        tidx = linear_cell(top[:, 0], top[:, 1], top[:, 2], self.top_dims)
        r = take(self.top_res_log, tidx)
        off = take(self.top_offset, tidx)
        local = (voxel & ((1 << lv) - 1)) >> (lv - r)[:, None]
        side = torch.ones_like(r) << r
        sub = (local[:, 2] * side + local[:, 1]) * side + local[:, 0]
        e = take(self.entries, off + sub)
        return e, take(self.cell_min, e), take(self.cell_max, e)

    def stats(self) -> dict:
        starts = self.cell_starts.cpu().numpy()
        alive = self.alive.cpu().numpy()
        counts = np.diff(starts)[: alive.shape[0]][alive]
        return dict(
            top_dims=self.top_dims, levels=self.levels,
            entries=int(self.num_entries), cells=int(alive.sum()),
            refs=int(self.total_refs),
            refs_per_cell_mean=float(counts.mean()) if counts.size else 0.0,
            refs_per_cell_max=int(counts.max()) if counts.size else 0,
            empty_cell_frac=float((counts == 0).mean()) if counts.size else 0,
        )


def _coords(c, dims):
    """Linear x-fastest index -> (x, y, z)."""
    tdx, tdy, _ = dims
    rem = c // tdx
    return c % tdx, rem % tdy, rem // tdy


# --------------------------------------------------------------------------
# Stage 1+2: top-level binning and per-cell resolution.
# --------------------------------------------------------------------------

def _res_demand_host(n_c: np.ndarray, snd_density: float) -> np.ndarray:
    """The reference's demanded resolution ceil(log2(max(cbrt(x), 1))),
    x = f32(snd_density * n_c), with each step rounded to f32 as the
    reference rounds it (its f32 cbrt is exact on perfect cubes, so an
    f64 cbrt rounded once stands for it). Host numpy, for integer n_c."""
    x = (np.float32(snd_density) * n_c.astype(np.float32)).astype(np.float32)
    side = np.cbrt(x.astype(np.float64)).astype(np.float32)
    lg = np.log2(np.maximum(side, np.float32(1.0)).astype(np.float64))
    return np.ceil(lg.astype(np.float32)).astype(np.int64)


_NEVER = (1 << 31) - 1   # a threshold no i32 count reaches


@functools.lru_cache(maxsize=64)
def res_thresholds(snd_density: float, levels: int) -> tuple:
    """thr[k - 1] = the least triangle count whose demanded resolution is
    at least k, for k = 1..levels. The demand crosses k where x passes
    8^(k-1), so only the few counts around there are evaluated."""
    thr = []
    for k in range(1, levels + 1):
        n0 = int(8.0 ** (k - 1) / max(snd_density, 1e-30))
        n = np.arange(max(n0 - 4, 0), n0 + 6, dtype=np.int64)
        ok = np.nonzero(_res_demand_host(n, snd_density) >= k)[0]
        thr.append(int(n[ok[0]]) if ok.size else _NEVER)
    return tuple(thr)


def res_demand(n_c: torch.Tensor, snd_density: float,
               levels: int) -> torch.Tensor:
    """Demanded resolution log2 per cell from its triangle count i32,
    clipped to `levels`, as integer compares against `res_thresholds`:
    no float cube root on the device, so the card and the CPU agree with
    the reference for every count."""
    res = torch.zeros_like(n_c, dtype=torch.int32)
    for t in res_thresholds(float(snd_density), int(levels)):
        res += (n_c >= t).to(torch.int32)
    return res


def _stage_top(tris, bbox_lo, bbox_hi, top_dims, levels, snd_density,
               ref_growth, rt_cap):
    """`levels` is the structural maximum (params.levels + 1): the
    density heuristic demands a resolution per top cell and a ref-growth
    cap grants it, so dense cells of small triangles get the extra level
    and cells of large triangles (foliage) stay coarse."""
    lo, hi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, top_dims)
    skeys, srefs, top_starts, total = bin_refs(lo, hi, top_dims, rt_cap)
    n_top = int(np.prod(top_dims))

    # Demand: side = cbrt(snd_density * n_c) rounded up to a power of two.
    # Supply: the cell's projected refs at resolution r,
    #   refs(r) <= A3 s^3 + A2 s^2 + A1 s + n_c,  s = 2^(r - levels),
    # from each tri's fine-voxel span polynomial prod_i (a_i s + 1) summed
    # per cell; the cell takes the deepest demanded r whose projection
    # stays within ref_growth * n_c.
    n_ci = top_starts[1:] - top_starts[:-1]
    n_c = n_ci.to(torch.float32)
    res_d = res_demand(n_ci, snd_density, levels)

    fine_dims = tuple(d << levels for d in top_dims)
    flo, fhi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, fine_dims)
    a = (fhi - flo + 1).to(torch.float32)
    tri_poly = torch.stack(
        [a.sum(1),
         a[:, 0] * a[:, 1] + a[:, 0] * a[:, 2] + a[:, 1] * a[:, 2],
         a[:, 0] * a[:, 1] * a[:, 2]], dim=1)
    valid = (skeys < n_top)[:, None]
    pv = torch.where(valid, take(tri_poly, srefs.clamp(min=0)), 0.0)
    # The sums are of integer-valued floats. A float scatter-add on the
    # card adds in no fixed order and rounds past 2^24, which could move
    # a cell across its budget from run to run; summing in f64 and
    # rounding once is exact, and equals the reference's f32 sum wherever
    # that sum is exact.
    A = torch.zeros((n_top + 1, 3), dtype=torch.float64, device=pv.device)
    A.index_add_(0, skeys.clamp(max=n_top).long(), pv.to(torch.float64))
    A = A[:n_top].to(torch.float32)
    A1, A2, A3 = A[:, 0], A[:, 1], A[:, 2]
    # Small cells refine freely (tiny scenes would otherwise never
    # subdivide); the cap stops dense cells of large triangles from
    # multiplying refs without separating them.
    budget = torch.clamp(ref_growth * n_c, min=512.0)
    res_cap = torch.zeros_like(res_d)
    for r in range(1, levels + 1):
        sc = 2.0 ** (r - levels)
        proj = ((A3 * sc + A2) * sc + A1) * sc + n_c
        # refs(r) grows with r: the running where keeps the deepest
        # affordable resolution.
        res_cap = torch.where(proj <= budget, r, res_cap)
    res_log = torch.minimum(res_d, res_cap).clamp(0, levels)
    sizes = torch.ones_like(res_log) << (3 * res_log)
    offsets = exclusive_scan(sizes)
    e_total = offsets[-1] + sizes[-1]
    return top_starts, skeys, srefs, total, res_log, offsets, e_total


# --------------------------------------------------------------------------
# Stage 3+4: sub-voxel ref emission and initial leaf cells.
# --------------------------------------------------------------------------

def _stage_cells(tris, bbox_lo, bbox_hi, top_cell_of_ref, top_refs,
                 res_log, offsets, e_total, top_dims, levels, e_cap, r2_cap):
    """Expand each (top cell, tri) ref into the tri's sub-voxels at the
    cell's resolution; one leaf cell per sub-voxel."""
    fine_dims = tuple(d << levels for d in top_dims)
    flo, fhi = tri_voxel_ranges(tris, bbox_lo, bbox_hi, fine_dims)
    n_top = int(np.prod(top_dims))

    valid_ref = top_refs >= 0
    c = top_cell_of_ref.clamp(max=n_top - 1)
    t = top_refs.clamp(min=0)
    r = take(res_log, c)
    shift = levels - r  # sub-voxel width log2, in fine voxels

    cx, cy, cz = _coords(c, top_dims)
    cell_lo = torch.stack([cx, cy, cz], -1) << levels

    # Tri's fine range clipped to the top cell, in sub-voxel coords.
    side = torch.ones_like(r) << r
    zero = torch.zeros_like(cell_lo)
    smax = (side - 1)[:, None]
    lo_s = torch.minimum(torch.maximum(
        (take(flo, t) - cell_lo) >> shift[:, None], zero), smax)
    hi_s = torch.minimum(torch.maximum(
        (take(fhi, t) - cell_lo) >> shift[:, None], zero), smax)
    span = hi_s - lo_s + 1
    counts = torch.where(valid_ref, span[:, 0] * span[:, 1] * span[:, 2], 0)

    ref_idx, rank, valid, total2 = expand_by_counts(counts, r2_cap)
    valid = valid & take(valid_ref, ref_idx)
    s = take(span, ref_idx)
    lo_r = take(lo_s, ref_idx)
    dx = rank % s[:, 0]
    rem2 = rank // s[:, 0]
    dy = rem2 % s[:, 1]
    dz = rem2 // s[:, 1]
    lx = lo_r[:, 0] + dx
    ly = lo_r[:, 1] + dy
    lz = lo_r[:, 2] + dz
    side_e = take(side, ref_idx)
    entry = take(offsets, take(c, ref_idx)) + (lz * side_e + ly) * side_e + lx

    key = torch.where(valid, entry, e_cap)
    tri_of = torch.where(valid, take(top_refs, ref_idx), -1)
    skeys, srefs = sort_pairs(key, tri_of)
    cell_starts = segment_starts(skeys, e_cap)

    # Initial cells: one per entry e < e_total; int bbox = sub-voxel
    # extent. Entry -> owning top cell by a marker scatter and a prefix sum.
    dev = offsets.device
    e = torch.arange(e_cap, dtype=torch.int32, device=dev)
    owner = (cumsum_i32(add_at_drop(e_cap, offsets, 1)) - 1).clamp(
        0, offsets.shape[0] - 1)
    local = e - take(offsets, owner)
    r_o = take(res_log, owner)
    side_o = torch.ones_like(r_o) << r_o
    w = torch.ones_like(r_o) << (levels - r_o)
    # side_o is a power of two: masks and shifts instead of div/mod.
    lx = local & (side_o - 1)
    rem3 = local >> r_o
    ly = rem3 & (side_o - 1)
    lz = rem3 >> r_o
    ox, oy, oz = _coords(owner, top_dims)
    cmin = ((torch.stack([ox, oy, oz], -1) << levels)
            + torch.stack([lx, ly, lz], -1) * w[:, None])
    cmax = cmin + (w[:, None] - 1)
    alive = e < e_total
    cmin = torch.where(alive[:, None], cmin, 0)
    cmax = torch.where(alive[:, None], cmax, -1)
    return e, cmin, cmax, cell_starts, srefs, alive, total2


# --------------------------------------------------------------------------
# Stage 4.5: analytic air coalescing ("air octree").
# --------------------------------------------------------------------------

def _stage_airboxes(top_starts, offsets, cell_min, cell_max, top_dims,
                    levels, air_levels, c_cap):
    """Pre-expand empty top cells' bboxes to their largest aligned all-air
    cube of top cells: an octree reduction over the top cells (a level-k
    cube is air iff its 8 level-(k-1) children are). Ownership (entries)
    is untouched, so this is expansion (bbox over empty-owned voxels);
    the touched cells are flagged and excluded from merging."""
    tdx, tdy, tdz = top_dims
    dev = top_starts.device
    air = (top_starts[1:] - top_starts[:-1]) == 0
    # (z, y, x) occupancy volume, padded to multiples of 2^air_levels.
    pd = 1 << air_levels
    pdx, pdy, pdz = (-(-d // pd) * pd for d in (tdx, tdy, tdz))
    vol = torch.zeros((pdz, pdy, pdx), dtype=torch.bool, device=dev)
    vol[:tdz, :tdy, :tdx] = air.reshape(tdz, tdy, tdx)

    best_k = torch.zeros((pdz, pdy, pdx), dtype=torch.int32, device=dev)
    cur = vol
    for k in range(1, air_levels + 1):
        s = cur.shape
        cur = cur.reshape(s[0] // 2, 2, s[1] // 2, 2, s[2] // 2, 2)
        cur = cur.all(dim=5).all(dim=3).all(dim=1)  # level-k cube all air?
        # Each cube's flag back on its (2^k)^3 cells: repeat_interleave
        # along the three axes, as a broadcast.
        z, y, x = cur.shape
        w = 2 ** k
        up = cur[:, None, :, None, :, None].expand(z, w, y, w, x, w)
        best_k = torch.where(up.reshape(pdz, pdy, pdx), k, best_k)

    k = best_k[:tdz, :tdy, :tdx].reshape(-1)
    c = torch.arange(tdx * tdy * tdz, dtype=torch.int32, device=dev)
    coord = torch.stack(_coords(c, top_dims), -1)
    base = (coord >> k[:, None]) << k[:, None]
    cube_min = base << levels
    cube_max = ((base + (torch.ones_like(base) << k[:, None])) << levels) - 1
    # Clamp to the real top dims: edge cubes can stick out when the dims
    # are not multiples of the cube.
    fine_max = (const(top_dims, torch.int32, dev) << levels) - 1
    cube_max = torch.minimum(cube_max, fine_max)

    rows = torch.where(air & (k > 0), offsets, c_cap).long()
    cell_min = _set_drop(cell_min, rows, cube_min)
    cell_max = _set_drop(cell_max, rows, cube_max)
    preexp = _set_drop(torch.zeros((c_cap,), dtype=torch.bool, device=dev),
                       rows, torch.ones_like(rows, dtype=torch.bool))
    return cell_min, cell_max, preexp


def _set_drop(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """x.at[idx].set(vals, mode="drop") for non-negative idx whose
    in-range targets are distinct: rows >= len(x) land in a cut-off
    slot."""
    n = x.shape[0]
    out = torch.cat([x, x[:1]])
    out[idx.clamp(max=n).long()] = vals
    return out[:n]


# --------------------------------------------------------------------------
# Stage 5: SAH neighbour merging (hash-parity matching).
# --------------------------------------------------------------------------

def _half_area(cmin, cmax, cs):
    """SAH half-area of a cell's int bbox in world units; cs f32[3] is
    the fine-cell size."""
    e = (cmax - cmin + 1).to(torch.float32) * cs
    return e[..., 0] * (e[..., 1] + e[..., 2]) + e[..., 1] * e[..., 2]


_U32 = 0xFFFFFFFF


def _hash_bit(x, salt: int):
    """The merge parity: bit 0 of h ^ (h >> 16), h = x * 2654435761 +
    salt * 40503 in uint32 arithmetic (int64 here, masked to 32 bits)."""
    x = x.to(torch.int64) & _U32
    h = (x * 2654435761 + (int(salt) & _U32) * 40503) & _U32
    return ((h ^ (h >> 16)) & 1).to(torch.bool)


def _probe_plus(cmin, cmax, axis, fine):
    """The voxel just past cmax on `axis` at the cmin corner, clamped
    into the grid, and whether it was inside."""
    probe = cmin.clone()
    probe[:, axis] = cmax[:, axis] + 1
    in_b = probe[:, axis] < fine[axis]
    return torch.minimum(probe.clamp(min=0), fine - 1), in_b


def _box_pair(cmin, cmax, jmin, jmax, axis):
    """j starts just past i on `axis` and has i's cross-section."""
    oa = [a for a in range(3) if a != axis]
    return ((jmin[:, axis] == cmax[:, axis] + 1)
            & (jmin[:, oa[0]] == cmin[:, oa[0]])
            & (jmax[:, oa[0]] == cmax[:, oa[0]])
            & (jmin[:, oa[1]] == cmin[:, oa[1]])
            & (jmax[:, oa[1]] == cmax[:, oa[1]]))


def _fine(grid):
    return const(grid.fine_dims, torch.int32, grid.cell_min.device)


def _absorb(accept, j, c_cap):
    """merge_map with map[j] = i for accepted pairs (distinct j), else
    the identity."""
    i_idx = torch.arange(c_cap, dtype=torch.int32, device=j.device)
    return i_idx, _set_drop(i_idx, torch.where(accept, j, c_cap), i_idx)


def _buddy_pass(grid: IrregularGrid, axis: int) -> IrregularGrid:
    """Empty-only merge pass: aligned equal-size empty buddies coalesce,
    with no ref work (absorbed cells are empty, so cell_starts stays
    valid)."""
    c_cap = grid.cell_min.shape[0]
    alive, cmin, cmax = grid.alive, grid.cell_min, grid.cell_max
    starts = grid.cell_starts
    n_refs = (starts[1:] - starts[:-1])[:c_cap]

    probe, in_b = _probe_plus(cmin, cmax, axis, _fine(grid))
    j, jmin, jmax = grid.lookup(probe)
    w_i = cmax[:, axis] - cmin[:, axis] + 1
    w_j = jmax[:, axis] - jmin[:, axis] + 1
    buddy = (w_i == w_j) & ((cmin[:, axis] & (2 * w_i - 1)) == 0)
    accept = (alive & in_b & take(alive, j)
              & _box_pair(cmin, cmax, jmin, jmax, axis) & buddy
              & (n_refs == 0) & (take(n_refs, j) == 0)
              & ~grid.preexpanded & ~take(grid.preexpanded, j))

    i_idx, merge_map = _absorb(accept, j, c_cap)
    new_cmax = torch.where(accept[:, None], torch.maximum(cmax, jmax), cmax)
    return grid.replace(entries=take(merge_map, grid.entries),
                        cell_max=new_cmax, alive=alive & (merge_map == i_idx))


def _sort2(k1: torch.Tensor, k2: torch.Tensor):
    """Lexicographic sort of (k1, k2), k1 in [0, 2^31), k2 any int32, as
    one int64 key: returns the sorted (k1, k2) as int32."""
    comp = (k1.to(torch.int64) << 32) | (k2.to(torch.int64) + (1 << 31))
    s = torch.sort(comp).values
    return ((s >> 32).to(torch.int32),
            ((s & _U32) - (1 << 31)).to(torch.int32))


def _merge_pass(grid: IrregularGrid, salt, axis: int,
                alpha: float) -> IrregularGrid:
    """One merge pass along `axis`: each alive cell proposes its +axis
    neighbour if the pair tiles a box and the SAH cost of the union beats
    alpha * (sum of parts), with |A| + |B| as the union's ref count.
    Non-empty pairs are accepted where the hash parity allows; empty
    pairs only as aligned equal-size buddies. Absorbed cells die, entries
    are repointed, ref lists re-sorted and deduplicated."""
    c_cap = grid.cell_min.shape[0]
    fine = _fine(grid)
    cs = (grid.bbox_hi - grid.bbox_lo) / fine.to(torch.float32)
    alive, cmin, cmax = grid.alive, grid.cell_min, grid.cell_max
    starts = grid.cell_starts
    n_refs = (starts[1:] - starts[:-1])[:c_cap]

    probe, in_b = _probe_plus(cmin, cmax, axis, fine)
    j, jmin, jmax = grid.lookup(probe)
    n_j = take(n_refs, j)
    # Pre-expanded (air cube) cells: their bbox is not their owned
    # region, so bbox adjacency says nothing about them.
    cand = (alive & in_b & take(alive, j)
            & _box_pair(cmin, cmax, jmin, jmax, axis)
            & ~grid.preexpanded & ~take(grid.preexpanded, j))

    umin = torch.minimum(cmin, jmin)
    umax = torch.maximum(cmax, jmax)
    cost_a = _half_area(cmin, cmax, cs) * (C_TRAV + C_ISECT * n_refs)
    cost_b = _half_area(jmin, jmax, cs) * (C_TRAV + C_ISECT * n_j)
    cost_u = _half_area(umin, umax, cs) * (C_TRAV + C_ISECT * (n_refs + n_j))
    sah_ok = cost_u <= alpha * (cost_a + cost_b)

    # Empty cells merge only with aligned equal-size empty buddies
    # (octree doubling), which keeps air isotropic; buddy accepts are
    # conflict-free without the parity. SAH merges keep the parity.
    empty_i = n_refs == 0
    empty_j = n_j == 0
    w_i = cmax[:, axis] - cmin[:, axis] + 1
    w_j = jmax[:, axis] - jmin[:, axis] + 1
    buddy = (w_i == w_j) & ((cmin[:, axis] & (2 * w_i - 1)) == 0)

    i_idx = torch.arange(c_cap, dtype=torch.int32, device=j.device)
    parity = ~_hash_bit(i_idx, salt) & _hash_bit(j, salt)
    accept = ((cand & ~empty_i & ~empty_j & sah_ok & parity)
              | (cand & empty_i & empty_j & buddy))

    # Absorb j into i: map[j] = i. j's matching left neighbour is unique
    # and the parity forbids a cell absorbing and being absorbed at once,
    # so the scatter has distinct targets.
    _, merge_map = _absorb(accept, j, c_cap)
    new_alive = alive & (merge_map == i_idx)
    new_cmax = torch.where(accept[:, None], umax, cmax)
    new_cmin = torch.where(accept[:, None], umin, cmin)

    # Re-key every ref to its (possibly merged) owner, sort, dedup.
    r_cap = grid.ref_ids.shape[0]
    rrow = torch.arange(r_cap, dtype=torch.int32, device=j.device)
    owner = rows_to_segments(starts, r_cap)
    valid = (rrow < grid.total_refs) & (grid.ref_ids >= 0)
    key = torch.where(valid, take(merge_map, owner), c_cap)
    skeys, srefs = _sort2(key, torch.where(valid, grid.ref_ids, 1 << 30))
    dup = torch.zeros_like(valid)
    dup[1:] = (skeys[1:] == skeys[:-1]) & (srefs[1:] == srefs[:-1])
    keep = (skeys < c_cap) & ~dup
    ck, cr = sort_pairs(torch.where(keep, skeys, c_cap),
                        torch.where(keep, srefs, -1))
    return grid.replace(entries=take(merge_map, grid.entries),
                        cell_min=new_cmin, cell_max=new_cmax,
                        cell_starts=segment_starts(ck, c_cap), ref_ids=cr,
                        alive=new_alive, total_refs=keep.sum(dtype=torch.int32))


# --------------------------------------------------------------------------
# Stage 6: greedy cell expansion.
# --------------------------------------------------------------------------

def _subset_test(grid: IrregularGrid, n_refs, jp, jm, candp, candm):
    """For candidate pairs (A, B = jp[A]) and (A, B = jm[A]), decide
    refs(B) within refs(A): B's refs become query rows and A's own refs
    data rows, all sorted by (cell A, ref, tag) with data first; a query
    is matched when a data row of the same (A, ref) precedes it in its
    group (at most 3 rows: 1 data + 2 directions). A pair passes when all
    its queries matched. Overflow drops rows, which only suppresses
    expansions."""
    c_cap = n_refs.shape[0]
    r_cap = grid.ref_ids.shape[0]
    starts = grid.cell_starts

    need = candp | candm
    di, dr, dv, _ = expand_by_counts(torch.where(need, n_refs, 0), r_cap)
    ref_d = take(grid.ref_ids, take(starts, di) + dr)

    def qrows(j, cand):
        n_b = torch.where(cand, take(n_refs, j), 0)
        qi, qr, qv, _ = expand_by_counts(n_b, r_cap)
        refq = take(grid.ref_ids, take(starts, take(j, qi)) + qr)
        return qi, refq, qv, n_b

    qi_p, ref_p, qv_p, n_bp = qrows(jp, candp)
    qi_m, ref_m, qv_m, n_bm = qrows(jm, candm)

    cell = torch.cat([torch.where(dv, di, c_cap),
                      torch.where(qv_p, qi_p, c_cap),
                      torch.where(qv_m, qi_m, c_cap)])
    key = torch.cat([ref_d * 4, ref_p * 4 + 1, ref_m * 4 + 2])
    s_cell, s_key = _sort2(cell, torch.where(cell < c_cap, key, 0))
    tag = s_key & 3
    ref = s_key >> 2
    same = torch.zeros_like(s_cell, dtype=torch.bool)
    same[1:] = (s_cell[1:] == s_cell[:-1]) & (ref[1:] == ref[:-1])
    has_data = tag == 0
    for _ in range(2):
        prev = torch.roll(has_data, 1)
        has_data = has_data | (same & prev)
    live = s_cell < c_cap
    cm_p = add_at_drop(c_cap, s_cell, (has_data & (tag == 1) & live)
                       .to(torch.int32))
    cm_m = add_at_drop(c_cap, s_cell, (has_data & (tag == 2) & live)
                       .to(torch.int32))
    return candp & (cm_p == n_bp), candm & (cm_m == n_bm)


def _expand_pass(grid: IrregularGrid, axis: int,
                 subset: bool = False) -> IrregularGrid:
    """Grow each alive cell's bbox along +axis and -axis into a
    neighbour that covers the full cross-section and is empty or
    (subset=True) has a ref list within the cell's own. Safe
    transitively, so repeated passes chain."""
    c_cap = grid.cell_min.shape[0]
    fine = _fine(grid)
    starts = grid.cell_starts
    n_refs = (starts[1:] - starts[:-1])[:c_cap]
    oa = [a for a in range(3) if a != axis]
    cmin, cmax = grid.cell_min, grid.cell_max
    i_idx = torch.arange(c_cap, dtype=torch.int32, device=cmin.device)

    def probe_dir(direction):
        """(neighbour, its bbox, geometric acceptability) per cell. Both
        directions read the original bbox: growth along `axis` leaves the
        cross-section the covers test uses unchanged."""
        probe = cmin.clone()
        if direction > 0:
            probe[:, axis] = cmax[:, axis] + 1
            in_b = probe[:, axis] < fine[axis]
        else:
            probe[:, axis] = cmin[:, axis] - 1
            in_b = probe[:, axis] >= 0
        j, jmin, jmax = grid.lookup(
            torch.minimum(probe.clamp(min=0), fine - 1))
        covers = ((jmin[:, oa[0]] <= cmin[:, oa[0]])
                  & (jmax[:, oa[0]] >= cmax[:, oa[0]])
                  & (jmin[:, oa[1]] <= cmin[:, oa[1]])
                  & (jmax[:, oa[1]] >= cmax[:, oa[1]]))
        return j, jmin, jmax, grid.alive & in_b & covers & (j != i_idx)

    jp, _, jmax_p, base_p = probe_dir(+1)
    jm, jmin_m, _, base_m = probe_dir(-1)
    n_p, n_m = take(n_refs, jp), take(n_refs, jm)
    ok_p = base_p & (n_p == 0)
    ok_m = base_m & (n_m == 0)
    if subset:
        cand_p = base_p & (n_p > 0) & (n_p <= n_refs)
        cand_m = base_m & (n_m > 0) & (n_m <= n_refs)
        sub_p, sub_m = _subset_test(grid, n_refs, jp, jm, cand_p, cand_m)
        ok_p = ok_p | sub_p
        ok_m = ok_m | sub_m
    cmax = cmax.clone()
    cmin = cmin.clone()
    cmax[:, axis] = torch.where(ok_p, jmax_p[:, axis], cmax[:, axis])
    cmin[:, axis] = torch.where(ok_m, jmin_m[:, axis], cmin[:, axis])
    return grid.replace(cell_min=cmin, cell_max=cmax)


# --------------------------------------------------------------------------
# Host build wrapper.
# --------------------------------------------------------------------------

def _bucket(n: int, lo: int = 1024) -> int:
    """Round a capacity up to a coarse bucket (25% steps, multiples of
    256, so quad-row reshapes stay exact)."""
    b = lo
    while b < n:
        b += max(b // 4 // 256 * 256, lo)
    return b


def _cell_capacity(n_alive: int) -> int:
    """The rows compaction keeps: the reference's bucket of n_alive."""
    return _bucket(n_alive)


def _empty_grid(tris: Triangles) -> IrregularGrid:
    """Degenerate but legal: one empty unit-box cell, every ray misses."""
    dev = tris.device
    i32 = dict(dtype=torch.int32, device=dev)
    return IrregularGrid(
        top_dims=(1, 1, 1), levels=0,
        bbox_lo=torch.zeros(3, device=dev), bbox_hi=torch.ones(3, device=dev),
        top_res_log=torch.zeros(1, **i32), top_offset=torch.zeros(1, **i32),
        entries=torch.zeros(1, **i32), cell_min=torch.zeros((1, 3), **i32),
        cell_max=torch.zeros((1, 3), **i32),
        cell_starts=torch.zeros(2, **i32),
        ref_ids=torch.full((1,), -1, **i32),
        alive=torch.ones(1, dtype=torch.bool, device=dev),
        num_entries=torch.ones((), **i32), total_refs=torch.zeros((), **i32),
        tris=tris, preexpanded=torch.zeros(1, dtype=torch.bool, device=dev),
        top_info=torch.zeros(1, **i32), erec=torch.zeros((1, 8), **i32),
        ref_tris=torch.zeros((1, 12), device=dev))


# The build as the reference runs it: four spans of device work between
# its host reads. build_irregular runs each span op by op; a warm
# RenderSession rebuild replays each as a captured graph
# (render/session.py).
# - A (`_span_top`): the scene bounds and `_stage_top`;
#   read rt_total with e_total;
# - B (`_span_cells`): `_stage_cells`; read r2_total;
# - C (`_span_merge`): the air octree, the buddy and the merge passes;
#   read n_alive (params.compact);
# - D (`_span_finish`): compaction, the expansion passes, the packed
#   tables.
# A span takes the frame's triangles (A) or reads the earlier spans'
# outputs in place (B-D), and returns a tuple of tensors. A's outputs:
# the triangles (its inputs), the bounds, the top stage's seven tables
# and (rt_total, e_total).
_CELLS = ("entries", "cell_min", "cell_max", "cell_starts", "ref_ids",
          "alive", "total_refs", "preexpanded")
_PACKED = ("top_info", "erec", "ref_tris")


def _grid(a, cells, top_dims, levels, packed=(None, None, None)):
    """The grid of span A's outputs `a` and the _CELLS tables `cells`
    (and the _PACKED tables once packed)."""
    v0, e1, e2, n, lo, hi, _, _, _, _, res_log, offsets, e_total, _ = a
    return IrregularGrid(
        top_dims=top_dims, levels=levels, bbox_lo=lo, bbox_hi=hi,
        top_res_log=res_log, top_offset=offsets, num_entries=e_total,
        tris=Triangles(v0, e1, e2, n), **dict(zip(_CELLS, cells)),
        **dict(zip(_PACKED, packed)))


def _span_top(v0, e1, e2, n, top_dims, levels, params, rt_cap):
    tris = Triangles(v0, e1, e2, n)
    lo, hi = scene_bounds(tris)
    top = _stage_top(tris, lo, hi, top_dims, levels, params.snd_density,
                     params.ref_growth, rt_cap)
    return (v0, e1, e2, n, lo, hi, *top, torch.stack([top[3], top[6]]))


def _span_cells(a, top_dims, levels, e_cap, r2_cap):
    v0, e1, e2, n, lo, hi, _, keys, refs, _, res_log, offsets, e_total, _ = a
    return _stage_cells(Triangles(v0, e1, e2, n), lo, hi, keys, refs,
                        res_log, offsets, e_total, top_dims, levels, e_cap,
                        r2_cap)


def _cells_grid(a, b, top_dims, levels, air_levels):
    """The grid after the cell stage (span B's outputs `b`) and the air
    octree, without packed tables."""
    entries, cmin, cmax, cell_starts, refs, alive, total2 = b
    cmin, cmax, preexp = _stage_airboxes(a[6], a[11], cmin, cmax, top_dims,
                                         levels, air_levels,
                                         entries.shape[0])
    return _grid(a, (entries, cmin, cmax, cell_starts, refs, alive, total2,
                     preexp), top_dims, levels)


def _span_merge(a, b, top_dims, levels, params):
    grid = _cells_grid(a, b, top_dims, levels, params.air_levels)
    # Cheap empty-buddy coalescing first (no ref work), then SAH merges.
    for _ in range(params.buddy_passes):
        for axis in range(3):
            grid = _buddy_pass(grid, axis)
    for p in range(params.merge_passes):
        for axis in range(3):
            grid = _merge_pass(grid, p * 3 + axis + 1, axis,
                               float(params.alpha))
    return (*(getattr(grid, k) for k in _CELLS),
            grid.alive.sum(dtype=torch.int32))


def _span_finish(a, c, top_dims, levels, params, cell_cap):
    """cell_cap: the rows compaction keeps (None: no compaction)."""
    grid = _grid(a, c[:len(_CELLS)], top_dims, levels)
    # Compact before expansion: merging kills about half the cells, and
    # every expansion pass scans all cell rows.
    if cell_cap is not None:
        grid = compact_cells(grid, cell_cap)
    for p in range(params.expansion_passes):
        for axis in range(3):
            # The sort-backed subset test runs on the first pass only;
            # chains continue through the cheap empty rule.
            grid = _expand_pass(grid, axis,
                                subset=params.subset_expansion and p == 0)
    grid = _pack_tables(grid)
    return tuple(getattr(grid, k) for k in _CELLS + _PACKED)


def _read(fn):
    """One of the build's host reads, fn(): span "read.build" and counter
    "host_reads.build" (utils/profiling.py)."""
    profiling.count("host_reads.build")
    with profiling.span("read.build"):
        return fn()


def _top_and_cells(tris, params, top_dims, run, caps):
    """Spans A and B with their reads: (a, b, top_dims, levels)."""
    n = tris.count
    if top_dims is None:
        lo, hi = scene_box(tris)
        top_dims = density_dims(hi - lo, n, params.top_density)
    top_dims = tuple(int(d) for d in top_dims)
    # Structural max res: one level beyond the density default, granted
    # per cell only where the ref-growth cap allows (see _stage_top).
    levels = params.levels + 1
    # rt_cap sizes no table of the grid: a warm session starts where its
    # last build ended, so its span A keeps one capture.
    rt_cap = max(_bucket(int(n * 2.5 * params.ref_slack)), caps.get("rt", 0))
    while True:
        a = run("top", (n, top_dims, params, rt_cap),
                functools.partial(_span_top, top_dims=top_dims,
                                  levels=levels, params=params,
                                  rt_cap=rt_cap),
                (tris.v0, tris.e1, tris.e2, tris.n), fresh=False)
        t, e_total = _read(a[-1].tolist)
        if t <= rt_cap:
            break
        rt_cap = _bucket(int(t * 1.25))
    caps["rt"] = rt_cap
    e_cap = _bucket(e_total + 1)
    # r2_cap sizes ref_ids: the reference's (its first capacity from t,
    # grown once to fit r2_total). A warm session starts at the capacity
    # its last build ended on from the same first one.
    first = _bucket(int(t * 3.0 * params.ref_slack))
    r2_cap = caps.get(("r2", first), first)
    while True:
        b = run("cells", (top_dims, levels, e_cap, r2_cap),
                functools.partial(_span_cells, a, top_dims=top_dims,
                                  levels=levels, e_cap=e_cap, r2_cap=r2_cap),
                (), reads=a, fresh=False)
        t2 = _read(b[-1].item)
        want = first if t2 <= first else _bucket(int(t2 * 1.25))
        if want == r2_cap:
            break
        r2_cap = want
    caps[("r2", first)] = r2_cap
    return a, b, top_dims, levels


def build_stages(tris: Triangles, params: BuildParams,
                 top_dims: tuple | None = None):
    """The build up to (not including) the optimisation passes, op by op:
    the grid after the air octree, with zero packed tables as the
    reference's has, and the intermediate tables of the top stage (for
    tests of each stage)."""
    a, b, top_dims, levels = _top_and_cells(tris, params, top_dims, eager,
                                            {})
    grid = _cells_grid(a, b, top_dims, levels, params.air_levels)
    dev = tris.device
    return grid.replace(
        tris=tris,
        top_info=torch.zeros((int(np.prod(top_dims)),), dtype=torch.int32,
                             device=dev),
        erec=torch.zeros((grid.entries.shape[0], 8), dtype=torch.int32,
                         device=dev),
        ref_tris=torch.zeros((grid.ref_ids.shape[0], 12), device=dev)), a[6:13]


def build_spans(tris: Triangles, params: BuildParams,
                top_dims: tuple | None = None, run=eager,
                caps: dict | None = None) -> IrregularGrid:
    """build_irregular's host side for a non-empty scene: the four spans,
    each through `run` (utils/graphs.py's `Graphs.call` signature: `eager`
    runs a span op by op, a session's `Graphs.call` replays it as a
    captured graph), and between them the reference's reads: the bounds
    (only to derive top_dims), rt_total with e_total in one read,
    r2_total, and n_alive (params.compact). Every capacity that sizes a
    table is the reference's, so the tables are the same whichever way
    the spans run. caps: a warm session's capacities of its last build
    (updated here)."""
    caps = {} if caps is None else caps
    a, b, top_dims, levels = _top_and_cells(tris, params, top_dims, run,
                                            caps)
    c = run("merge", (top_dims, levels, params),
            functools.partial(_span_merge, a, b, top_dims=top_dims,
                              levels=levels, params=params),
            (), reads=a + b, fresh=False)
    cell_cap = _cell_capacity(_read(c[-1].item)) if params.compact else None
    d = run("finish", (top_dims, levels, params, cell_cap),
            functools.partial(_span_finish, a, c, top_dims=top_dims,
                              levels=levels, params=params,
                              cell_cap=cell_cap),
            (), reads=a + c, fresh=False)
    return _grid(a, d[:len(_CELLS)], top_dims, levels,
                 d[len(_CELLS):]).replace(tris=tris)


def build_irregular(tris: Triangles, params: BuildParams | None = None,
                    top_dims: tuple | None = None) -> IrregularGrid:
    params = params or BuildParams()
    # top_info packs res_log (at most params.levels + 1) into 3 bits.
    if not 0 <= params.levels <= 6:
        raise ValueError(f"BuildParams.levels must be in [0, 6], "
                         f"got {params.levels}")
    if tris.count == 0:
        return _empty_grid(tris)
    return build_spans(tris, params, top_dims)


def compact_cells(grid: IrregularGrid, cell_capacity: int) -> IrregularGrid:
    """Renumber alive cells densely and shrink the per-cell tables to
    `cell_capacity` rows, repointing entries. Relative cell order is
    kept, so ref_ids stay sorted by owner and cell_starts is a gather of
    the old boundaries (dead segments between alive cells are empty)."""
    alive = grid.alive
    order = cumsum_i32(alive.to(torch.int32)) - 1  # dense id per cell
    new_id = torch.where(alive, order, -1)
    perm, n_alive = compact_indices(alive)
    keep = perm[:cell_capacity]
    row = torch.arange(cell_capacity, dtype=torch.int32, device=alive.device)
    live = row < n_alive
    starts_new = torch.where(live, take(grid.cell_starts, keep),
                             grid.total_refs)
    starts_full = torch.cat([starts_new, grid.total_refs.reshape(1)]).to(
        torch.int32)
    return grid.replace(
        entries=take(new_id, grid.entries),
        cell_min=torch.where(live[:, None], take(grid.cell_min, keep), 0),
        cell_max=torch.where(live[:, None], take(grid.cell_max, keep), -1),
        cell_starts=starts_full,
        alive=live,
        preexpanded=live & take(grid.preexpanded, keep),
    )


def _pack_tables(grid: IrregularGrid) -> IrregularGrid:
    """The packed hot-path tables from the canonical arrays."""
    top_info = (grid.top_offset << 3) | grid.top_res_log
    cell = grid.entries
    starts = grid.cell_starts
    erec = torch.cat([
        take(grid.cell_min, cell), take(grid.cell_max, cell),
        take(starts, cell)[:, None], take(starts, cell + 1)[:, None]], dim=1)
    tid = grid.ref_ids.clamp(min=0)
    tris = grid.tris
    n = tid.shape[0]
    # The id rides as a float value (exact below 2^24 tris), not bits.
    idb = grid.ref_ids.to(torch.float32)
    pad = torch.zeros((n, 2), device=tid.device)
    ref_tris = torch.cat([take(tris.v0, tid), take(tris.e1, tid),
                          take(tris.e2, tid), idb[:, None], pad], dim=1)
    return grid.replace(top_info=top_info, erec=erec, ref_tris=ref_tris)


# --------------------------------------------------------------------------
# Traversal wrappers.
# --------------------------------------------------------------------------

def irregular_lookup(grid: IrregularGrid, voxel):
    """The wavefront's lookup protocol."""
    return grid.lookup(voxel)


def trace_irregular_fast(grid: IrregularGrid, rays, any_hit: bool = False,
                         coherent: bool = False):
    """Wavefront trace on the packed tables (ops/wavefront.trace): one
    launch of the march kernel on the card, the compacted rounds of the
    plain version on the CPU. coherent: camera-ordered rays (picks the
    kernel's refill threshold; no result changes)."""
    from ..ops import wavefront

    return wavefront.trace(grid, irregular_lookup, rays, any_hit=any_hit,
                           coherent=coherent)


def trace_irregular(grid: IrregularGrid, rays, refs_per_iter: int = 8,
                    any_hit: bool = False):
    """Wavefront traversal to completion. CUDA tensors: one launch of the
    march kernel on the packed tables (ops/wavefront.trace; its quad rows
    test 4 refs an iteration whatever refs_per_iter says, which changes
    the steps and not the hits). CPU tensors: the plain version,
    trace_wavefront's lockstep march through the generic lookup. Any
    other device raises."""
    from ..ops import wavefront

    if rays.org.device.type != "cpu":
        return wavefront.trace(grid, irregular_lookup, rays,
                               refs_per_iter=refs_per_iter, any_hit=any_hit)
    return wavefront.trace_wavefront(
        rays, grid.tris, grid.lookup, grid.cell_starts, grid.ref_ids,
        grid.bbox_lo, grid.bbox_hi, grid.fine_dims,
        refs_per_iter=refs_per_iter, any_hit=any_hit)
