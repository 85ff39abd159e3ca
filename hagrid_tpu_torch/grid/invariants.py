"""Structural invariant checks over built grids (port of
hagrid_tpu/grid/invariants.py), for tests and debugging, never on the
frame path.

`check_packet` works on host copies of the packet grid's tables.
`check_uniform` and `check_irregular` are vectorized torch on the grid's
device: membership of a triangle in a cell's ref list is a binary search
of the key (cell << 32 | tri) among the grid's rows, which are sorted by
cell and, within a cell, by tri. `check_irregular` can check a random
sample of voxels and (tri, voxel) pairs instead of all of them, so that
it runs at Sponza scale (about 1.6e8 fine voxels).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.segment import rows_to_segments
from .irregular import IrregularGrid
from .packet import MT_COLS, PacketGrid
from .uniform import UniformGrid, tri_box_overlap, tri_voxel_ranges

_ID_COL = 16   # tri id within a ref's 20 coefficients (a float value)


def _np(x):
    return x.detach().cpu().numpy()


def check_packet(grid: PacketGrid, sample_tris: int | None = 4096,
                 seed: int = 0):
    """Vectorized invariants for the packet grid; raises AssertionError.

    1. rs tables are consistent ref maps: monotone within and across
       rows, within capacity, layout-offset aligned.
    2. Ref rows of `cols` carry valid triangle ids in every live span.
    3. Conservative completeness (sampled): every (tri, voxel) exact
       overlap has the tri's id somewhere in the voxel's row span.
    """
    r_cap = grid.ref_capacity
    # cols stores 128-lane group rows of 6 refs x 20 coefficients and 8 pad
    # lanes; lanes 16, 36, ..., 116 are the 6 tri ids, so the stride-20
    # slice yields exactly 6 per row and none from the pad lanes.
    ids_all = _np(grid.cols)[:, _ID_COL::MT_COLS].reshape(-1).astype(np.int32)
    n_tris = grid.tris.count
    rng = np.random.default_rng(seed)

    rs_flat = _np(grid.rs)
    rowinfo = _np(grid.rowinfo)
    blo, bhi = _np(grid.bbox_lo), _np(grid.bbox_hi)
    planes = _np(grid.planes)
    tlo3, thi3 = (_np(x) for x in grid.tris.bounds())
    v0h = _np(grid.tris.v0)
    v1h = v0h + _np(grid.tris.e1)
    v2h = v0h + _np(grid.tris.e2)
    cpu = torch.device("cpu")
    rbase = 0
    for a in range(3):
        da, db, dc = grid.dims3[a]
        nrows = da * db
        ri = rowinfo[rbase:rbase + nrows]
        rbase += nrows
        row_off = ri & 0x0FFFFFFF
        m_row = 1 << (ri >> 28)
        nc_row = m_row * dc

        # 1: structure of the ragged ref map: each row's table is
        # monotone, rows are contiguous, values layout-offset aligned
        # within capacity.
        ends = row_off + nc_row
        first = rs_flat[row_off] - a * r_cap
        last = rs_flat[ends] - a * r_cap
        assert first[0] == 0 and np.all(first >= 0) \
            and np.all(last <= r_cap)
        assert np.all(first[1:] == last[:-1]), \
            f"layout {a}: row spans not contiguous"
        for r in range(nrows):
            seg = rs_flat[row_off[r]:ends[r] + 1] - a * r_cap
            assert np.all(np.diff(seg) >= 0), \
                f"layout {a}: rs not monotone within row {r}"

        # 2: live spans carry valid ids.
        ids = ids_all[a * r_cap:(a + 1) * r_cap]
        total = int(last[-1])
        assert np.all(ids[:total] >= 0) and np.all(ids[:total] < n_tris)

        # 3: sampled completeness vs recomputed voxel ranges. The build
        # SAT-prunes (tri, cell) pairs, so membership is required only
        # where the exact overlap test passes for some cell of the row.
        # Slice-axis boundaries come from the plane table.
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        dims_xyz = [0, 0, 0]
        dims_xyz[a], dims_xyz[a1], dims_xyz[a2] = da, db, dc
        lo, hi = (_np(x).copy() for x in tri_voxel_ranges(
            grid.tris, grid.bbox_lo, grid.bbox_hi, tuple(dims_xyz)))
        P = planes[a, :da + 1]
        if da > 1:
            lo[:, a] = np.sum(tlo3[:, a:a + 1] >= P[None, 1:da], axis=1)
            hi[:, a] = np.sum(thi3[:, a:a + 1] >= P[None, 1:da], axis=1)
        cs = ((bhi - blo) / np.asarray(dims_xyz, np.float32)
              ).astype(np.float32)
        n_s = n_tris if sample_tris is None else min(n_tris, sample_tris)
        ts = rng.choice(n_tris, size=n_s, replace=False)
        row_sets = {}
        for t in ts:
            for k in range(lo[t, a], hi[t, a] + 1):
                for j in range(lo[t, a1], hi[t, a1] + 1):
                    ccols = np.arange(lo[t, a2], hi[t, a2] + 1)
                    vox = np.zeros((len(ccols), 3), np.float32)
                    vox[:, a], vox[:, a1], vox[:, a2] = k, j, ccols
                    clo = blo + vox * cs
                    chi = clo + cs
                    clo[:, a] = P[k]
                    chi[:, a] = P[min(k + 1, da)]
                    m = _np(tri_box_overlap(*(
                        torch.as_tensor(np.array(x), device=cpu)
                        for x in (np.broadcast_to(v0h[t], clo.shape),
                                  np.broadcast_to(v1h[t], clo.shape),
                                  np.broadcast_to(v2h[t], clo.shape),
                                  clo, chi))))
                    if not m.any():
                        continue
                    r = k * db + j
                    # Column-trimmed membership at fine granularity: the
                    # tracer gathers ids[rs[off+c0]:rs[off+c1+1]] over the
                    # row's columns, so the tri must sit in every fine
                    # column its c-extent covers within each SAT-positive
                    # base cell.
                    mr = int(m_row[r])
                    ro = int(row_off[r])
                    tcmin = min(v0h[t, a2], v1h[t, a2], v2h[t, a2])
                    tcmax = max(v0h[t, a2], v1h[t, a2], v2h[t, a2])
                    icf = np.float32(mr) / cs[a2]
                    for c in ccols[m]:
                        fl = int(np.clip(
                            np.floor((tcmin - blo[a2]) * icf),
                            c * mr, c * mr + mr - 1))
                        fh = int(np.clip(
                            np.floor((tcmax - blo[a2]) * icf),
                            fl, c * mr + mr - 1))
                        for fc in range(fl, fh + 1):
                            key = (r, fc)
                            if key not in row_sets:
                                row_sets[key] = set(
                                    ids[rs_flat[ro + fc] - a * r_cap:
                                        rs_flat[ro + fc + 1] - a * r_cap
                                        ].tolist())
                            assert int(t) in row_sets[key], \
                                f"layout {a}: tri {t} missing from " \
                                f"row {r} fine column {fc}"


def _box_voxels(lo, hi, sample, gen):
    """(owner box index, voxel i32[., 3]) for every voxel of the
    inclusive boxes lo/hi i32[B, 3], x fastest; or for `sample` of them
    drawn uniformly (with replacement) when there are more."""
    span = (hi - lo + 1).clamp(min=0).to(torch.int64)
    counts = span[:, 0] * span[:, 1] * span[:, 2]
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if ends.numel() else 0
    dev = lo.device
    if sample is None or sample >= total:
        j = torch.arange(total, device=dev)
    else:
        j = torch.randint(0, total, (sample,), generator=gen,
                          device="cpu").to(dev)
    src = torch.searchsorted(ends, j, right=True)
    rank = j - (ends[src] - counts[src])
    s = span[src]
    dx = rank % s[:, 0]
    rem = rank // s[:, 0]
    vox = torch.stack([dx, rem % s[:, 1], rem // s[:, 1]], -1)
    return src, (lo[src].to(torch.int64) + vox).to(torch.int32)


def _row_keys(starts, refs, total):
    """Sorted int64 keys (cell << 32 | tri) of the live ref rows, and
    each row's cell."""
    cell = rows_to_segments(starts, total)
    return (cell.to(torch.int64) << 32) | refs[:total].to(torch.int64), cell


def _member(keys, cell, tri):
    """bool: tri is in cell's ref list."""
    q = (cell.to(torch.int64) << 32) | tri.to(torch.int64)
    pos = torch.searchsorted(keys, q).clamp(max=max(keys.numel() - 1, 0))
    return (keys.numel() > 0) & (keys[pos] == q)


def _check_ref_rows(starts, refs, total, n_tris, cells=None):
    """Segment starts monotone from 0 to total, live ids in range, and
    each cell's list sorted and unique (within the given live cells)."""
    assert int(starts[0]) == 0 and int(starts[-1]) == total, \
        "cell_starts do not span the live refs"
    assert bool((starts[1:] >= starts[:-1]).all()), "cell_starts not monotone"
    live = refs[:total]
    assert bool(((live >= 0) & (live < n_tris)).all()), "ref id out of range"
    keys, cell = _row_keys(starts, refs, total)
    inc = keys[1:] > keys[:-1]
    if cells is not None:
        inc |= ~cells[cell[1:]]
    assert bool(inc.all()), "a cell's refs are not sorted and unique"
    return keys


def check_uniform(grid: UniformGrid) -> None:
    """Ref buffer within capacity, monotone starts, ids in range, every
    cell's list sorted and unique, and conservative completeness: every
    triangle is in every cell of its voxel range."""
    refs = grid.ref_ids
    total = int(grid.total_refs)
    assert total <= refs.shape[0], "ref buffer overflow"
    keys = _check_ref_rows(grid.cell_starts, refs, total, grid.tris.count)
    assert bool((refs[total:] == -1).all())
    lo, hi = tri_voxel_ranges(grid.tris, grid.bbox_lo, grid.bbox_hi,
                              grid.dims)
    tri, vox = _box_voxels(lo, hi, None, None)
    dx, dy, _ = grid.dims
    cell = (vox[:, 2] * dy + vox[:, 1]) * dx + vox[:, 0]
    ok = _member(keys, cell, tri)
    assert bool(ok.all()), \
        f"tri {int(tri[~ok][0])} missing from cell {int(cell[~ok][0])}"


def check_irregular(grid: IrregularGrid, sample: int | None = None,
                    seed: int = 0) -> None:
    """Invariants that make irregular-grid traversal correct:
    1. every fine voxel is owned by an alive cell whose bbox contains it;
    2. conservative completeness: a tri overlapping voxel v is in the ref
       list of v's owner;
    3. expansion safety: every voxel inside a cell's (possibly expanded)
       bbox is owned by that cell or by a cell whose refs are a subset of
       the cell's own;
    4. per-cell ref lists are sorted, unique and in range.
    sample: None checks every voxel, (tri, voxel) pair and (cell, voxel
    in its bbox) pair, as the reference does; a number checks that many
    of each, drawn at random from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    dev = grid.cell_min.device
    fine = torch.tensor(grid.fine_dims, dtype=torch.int32, device=dev)
    alive = grid.alive
    starts = grid.cell_starts
    total = int(grid.total_refs)
    n_refs = (starts[1:] - starts[:-1])[:alive.shape[0]]

    # 4, with the row keys that the membership tests search.
    keys = _check_ref_rows(starts, grid.ref_ids, total, grid.tris.count,
                           cells=alive)

    # 1: owners alive, owner bbox contains the voxel.
    zero = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    _, vox = _box_voxels(zero, fine[None] - 1, sample, gen)
    owner, cmin_o, cmax_o = grid.lookup(vox)
    assert bool(alive[owner.long()].all()), "voxel owned by dead cell"
    assert bool(((cmin_o <= vox) & (vox <= cmax_o)).all()), \
        "owner bbox does not contain voxel"

    # 2: completeness against recomputed fine ranges.
    lo, hi = tri_voxel_ranges(grid.tris, grid.bbox_lo, grid.bbox_hi,
                              grid.fine_dims)
    tri, vox = _box_voxels(lo, hi, sample, gen)
    owner = grid.lookup(vox)[0]
    ok = _member(keys, owner, tri)
    assert bool(ok.all()), \
        f"tri {int(tri[~ok][0])} missing from owner cell " \
        f"{int(owner[~ok][0])} of voxel {vox[~ok][0].tolist()}"

    # 3: a foreign cell inside a cell's bbox has a subset of its refs.
    cells = torch.nonzero(alive).flatten()
    src, vox = _box_voxels(grid.cell_min[cells], grid.cell_max[cells],
                           sample, gen)
    c = cells[src]
    o = grid.lookup(vox)[0].long()
    foreign = o != c
    c, o = c[foreign], o[foreign]
    # Expand each pair's foreign refs into rows (pair, tri).
    cnt = n_refs[o].to(torch.int64)
    ends = torch.cumsum(cnt, 0)
    j = torch.arange(int(ends[-1]) if ends.numel() else 0, device=dev)
    pair = torch.searchsorted(ends, j, right=True)
    row = starts[o[pair]].to(torch.int64) + (j - (ends[pair] - cnt[pair]))
    ok = _member(keys, c[pair], grid.ref_ids[row])
    assert bool(ok.all()), \
        f"cell {int(c[pair][~ok][0])} bbox covers foreign cell " \
        f"{int(o[pair][~ok][0])} whose ref {int(grid.ref_ids[row][~ok][0])}" \
        f" is not in its own list"
