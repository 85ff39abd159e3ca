"""Structural invariant checks over built packet grids (port of
hagrid_tpu/grid/invariants.py::check_packet): numpy on host copies of the
grid's tables, for tests and debugging, never on the frame path.
"""

from __future__ import annotations

import numpy as np
import torch

from .packet import MT_COLS, PacketGrid
from .uniform import tri_box_overlap, tri_voxel_ranges

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
