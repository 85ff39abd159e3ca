"""Step-synchronous wavefront traversal with ray compaction (port of
hagrid_tpu/ops/wavefront.py).

All rays advance in lockstep on masked tensors: each iteration every live
ray either tests a chunk of its current cell's refs (Moller-Trumbore over
the chunk) or steps past the whole cell, leaving by the cell's integer
bbox (the irregular grid's "skip by cell, not voxel" rule). Every update
is masked by `alive`, so a dead ray never changes: iterations past a
ray's end are no-ops, and the hits do not depend on how many run.

`trace` runs in rounds: a capped number of iterations with no host read,
one read of the live count, a scatter of the batch's results and a
compaction of the survivors into a power-of-two batch, so the cost
follows the live rays and not the slowest one.

Grid protocol: a grid exposes `.cell_starts`, `.ref_ids`, `.bbox_lo/hi`,
`.tris` and `.fine_dims`, and `lookup_fn(grid, voxel i32[N, 3]) -> (cell,
cmin, cmax)`. A grid with `is_packed` (the irregular grid) answers the
lookup from its packed `top_info`/`erec` tables and tests refs from
`ref_tris` rows instead.
"""

from __future__ import annotations

import warnings

import torch

from ..core.intersect import moller_trumbore, safe_inv_dir, slab_test
from ..core.types import Hits, Rays
from .segment import take, trunc_i32

_OUT_KEYS = ("best_t", "best_id", "best_u", "best_v", "steps")
# trace_wavefront's iterations between two reads of the live count.
_CHECK_EVERY = 16


def _geometry(grid):
    """(fine dims i32[3], cell size f32[3]) on the grid's device."""
    dev = grid.bbox_lo.device
    dims = torch.tensor(grid.fine_dims, dtype=torch.int32, device=dev)
    cs = (grid.bbox_hi - grid.bbox_lo) / dims.to(torch.float32)
    return dims, cs


def _load_cell(grid, lookup_fn, voxel, in_bounds):
    """Masked cell fetch: (cmin, cmax, first ref, end ref); rays out of
    bounds get an empty range. Packed grids answer with two row gathers:
    the top cell's word (offset << 3 | res_log) and the entry's record
    [cmin, cmax, start, end]. A voxel past the grid's end indexes past
    the tables, so every gather clamps (`take`)."""
    safe_vox = voxel.clamp(min=0)
    if getattr(grid, "is_packed", False):
        lv = grid.levels
        top = safe_vox >> lv
        tdx, tdy, _ = grid.top_dims
        tidx = (top[:, 2] * tdy + top[:, 1]) * tdx + top[:, 0]
        info = take(grid.top_info, tidx)
        r = info & 7
        off = info >> 3
        local = (safe_vox & ((1 << lv) - 1)) >> (lv - r)[:, None]
        side = torch.ones_like(r) << r
        sub = (local[:, 2] * side + local[:, 1]) * side + local[:, 0]
        rec = take(grid.erec, off + sub)
        s0 = torch.where(in_bounds, rec[:, 6], 0)
        s1 = torch.where(in_bounds, rec[:, 7], 0)
        return rec[:, 0:3], rec[:, 3:6], s0, s1
    cell, cmin, cmax = lookup_fn(grid, safe_vox)
    starts = grid.cell_starts
    s0 = torch.where(in_bounds, take(starts, cell), 0)
    s1 = torch.where(in_bounds, take(starts, cell + 1), 0)
    return cmin, cmax, s0, s1


def _init_state(grid, lookup_fn, rays: Rays) -> dict:
    n = rays.count
    dev = rays.org.device
    dims, cs = _geometry(grid)
    inv_dir = safe_inv_dir(rays.dir)
    enter, _, ok = slab_test(rays.org, inv_dir, grid.bbox_lo, grid.bbox_hi,
                             rays.tmin, rays.tmax)
    p_in = rays.org + enter[:, None] * rays.dir
    vox0 = trunc_i32(torch.floor((p_in - grid.bbox_lo) / cs))
    vox0 = torch.minimum(vox0.clamp(min=0), dims - 1)
    cmin0, cmax0, s00, s10 = _load_cell(grid, lookup_fn, vox0, ok)
    return dict(
        alive=ok, cursor=s00, end=s10, cmin=cmin0, cmax=cmax0,
        t_cur=torch.maximum(enter, rays.tmin),
        org=rays.org, dir=rays.dir, tmin=rays.tmin, tmax=rays.tmax,
        idx=torch.arange(n, dtype=torch.int32, device=dev),
        best_t=torch.full((n,), float("inf"), device=dev),
        best_id=torch.full((n,), -1, dtype=torch.int32, device=dev),
        best_u=torch.zeros((n,), device=dev),
        best_v=torch.zeros((n,), device=dev),
    )


def _make_body(grid, lookup_fn, refs_per_iter: int, any_hit: bool):
    dims, cs = _geometry(grid)
    inv_cs = 1.0 / cs
    tris = grid.tris
    ref_ids = grid.ref_ids
    packed = getattr(grid, "is_packed", False)
    no_tris = tris.count == 0  # an empty scene has nothing to test
    quad_ok = packed and grid.ref_tris.shape[0] % 4 == 0
    if quad_ok:
        quads = grid.ref_tris.reshape(-1, 48)  # a view: R_cap % 4 == 0
    lo = grid.bbox_lo

    def body(st: dict) -> dict:
        org, dirs = st["org"], st["dir"]
        tmin, tmax = st["tmin"], st["tmax"]
        inv_dir = safe_inv_dir(dirs)
        pos_dir = dirs >= 0
        alive = st["alive"]
        cursor = st["cursor"]
        end = st["end"]

        # Phase 1: a masked chunk of Moller-Trumbore tests.
        def mt_update(m, tid, v0, e1, e2, best):
            bt, bid, bu, bv = best
            tid = torch.where(m, tid, 0)
            h, t, u, v = moller_trumbore(org, dirs, v0, e1, e2, tmin, tmax)
            better = m & h & ((t < bt) | ((t == bt) & (tid < bid)))
            return (torch.where(better, t, bt), torch.where(better, tid, bid),
                    torch.where(better, u, bu), torch.where(better, v, bv))

        best = (st["best_t"], st["best_id"], st["best_u"], st["best_v"])
        if no_tris:
            pass
        elif quad_ok:
            # Quad rows: one 48-wide row gather serves 4 triangle tests.
            qidx = torch.minimum(cursor >> 2,
                                 torch.full_like(cursor, quads.shape[0] - 1))
            qrow = take(quads, torch.where(alive, qidx, 0))
            base = qidx << 2
            for k in range(4):
                ridx = base + k
                m = alive & (ridx >= cursor) & (ridx < end)
                row = qrow[:, k * 12:k * 12 + 12]
                best = mt_update(m, row[:, 9].to(torch.int32), row[:, 0:3],
                                 row[:, 3:6], row[:, 6:9], best)
            cursor = torch.where(alive, torch.minimum(base + 4, end), cursor)
        else:
            for k in range(refs_per_iter):
                r = cursor + k
                m = alive & (r < end)
                rm = torch.where(m, r, 0)
                if packed:  # per-row packed path (odd-capacity tables)
                    row = take(grid.ref_tris, rm)
                    best = mt_update(m, row[:, 9].to(torch.int32),
                                     row[:, 0:3], row[:, 3:6], row[:, 6:9],
                                     best)
                else:
                    tid = take(ref_ids, rm)
                    safe = torch.where(m, tid, 0)
                    best = mt_update(m, tid, take(tris.v0, safe),
                                     take(tris.e1, safe),
                                     take(tris.e2, safe), best)
            cursor = torch.minimum(cursor + refs_per_iter, end)
        best_t, best_id, best_u, best_v = best

        # Phase 2: rays whose cell is exhausted step past the cell.
        finished_cell = alive & (cursor >= end)
        t_cur = st["t_cur"]
        cmin_o, cmax_o = st["cmin"], st["cmax"]
        hi_plane = lo + (cmax_o + 1).to(torch.float32) * cs
        lo_plane = lo + cmin_o.to(torch.float32) * cs
        t_axes = torch.where(pos_dir, (hi_plane - org) * inv_dir,
                             (lo_plane - org) * inv_dir)
        t_axes = torch.where(dirs != 0.0, t_axes, float("inf"))
        # Only exit planes ahead of the ray's march: expanded cells
        # overlap, so a cell entered by clamping can have exit planes the
        # ray already crossed, and going back to one makes two cells
        # ping-pong. t stays monotone; the voxel is re-derived from the
        # true position.
        t_ahead = torch.where(t_axes > t_cur[:, None], t_axes, float("inf"))
        t_exit, axis = torch.min(t_ahead, dim=-1)
        has_ahead = torch.isfinite(t_exit)
        # Degenerate fallback (outside the bbox on every axis): nudge t
        # forward and resolve the true voxel, no jump.
        t_step = torch.where(has_ahead, t_exit, t_cur * 1.000001 + 1e-5)

        terminated = (best_id >= 0) if any_hit else (best_t <= t_step)
        terminated = terminated | (t_step >= tmax)

        # Next voxel: jump past the cell bbox on the exit axis; the other
        # axes come from the ray point at t_step, clamped into the bbox.
        p_exit = org + t_step[:, None] * dirs
        vox_true = trunc_i32(torch.floor((p_exit - lo) * inv_cs))
        vox_in = torch.minimum(torch.maximum(vox_true, cmin_o), cmax_o)
        jump = torch.where(pos_dir, cmax_o + 1, cmin_o - 1)
        onehot = axis[:, None] == torch.arange(3, device=axis.device)
        vox_in = torch.where(onehot, jump, vox_in)
        vox = torch.where(has_ahead[:, None], vox_in, vox_true)
        in_bounds = ((vox >= 0) & (vox < dims)).all(dim=-1)

        advance = finished_cell & ~terminated & in_bounds
        cmin, cmax, s0, s1 = _load_cell(grid, lookup_fn, vox, advance)
        out = dict(st)
        out.update(
            alive=alive & torch.where(finished_cell, advance, True),
            cursor=torch.where(advance, s0, cursor),
            end=torch.where(advance, s1, end),
            cmin=torch.where(advance[:, None], cmin, cmin_o),
            cmax=torch.where(advance[:, None], cmax, cmax_o),
            t_cur=torch.where(advance, t_step, t_cur),
            best_t=best_t, best_id=best_id, best_u=best_u, best_v=best_v)
        return out

    return body


def max_march_iters(fine_dims, max_refs_per_cell: int = 0,
                    refs_per_iter: int = 4) -> int:
    """Upper bound on one ray's march length (safety cap). Each iteration
    steps one cell or tests one ref chunk, so the cap grows with the
    largest cell, which a ray alone takes refs/refs_per_iter iterations
    to test."""
    return (8 * int(sum(fine_dims)) + 256
            + 8 * (int(max_refs_per_cell) // max(refs_per_iter, 1)))


#: What the last `trace` call saw: rays still alive when the safety cap
#: expired (0 in healthy runs), rounds, and mean marched steps per ray.
last_trace_stats = {"truncated_rays": 0, "rounds": 0, "mean_steps": 0.0}


def _hits(best_t, best_id, best_u, best_v) -> Hits:
    found = best_id >= 0
    return Hits(tri_id=best_id,
                t=torch.where(found, best_t, float("inf")),
                u=best_u, v=best_v)


class _LooseGrid:
    """The loose-array interface of trace_wavefront as a grid."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def trace_wavefront(rays: Rays, tris, lookup, starts, ref_ids, bbox_lo,
                    bbox_hi, fine_dims, refs_per_iter: int = 8,
                    any_hit: bool = False,
                    max_iters: int | None = None) -> Hits:
    """One lockstep march to completion, no compaction: the simple path
    of the tests and small workloads. Whether a ray is still alive is
    read once every _CHECK_EVERY iterations (the hits do not depend on
    it)."""
    g = _LooseGrid(cell_starts=starts, ref_ids=ref_ids, bbox_lo=bbox_lo,
                   bbox_hi=bbox_hi, tris=tris, fine_dims=tuple(fine_dims))

    def lookup_fn(_g, vox):
        return lookup(vox)

    if max_iters is None:
        max_iters = max_march_iters(fine_dims)
    state = _init_state(g, lookup_fn, rays)
    body = _make_body(g, lookup_fn, refs_per_iter, any_hit)
    it = 0
    while it < max_iters and bool(state["alive"].any()):
        for _ in range(min(_CHECK_EVERY, max_iters - it)):
            state = body(state)
        it += _CHECK_EVERY
    return _hits(state["best_t"], state["best_id"], state["best_u"],
                 state["best_v"])


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def trace(grid, lookup_fn, rays: Rays, refs_per_iter: int = 2,
          any_hit: bool = False, round_iters: int = 16,
          min_batch: int = 8192) -> Hits:
    """Round-based compacted wavefront trace (host-orchestrated).

    Marches `round_iters` lockstep iterations, scatters results, compacts
    the survivors into the next power-of-two batch (at least `min_batch`
    rays), and doubles the cap once the batch stops shrinking; repeats
    until no ray is alive. Host reads: the largest cell's ref count once,
    the live count once a round, and the step total at the end.
    """
    n = rays.count
    dev = rays.org.device
    state = _init_state(grid, lookup_fn, rays)
    state["steps"] = torch.zeros((n,), dtype=torch.int32, device=dev)
    out = {k: state[k].clone() for k in _OUT_KEYS}
    starts = grid.cell_starts
    max_cell_refs = int((starts[1:] - starts[:-1]).max())
    hard_cap = max_march_iters(grid.fine_dims, max_cell_refs, refs_per_iter)
    body = _make_body(grid, lookup_fn, refs_per_iter, any_hit)
    cap = round_iters
    size = n
    rounds = 0
    while True:
        rounds += 1
        for _ in range(min(cap, hard_cap)):
            steps = state["steps"] + state["alive"].to(torch.int32)
            state = body(state)
            state["steps"] = steps
        idx = state["idx"].long()
        for k in _OUT_KEYS:
            out[k][idx] = state[k]
        live = int(state["alive"].sum())
        if live == 0 or cap >= hard_cap:
            if live:
                warnings.warn(
                    f"wavefront.trace: safety cap {hard_cap} expired with "
                    f"{live} rays still marching; their hit records are "
                    f"partial (see ops/wavefront.last_trace_stats)")
            break
        new_size = min(max(_pow2_at_least(live), min_batch), size)
        if new_size < size:
            # Still shrinking: keep rounds short so the batch tracks the
            # live count; grow the cap once compaction stalls.
            perm = torch.sort((~state["alive"]).to(torch.int8),
                              stable=True).indices[:new_size]
            state = {k: v[perm] for k, v in state.items()}
            size = new_size
        else:
            cap *= 2
    last_trace_stats["truncated_rays"] = live
    last_trace_stats["rounds"] = rounds
    last_trace_stats["mean_steps"] = float(out["steps"].sum()) / max(n, 1)
    return _hits(out["best_t"], out["best_id"], out["best_u"], out["best_v"])
