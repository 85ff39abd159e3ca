"""Wavefront traversal (port of hagrid_tpu/ops/wavefront.py).

A ray marches through the grid one iteration at a time: each iteration it
either tests a chunk of its current cell's refs (Moller-Trumbore over the
chunk) or steps past the whole cell, leaving by the cell's integer bbox
(the irregular grid's "skip by cell, not voxel" rule). A ray's update
reads only that ray's state, and a dead ray is a fixed point: iterations
past a ray's end are no-ops, and the hits do not depend on how many run.

`trace` runs on each device as follows:
- CUDA tensors: one launch of the march kernel (csrc/wavefront.cu), in
  which persistent warps march every ray from its slab test to its end
  and refill their dead lanes with new rays; no rounds, no host read
  before the launch and one after it. `launches` counts its launches.
- CPU tensors: the plain version `trace_plain`, the reference's rounds:
  a segment of a capped number of lockstep iterations of torch ops
  (`segment_plain`), one read of the live count, a scatter of the batch's
  results and a compaction of the survivors into a power-of-two batch,
  so the cost follows the live rays and not the slowest one.
The two agree on the hits and steps of every ray that the safety cap
does not cut.

`trace_wavefront` (loose arrays, any lookup callable, no compaction) is
one lockstep loop of torch ops to completion, on any device: the plain
version of `grid.irregular.trace_irregular` and `grid.uniform.
trace_uniform`, which on CUDA tensors launch the march kernel through
`trace` instead.

Grid protocol: a grid exposes `.cell_starts`, `.ref_ids`, `.bbox_lo/hi`,
`.tris` and `.fine_dims`, and `lookup_fn(grid, voxel i32[N, 3]) -> (cell,
cmin, cmax)`. A grid with `is_packed` (the irregular grid) answers the
lookup from its packed `top_info`/`erec` tables and tests refs from
`ref_tris` rows instead.
"""

from __future__ import annotations

import ctypes
import warnings

import torch

from ..core.intersect import moller_trumbore, safe_inv_dir, slab_test
from ..core.types import Hits, Rays
from ..utils import profiling
from . import _build
from .segment import take, trunc_i32

_OUT_KEYS = ("best_t", "best_id", "best_u", "best_v", "steps")
# trace_wavefront's iterations between two reads of the live count.
_CHECK_EVERY = 16

# Kernel launches, counted where the kernel is launched.
launches = {"wavefront_march": 0}


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


def segment_plain(grid, lookup_fn, state: dict, refs_per_iter: int,
                  any_hit: bool, cap: int):
    """`cap` lockstep iterations of the body over the batch state (the
    reference's `_jit_segment`, which stops early once every ray is dead:
    a dead ray is a fixed point, so the state is the same). `steps` counts
    the iterations in which a ray was alive. Returns (new state, live
    count as an i32 tensor); the input state is not changed."""
    body = _make_body(grid, lookup_fn, refs_per_iter, any_hit)
    for _ in range(cap):
        steps = state["steps"] + state["alive"].to(torch.int32)
        state = body(state)
        state["steps"] = steps
    return state, state["alive"].sum(dtype=torch.int32)


# The kernel's lookups (csrc/wavefront.cu's kMode).
_QUAD, _ROWS, _UNIFORM = 0, 1, 2
# The march kernel's refill threshold, by the wave's coherence: a warp's
# empty lanes take new rays once fewer than this many of its 32 lanes are
# marching (32: every iteration a lane ends in; 1: only when the whole
# warp is done). Measured on the Sponza-scale waves (chip_smoke.py phase
# 12, PERF.md): a coherent warp loses its coherence to refilled lanes, so
# camera-ordered waves refill whole warps only; incoherent waves (an
# any-hit AO wave and a closest-hit path bounce alike) refill once a
# quarter of the lanes are done.
REFILL = {True: 1, False: 24}
_P, _I = ctypes.c_void_p, ctypes.c_int


class _MarchArgs(ctypes.Structure):
    """csrc/wavefront.cu's MarchArgs, field for field."""
    _fields_ = (
        [("n", _I), ("refs_per_iter", _I), ("no_tris", _I), ("refill", _I),
         ("dims", _I * 3), ("cap_base", _I), ("bbox_lo", _P),
         ("bbox_hi", _P), ("max_cell_refs", _P), ("top_info", _P),
         ("n_top", _I), ("n_erec", _I), ("n_ref_rows", _I), ("levels", _I),
         ("top_dims", _I * 3), ("pad0_", _I), ("erec", _P),
         ("ref_tris", _P), ("cell_starts", _P), ("ref_ids", _P),
         ("v0", _P), ("e1", _P), ("e2", _P), ("n_starts", _I),
         ("n_ref_ids", _I), ("n_tris", _I), ("pad1_", _I)]
        + [(k, _P) for k in ("org", "dir", "tmin", "tmax")]
        + [(k, _P) for k in ("t", "id", "u", "v", "steps")]
        + [("stats", _P), ("work", _P)])


def kernel_mode(grid, lookup_fn) -> int:
    """Which of the kernel's lookups serves (grid, lookup_fn): the packed
    irregular tables in quad rows (rows % 4 == 0) or per row, or the
    uniform grid's; anything else raises, naming the lookup."""
    if getattr(grid, "is_packed", False):
        return _QUAD if grid.ref_tris.shape[0] % 4 == 0 else _ROWS
    from ..grid.uniform import uniform_lookup
    if lookup_fn is uniform_lookup:
        return _UNIFORM
    raise ValueError(
        f"the wavefront kernel has no lookup "
        f"{getattr(lookup_fn, '__qualname__', lookup_fn)!r} for "
        f"{type(grid).__name__}: it serves the packed irregular grid and "
        f"grid.uniform.uniform_lookup")


def _table(x: torch.Tensor, dtype, dev, rows16: bool = False):
    """A tensor as the kernel reads it: contiguous, on `dev`, and with
    rows16 16-byte aligned (the kernel loads rows as 16-byte vectors)."""
    if x.dtype != dtype or x.device != dev:
        raise ValueError(f"a grid table is {x.dtype} on {x.device}, the "
                         f"kernel needs {dtype} on {dev}")
    x = x.contiguous()
    if rows16 and x.data_ptr() % 16:
        x = x.clone()
    return x


def march_args(grid, lookup_fn, rays: Rays, refs_per_iter: int,
               refill: int = REFILL[False], steps=None, work=None):
    """The march kernel's arguments for one trace, on the rays' device:
    (mode, MarchArgs, outputs {t, id, u, v, steps}, stats i64[4] (the ray
    counter, truncated rays, step total, hard cap), the tensors the
    arguments point into, which must outlive the launch). Checks the
    rays' and tables' types, shapes and devices and raises on what the
    kernel does not take; reads nothing from the device."""
    mode = kernel_mode(grid, lookup_fn)
    dev = rays.org.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the wavefront march runs on CUDA or CPU tensors, "
                         f"not {dev}")
    n = rays.count
    ins = {}
    for k in ("org", "dir", "tmin", "tmax"):
        x = getattr(rays, k)
        shape = (n, 3) if k in ("org", "dir") else (n,)
        if (x.dtype != torch.float32 or x.device != dev
                or tuple(x.shape) != shape):
            raise ValueError(f"rays.{k} must be float32{list(shape)} on "
                             f"{dev}, got {x.dtype}{list(x.shape)} on "
                             f"{x.device}")
        ins[k] = x.contiguous()
    if steps is None:
        steps = torch.empty((n,), dtype=torch.int32, device=dev)
    elif (steps.dtype != torch.int32 or steps.shape != (n,)
          or steps.device != dev or not steps.is_contiguous()):
        raise ValueError(f"steps must be a contiguous int32[{n}] on {dev}")
    if work is not None and (work.dtype != torch.int64
                             or work.shape != (5,) or work.device != dev):
        raise ValueError(f"work must be int64[5] on {dev}")
    if not 1 <= int(refill) <= 32:
        raise ValueError(f"refill must be in 1..32, got {refill}")
    outs = dict(t=torch.empty((n,), dtype=torch.float32, device=dev),
                id=torch.empty((n,), dtype=torch.int32, device=dev),
                u=torch.empty((n,), dtype=torch.float32, device=dev),
                v=torch.empty((n,), dtype=torch.float32, device=dev),
                steps=steps)
    stats = torch.zeros((4,), dtype=torch.int64, device=dev)
    starts = _table(grid.cell_starts, torch.int32, dev)
    max_refs = (starts[1:] - starts[:-1]).max()
    lo = _table(grid.bbox_lo, torch.float32, dev)
    hi = _table(grid.bbox_hi, torch.float32, dev)
    tris = grid.tris
    keep = [max_refs, lo, hi, stats, *ins.values(), *outs.values()]

    def ptr(x):
        keep.append(x)
        return x.data_ptr()

    dims = [int(d) for d in grid.fine_dims]
    a = _MarchArgs(n=n, refs_per_iter=int(refs_per_iter),
                   no_tris=int(tris.count == 0), refill=int(refill),
                   cap_base=8 * sum(dims) + 256, bbox_lo=lo.data_ptr(),
                   bbox_hi=hi.data_ptr(), max_cell_refs=max_refs.data_ptr(),
                   stats=stats.data_ptr(),
                   work=None if work is None else work.data_ptr())
    a.dims[:] = dims
    if mode == _UNIFORM:
        refs = _table(grid.ref_ids, torch.int32, dev)
        a.cell_starts, a.n_starts = ptr(starts), starts.shape[0]
        a.ref_ids, a.n_ref_ids = ptr(refs), refs.shape[0]
        a.n_tris = tris.count
        if tris.count:
            a.v0, a.e1, a.e2 = (ptr(_table(getattr(tris, k), torch.float32,
                                           dev)) for k in ("v0", "e1", "e2"))
    else:
        top = _table(grid.top_info, torch.int32, dev)
        erec = _table(grid.erec, torch.int32, dev, rows16=True)
        rows = _table(grid.ref_tris, torch.float32, dev, rows16=True)
        a.top_info, a.n_top = ptr(top), top.shape[0]
        a.erec, a.n_erec = ptr(erec), erec.shape[0]
        a.ref_tris, a.n_ref_rows = ptr(rows), rows.shape[0]
        a.levels = int(grid.levels)
        a.top_dims[:] = [int(d) for d in grid.top_dims]
    for k, x in ins.items():
        setattr(a, k, x.data_ptr())
    for k, x in outs.items():
        setattr(a, k, x.data_ptr())
    return mode, a, outs, stats, keep


def launch_march(mode, args, any_hit: bool, stream=None):
    """One launch of the march kernel's C entry point on `stream` (the
    current stream by default); raises on a CUDA error. Returns (blocks
    an SM, blocks launched). Counts no launch: `trace` does."""
    if stream is None:
        stream = torch.cuda.current_stream().cuda_stream
    grid = (_I * 2)()
    lib = _build.load()
    err = lib.hagrid_wavefront_march(ctypes.byref(args), mode, int(any_hit),
                                     _P(stream), grid)
    if err:
        raise RuntimeError(f"wavefront march kernel launch failed: "
                           f"{lib.hagrid_error_string(err).decode()}")
    return grid[0], grid[1]


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
#: Truncated rays summed over every trace since the process began or a
#: caller zeroed them (a workload of many traces reads it).
trace_totals = {"truncated_rays": 0}


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
    """One lockstep march to completion, no compaction: the plain version
    of trace_irregular and trace_uniform (the reference's compiled
    while_loop, op for op), which no kernel serves itself: its lookup is
    any callable `lookup(voxel) -> (cell, cmin, cmax)`. Whether a ray is
    still alive is read once every _CHECK_EVERY iterations (the hits do
    not depend on it). Records last_trace_stats (one round; the rays
    still marching when max_iters ran out, with a warning) in one more
    read."""
    g = _LooseGrid(cell_starts=starts, ref_ids=ref_ids, bbox_lo=bbox_lo,
                   bbox_hi=bbox_hi, tris=tris, fine_dims=tuple(fine_dims))

    def lookup_fn(_g, vox):
        return lookup(vox)

    if max_iters is None:
        max_iters = max_march_iters(fine_dims)
    state = _init_state(g, lookup_fn, rays)
    body = _make_body(g, lookup_fn, refs_per_iter, any_hit)
    steps = torch.zeros((rays.count,), dtype=torch.int32,
                        device=rays.org.device)
    it = 0
    while it < max_iters and bool(state["alive"].any()):
        for _ in range(min(_CHECK_EVERY, max_iters - it)):
            steps += state["alive"].to(torch.int32)
            state = body(state)
        it += _CHECK_EVERY
    truncated, step_total = torch.stack([
        state["alive"].sum(), steps.sum()]).tolist()
    _record(rays.count, truncated, 1, step_total, max_iters)
    return _hits(state["best_t"], state["best_id"], state["best_u"],
                 state["best_v"])


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _record(n: int, truncated: int, rounds: int, step_total: int,
            hard_cap: int):
    """last_trace_stats of a trace, and the warning of a cut one."""
    if truncated:
        warnings.warn(
            f"wavefront: safety cap {hard_cap} expired with "
            f"{truncated} rays still marching; their hit records are "
            f"partial (see ops/wavefront.last_trace_stats)")
    last_trace_stats["truncated_rays"] = truncated
    last_trace_stats["rounds"] = rounds
    last_trace_stats["mean_steps"] = float(step_total) / max(n, 1)
    trace_totals["truncated_rays"] += truncated
    profiling.count("march.steps", step_total)
    profiling.count("march.rays", n)


def trace_plain(grid, lookup_fn, rays: Rays, refs_per_iter: int = 2,
                any_hit: bool = False, round_iters: int = 16,
                min_batch: int = 8192, steps=None) -> Hits:
    """The march kernel's plain version: the reference's round-based
    compacted trace (host-orchestrated), on any device.

    Marches `round_iters` lockstep iterations (`segment_plain`), scatters
    results, compacts the survivors into the next power-of-two batch (at
    least `min_batch` rays), and doubles the cap once the batch stops
    shrinking; repeats until no ray is alive or the safety cap has run.
    Host reads: the largest cell's ref count once, the live count once a
    round, and the step total at the end. steps: optional int32[N] that
    receives each ray's marched iterations."""
    n = rays.count
    dev = rays.org.device
    state = _init_state(grid, lookup_fn, rays)
    state["steps"] = torch.zeros((n,), dtype=torch.int32, device=dev)
    out = {k: state[k].clone() for k in _OUT_KEYS}
    starts = grid.cell_starts
    max_cell_refs = int((starts[1:] - starts[:-1]).max())
    hard_cap = max_march_iters(grid.fine_dims, max_cell_refs, refs_per_iter)
    cap = round_iters
    size = n
    rounds = 0
    while True:
        rounds += 1
        state, live = segment_plain(grid, lookup_fn, state, refs_per_iter,
                                    any_hit, min(cap, hard_cap))
        idx = state["idx"].long()
        for k in _OUT_KEYS:
            out[k][idx] = state[k]
        live = int(live)
        if live == 0 or cap >= hard_cap:
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
    if steps is not None:
        steps.copy_(out["steps"])
    _record(n, live, rounds, int(out["steps"].sum()), hard_cap)
    return _hits(out["best_t"], out["best_id"], out["best_u"], out["best_v"])


def trace(grid, lookup_fn, rays: Rays, refs_per_iter: int = 2,
          any_hit: bool = False, round_iters: int = 16,
          min_batch: int = 8192, *, coherent: bool = False, steps=None,
          work=None) -> Hits:
    """Wavefront trace of `rays` through the grid: closest hit, or any
    hit.

    CUDA tensors: one launch of the march kernel (csrc/wavefront.cu),
    which marches every ray from its slab test to its end; the round
    arguments are not read. No host read before the launch, one after
    it (truncated rays, step total, hard cap); `rounds` is 1. CPU tensors:
    the plain version `trace_plain` (the reference's rounds). Any other
    device, or a lookup the kernel does not know, raises.
    coherent: the rays come in camera order (primaries); it picks the
    kernel's refill threshold (REFILL) and changes no result.
    steps: optional int32[N] that receives each ray's marched iterations.
    work: optional int64[5] on the card (zeroed), to which the kernel adds
    the refs it tested, the rows it gathered, the cell exits it computed,
    the cells it fetched and its warp iterations; the plain version counts
    no work.
    With tracing on (utils/profiling.py): span "march" around the launch
    (the plain version on the CPU), span "read.march" around the read,
    counters "march.steps" and "march.rays" from what the read returns."""
    dev = rays.org.device
    if dev.type == "cpu":
        if work is not None:
            raise ValueError("the plain version counts no work")
        with profiling.span("march"):
            return trace_plain(grid, lookup_fn, rays, refs_per_iter,
                               any_hit, round_iters, min_batch, steps=steps)
    mode, args, outs, stats, _keep = march_args(
        grid, lookup_fn, rays, refs_per_iter, refill=REFILL[bool(coherent)],
        steps=steps, work=work)
    if args.n:
        with profiling.span("march"):
            launch_march(mode, args, any_hit,
                         torch.cuda.current_stream(dev).cuda_stream)
        launches["wavefront_march"] += 1
        with profiling.span("read.march"):
            truncated, step_total, hard_cap = stats[1:].tolist()
    else:
        truncated = step_total = hard_cap = 0
    _record(args.n, truncated, 1, step_total, hard_cap)
    return Hits(tri_id=outs["id"], t=outs["t"], u=outs["u"], v=outs["v"])
