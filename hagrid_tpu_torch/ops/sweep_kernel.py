"""The sweep kernel: every ray tile against its run of gathered 768-ref
blocks, closest hit or any hit (CUDA: csrc/sweep.cu; replaces the TPU
kernels hagrid_tpu/ops/sweep_trace.py::_make_kernel and ::_make_kernel_dma
and their any_hit=True instances).

Inputs, as the planner (ops/sweep_trace.py) emits them:
- xt f32[16, n_cols]: the rays' X matrix transposed (rows: 1, o, d,
  m = o x d, 0, 0, tmin, tmax, seed best t, 0); n_cols = (nt + 1) * tile,
  the last tile a dummy.
- cols f32[R, 128]: the grid's group rows; a gather unit is 4 rows.
- gidx i32[n_blocks * 32]: unit indices, 32 units (768 refs) per block.
- tile_of i32[n_blocks]: owning tile per block, ascending; nt marks an
  unused block.
- tminb i32[n_blocks]: f32 bit pattern of the block's early-out
  threshold: a block is skipped when every ray's best t is <= it.

Output (t f32, id i32, u f32, v f32), each [n_cols]: per ray of every tile
with at least one block, the best hit better than its seed (t = BIG,
id = -1, u = v = 0 where none). Ties on t go to the smaller id.

any_hit=True also requires t < tmax (xt row 13) of every accepted pair;
the planner then seeds the raw best and gives every block the threshold
just below BIG, so the kernel stops sweeping a tile once all its rays hit.
Its hit/miss equals the plain version's exactly; the t and id it keeps
are those of the closest hit among the blocks it swept, which may lie
behind the ray's closest hit.

`sweep_blocks` runs the CUDA kernel for CUDA tensors and the plain
version `sweep_blocks_plain` for CPU tensors; it counts kernel launches
per instance in `launches` ("sweep_blocks" closest hit,
"sweep_blocks_anyhit" any hit; a launch that a graph captured counts
at each replay of the graph). On the card each call is one C call that
launches three kernels: a plan kernel cuts each tile's run of blocks into
chunks of at most C blocks (`chunk_plan`; sized from shapes, no host
read), the sweep runs one CTA a chunk, and a resolve pass merges the
chunks of a split tile per ray by the plain version's (t, id) key, so the
result is the same function.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count_launch
from . import _build
from ._build import raise_on

UNIT_ROWS = 4          # group rows of `cols` per gather unit
UNITS_PER_BLOCK = 32   # gather units per 768-ref block
_REFS_PER_ROW = 6
_COEFS = 20
_BIG = 3e38
_KEY_NONE = torch.iinfo(torch.int64).max
_PAIRS_PER_CHUNK = 1 << 23   # ray-ref pairs the plain version holds at once
# The kernel's work split (chunk_blocks): the fewest blocks of a chunk, and
# the chunks a full budget is cut into.
MIN_CHUNK = 16
CHUNK_TARGET = 16384
PLAN_BINS = 64   # the plan kernel's size classes (kPlanBins)

# Kernel launches per instance, counted where the kernel is launched; a
# launch inside a captured graph counts at every replay
# (utils/profiling.count_launch).
launches = {"sweep_blocks": 0, "sweep_blocks_anyhit": 0}


def _check(xt, cols, gidx, tile_of, tminb, tile):
    if xt.dtype != torch.float32 or cols.dtype != torch.float32:
        raise TypeError("xt and cols must be float32")
    for name, x in (("gidx", gidx), ("tile_of", tile_of), ("tminb", tminb)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if xt.dim() != 2 or xt.shape[0] != 16 or xt.shape[1] % tile:
        raise ValueError(f"xt must be [16, k*{tile}], got {tuple(xt.shape)}")
    if cols.dim() != 2 or cols.shape[1] != 128 or cols.shape[0] % UNIT_ROWS:
        raise ValueError(f"cols must be [4k, 128], got {tuple(cols.shape)}")
    nb = tile_of.shape[0]
    if gidx.shape != (nb * UNITS_PER_BLOCK,) or tminb.shape != (nb,):
        raise ValueError("gidx/tminb do not match tile_of's block count")
    devs = {x.device for x in (xt, cols, gidx, tile_of, tminb)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return xt.shape[1] // tile - 1


def _empty_out(n_cols, device):
    """Outputs before the sweep: t = BIG, id = -1, u = v = 0."""
    return (torch.full((n_cols,), _BIG, dtype=torch.float32, device=device),
            torch.full((n_cols,), -1, dtype=torch.int32, device=device),
            torch.zeros((n_cols,), dtype=torch.float32, device=device),
            torch.zeros((n_cols,), dtype=torch.float32, device=device))


def _ordered(bits: torch.Tensor) -> torch.Tensor:
    """f32 bit patterns -> i32 keys with the floats' total order (an
    involution: applying it twice gives the bits back)."""
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def sweep_blocks_plain(xt, cols, gidx, tile_of, tminb, tile, any_hit=False):
    """Plain PyTorch version: gather each block's refs, dense
    Moller-Trumbore in the kernel's linear form (same formulas, same
    acceptance), lexicographic (t, id) min per ray over the tile's
    blocks. Ignores the early-out, which for closest hit can only change
    a result on an exact-t tie at a block's threshold; for any hit it
    returns each ray's closest hit in (tmin, tmax)."""
    nt = _check(xt, cols, gidx, tile_of, tminb, tile)
    n_cols = xt.shape[1]
    dev = xt.device
    out_t, out_id, out_u, out_v = _empty_out(n_cols, dev)
    blocks = torch.nonzero(tile_of < nt).reshape(-1)
    if blocks.numel() == 0:
        return out_t, out_id, out_u, out_v
    units = cols.reshape(-1, UNIT_ROWS * 128)
    lanes = torch.arange(tile, device=dev)
    chunk = max(1, _PAIRS_PER_CHUNK // (128 * _REFS_PER_ROW * tile))
    keys, us, vs = [], [], []
    for s in range(0, blocks.numel(), chunk):
        blk = blocks[s:s + chunk]
        nb = blk.numel()
        ray = (tile_of[blk].long()[:, None] * tile + lanes).reshape(-1)
        X = xt[:, ray].reshape(16, nb, 1, tile)
        ox, oy, oz, dx, dy, dz, mx, my, mz = X[1:10]
        tmin, tmax, seed = X[12], X[13], X[14]
        ui = gidx.reshape(-1, UNITS_PER_BLOCK)[blk].long()
        g = units[ui].reshape(nb, 128, 128)[:, :, :_REFS_PER_ROW * _COEFS]
        g = g.reshape(nb, 128 * _REFS_PER_ROW, _COEFS, 1)
        (n0, n1, n2, b0, b1, b2, c0, c1, c2, d0, d1, d2, e0, e1, e2, f,
         idf) = g.unbind(2)[:17]
        det = dx * n0 + dy * n1 + dz * n2
        tt = f - (ox * n0 + oy * n1 + oz * n2)
        uu = mx * b0 + my * b1 + mz * b2 + dx * c0 + dy * c1 + dz * c2
        vv = mx * d0 + my * d1 + mz * d2 + dx * e0 + dy * e1 + dz * e2
        inv = 1.0 / det
        t = tt * inv
        u = uu * inv
        v = vv * inv
        edge = torch.minimum(torch.minimum(u, v), 1.0 - (u + v))
        ok = (edge >= 0.0) & (det.abs() > 1e-12) & (t > tmin) & (t < seed)
        if any_hit:
            ok = ok & (t < tmax)
        key = (_ordered(t.view(torch.int32)).to(torch.int64) << 32) \
            + idf.to(torch.int64)
        key = torch.where(ok, key, _KEY_NONE)
        kmin, arg = key.min(dim=1)                  # (nb, tile)
        keys.append(kmin)
        us.append(torch.gather(u, 1, arg[:, None])[:, 0])
        vs.append(torch.gather(v, 1, arg[:, None])[:, 0])
    kmin = torch.cat(keys)
    owner = tile_of[blocks].long()
    best = torch.full((nt, tile), _KEY_NONE, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, owner[:, None].expand(-1, tile), kmin, "amin")
    found = best != _KEY_NONE
    t_bits = _ordered((best >> 32).to(torch.int32))
    tiles = slice(0, nt * tile)
    out_t[tiles] = torch.where(found, t_bits.view(torch.float32),
                               _BIG).reshape(-1)
    out_id[tiles] = torch.where(found, (best & 0xFFFFFFFF).to(torch.int32),
                                -1).reshape(-1)
    # u, v of the winning pair: every block row whose key equals its
    # tile's best holds the same (t, id) and therefore the same u, v.
    win = (kmin == best[owner]) & (kmin != _KEY_NONE)
    ray = (owner[:, None] * tile + lanes)[win]
    out_u[ray] = torch.cat(us)[win]
    out_v[ray] = torch.cat(vs)[win]
    return out_t, out_id, out_u, out_v


def chunk_blocks(n_blocks: int) -> int:
    """C, the most stream blocks one CTA sweeps, from the budget alone
    (no read of the device): at least MIN_CHUNK, so that coherent waves'
    short runs (at most 8 blocks on the primary stream) stay whole, and
    otherwise so that a full budget makes about CHUNK_TARGET chunks."""
    return max(MIN_CHUNK, -(-n_blocks // CHUNK_TARGET))


def plan_rows(nt: int, n_blocks: int, chunk: int) -> int:
    """Rows of the launch plan, an upper bound on the chunk count from
    shapes alone: nt + ceil(n_blocks / chunk)."""
    return nt + -(-n_blocks // chunk)


def chunk_plan_plain(tile_of, nt: int, chunk: int):
    """Plain version of the plan kernel (csrc/sweep_shell.cuh
    plan_kernel): each tile's run of blocks cut into run // chunk full
    chunks and, if run % chunk > 0, a last shorter one; all chunks in
    order of decreasing size, sizes capped at top = min(chunk,
    PLAN_BINS - 1), stable in (tile, block) order. Returns (table
    i32[rows, 4] = (tile, first block, blocks, slot), tile_first i32[nt],
    tile_chunks i32[nt] = the tile's chunk count n), rows =
    plan_rows(...); rows past the last chunk are (0, 0, 0, -1). A tile of
    n > 1 chunks owns the scratch slots tile_first + 0..n-1 (numbered by
    tile, its j-th chunk in block order the j-th); a tile of one chunk has
    slot -1 and tile_first 0."""
    dev = tile_of.device
    n_blocks = tile_of.numel()
    tiles = torch.arange(nt + 1, dtype=torch.int32, device=dev)
    bound = torch.searchsorted(tile_of, tiles, out_int32=True).long()
    bstart, run = bound[:-1], bound[1:] - bound[:-1]
    n = torch.div(run + (chunk - 1), chunk, rounding_mode="floor")
    split = torch.where(n > 1, n, 0)
    slot0 = torch.cumsum(split, 0) - split
    # Every chunk in (tile, block) order, then stably by decreasing size.
    tile = torch.repeat_interleave(torch.arange(nt, device=dev), n)
    j = torch.arange(tile.numel(), device=dev) - (torch.cumsum(n, 0) - n)[tile]
    size = (run[tile] - j * chunk).clamp(max=chunk)
    order = torch.argsort(size.clamp(max=min(chunk, PLAN_BINS - 1)),
                          descending=True, stable=True)
    live = torch.stack([tile, bstart[tile] + j * chunk, size,
                        torch.where(n[tile] > 1, slot0[tile] + j, -1)], 1)
    table = torch.tensor([0, 0, 0, -1], device=dev).repeat(
        plan_rows(nt, n_blocks, chunk), 1)
    table[:tile.numel()] = live[order]
    return (table.to(torch.int32),
            torch.where(n > 1, slot0, 0).to(torch.int32), n.to(torch.int32))


def chunk_plan(tile_of, nt: int, chunk: int):
    """The plan kernel alone (the first launch of every sweep) for CUDA
    tensors, its plain version for CPU tensors: chunk_plan_plain's
    (table, tile_first, tile_chunks). For checking and reporting the
    plan; the sweep launches the kernel itself."""
    if tile_of.device.type == "cpu":
        return chunk_plan_plain(tile_of, nt, chunk)
    if tile_of.device.type != "cuda":
        raise RuntimeError(f"no plan kernel for device {tile_of.device}")
    n_blocks = tile_of.numel()
    rows = plan_rows(nt, n_blocks, chunk)
    scratch = _plan_scratch(rows, nt, tile_of.device)
    lib = _build.load()
    ptr = ctypes.c_void_p
    raise_on(lib, lib.hagrid_sweep_plan(
        ptr(tile_of.data_ptr()), n_blocks, nt, chunk, rows,
        ptr(scratch.data_ptr()),
        ptr(torch.cuda.current_stream(tile_of.device).cuda_stream)),
        "sweep plan")
    return (scratch[:4 * rows].view(rows, 4),
            scratch[4 * rows:4 * rows + nt],
            scratch[4 * rows + nt + 1:])


def _plan_scratch(rows, nt, device):
    """The plan kernel's i32 scratch: table [rows, 4], tile_first
    [nt + 1] (the last entry is the kernel's), tile_chunks [nt]."""
    return torch.empty(4 * rows + 2 * nt + 1, dtype=torch.int32,
                       device=device)


def cuda_launch_args(xt, cols, gidx, tile_of, tminb, tile, chunk=None):
    """What a launch of the sweep's shell needs beside its inputs, after
    checking them for the card: (nt, C, plan rows, the four outputs, the
    plan's scratch). The outputs are left unset (the launch writes every
    ray) unless there is nothing to launch: rows is then 0 and the
    outputs say "no hit". chunk: C (default chunk_blocks of the
    budget)."""
    if xt.device.type != "cuda":
        raise RuntimeError(f"no sweep kernel for device {xt.device}")
    nt = _check(xt, cols, gidx, tile_of, tminb, tile)
    if tile % 64 or not 64 <= tile <= 512:
        raise ValueError(f"the CUDA sweep takes tiles of 64..512 rays in "
                         f"steps of 64, got {tile}")
    tensors = (xt, cols, gidx, tile_of, tminb)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("sweep inputs must be contiguous")
    if cols.data_ptr() % 16:
        raise ValueError("cols must be 16-byte aligned (bulk copies)")
    n_blocks = tile_of.numel()
    chunk = chunk or chunk_blocks(n_blocks)
    if nt == 0 or n_blocks == 0:
        return nt, chunk, 0, _empty_out(xt.shape[1], xt.device), None
    rows = plan_rows(nt, n_blocks, chunk)
    out = (torch.empty(xt.shape[1], dtype=torch.float32, device=xt.device),
           torch.empty(xt.shape[1], dtype=torch.int32, device=xt.device),
           torch.empty(xt.shape[1], dtype=torch.float32, device=xt.device),
           torch.empty(xt.shape[1], dtype=torch.float32, device=xt.device))
    return nt, chunk, rows, out, _plan_scratch(rows, nt, xt.device)


def resident_ctas(tile, any_hit=False, device=None):
    """(CTAs of the sweep instance for (tile, any_hit) that one SM holds at
    once, the card's SM count): the occupancy calculator's answer."""
    lib = _build.load()
    per_sm = ctypes.c_int(0)
    raise_on(lib, lib.hagrid_sweep_occupancy(int(any_hit), tile,
                                             ctypes.byref(per_sm)),
             "occupancy query of the sweep")
    props = torch.cuda.get_device_properties(device or 0)
    return per_sm.value, props.multi_processor_count


def sweep_blocks(xt, cols, gidx, tile_of, tminb, tile, any_hit=False,
                 skipped=None):
    """The sweep: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors; anything else raises. skipped: optional i32[nt] on the
    card, to which the kernel adds each tile's count of blocks skipped by
    the early-out (the plain version has no early-out and takes none)."""
    if xt.device.type == "cpu":
        if skipped is not None:
            raise ValueError("the plain version skips no blocks")
        return sweep_blocks_plain(xt, cols, gidx, tile_of, tminb, tile,
                                  any_hit)
    return _sweep_cuda(xt, cols, gidx, tile_of, tminb, tile, any_hit,
                       skipped)


def _sweep_cuda(xt, cols, gidx, tile_of, tminb, tile, any_hit, skipped,
                chunk=None):
    """sweep_blocks on the card; chunk overrides C (for measuring it: the
    result does not depend on it)."""
    nt, chunk, rows, out, plan = cuda_launch_args(xt, cols, gidx, tile_of,
                                                  tminb, tile, chunk)
    if skipped is not None and (skipped.dtype != torch.int32
                                or skipped.shape != (nt,)
                                or skipped.device != xt.device):
        raise ValueError(f"skipped must be i32[{nt}] on {xt.device}")
    if rows == 0:
        return out
    # Scratch of the split tiles' chunks, indexed by plan row; rows of
    # whole tiles leave theirs unwritten.
    partial = torch.empty((rows, tile, 4), dtype=torch.int32,
                          device=xt.device)
    lib = _build.load()
    ptr = ctypes.c_void_p
    err = lib.hagrid_sweep(
        ptr(xt.data_ptr()), xt.shape[1], ptr(cols.data_ptr()),
        ptr(gidx.data_ptr()), ptr(tile_of.data_ptr()), tile_of.numel(),
        ptr(tminb.data_ptr()), *(ptr(o.data_ptr()) for o in out), nt, tile,
        chunk, rows, int(any_hit),
        ptr(None if skipped is None else skipped.data_ptr()),
        ptr(plan.data_ptr()), ptr(partial.data_ptr()),
        ptr(torch.cuda.current_stream(xt.device).cuda_stream))
    raise_on(lib, err, "sweep")
    count_launch(launches, "sweep_blocks_anyhit" if any_hit
                 else "sweep_blocks")
    return out
