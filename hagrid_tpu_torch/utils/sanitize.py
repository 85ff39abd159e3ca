"""Runtime sanitizer for the sweep planner (port of
hagrid_tpu/utils/sanitize.py::check_sweep_plan).

The failure modes that matter are value-level: NaNs escaping the planning
math, out-of-bounds gather indices into the ref tables, divisions by
zero, and budget bookkeeping going negative. `check_sweep_plan` replays
one frame's planning (precompute -> plan -> items) with explicit asserts
between the stages, then asserts the item stream's invariants on the
host. It is a debug tool (it reads back to the host at every step); call
it from tests when a trace looks wrong.
"""

from __future__ import annotations

import torch

from ..core.types import Rays
from ..grid.packet import PacketGrid
from ..ops import sweep_trace as st


def _finite(name, tensors):
    for k, x in tensors.items():
        if torch.is_tensor(x) and x.is_floating_point():
            assert bool(torch.isfinite(x).all()), f"{name}[{k}] not finite"


def _in_range(name, idx, n):
    if idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        assert 0 <= lo and hi < n, \
            f"{name}: index [{lo}, {hi}] outside [0, {n})"


def check_sweep_plan(grid: PacketGrid, rays: Rays, tile: int = 512,
                     bmax: int = 4096) -> dict:
    """Checked replay of one frame's dense planning. Raises
    AssertionError on NaN or infinity, an out-of-bounds gather or a zero
    divisor inside precompute/plan/items; asserts the stream invariants;
    returns summary stats."""
    n = rays.count
    n_pad = -(-n // tile) * tile
    nt = n_pad // tile
    slab = max(d[0] for d in grid.dims3)
    xp_ext, _ = st._pad_coherent(rays.org, rays.dir, rays.tmin, rays.tmax,
                                 n_pad, tile)
    cs_tab, n_tab, lo_tab = st._tile_tabs(grid.bbox_lo, grid.bbox_hi,
                                          grid.dims3)
    # Divisors of the planner: cell sizes (1 / cs_c) and grid dims.
    assert bool((cs_tab > 0).all()), "zero or negative cell size"
    assert bool((n_tab > 0).all()), "zero grid dimension"
    _finite("tabs", dict(cs=cs_tab, lo=lo_tab, planes=grid.planes))
    per_ray, per_tile = st._precompute(
        xp_ext[:nt * tile], cs_tab, n_tab, lo_tab, grid.bbox_lo,
        grid.bbox_hi, tile, grid.planes)
    _finite("per_ray", per_ray)
    _finite("per_tile", per_tile)
    _in_range("k0", per_tile["k0"], slab)
    traceable = xp_ext[:nt * tile, 13].reshape(nt, tile) > 0
    best0 = torch.where(traceable, st._BIG, -st._BIG)
    # Every table gather of the planner goes through st._take, which
    # clamps like the reference's gathers; here an index out of range is
    # an error, so the gathers are replayed on host copies, where _take
    # asserts the range of each.
    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x.to("cpu") if torch.is_tensor(x) else x

    starts, counts, thr = st._plan(
        *map(host, (per_ray, per_tile, cs_tab, n_tab, lo_tab, grid.rs,
                    grid.rowinfo, per_tile["k0"], best0)),
        grid.dims3, slab, False)
    dead_idx = grid.cols.shape[0] // st._U - 1
    gidx, tile_of, tminb, n_blocks, demand = st._items(
        starts, counts, thr, nt, slab, bmax, dead_idx)

    units = grid.cols.shape[0] // st._U
    assert bool((counts >= 0).all()), "negative range count"
    live = counts > 0
    assert bool((starts[live] >= 0).all()), "negative range start"
    assert bool((starts[live] + counts[live] <= units).all()), \
        "range past the cols table"
    assert bool((gidx >= 0).all()) and bool((gidx < units).all()), \
        "gather unit index out of bounds"
    nb = int(n_blocks)
    assert bool((tile_of[:nb] < nt).all()), \
        "live block points at the dummy tile"
    assert bool((tile_of[nb:] == nt).all()), \
        "dead block not parked on dummy tile"
    return {
        "ranges": int(live.sum()),
        "units": int(counts.sum()),
        "blocks": nb,
        "demand_units": int(demand),
    }
