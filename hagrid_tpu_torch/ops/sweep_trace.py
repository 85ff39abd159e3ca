"""Planned-sweep packet traversal (port of hagrid_tpu/ops/sweep_trace.py).

Camera-coherent waves (coherent=True) stay in their (block-Morton) order;
incoherent waves (AO, shadow, path bounces) are first binned by (major
axis, sign) into tile-aligned groups with a stable counting sort
(`_bin_rays`) and scattered back at the end (`_unbin`). Rays are cut into
tiles of `tile` rays. Each round:

1. the planner (torch): per tile and slice of the tile's major axis, the
   frustum rect of each ray quarter, trimmed per row, turned into ref
   ranges through the grid's `rs`/`rowinfo` tables, with an early-out
   threshold per range (the slice's tile-entry t; for any hit the largest
   float below BIG). The dense planner `_plan` + `_items` works in fixed
   (tile, slice, row slot) form, right for coherent waves; the compact
   planner `_plan_items2` expands exactly the live rect rows into a row
   stream, right for incoherent waves with tall rects and small tiles;
2. both pack the ranges' 24-ref gather units into a stream of 768-ref
   blocks (`gidx`), each owned by one tile (`tile_of`, ascending) with a
   per-block threshold (`tminb`) (`_pack_units`);
3. `sweep_blocks` (hand-written CUDA kernel, ops/sweep_kernel.py): every
   tile's run of blocks against its rays, best (t, id, u, v) per ray;
   closest hit or any hit;
4. `_merge` (torch): fold the round's hits into the running best.

With tracing on (utils/profiling.py) the frame opens spans
"sweep.layout" (the ray layout and the per-tile precompute), and each
round "sweep.plan" (steps 1-2), "sweep.kernel" (3) and "sweep.merge"
(4); inside a session's captured graph they are its event nodes.

The whole frame runs with no host read: budgets (`bcaps`) are static per
round and overflow is a device flag. Out-of-range semantics differ from
JAX's (see ops/segment.py): every f32 -> i32 cast goes through
`trunc_i32`, every drop-mode scatter through `add_at_drop`, and table
gathers through `_take`, which clamps like a jnp gather and, on the CPU,
asserts that no index was out of range.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.types import Hits, Rays
from ..device import const
from ..grid.packet import BIG as _BIG
from ..grid.packet import PacketGrid, rays_to_x
from ..utils import profiling
from .segment import (add_at_drop, cumsum_i32, expand_by_counts,
                      running_min, trunc_i32)
from .sweep_kernel import UNIT_ROWS, UNITS_PER_BLOCK, sweep_blocks

_SUB = 4        # ray quarters per tile (tighter union rects)
_RMAX = 4       # c-trimmed row ranges per (tile, slice) + one tail range
_G = 6          # refs per group row of `cols`
_U = UNIT_ROWS  # group rows per gather unit
_UPB = UNITS_PER_BLOCK  # gather units per 768-ref block
_IBIG = 1 << 20
_BIG_BITS = int(np.float32(_BIG).view(np.int32))  # bit pattern of BIG
_NGROUPS = 7    # (axis, sign) ray groups + 1 dead group
_NGROUPS_FINE = 25  # (axis, sign, minor-sign quadrant) groups + 1 dead


def _clip(x, lo, hi):
    """jnp.clip with scalar or tensor bounds."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else x.clamp(min=lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else x.clamp(max=hi)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with a jnp gather's clamping; on the CPU (the tests)
    an out-of-range index is a planner bug and raises."""
    n = table.shape[0]
    if idx.device.type == "cpu" and idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        assert 0 <= lo and hi < n, f"gather index [{lo}, {hi}] vs {n}"
    return table[idx.clamp(0, n - 1).long()]


def _along(arr: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.take_along_axis with in-range indices."""
    return torch.gather(arr, dim, idx.long())


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


# ----------------------------------------------------------------------
# Ray layout and per-tile precompute
# ----------------------------------------------------------------------

def _pad_coherent(org, dir, tmin, tmax, n_pad, tile):
    """Keep ray order, pad with dead rays, append the all-dead dummy
    tile. Returns (xp_ext f32[n_pad + tile, 16], xt_ext = its transpose)."""
    x = rays_to_x(org, dir, tmin, tmax)
    pad = _dead_row(x.device).expand(n_pad + tile - x.shape[0], 16)
    xp_ext = torch.cat([x, pad], dim=0)
    return xp_ext, xp_ext.t().contiguous()


_DEAD_ROW = (1.0, -1e30) + (0.0,) * 2 + (1.0,) + (0.0,) * 11


def _dead_row(device):
    """X row of a dead ray (tmax = 0: never traced, never hits)."""
    return const(_DEAD_ROW, torch.float32, device)


def _bin_rays(org, dir, tmin, tmax, n_pad, tile, fine=False):
    """Group rays by (major axis, sign) into tile-aligned segments with a
    stable counting sort (masked cumsums, no device-wide sort); rays with
    tmax <= 0 go to a last, dead group so live tiles stay dense. Within a
    group the caller's order is kept (the origin-sorted order of a
    secondary wave). fine=True splits each (axis, sign) group by the
    signs of the two minor direction components (24 live groups): a
    quarter of the direction cone per tile, for waves with no origin
    locality. Returns (xp_ext f32[n_pad + tile, 16], xt_ext = its
    transpose, inv i32[n_pad]: original ray of each row, -1 for padding);
    n_pad must leave room for every group's padding, (ceil(n/tile) +
    groups) * tile, groups being 7 (25 with fine)."""
    x = rays_to_x(org, dir, tmin, tmax)
    n = x.shape[0]
    dev = x.device
    d = x[:, 4:7]
    ad = d.abs()
    axis = torch.where(ad[:, 0] >= torch.maximum(ad[:, 1], ad[:, 2]), 0,
                       torch.where(ad[:, 1] >= ad[:, 2], 1, 2))
    sign = (_along(d, axis[:, None], 1)[:, 0] < 0).to(torch.int32)
    glive = axis.to(torch.int32) * 2 + sign
    ng = _NGROUPS
    if fine:
        d1 = _along(d, ((axis + 1) % 3)[:, None], 1)[:, 0]
        d2 = _along(d, ((axis + 2) % 3)[:, None], 1)[:, 0]
        sub = (d1 < 0).to(torch.int32) * 2 + (d2 < 0).to(torch.int32)
        glive, ng = glive * 4 + sub, _NGROUPS_FINE
    g = torch.where(x[:, 13] > 0, glive, ng - 1)
    ranks = torch.zeros((n,), dtype=torch.int32, device=dev)
    counts = []
    for k in range(ng):
        mk = g == k
        ck = cumsum_i32(mk.to(torch.int32))
        ranks = torch.where(mk, ck - 1, ranks)
        counts.append(ck[-1])
    counts = torch.stack(counts)
    padded = -torch.div(-counts, tile, rounding_mode="floor") * tile
    offs = cumsum_i32(padded) - padded
    pos = offs[g.long()] + ranks
    # Scatter a 1-int permutation, then gather the 16-float rows.
    inv = torch.full((n_pad + tile,), -1, dtype=torch.int32, device=dev)
    inv[pos.long()] = torch.arange(n, dtype=torch.int32, device=dev)
    xp_ext = torch.where((inv >= 0)[:, None], x[inv.clamp(min=0).long()],
                         _dead_row(dev))
    return xp_ext, xp_ext.t().contiguous(), inv[:n_pad]


def _unbin(best, inv, n) -> Hits:
    """Scatter binned per-row results (t, id, u, v) back to ray order;
    t = inf and id = -1 where no hit."""
    dev = inv.device
    safe = torch.where(inv >= 0, inv, n).long()

    def back(x, fill):
        out = torch.full((n + 1,), fill, dtype=x.dtype, device=dev)
        out[safe] = x.reshape(-1)
        return out[:n]

    tri = back(best[1], -1)
    return Hits(tri_id=tri,
                t=torch.where(tri >= 0, back(best[0], 0.0), float("inf")),
                u=back(best[2], 0.0), v=back(best[3], 0.0))


def _tile_tabs(bbox_lo, bbox_hi, dims3):
    """Per-layout (cs, dims, lo) tables in (slice, row, col) order."""
    ext = bbox_hi - bbox_lo
    cs_rows, lo_rows = [], []
    for a in range(3):
        da, db, dc = dims3[a]
        b, c = (a + 1) % 3, (a + 2) % 3
        cs_rows.append(torch.stack([ext[a] / da, ext[b] / db, ext[c] / dc]))
        lo_rows.append(torch.stack([bbox_lo[a], bbox_lo[b], bbox_lo[c]]))
    n_tab = const(tuple(tuple(int(x) for x in d) for d in dims3),
                  torch.int32, bbox_lo.device)
    return torch.stack(cs_rows), n_tab, torch.stack(lo_rows)


def _inv(dv):
    nz = dv.abs() > 1e-30
    return torch.where(nz, 1.0 / torch.where(nz, dv, 1.0),
                       torch.where(dv < 0, -_BIG, _BIG))


def _precompute(xp, cs_tab, n_tab, lo_tab, bbox_lo, bbox_hi, tile,
                planes):
    """Static per-ray / per-tile quantities for the round loop."""
    nt = xp.shape[0] // tile
    x3 = xp.reshape(nt, tile, 16)
    o = x3[..., 1:4]
    d = x3[..., 4:7]
    tmin = x3[..., 12]
    tmax = x3[..., 13]

    # Tile-uniform axis/sign from ray 0.
    ad0 = x3[:, 0, 4:7].abs()
    axis = torch.where(ad0[:, 0] >= torch.maximum(ad0[:, 1], ad0[:, 2]), 0,
                       torch.where(ad0[:, 1] >= ad0[:, 2], 1, 2)).to(
                           torch.int32)
    d0 = _along(x3[:, 0, 4:7], axis[:, None], 1)[:, 0]
    step = torch.where(d0 < 0, -1, 1).to(torch.int32)

    def perm(arr, ax):  # (nt, tile, 3) -> (nt, tile) at the per-tile axis
        return _along(arr, ax[:, None, None].expand(nt, tile, 1), 2)[..., 0]

    a1 = (axis + 1) % 3
    a2 = (axis + 2) % 3
    o_a, o_b, o_c = perm(o, axis), perm(o, a1), perm(o, a2)
    d_a, d_b, d_c = perm(d, axis), perm(d, a1), perm(d, a2)
    inv_a = _inv(d_a)

    def slab1(oc, dc_, lo, hi):
        i = _inv(dc_)
        t0 = (lo - oc) * i
        t1 = (hi - oc) * i
        bad = torch.isnan(t0 * t1)
        return (torch.where(bad, -_BIG, torch.minimum(t0, t1)),
                torch.where(bad, _BIG, torch.maximum(t0, t1)))

    nx, fx = slab1(o[..., 0], d[..., 0], bbox_lo[0], bbox_hi[0])
    ny, fy = slab1(o[..., 1], d[..., 1], bbox_lo[1], bbox_hi[1])
    nz_, fz = slab1(o[..., 2], d[..., 2], bbox_lo[2], bbox_hi[2])
    enter = torch.maximum(torch.maximum(nx, ny), torch.maximum(nz_, tmin))
    leave = torch.minimum(torch.minimum(fx, fy), torch.minimum(fz, tmax))
    alive = enter <= leave

    n_a = n_tab[axis.long(), 0]
    # Entry slice: count of interior planes <= the packet's front entry.
    pa_in = o_a + enter * d_a
    pa_sel = torch.where(alive, pa_in, torch.where(step[:, None] > 0,
                                                   _BIG, -_BIG))
    front = torch.where(step > 0, pa_sel.min(1).values,
                        pa_sel.max(1).values)
    p_tile = planes[axis.long()]                      # (nt, PMAX)
    pidx = torch.arange(planes.shape[1], dtype=torch.int32,
                        device=xp.device)
    interior = (pidx[None, :] >= 1) & (pidx[None, :] <= n_a[:, None] - 1)
    k0 = ((p_tile <= front[:, None]) & interior).sum(1, dtype=torch.int32)
    k0 = _clip(k0, 0, n_a - 1)

    per_ray = dict(o_a=o_a, o_b=o_b, o_c=o_c, d_a=d_a, d_b=d_b, d_c=d_c,
                   inv_a=inv_a, enter=enter, leave=leave, alive=alive,
                   tmax=tmax)
    per_tile = dict(axis=axis, step=step, k0=k0, p_tile=p_tile)
    return per_ray, per_tile


# ----------------------------------------------------------------------
# Round planning
# ----------------------------------------------------------------------

def _plan_dense(per_ray, per_tile, cs_tab, n_tab, lo_tab, ka, best_t,
                dims3, slab, any_hit=False):
    """Per (tile, slice): per-quarter frustum bounds, t windows and row
    rects. Elementwise math and reductions only. Shared by the dense slot
    planner (_plan) and the compact row-stream planner (_plan_items2)."""
    axis = per_tile["axis"]
    step = per_tile["step"]
    ax = axis.long()
    nt = axis.shape[0]
    dev = axis.device
    cs_b, cs_c = cs_tab[ax, 1], cs_tab[ax, 2]
    lo_b, lo_c = lo_tab[ax, 1], lo_tab[ax, 2]
    n_a, n_b, n_c = n_tab[ax, 0], n_tab[ax, 1], n_tab[ax, 2]

    # Ray liveness: closest hit is done once its best hit precedes the
    # slab's entry plane, any hit once it has a hit.
    p_tile = per_tile["p_tile"]
    plane0 = _along(p_tile, _clip(ka + (step < 0).to(torch.int32), 0,
                                  n_a)[:, None], 1)[:, 0]
    t_entry = (plane0[:, None] - per_ray["o_a"]) * per_ray["inv_a"]
    lim = torch.minimum(per_ray["tmax"], per_ray["leave"])
    if any_hit:
        done = best_t < per_ray["tmax"].clamp(max=_BIG)
    else:
        done = best_t <= t_entry
    live = per_ray["alive"] & ~done & (t_entry < lim) \
        & (ka[:, None] >= 0) & (ka[:, None] < n_a[:, None])

    # Frustum bounds per quarter tile; the rect is the live union.
    def q(v):  # (nt, tile) -> (nt, SUB, tile/SUB)
        return v.reshape(nt, _SUB, -1)

    liveq = q(live)

    def mnq(v):
        return torch.where(liveq, q(v), _BIG).min(2).values

    def mxq(v):
        return torch.where(liveq, q(v), -_BIG).max(2).values

    ob_lo, ob_hi = mnq(per_ray["o_b"]), mxq(per_ray["o_b"])
    oc_lo, oc_hi = mnq(per_ray["o_c"]), mxq(per_ray["o_c"])
    db_lo, db_hi = mnq(per_ray["d_b"]), mxq(per_ray["d_b"])
    dc_lo, dc_hi = mnq(per_ray["d_c"]), mxq(per_ray["d_c"])
    oa_lo, oa_hi = mnq(per_ray["o_a"]), mxq(per_ray["o_a"])
    ia_lo, ia_hi = mnq(per_ray["inv_a"]), mxq(per_ray["inv_a"])
    t_lo0 = mnq(per_ray["enter"]).clamp(min=0.0)
    t_cap = mxq(torch.minimum(torch.minimum(best_t, per_ray["tmax"]),
                              per_ray["leave"]))

    # Slab slices (nt, S); per-quarter per-slice t range and rect.
    ks = ka[:, None] + step[:, None] * torch.arange(
        slab, dtype=torch.int32, device=dev)
    k_ok = (ks >= 0) & (ks < n_a[:, None])
    ks_cl = _clip(ks, 0, n_a[:, None])
    pl0 = _along(p_tile, ks_cl, 1)
    pl1 = _along(p_tile, torch.minimum(ks_cl + 1, n_a[:, None]), 1)

    def tq(p):  # (nt,S) plane x (nt,SUB) bounds -> (nt,SUB,S)
        return [(p[:, None, :] - oe[:, :, None]) * ie[:, :, None]
                for oe in (oa_lo, oa_hi) for ie in (ia_lo, ia_hi)]

    cands = tq(pl0) + tq(pl1)
    tl = functools.reduce(torch.minimum, cands)
    th = functools.reduce(torch.maximum, cands)
    tl = torch.maximum(tl, t_lo0[:, :, None])
    th = torch.minimum(th, t_cap[:, :, None])
    t_ok = tl <= th                                      # (nt,SUB,S)

    def minor(olo, ohi, dlo, dhi, lo_m, cs_m, n_m):
        x00 = tl * dlo[:, :, None]
        x01 = tl * dhi[:, :, None]
        x10 = th * dlo[:, :, None]
        x11 = th * dhi[:, :, None]
        vlo = olo[:, :, None] + torch.minimum(torch.minimum(x00, x01),
                                              torch.minimum(x10, x11))
        vhi = ohi[:, :, None] + torch.maximum(torch.maximum(x00, x01),
                                              torch.maximum(x10, x11))
        ics = (1.0 / cs_m)[:, None, None]
        lo_i = trunc_i32((vlo - lo_m[:, None, None]) * ics)
        hi_i = trunc_i32((vhi - lo_m[:, None, None]) * ics)
        top = n_m[:, None, None] - 1
        return _clip(lo_i, 0, top), _clip(hi_i, 0, top)

    b0q, b1q = minor(ob_lo, ob_hi, db_lo, db_hi, lo_b, cs_b, n_b)
    rect_okq = t_ok & k_ok[:, None, :]                   # (nt,SUB,S)
    b0 = torch.where(rect_okq, b0q, _IBIG).min(1).values  # (nt,S)
    b1 = torch.where(rect_okq, b1q, -1).max(1).values
    rect_ok = rect_okq.any(1)
    b0 = torch.where(rect_ok, b0, 0)
    b1 = torch.where(rect_ok, b1, 0)

    # rowinfo flat indexing: per-layout row base + per-tile strides.
    qbase_list, off = [], 0
    for a in range(3):
        qbase_list.append(off)
        off += dims3[a][0] * dims3[a][1]
    qbase = const(tuple(qbase_list), torch.int32, dev)[ax]   # (nt,)
    k_cl = _clip(ks, 0, n_a[:, None] - 1)

    return dict(
        nt=nt, cs_b=cs_b, cs_c=cs_c, lo_b=lo_b, lo_c=lo_c, n_a=n_a,
        n_b=n_b, n_c=n_c, qbase=qbase, ob_lo=ob_lo, ob_hi=ob_hi,
        oc_lo=oc_lo, oc_hi=oc_hi, db_lo=db_lo, db_hi=db_hi, dc_lo=dc_lo,
        dc_hi=dc_hi, tl=tl, th=th, rect_okq=rect_okq, rect_ok=rect_ok,
        b0q=b0q, b1q=b1q, b0=b0, b1=b1, k_cl=k_cl)


def _plan(per_ray, per_tile, cs_tab, n_tab, lo_tab, rs, rowinfo, ka,
          best_t, dims3, slab, any_hit=False, rmax=_RMAX):
    """One slab's plan in dense slot form: per (tile, slice) `rmax`
    column-trimmed row ranges plus one untrimmed tail range, as gather
    units. Returns (unit_start, unit_count, thr_bits) flattened over
    (tile, slice, rmax + 1); thr_bits is the i32 bit pattern of the
    slot's early-out threshold (no ref of the slot can hit earlier; for
    any hit, the largest float below BIG: done once a hit exists)."""
    D = _plan_dense(per_ray, per_tile, cs_tab, n_tab, lo_tab, ka, best_t,
                    dims3, slab, any_hit)
    dev = best_t.device
    cs_b, cs_c = D["cs_b"], D["cs_c"]
    lo_b, lo_c = D["lo_b"], D["lo_c"]
    n_b, n_c = D["n_b"], D["n_c"]
    ob_lo, ob_hi = D["ob_lo"], D["ob_hi"]
    oc_lo, oc_hi = D["oc_lo"], D["oc_hi"]
    db_lo, db_hi = D["db_lo"], D["db_hi"]
    dc_lo, dc_hi = D["dc_lo"], D["dc_hi"]
    tl, th = D["tl"], D["th"]
    rect_okq, rect_ok = D["rect_okq"], D["rect_ok"]
    b0q, b1q, b0, b1 = D["b0q"], D["b1q"], D["b0"], D["b1"]
    k_cl, qbase = D["k_cl"], D["qbase"]

    # Per-row column trim: restrict each quarter's slice t-interval to the
    # t's where some ray is inside that row's b-band, then derive the
    # column interval from the restricted t's.
    rr = torch.arange(rmax, dtype=torch.int32, device=dev)
    j_r = b0[:, :, None] + rr[None, None, :]             # (nt,S,R)
    db_ok = (db_lo > 1e-30) | (db_hi < -1e-30)           # (nt,SUB)
    idb_a = 1.0 / torch.where(db_ok, db_lo, 1.0)
    idb_b = 1.0 / torch.where(db_ok, db_hi, 1.0)
    # Broadcast: quarter bounds (nt,SUB,1,1), slice t (nt,SUB,S,1),
    # rows (nt,1,S,R) -> (nt,SUB,S,R).
    csb4 = cs_b[:, None, None, None]
    wb0 = lo_b[:, None, None, None] + j_r[:, None].to(torch.float32) * csb4
    wb1 = wb0 + csb4
    nlo0 = wb0 - ob_hi[:, :, None, None]
    nhi0 = wb0 - ob_lo[:, :, None, None]
    nlo1 = wb1 - ob_hi[:, :, None, None]
    nhi1 = wb1 - ob_lo[:, :, None, None]
    ia = idb_a[:, :, None, None]
    ib = idb_b[:, :, None, None]

    def hull4(na, nb):
        p0, p1 = na * ia, na * ib
        p2, p3 = nb * ia, nb * ib
        return (torch.minimum(torch.minimum(p0, p1), torch.minimum(p2, p3)),
                torch.maximum(torch.maximum(p0, p1), torch.maximum(p2, p3)))

    e0_lo, e0_hi = hull4(nlo0, nhi0)    # crossing times of band lo
    e1_lo, e1_hi = hull4(nlo1, nhi1)    # crossing times of band hi
    tb_lo = torch.minimum(e0_lo, e1_lo)
    tb_hi = torch.maximum(e0_hi, e1_hi)
    dbok4 = db_ok[:, :, None, None]
    tl4, th4 = tl[..., None], th[..., None]
    tj_lo = torch.where(dbok4, torch.maximum(tl4, tb_lo), tl4)
    tj_hi = torch.where(dbok4, torch.minimum(th4, tb_hi), th4)
    row_okq = (rect_okq[..., None] & (tj_lo <= tj_hi)
               & (j_r[:, None] <= b1q[..., None])
               & (j_r[:, None] >= b0q[..., None]))
    x00 = tj_lo * dc_lo[:, :, None, None]
    x01 = tj_lo * dc_hi[:, :, None, None]
    x10 = tj_hi * dc_lo[:, :, None, None]
    x11 = tj_hi * dc_hi[:, :, None, None]
    vlo = oc_lo[:, :, None, None] + torch.minimum(
        torch.minimum(x00, x01), torch.minimum(x10, x11))
    vhi = oc_hi[:, :, None, None] + torch.maximum(
        torch.maximum(x00, x01), torch.maximum(x10, x11))
    # Per-row rowinfo (rs offset + column multiplier), one gather.
    j_cl = torch.minimum(j_r, n_b[:, None, None] - 1)
    ri = _take(rowinfo, qbase[:, None, None]
               + k_cl[:, :, None] * n_b[:, None, None] + j_cl)
    roff = ri & 0x0FFFFFFF
    lgm = (ri >> 28)[:, None]                            # (nt,1,S,R)
    ics = (1.0 / cs_c)[:, None, None, None] * torch.exp2(
        lgm.to(torch.float32))
    lo4 = lo_c[:, None, None, None]
    ncl = (n_c[:, None, None, None] << lgm) - 1
    c0q_r = _clip(trunc_i32((vlo - lo4) * ics), 0, ncl)
    c1q_r = _clip(trunc_i32((vhi - lo4) * ics), 0, ncl)
    c0_r = torch.where(row_okq, c0q_r, _IBIG).min(1).values   # (nt,S,R)
    c1_r = torch.where(row_okq, c1q_r, -1).max(1).values
    row_any = row_okq.any(1)
    c0_r = torch.where(row_any, c0_r, 0)
    c1_r = torch.where(row_any, c1_r, -1)  # empty range when uncovered

    # Per-row trimmed ranges + untrimmed multi-row tail.
    row_ok = (j_r <= b1[:, :, None]) & rect_ok[:, :, None] & row_any
    g1 = _take(rs, roff + c0_r)
    g2 = _take(rs, roff + c1_r.clamp(min=0) + 1)
    has_tail = rect_ok & (b1 - b0 + 1 > rmax)
    rowbase = qbase[:, None] + k_cl * n_b[:, None]
    jt = torch.minimum(b0 + rmax, n_b[:, None] - 1)
    ri_t = _take(rowinfo, rowbase + jt)
    ri_b = _take(rowinfo, rowbase + b1)
    t1 = _take(rs, ri_t & 0x0FFFFFFF)
    t2 = _take(rs, (ri_b & 0x0FFFFFFF) + (n_c[:, None] << (ri_b >> 28)))

    # Emit in gather units: round each ref range outward (the extra refs
    # are real refs of the same layout or zero rows: conservative).
    refs_u = _G * _U
    lo_r = torch.cat([g1, t1[..., None]], dim=2)
    hi_r = torch.cat([g2, t2[..., None]], dim=2)
    lo_g = torch.div(lo_r, refs_u, rounding_mode="floor")
    hi_g = -torch.div(-hi_r, refs_u, rounding_mode="floor")
    ok3 = torch.cat([row_ok, has_tail[..., None]], dim=2)
    valid = ok3 & (hi_r > lo_r)
    # Boundary-unit dedup: a slice's slots are disjoint ascending ref
    # spans, so their round-outs overlap by at most the shared boundary
    # unit; clamp each start to the running max end of earlier slots.
    hi_m = torch.where(valid, hi_g, 0)
    run = torch.zeros(hi_m.shape[:2], dtype=hi_m.dtype, device=dev)
    lo_cl = []
    for r in range(rmax + 1):
        lo_cl.append(torch.maximum(lo_g[:, :, r], run))
        run = torch.maximum(run, hi_m[:, :, r])
    lo_g = torch.stack(lo_cl, dim=2)
    cnt_g = torch.where(valid, (hi_g - lo_g).clamp(min=0), 0)
    if any_hit:
        thr = torch.full_like(cnt_g, _BIG_BITS - 1)
        return lo_g.reshape(-1), cnt_g.reshape(-1), thr.reshape(-1)

    # Early-out thresholds (t >= 0, so int bit order == float order):
    # row slots use the row-restricted entry time, the tail the slice
    # entry; a suffix-min over the slot axis keeps them safe for the
    # boundary units that the clamp above hands to earlier slots.
    t_thr = torch.where(rect_okq, tl, _BIG).min(1).values          # (nt,S)
    t_thr_r = torch.where(row_okq, tj_lo, _BIG).min(1).values      # (nt,S,R)
    t_all = torch.cat([t_thr_r, t_thr[..., None]], dim=2)
    t_all = torch.where(valid, t_all, _BIG)
    t_all = torch.cummin(t_all.flip(2), dim=2).values.flip(2)
    return lo_g.reshape(-1), cnt_g.reshape(-1), _bits(t_all).reshape(-1)


def _pack_units(starts, thr, roff, tile_base, tile_units, demand, nt, bcap,
                dead_idx):
    """Pack ranges of gather units into a per-round block stream. Range i
    starts at unit `starts[i]` and lands at stream slot `roff[i]`
    (non-decreasing; each tile's segment [tile_base, tile_base +
    tile_units) is padded to whole blocks, so blocks never straddle
    tiles). Returns gidx i32[bcap*_UPB] (dead_idx for padding), tile_of
    i32[bcap] (owning tile, ascending; nt for unused blocks), tminb
    i32[bcap] (per-block early-out threshold, f32 bits: the min over its
    units) and n_blocks."""
    dev = starts.device
    ucap = bcap * _UPB
    # Per-slot (start - roff) and threshold by delta scatter + prefix sum
    # (piecewise constant per range; stacked deltas of empty ranges
    # telescope). Threshold deltas span the whole i32 range, so they
    # accumulate in i64.
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    sr = (starts - roff).to(torch.int32)
    sr_ff = cumsum_i32(add_at_drop(
        ucap, roff, torch.diff(sr, prepend=zero.to(torch.int32))))
    d_thr = torch.diff(thr.to(torch.int64), prepend=zero)
    thr_ff = torch.cumsum(add_at_drop(ucap, roff, d_thr), 0).to(torch.int32)
    tminb = thr_ff.reshape(bcap, _UPB).min(1).values

    n_blocks = torch.clamp(torch.div(demand, _UPB, rounding_mode="floor"),
                           max=bcap)
    bmark = add_at_drop(bcap, torch.div(tile_base, _UPB,
                                        rounding_mode="floor"), 1)
    btile = (cumsum_i32(bmark) - 1).clamp(0, nt - 1)
    blk = torch.arange(bcap, dtype=torch.int32, device=dev)
    tile_of = torch.where(blk < n_blocks, btile, nt).to(torch.int32)
    # Unit validity from the owner tile's segment end: pad units and
    # blocks past the demand both fall beyond it.
    own_end = _take(tile_base + tile_units, btile)
    slot = blk[:, None] * _UPB + torch.arange(_UPB, dtype=torch.int32,
                                              device=dev)[None, :]
    valid = slot < own_end[:, None]
    gidx = torch.where(valid, slot + sr_ff.reshape(bcap, _UPB), dead_idx)
    return gidx.reshape(-1).to(torch.int32), tile_of, tminb, n_blocks


def _block_pad(units):
    """Units rounded up to whole blocks, and their exclusive prefix sum."""
    pad = -torch.div(-units, _UPB, rounding_mode="floor") * _UPB
    return pad, cumsum_i32(pad) - pad


def _items(starts, counts, thr, nt, slab, bcap, dead_idx, rmax=_RMAX):
    """Pack the dense planner's slots into a per-round block stream:
    (gidx, tile_of, tminb, n_blocks, demand), demand being the unclamped
    unit demand (overflow detection); see _pack_units."""
    cnt2 = counts.reshape(nt, slab * (rmax + 1))
    tile_tot = cnt2.sum(1, dtype=torch.int32)
    tile_pad, tile_base = _block_pad(tile_tot)
    within = cumsum_i32(cnt2, dim=1) - cnt2
    roff = (tile_base[:, None] + within).reshape(-1)
    demand = tile_base[-1] + tile_pad[-1]
    return _pack_units(starts, thr, roff, tile_base, tile_tot, demand, nt,
                       bcap, dead_idx) + (demand,)


def _segmented_suffix_min(v, seg_last):
    """Per segment (a run of rows ending where seg_last is set), the min
    of v over each row and the rows after it in its segment. In reversed
    order, segment k's i32 values are shifted down by k * 2^32 in i64:
    every later segment then lies wholly below every earlier one, so one
    running min restarts at each segment."""
    flag = seg_last.flip(0)
    shift = torch.cumsum(flag.to(torch.int64), 0) << 32
    run = running_min(v.flip(0).to(torch.int64) - shift)
    return (run + shift).to(torch.int32).flip(0)


def _plan_items2(per_ray, per_tile, cs_tab, n_tab, lo_tab, rs, rowinfo, ka,
                 best_t, dims3, slab, any_hit, rowcap, bcap, dead_idx):
    """Compact row-stream planner and unit packer, for incoherent waves.

    The dense planner's cost scales with nt * slab * (rmax + 1) slots,
    live or not; incoherent waves need small tiles and many trimmed rows
    (tall rects), which inflate that slot space. This planner:
    1. runs the dense phase (_plan_dense): per-(tile, slice) rects;
    2. expands exactly the live rect rows into a stream of `rowcap` rows
       (overflow-flagged) by scatter + cumsum (expand_by_counts);
    3. gathers each row's per-tile and per-slice features once and trims
       every row's columns per quarter (no untrimmed tail);
    4. packs the rows' gather units into blocks (_pack_units).
    Row order is (tile, slice march, row ascending), so consecutive rows
    of one slice have ascending, disjoint ref spans, whose shared boundary
    units are clamped away pairwise.

    Returns (gidx, tile_of, tminb, n_blocks, demand_units, row_ovf,
    total_rows)."""
    D = _plan_dense(per_ray, per_tile, cs_tab, n_tab, lo_tab, ka, best_t,
                    dims3, slab, any_hit)
    nt, S = D["nt"], slab
    dev = best_t.device

    nrows_d = torch.where(D["rect_ok"], D["b1"] - D["b0"] + 1, 0)  # (nt,S)
    src, rank, valid_row, total_rows = expand_by_counts(
        nrows_d.reshape(-1), rowcap)
    tile_i = torch.div(src, S, rounding_mode="floor")

    # Row features: float and int tables kept apart (the reference packs
    # i32 bit patterns into one f32 table), gathered once per row.
    def t2s(v):  # (nt, SUB, S) -> (nt * S, SUB)
        return v.transpose(1, 2).reshape(nt * S, _SUB)

    per_slice_f = torch.cat([t2s(D["tl"]), t2s(D["th"])], dim=1)
    rbase = D["qbase"][:, None] + D["k_cl"] * D["n_b"][:, None]
    per_slice_i = torch.cat([t2s(D["b0q"]), t2s(D["b1q"]),
                             D["b0"].reshape(-1, 1), rbase.reshape(-1, 1)],
                            dim=1).to(torch.int32)
    per_tile_f = torch.cat([
        torch.stack([D["cs_b"], D["lo_b"], 1.0 / D["cs_c"], D["lo_c"]], 1),
        D["ob_lo"], D["ob_hi"], D["db_lo"], D["db_hi"],
        D["oc_lo"], D["oc_hi"], D["dc_lo"], D["dc_hi"]], dim=1)
    Fs, Is = per_slice_f[src.long()], per_slice_i[src.long()]
    Ft = per_tile_f[tile_i.long()]
    ncm1 = (D["n_c"] - 1)[tile_i.long()]
    cs_b, lo_b, icc0, lo_c_r = Ft[:, 0], Ft[:, 1], Ft[:, 2], Ft[:, 3]

    def quarter(k, q):  # per-tile quarter bound k (0: ob_lo .. 7: dc_hi)
        return Ft[:, 4 + 4 * k + q]

    j = Is[:, 8] + rank                                   # row index
    wb0 = lo_b + j.to(torch.float32) * cs_b
    wb1 = wb0 + cs_b
    # Per-row rowinfo: ragged rs offset and column multiplier.
    ri = _take(rowinfo, torch.where(valid_row, Is[:, 9] + j, 0))
    roff = ri & 0x0FFFFFFF
    lgm = ri >> 28
    icc = icc0 * torch.exp2(lgm.to(torch.float32))
    ncl = ((ncm1 + 1) << lgm) - 1

    c0 = torch.full((rowcap,), _IBIG, dtype=torch.int32, device=dev)
    c1 = torch.full((rowcap,), -1, dtype=torch.int32, device=dev)
    row_any = torch.zeros((rowcap,), dtype=torch.bool, device=dev)
    thr_t = torch.full((rowcap,), _BIG, dtype=torch.float32, device=dev)
    for q in range(_SUB):
        tlq, thq = Fs[:, q], Fs[:, 4 + q]
        b0qv, b1qv = Is[:, q], Is[:, 4 + q]
        oblo, obhi, dblo, dbhi = (quarter(k, q) for k in range(4))
        oclo, ochi, dclo, dchi = (quarter(k, q) for k in range(4, 8))
        db_ok = (dblo > 1e-30) | (dbhi < -1e-30)
        ia = 1.0 / torch.where(db_ok, dblo, 1.0)
        ib = 1.0 / torch.where(db_ok, dbhi, 1.0)

        def hull4(na, nb, ia=ia, ib=ib):
            p0, p1 = na * ia, na * ib
            p2, p3 = nb * ia, nb * ib
            return (torch.minimum(torch.minimum(p0, p1),
                                  torch.minimum(p2, p3)),
                    torch.maximum(torch.maximum(p0, p1),
                                  torch.maximum(p2, p3)))

        e0_lo, e0_hi = hull4(wb0 - obhi, wb0 - oblo)
        e1_lo, e1_hi = hull4(wb1 - obhi, wb1 - oblo)
        tj_lo = torch.where(db_ok, torch.maximum(
            tlq, torch.minimum(e0_lo, e1_lo)), tlq)
        tj_hi = torch.where(db_ok, torch.minimum(
            thq, torch.maximum(e0_hi, e1_hi)), thq)
        okq = (tlq <= thq) & (tj_lo <= tj_hi) & (j >= b0qv) & (j <= b1qv)
        x00, x01 = tj_lo * dclo, tj_lo * dchi
        x10, x11 = tj_hi * dclo, tj_hi * dchi
        vlo = oclo + torch.minimum(torch.minimum(x00, x01),
                                   torch.minimum(x10, x11))
        vhi = ochi + torch.maximum(torch.maximum(x00, x01),
                                   torch.maximum(x10, x11))
        c0q = _clip(trunc_i32((vlo - lo_c_r) * icc), 0, ncl)
        c1q = _clip(trunc_i32((vhi - lo_c_r) * icc), 0, ncl)
        c0 = torch.minimum(c0, torch.where(okq, c0q, _IBIG))
        c1 = torch.maximum(c1, torch.where(okq, c1q, -1))
        row_any = row_any | okq
        thr_t = torch.minimum(thr_t, torch.where(okq, tj_lo, _BIG))

    # rs span of the trimmed row. Rows past the total (valid_row False)
    # read entry 0: their spans are garbage in the reference too, and
    # only ever land in masked units.
    live = valid_row & row_any
    g1 = _take(rs, torch.where(live, roff + torch.minimum(c0, ncl), 0))
    g2 = _take(rs, torch.where(live, roff + c1.clamp(min=0) + 1, 0))
    refs_u = _G * _U
    lo_g = torch.div(g1, refs_u, rounding_mode="floor")
    hi_g = -torch.div(-g2, refs_u, rounding_mode="floor")
    valid = live & (g2 > g1)
    # Adjacent rows of one slice share at most one boundary unit; clamp
    # it away pairwise (rows r and r+2 cannot touch after rounding out by
    # less than one unit).
    hi_m = torch.where(valid, hi_g, 0)
    same_slot = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                           src[1:] == src[:-1]])
    prev_hi = torch.cat([hi_m.new_zeros(1), hi_m[:-1]])
    lo_g = torch.where(same_slot, torch.maximum(lo_g, prev_hi), lo_g)
    cnt = torch.where(valid, (hi_g - lo_g).clamp(min=0), 0)
    if any_hit:
        thr_row = torch.full((rowcap,), _BIG_BITS - 1, dtype=torch.int32,
                             device=dev)
    else:
        # Threshold safety as in _plan: a clamped row's boundary unit
        # rides under an earlier row's emission, so thresholds must not
        # increase toward earlier rows of a slot: a suffix min per slot.
        v = torch.where(valid, _bits(thr_t), _BIG_BITS)
        seg_last = torch.cat([src[:-1] != src[1:],
                              torch.ones((1,), dtype=torch.bool, device=dev)])
        thr_row = _segmented_suffix_min(v, seg_last)

    # Block packing from the compact stream.
    ex = cumsum_i32(cnt) - cnt
    rows_t = nrows_d.sum(1, dtype=torch.int32)
    roff_t = cumsum_i32(rows_t) - rows_t
    last_i = (roff_t + rows_t - 1).clamp(0, rowcap - 1).long()
    first_i = roff_t.clamp(0, rowcap - 1).long()
    ex_first = ex[first_i]
    tile_units = torch.where(rows_t > 0, (ex + cnt)[last_i] - ex_first, 0)
    tile_pad, tile_base = _block_pad(tile_units)
    demand = tile_base[-1] + tile_pad[-1]
    # Rows lie tile by tile and ex never decreases, so a row's tile's first
    # ex, the reference's running max of the tile-boundary ex values, is
    # ex at the tile's first row (rows past the total: the last tile's,
    # whose first row is the total when it has none).
    rows_off = _take(tile_base, tile_i) + (ex - _take(ex_first, tile_i))
    out = _pack_units(lo_g, thr_row, rows_off, tile_base, tile_units, demand,
                      nt, bcap, dead_idx)
    return out + (demand, total_rows > rowcap, total_rows)


def _merge(best, out, tile_of):
    """Fold one sweep's per-ray output (t, id, u, v over all tiles) into
    the running best. Exact-t ties prefer the smaller tri id."""
    best_t, best_id, best_u, best_v = best
    nt, tile = best_t.shape
    touched = torch.zeros((nt + 1,), dtype=torch.bool, device=best_t.device)
    touched.index_fill_(0, tile_of.long(), True)
    t_new, id_new, u_new, v_new = (x[:nt * tile].reshape(nt, tile)
                                   for x in out)
    improved = touched[:nt, None] & (
        (t_new < best_t)
        | ((t_new == best_t) & (id_new >= 0)
           & ((id_new < best_id) | (best_id < 0))))
    return (torch.where(improved, t_new, best_t),
            torch.where(improved, id_new, best_id),
            torch.where(improved, u_new, best_u),
            torch.where(improved, v_new, best_v))


# ----------------------------------------------------------------------
# Frame: all rounds, no host reads
# ----------------------------------------------------------------------

class _Frame:
    """Per-frame state shared by the rounds: ray layout (binned unless
    coherent), tables and per-tile precompute."""

    def __init__(self, grid: PacketGrid, rays: Rays, tile: int, n_pad: int,
                 coherent: bool, fine_bins: bool = False):
        self.tile = tile
        self.dims3 = grid.dims3
        self.rs, self.rowinfo, self.cols = grid.rs, grid.rowinfo, grid.cols
        with profiling.span("sweep.layout"):
            if coherent:
                self.xp_ext, self.xt_ext = _pad_coherent(
                    rays.org, rays.dir, rays.tmin, rays.tmax, n_pad, tile)
                self.inv = None
            else:
                self.xp_ext, self.xt_ext, self.inv = _bin_rays(
                    rays.org, rays.dir, rays.tmin, rays.tmax, n_pad, tile,
                    fine=fine_bins)
            self.nt = n_pad // tile
            self.tabs = _tile_tabs(grid.bbox_lo, grid.bbox_hi, grid.dims3)
            self.per_ray, self.per_tile = _precompute(
                self.xp_ext[:n_pad], *self.tabs, grid.bbox_lo, grid.bbox_hi,
                tile, grid.planes)
        # Gather units are 4-row slices of cols; the zero tail rows form
        # exactly the last unit, the dead gather target.
        self.dead_idx = grid.cols.shape[0] // _U - 1
        self.tmax = self.xp_ext[:n_pad, 13].reshape(self.nt, tile)

    def initial_best(self):
        # Untraceable lanes (padding, tmax <= 0) get -BIG so the kernel's
        # early-out still fires for their tiles; they can never hit.
        dev = self.tmax.device
        shape = (self.nt, self.tile)
        return (torch.where(self.tmax > 0, _BIG, -_BIG),
                torch.full(shape, -1, dtype=torch.int32, device=dev),
                torch.zeros(shape, dtype=torch.float32, device=dev),
                torch.zeros(shape, dtype=torch.float32, device=dev))

    def stream(self, best_t, ka, slab, bcap, rmax, any_hit, rowcap=None):
        """One round's block stream: (xt_round, gidx, tile_of, tminb,
        demand, row_ovf, rows); rowcap set = the compact planner, whose
        row overflow and live-row count are the last two (False and 0 for
        the dense planner). xt_round row 14 seeds each ray: closest hit
        with min(best, tmax), so the kernel drops its per-pair t < tmax
        test; any hit with the raw best, since its done threshold means
        "has a hit", which a tmax seed would trip at once. The dummy tile
        keeps -BIG."""
        args = (self.per_ray, self.per_tile, *self.tabs, self.rs,
                self.rowinfo, ka, best_t, self.dims3, slab, any_hit)
        if rowcap is None:
            starts, counts, thr = _plan(*args, rmax=rmax)
            gidx, tile_of, tminb, _, demand = _items(
                starts, counts, thr, self.nt, slab, bcap, self.dead_idx,
                rmax=rmax)
            row_ovf = torch.zeros((), dtype=torch.bool, device=best_t.device)
            rows = torch.zeros((), dtype=torch.int32, device=best_t.device)
        else:
            gidx, tile_of, tminb, _, demand, row_ovf, rows = _plan_items2(
                *args, rowcap, bcap, self.dead_idx)
        seed = best_t if any_hit else torch.minimum(best_t, self.tmax)
        xt_round = self.xt_ext.clone()
        xt_round[14, :self.nt * self.tile] = seed.reshape(-1)
        xt_round[14, self.nt * self.tile:] = -_BIG
        return xt_round, gidx, tile_of, tminb, demand, row_ovf, rows

    def run(self, slab, bcaps, rmax, any_hit, rowcaps=None):
        """All rounds. Returns (best, overflow, demand_max, rows_max):
        overflow ORs every round's unit and row overflow; demand_max is
        the peak round's block demand, rows_max its live-row count."""
        best = self.initial_best()
        ka = self.per_tile["k0"]
        step = self.per_tile["step"]
        dev = ka.device
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        demand_max = torch.zeros((), dtype=torch.int32, device=dev)
        rows_max = torch.zeros((), dtype=torch.int32, device=dev)
        for r, bcap in enumerate(bcaps):
            with profiling.span("sweep.plan"):
                xt_round, gidx, tile_of, tminb, demand, row_ovf, rows = \
                    self.stream(best[0], ka, slab, bcap, rmax, any_hit,
                                None if rowcaps is None else rowcaps[r])
            overflow = overflow | row_ovf | (demand > bcap * _UPB)
            demand_max = torch.maximum(
                demand_max, torch.div(demand, _UPB, rounding_mode="floor"))
            rows_max = torch.maximum(rows_max, rows)
            with profiling.span("sweep.kernel"):
                out = sweep_blocks(xt_round, self.cols, gidx, tile_of, tminb,
                                   self.tile, any_hit=any_hit)
            with profiling.span("sweep.merge"):
                best = _merge(best, out, tile_of)
            ka = ka + step * slab
        return best, overflow, demand_max, rows_max

    def hits(self, best, n) -> Hits:
        if self.inv is not None:
            return _unbin(best, self.inv, n)
        tri = best[1].reshape(-1)[:n]
        return Hits(tri_id=tri,
                    t=torch.where(tri >= 0, best[0].reshape(-1)[:n],
                                  float("inf")),
                    u=best[2].reshape(-1)[:n], v=best[3].reshape(-1)[:n])


def _budgets(grid, n, any_hit, coherent, tile, slab, bmax, rowmax,
             fine_bins=False, compact=None):
    """(tile, slab, n_pad, bcaps, rowcaps) with the reference's defaults.
    `coherent` decides the ray layout: camera order, or binned by (axis,
    sign) with the dead and padding groups in n_pad. `compact` (None: not
    coherent) decides the planner. The dense planner: tile 512, one round
    over the whole grid (the in-kernel early-out stands in for
    re-planning). The compact planner: tile 256 and slabs of 8 slices,
    re-planned between slabs with tightened t-caps. Later rounds run on a
    fraction of the round-0 budget `bmax` (round demands decay as rays
    terminate); rowcaps (compact only) follow the same ladder from
    `rowmax` live rows (default: a full unit budget's worth)."""
    if compact is None:
        compact = not coherent
    da_max = max(d[0] for d in grid.dims3)
    tile = tile or (256 if compact else 512)
    slab = slab or (8 if compact else da_max)
    groups = _NGROUPS_FINE if fine_bins else _NGROUPS
    n_pad = (-(-n // tile) + (0 if coherent else groups)) * tile
    nt = n_pad // tile
    if bmax is None:
        # Any-hit waves have wider frusta per tile; budget slack costs
        # only skipped work.
        scale = 12 if any_hit else 6
        bmax = min(24576 if any_hit else 12288, max(128, scale * nt))

    def cap(r):
        if r == 0:
            f = 1.0
        elif any_hit:
            f = 0.75 if r == 1 else 0.5
        else:
            f = 0.625 if r == 1 else 0.375
        return max(128, int(bmax * f) // 128 * 128)

    bcaps = tuple(cap(r) for r in range(-(-da_max // slab)))
    rowcaps = None
    if compact:
        rowmax = rowmax or bcaps[0] * _UPB
        rowcaps = tuple(max(4096, (-(-rowmax * b // bcaps[0]) // 8) * 8 + 8)
                        for b in bcaps)
    return tile, slab, n_pad, bcaps, rowcaps


def trace_frame(grid: PacketGrid, rays: Rays, any_hit: bool,
                coherent: bool, tile=None, slab=None, bmax=None, rowmax=None,
                fine_bins: bool = False, compact=None, rmax=None):
    """trace_sweep's whole frame, with no host read: (hits, overflow,
    peak round block demand, peak round live rows). RenderSession
    captures it as one CUDA graph per calibrated wave key."""
    tile, slab, n_pad, bcaps, rowcaps = _budgets(
        grid, rays.count, any_hit, coherent, tile, slab, bmax, rowmax,
        fine_bins, compact)
    frame = _Frame(grid, rays, tile, n_pad, coherent, fine_bins)
    best, overflow, demand_max, rows_max = frame.run(
        slab, bcaps, rmax or _RMAX, any_hit, rowcaps)
    return (frame.hits(best, rays.count), overflow, demand_max, rows_max)


def trace_sweep(grid: PacketGrid, rays: Rays, any_hit: bool = False,
                tile: int | None = None, slab: int | None = None,
                bmax: int | None = None, return_overflow: bool = False,
                coherent: bool = False, return_demand: bool = False,
                fine_bins: bool | None = None, rmax: int | None = None,
                compact: bool | None = None, rowmax: int | None = None):
    """Trace rays against a PacketGrid: closest hit, or with any_hit=True
    some hit in (tmin, tmax) (its t and id need not be the closest).

    coherent=True: the rays are camera-ordered (primaries) and keep their
    order. Otherwise they are binned by (axis, sign); fine_bins=True
    (default off, as in the reference) also splits each bin by the signs
    of the two minor direction components. compact picks the planner
    apart from the layout (None: the compact row-stream planner for
    incoherent waves, the dense planner for coherent ones), and with it
    the default tile and slab. The frame reads nothing back to the host.
    If a round demands more than its budget (`bmax` 768-ref blocks in
    round 0, `rowmax` live rows for the compact planner), the surplus is
    dropped and the device-side overflow flag is set
    (return_overflow=True). return_demand adds i32[2] = [peak round block
    demand, peak round live rows (compact planner; 0 otherwise)]."""
    hits, overflow, demand_max, rows_max = trace_frame(
        grid, rays, any_hit, coherent, tile, slab, bmax, rowmax,
        bool(fine_bins), compact, rmax)   # fine_bins None: off, as there
    out = (hits,)
    if return_overflow:
        out = out + (overflow,)
    if return_demand:
        out = out + (torch.stack([demand_max, rows_max]),)
    return out if len(out) > 1 else hits


def first_round_stream(grid: PacketGrid, rays: Rays, any_hit: bool = False,
                       coherent: bool = True, tile: int | None = None,
                       bmax: int | None = None, rowmax: int | None = None,
                       fine_bins: bool = False, compact: bool | None = None):
    """Round 0's sweep inputs (xt_round, gidx, tile_of, tminb, tile) for
    `rays` with trace_sweep's defaults, for holding the kernel against its
    plain version on a real stream."""
    tile, slab, n_pad, bcaps, rowcaps = _budgets(
        grid, rays.count, any_hit, coherent, tile, None, bmax, rowmax,
        fine_bins, compact)
    frame = _Frame(grid, rays, tile, n_pad, coherent, fine_bins)
    xt_round, gidx, tile_of, tminb = frame.stream(
        frame.initial_best()[0], frame.per_tile["k0"], slab, bcaps[0],
        _RMAX, any_hit, rowcaps and rowcaps[0])[:4]
    return xt_round, gidx, tile_of, tminb, tile
