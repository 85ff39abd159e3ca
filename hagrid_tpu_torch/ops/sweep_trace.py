"""Planned-sweep packet traversal, coherent closest-hit path (port of
hagrid_tpu/ops/sweep_trace.py).

Rays stay in their (block-Morton) camera order and are cut into tiles of
`tile` rays. Each round:

1. `_plan` (torch): per tile and slice of the tile's major axis, the
   frustum rect of each ray quarter, trimmed per row, turned into ref
   ranges through the grid's `rs`/`rowinfo` tables, with an early-out
   threshold per range (the slice's tile-entry t);
2. `_items` (torch): the ranges' 24-ref gather units packed into a
   stream of 768-ref blocks (`gidx`), each owned by one tile (`tile_of`,
   ascending) with a per-block threshold (`tminb`);
3. `sweep_blocks` (hand-written CUDA kernel, ops/sweep_kernel.py): every
   tile's run of blocks against its rays, best (t, id, u, v) per ray;
4. `_merge` (torch): fold the round's hits into the running best.

The whole frame runs with no host read: budgets (`bcaps`) are static per
round and overflow is a device flag. Out-of-range semantics differ from
JAX's (see ops/segment.py): every f32 -> i32 cast goes through
`trunc_i32`, every drop-mode scatter through `add_at_drop`, and table
gathers through `_take`, which clamps like a jnp gather and, on the CPU,
asserts that no index was out of range.
"""

from __future__ import annotations

import functools

import torch

from ..core.types import Hits, Rays
from ..grid.packet import BIG as _BIG
from ..grid.packet import PacketGrid, rays_to_x
from .segment import add_at_drop, cumsum_i32, trunc_i32
from .sweep_kernel import UNIT_ROWS, UNITS_PER_BLOCK, sweep_blocks

_SUB = 4        # ray quarters per tile (tighter union rects)
_RMAX = 4       # c-trimmed row ranges per (tile, slice) + one tail range
_G = 6          # refs per group row of `cols`
_U = UNIT_ROWS  # group rows per gather unit
_UPB = UNITS_PER_BLOCK  # gather units per 768-ref block
_IBIG = 1 << 20


def _i32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


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
    dead = torch.zeros((16,), dtype=torch.float32, device=x.device)
    dead[0], dead[1], dead[4] = 1.0, -1e30, 1.0
    pad = dead.expand(n_pad + tile - x.shape[0], 16)
    xp_ext = torch.cat([x, pad], dim=0)
    return xp_ext, xp_ext.t().contiguous()


def _tile_tabs(bbox_lo, bbox_hi, dims3):
    """Per-layout (cs, dims, lo) tables in (slice, row, col) order."""
    ext = bbox_hi - bbox_lo
    cs_rows, lo_rows = [], []
    for a in range(3):
        da, db, dc = dims3[a]
        b, c = (a + 1) % 3, (a + 2) % 3
        cs_rows.append(torch.stack([ext[a] / da, ext[b] / db, ext[c] / dc]))
        lo_rows.append(torch.stack([bbox_lo[a], bbox_lo[b], bbox_lo[c]]))
    n_tab = _i32([list(d) for d in dims3], bbox_lo.device)
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
                dims3, slab):
    """Per (tile, slice): per-quarter frustum bounds, t windows and row
    rects. Elementwise math and reductions only."""
    axis = per_tile["axis"]
    step = per_tile["step"]
    ax = axis.long()
    nt = axis.shape[0]
    dev = axis.device
    cs_b, cs_c = cs_tab[ax, 1], cs_tab[ax, 2]
    lo_b, lo_c = lo_tab[ax, 1], lo_tab[ax, 2]
    n_a, n_b, n_c = n_tab[ax, 0], n_tab[ax, 1], n_tab[ax, 2]

    # Ray liveness: best hit precedes the slab's entry plane -> done.
    p_tile = per_tile["p_tile"]
    plane0 = _along(p_tile, _clip(ka + (step < 0).to(torch.int32), 0,
                                  n_a)[:, None], 1)[:, 0]
    t_entry = (plane0[:, None] - per_ray["o_a"]) * per_ray["inv_a"]
    lim = torch.minimum(per_ray["tmax"], per_ray["leave"])
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
    qbase = _i32(qbase_list, dev)[ax]                    # (nt,)
    k_cl = _clip(ks, 0, n_a[:, None] - 1)

    return dict(
        nt=nt, cs_b=cs_b, cs_c=cs_c, lo_b=lo_b, lo_c=lo_c, n_a=n_a,
        n_b=n_b, n_c=n_c, qbase=qbase, ob_lo=ob_lo, ob_hi=ob_hi,
        oc_lo=oc_lo, oc_hi=oc_hi, db_lo=db_lo, db_hi=db_hi, dc_lo=dc_lo,
        dc_hi=dc_hi, tl=tl, th=th, rect_okq=rect_okq, rect_ok=rect_ok,
        b0q=b0q, b1q=b1q, b0=b0, b1=b1, k_cl=k_cl)


def _plan(per_ray, per_tile, cs_tab, n_tab, lo_tab, rs, rowinfo, ka,
          best_t, dims3, slab, rmax=_RMAX):
    """One slab's plan in dense slot form: per (tile, slice) `rmax`
    column-trimmed row ranges plus one untrimmed tail range, as gather
    units. Returns (unit_start, unit_count, thr_bits) flattened over
    (tile, slice, rmax + 1); thr_bits is the i32 bit pattern of the
    slot's early-out threshold (no ref of the slot can hit earlier)."""
    D = _plan_dense(per_ray, per_tile, cs_tab, n_tab, lo_tab, ka, best_t,
                    dims3, slab)
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


def _items(starts, counts, thr, nt, slab, bcap, dead_idx, rmax=_RMAX):
    """Pack the ranges' gather units into a per-round block stream:
    gidx i32[bcap*_UPB] (dead_idx for padding), tile_of i32[bcap]
    (owning tile, ascending; nt for unused blocks), tminb i32[bcap]
    (per-block early-out threshold, f32 bits), n_blocks, and the
    unclamped unit demand (overflow detection). Each tile's segment is
    padded to whole blocks so blocks never straddle tiles."""
    dev = counts.device
    nr = slab * (rmax + 1)
    ucap = bcap * _UPB
    cnt2 = counts.reshape(nt, nr)
    tile_tot = cnt2.sum(1, dtype=torch.int32)
    tile_pad = -torch.div(-tile_tot, _UPB, rounding_mode="floor") * _UPB
    tile_base = cumsum_i32(tile_pad) - tile_pad
    within = cumsum_i32(cnt2, dim=1) - cnt2
    roff = (tile_base[:, None] + within).reshape(-1)
    demand = tile_base[-1] + tile_pad[-1]

    # Per-slot (start - roff) and threshold by delta scatter + prefix sum
    # (piecewise constant per range; stacked deltas of empty ranges
    # telescope). Threshold deltas span the whole i32 range, so they
    # accumulate in i64.
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    sr = starts - roff
    sr_ff = cumsum_i32(add_at_drop(ucap, roff, torch.diff(sr, prepend=zero)))
    thr64 = thr.to(torch.int64)
    d_thr = torch.diff(thr64, prepend=zero.to(torch.int64))
    thr_ff = torch.cumsum(add_at_drop(ucap, roff, d_thr), 0).to(torch.int32)
    # Conservative per-block threshold: min over the block's units.
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
    own_end = _take(tile_base + tile_tot, btile)
    slot = blk[:, None] * _UPB + torch.arange(_UPB, dtype=torch.int32,
                                              device=dev)[None, :]
    valid = slot < own_end[:, None]
    gidx = torch.where(valid, slot + sr_ff.reshape(bcap, _UPB), dead_idx)
    return gidx.reshape(-1).to(torch.int32), tile_of, tminb, n_blocks, demand


def _merge(best, out, tile_of):
    """Fold one sweep's per-ray output (t, id, u, v over all tiles) into
    the running best. Exact-t ties prefer the smaller tri id."""
    best_t, best_id, best_u, best_v = best
    nt, tile = best_t.shape
    touched = torch.zeros((nt + 1,), dtype=torch.bool, device=best_t.device)
    touched[tile_of.long()] = True
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
    """Per-frame state shared by the rounds: ray layout, tables and
    per-tile precompute."""

    def __init__(self, grid: PacketGrid, rays: Rays, tile: int, n_pad: int):
        self.tile = tile
        self.dims3 = grid.dims3
        self.rs, self.rowinfo, self.cols = grid.rs, grid.rowinfo, grid.cols
        self.xp_ext, self.xt_ext = _pad_coherent(
            rays.org, rays.dir, rays.tmin, rays.tmax, n_pad, tile)
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
        # Untraceable lanes (padding) get -BIG so the kernel's early-out
        # still fires for their tiles; they can never produce a hit.
        dev = self.tmax.device
        shape = (self.nt, self.tile)
        return (torch.where(self.tmax > 0, _BIG, -_BIG),
                torch.full(shape, -1, dtype=torch.int32, device=dev),
                torch.zeros(shape, dtype=torch.float32, device=dev),
                torch.zeros(shape, dtype=torch.float32, device=dev))

    def stream(self, best_t, ka, slab, bcap, rmax):
        """One round's block stream: (xt_round, gidx, tile_of, tminb,
        demand). xt_round row 14 seeds each ray with min(best, tmax)
        (closest-hit folds tmax into the seed, so the kernel drops its
        per-pair t < tmax test); the dummy tile keeps -BIG."""
        starts, counts, thr = _plan(
            self.per_ray, self.per_tile, *self.tabs, self.rs, self.rowinfo,
            ka, best_t, self.dims3, slab, rmax=rmax)
        gidx, tile_of, tminb, _, demand = _items(
            starts, counts, thr, self.nt, slab, bcap, self.dead_idx,
            rmax=rmax)
        seed = torch.minimum(best_t, self.tmax)
        xt_round = self.xt_ext.clone()
        xt_round[14, :self.nt * self.tile] = seed.reshape(-1)
        xt_round[14, self.nt * self.tile:] = -_BIG
        return xt_round, gidx, tile_of, tminb, demand

    def run(self, slab, bcaps, rmax):
        best = self.initial_best()
        ka = self.per_tile["k0"]
        step = self.per_tile["step"]
        dev = ka.device
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        demand_max = torch.zeros((), dtype=torch.int32, device=dev)
        for bcap in bcaps:
            xt_round, gidx, tile_of, tminb, demand = self.stream(
                best[0], ka, slab, bcap, rmax)
            overflow = overflow | (demand > bcap * _UPB)
            demand_max = torch.maximum(
                demand_max, torch.div(demand, _UPB, rounding_mode="floor"))
            out = sweep_blocks(xt_round, self.cols, gidx, tile_of, tminb,
                               self.tile)
            best = _merge(best, out, tile_of)
            ka = ka + step * slab
        return best, overflow, demand_max


def _budgets(grid, n, tile, slab, bmax):
    """(tile, slab, n_pad, bcaps) with the reference's defaults: one
    round over the whole grid for coherent closest-hit waves, and a
    per-round budget ladder (later rounds on a fraction of bmax)."""
    da_max = max(d[0] for d in grid.dims3)
    tile = tile or 512
    slab = slab or da_max
    n_pad = -(-n // tile) * tile
    nt = n_pad // tile
    if bmax is None:
        bmax = min(12288, max(128, 6 * nt))

    def cap(r):
        f = 1.0 if r == 0 else 0.625 if r == 1 else 0.375
        return max(128, int(bmax * f) // 128 * 128)

    bcaps = tuple(cap(r) for r in range(-(-da_max // slab)))
    return tile, slab, n_pad, bcaps


def trace_sweep(grid: PacketGrid, rays: Rays, any_hit: bool = False,
                tile: int | None = None, slab: int | None = None,
                bmax: int | None = None, return_overflow: bool = False,
                coherent: bool = False, return_demand: bool = False,
                rmax: int | None = None, compact: bool | None = None):
    """Trace camera-coherent rays against a PacketGrid, closest hit.

    The frame reads nothing back to the host. If a round demands more
    than its budget (`bmax` 768-ref blocks in round 0), the surplus is
    dropped and the device-side overflow flag is set
    (return_overflow=True). slab=None plans the whole grid in one round;
    the in-kernel early-out stands in for re-planning.
    return_demand adds i32[2] = [peak round block demand, 0]."""
    if not coherent:
        raise NotImplementedError(
            "only coherent=True (camera-ordered waves) is ported; the "
            "binned incoherent path comes with the any-hit kernel")
    if any_hit:
        raise NotImplementedError("any-hit tracing is not ported yet")
    if compact:
        raise NotImplementedError("the compact row-stream planner is not "
                                  "ported yet")
    n = rays.count
    tile, slab, n_pad, bcaps = _budgets(grid, n, tile, slab, bmax)
    frame = _Frame(grid, rays, tile, n_pad)
    best, overflow, demand_max = frame.run(slab, bcaps, rmax or _RMAX)

    tri = best[1].reshape(-1)[:n]
    found = tri >= 0
    hits = Hits(tri_id=tri,
                t=torch.where(found, best[0].reshape(-1)[:n], float("inf")),
                u=best[2].reshape(-1)[:n], v=best[3].reshape(-1)[:n])
    out = (hits,)
    if return_overflow:
        out = out + (overflow,)
    if return_demand:
        out = out + (torch.stack([demand_max, torch.zeros_like(demand_max)]),)
    return out if len(out) > 1 else hits


def first_round_stream(grid: PacketGrid, rays: Rays, tile: int = 512,
                       bmax: int | None = None):
    """Round 0's sweep inputs for camera-coherent `rays`:
    (xt_round, gidx, tile_of, tminb). For holding the kernel against its
    plain version on a real stream."""
    tile, slab, n_pad, bcaps = _budgets(grid, rays.count, tile, None, bmax)
    frame = _Frame(grid, rays, tile, n_pad)
    xt_round, gidx, tile_of, tminb, _ = frame.stream(
        frame.initial_best()[0], frame.per_tile["k0"], slab, bcaps[0],
        _RMAX)
    return xt_round, gidx, tile_of, tminb
