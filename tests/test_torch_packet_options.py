"""PyTorch port, the packet grid's options: per-row column refinement
(build_packet(refine=True)), adaptive slice planes (adaptive=True) and
fine ray bins (trace_sweep(fine_bins=True)), held against the JAX
package.

Tolerances: every integer table (rs, rowinfo, totals, the planner's
streams, the binned layout) and the slice planes are bit-equal, the
planner's early-out thresholds within 4 ulp; the cols
coefficients match at rtol 1e-6, atol 1e-6 (the compiled reference
contracts the cross products into FMAs), their tri ids exactly. Hits
are held to tests/test_sweep_trace.py::_check against the reference's
brute-force oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_packet import _cell_sets
from test_sweep_trace import _check as check_hits

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid import packet as j_packet
from hagrid_tpu.ops import sweep_trace as j_st
from hagrid_tpu_torch import interop
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.grid import invariants, packet
from hagrid_tpu_torch.ops import sweep_trace as st

INT_TABLES = ("rs", "rowinfo", "total_refs", "total_pairs")
# The planner's early-out thresholds: f32 bit patterns, which the compiled
# reference computes with contracted FMAs.
THR_TABLES = {"thr", "tminb"}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


def _scene(name):
    if name == "cornell":
        return j_scenes.cornell_box()
    if name.startswith("sponza"):
        return j_scenes.sponza_like(int(name[6:]))
    return j_scenes.random_soup(3000, seed=1)


def _assert_tables_equal(g, jg):
    assert g.dims3 == tuple(tuple(d) for d in jg.dims3)
    for k in INT_TABLES:
        np.testing.assert_array_equal(_np(getattr(g, k)),
                                      _np(getattr(jg, k)), err_msg=k)
    np.testing.assert_array_equal(_np(g.planes), _np(jg.planes))
    cols, jcols = _np(g.cols), _np(jg.cols)
    assert cols.shape == jcols.shape
    np.testing.assert_array_equal(cols[:, 16::20], jcols[:, 16::20])
    np.testing.assert_allclose(cols, jcols, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ref_sponza():
    """sponza_like(2000) and the reference's refined + adaptive grid at
    the default dims (shared with the planner tests)."""
    v, f = j_scenes.sponza_like(2000)
    jt = JTris.from_mesh(v, f)
    return v, f, jt, j_packet.build_packet(jt, refine=True, adaptive=True)


@pytest.fixture(scope="module")
def adaptive20000():
    """sponza_like(20000)'s adaptive grids: (the port's, the reference's)."""
    v, f = j_scenes.sponza_like(20000)
    return (packet.build_packet(Triangles.from_mesh(v, f, device="cpu"),
                                adaptive=True),
            j_packet.build_packet(JTris.from_mesh(v, f), adaptive=True))


@pytest.mark.parametrize("name,kw", [
    ("cornell", dict(dims=(6, 5, 4), refine=True)),
    ("sponza2000", dict(dims=(4, 4, 4), refine=True)),
    ("sponza2000", dict(refine=True, adaptive=True)),
    ("sponza20000", dict(adaptive=True)),
    ("soup3000", dict(adaptive=True, refine=True)),
])
def test_option_tables_equal_reference(name, kw, ref_sponza, adaptive20000):
    """Refined and adaptive tables equal the reference's: ragged rs rows,
    rowinfo multipliers, totals, planes; and the refinement gate fires
    (rows with m = 2 and, on Sponza, m = 4)."""
    if name == "sponza20000":
        g, jg = adaptive20000
    else:
        if name == "sponza2000" and kw.get("adaptive"):
            v, f, _, jg = ref_sponza
        else:
            v, f = _scene(name)
            jg = j_packet.build_packet(JTris.from_mesh(v, f), **kw)
        g = packet.build_packet(Triangles.from_mesh(v, f, device="cpu"),
                                **kw)
    _assert_tables_equal(g, jg)
    lgm = _np(g.rowinfo) >> 28
    if kw.get("refine"):
        assert (lgm >= 1).any(), "refinement never triggered"
        if name.startswith("sponza"):
            assert (lgm == 2).any(), "no row refined by 4"
    else:
        assert (lgm == 0).all()


def test_refined_columns_union_and_planes(adaptive20000):
    """Per base cell, the union of a refined row's fine columns equals the
    unrefined cell set (fine binning only splits, never drops); adaptive
    planes are strictly increasing, pinned to the bbox and not uniform."""
    v, f = j_scenes.sponza_like(2000)
    tris = Triangles.from_mesh(v, f, device="cpu")
    g0 = packet.build_packet(tris, dims=(4, 4, 4))
    g1 = packet.build_packet(tris, dims=(4, 4, 4), refine=True)
    assert g1.num_cells == g0.num_cells == 64
    for axis in range(3):
        assert _cell_sets(g1, axis, None) == _cell_sets(g0, axis, None)
    assert int(g1.total_refs) > int(g0.total_refs)   # straddlers duplicate
    ga = adaptive20000[0]
    pl = _np(ga.planes)
    for a in range(3):
        da = ga.dims3[a][0]
        row = pl[a, :da + 1]
        assert (np.diff(row) > 0).all()
        assert row[0] == _np(ga.bbox_lo)[a] and row[-1] == _np(ga.bbox_hi)[a]
        assert (pl[a, da:] == row[-1]).all()
    da = ga.dims3[0][0]
    assert not np.allclose(pl[0, :da + 1], np.linspace(pl[0, 0], pl[0, da],
                                                       da + 1), rtol=1e-3)


@pytest.fixture(scope="module")
def sponza():
    """sponza_like(2000) in both packages, the port's default, refined and
    adaptive grids, 48x48 primaries and 1536 random interior rays (a
    fifth of them with a finite tmax) with the reference oracle's answers."""
    v, f = j_scenes.sponza_like(2000)
    jt = JTris.from_mesh(v, f)
    tris = Triangles.from_mesh(v, f, device="cpu")
    grids = {"default": packet.build_packet(tris),
             "refine": packet.build_packet(tris, refine=True),
             "adaptive": packet.build_packet(tris, adaptive=True)}
    jr = j_primary_rays(j_scenes.sponza_camera(), 48, 48, order="block")
    prim = interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                   device="cpu")
    rng = np.random.default_rng(11)
    lo, hi = v.min(0), v.max(0)
    n = 1536
    org = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo),
                      (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.2, 3.0, np.inf).astype(np.float32)
    tmax[rng.random(n) < 0.03] = 0.0
    jrand = JRays.make(org, d, tmax=tmax)
    rand = interop.rays_from_numpy(org, d, np.zeros(n, np.float32), tmax,
                                   device="cpu")
    ao_tmax = np.full(n, 3.0, np.float32)
    jao = JRays.make(org, d, tmax=ao_tmax)
    ao = interop.rays_from_numpy(org, d, np.zeros(n, np.float32), ao_tmax,
                                 device="cpu")
    return dict(grids=grids, tris=tris, prim=prim, rand=rand, ao=ao,
                prim_ref=j_oracle.closest_hit(jr, jt),
                rand_ref=j_oracle.closest_hit(jrand, jt),
                ao_ref=np.asarray(j_oracle.any_hit(jao, jt)))


@pytest.mark.parametrize("kind", ["refine", "adaptive"])
def test_primaries_on_option_grids_match_oracle(sponza, kind):
    """Coherent primaries (tile 128, the dense planner) through ragged rows
    and non-uniform planes, with no overflow."""
    hits, ovf = st.trace_sweep(sponza["grids"][kind], sponza["prim"],
                               coherent=True, tile=128, return_overflow=True)
    assert not bool(ovf)
    check_hits(hits, sponza["prim_ref"])


@pytest.mark.parametrize("kind,fine", [("default", True), ("refine", False),
                                       ("refine", True), ("adaptive", True)])
def test_incoherent_closest_hit_matches_oracle(sponza, kind, fine):
    """Binned incoherent rays (the compact planner, tile 64, a budget of
    4096 blocks), with and without the 24 fine bins."""
    hits, ovf = st.trace_sweep(sponza["grids"][kind], sponza["rand"],
                               tile=64, fine_bins=fine, bmax=4096,
                               return_overflow=True)
    assert not bool(ovf)
    check_hits(hits, sponza["rand_ref"])


@pytest.mark.parametrize("kind,fine", [("default", True), ("refine", False),
                                       ("refine", True)])
def test_any_hit_matches_oracle(sponza, kind, fine):
    """An AO-like any-hit wave (tmax 3): hit/miss equals the oracle's on
    more than 99.9% of the rays."""
    hits, ovf = st.trace_sweep(sponza["grids"][kind], sponza["ao"],
                               any_hit=True, tile=64, fine_bins=fine,
                               bmax=4096, return_overflow=True)
    assert not bool(ovf)
    agree = ((_np(hits.tri_id) >= 0) == sponza["ao_ref"]).mean()
    assert agree > 0.999, agree


def test_fine_bins_pad_for_every_group(sponza):
    """fine_bins=True leaves room for 25 groups' tile padding (n_pad) and
    is ignored by coherent waves, as in the reference."""
    g = sponza["grids"]["default"]
    n = sponza["rand"].count
    assert st._budgets(g, n, False, False, 64, None, None, None,
                       True)[2] == (-(-n // 64) + 25) * 64
    assert st._budgets(g, n, False, False, 64, None, None, None,
                       False)[2] == (-(-n // 64) + 7) * 64
    a = st.trace_sweep(g, sponza["prim"], coherent=True, tile=128,
                       fine_bins=True)
    b = st.trace_sweep(g, sponza["prim"], coherent=True, tile=128)
    assert torch.equal(a.tri_id, b.tri_id) and torch.equal(a.t, b.t)


def test_bin_rays_fine_equal():
    """The 24 + 1 fine groups of 700 rays with dead ones and axis-parallel
    components (signs of -0.0 included), tile 32: row layout and inverse
    map equal the reference's."""
    n, tile = 700, 32
    n_pad = (-(-n // tile) + 25) * tile
    rng = np.random.default_rng(3)
    org = rng.uniform(-1, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[rng.random((n, 3)) < 0.1] = 0.0
    d[::13, 2] = -0.0
    d[(d == 0).all(1)] = (0.0, 1.0, 0.0)
    tmax = np.where(rng.random(n) < 0.05, 0.0, np.inf).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    jx, jxt, jinv = j_st._bin_rays(*(jnp.asarray(a) for a in
                                     (org, d, tmin, tmax)), n_pad, tile,
                                   fine=True)
    x, xt, inv = st._bin_rays(*(torch.as_tensor(a) for a in
                                (org, d, tmin, tmax)), n_pad, tile,
                              fine=True)
    np.testing.assert_array_equal(_np(inv), _np(jinv))
    np.testing.assert_array_equal(_np(x), _np(jx))
    np.testing.assert_array_equal(_np(xt), _np(jxt))
    assert (_np(inv) >= 0).sum() == n


def _plan_tables(mod, arr, jg, xp, compact, tile):
    """Round 0 of a closest-hit planner of `mod` (the reference's
    sweep_trace or the port's) on the same X matrix and grid tables."""
    n = xp.shape[0]
    nt = n // tile
    dead = jg.cols.shape[0] // 4 - 1
    da = max(d[0] for d in jg.dims3)

    def run(xp, lo, hi, planes, rs, rowinfo):
        tabs = mod._tile_tabs(lo, hi, jg.dims3)
        pr, pt = mod._precompute(xp, *tabs, lo, hi, tile, planes)
        best = mod_where(xp[:, 13] > 0, 3e38, -3e38).reshape(nt, tile)
        if compact:
            return mod._plan_items2(pr, pt, *tabs, rs, rowinfo, pt["k0"],
                                    best, jg.dims3, 8, False, 8192, 1024,
                                    dead)
        starts, counts, thr = mod._plan(pr, pt, *tabs, rs, rowinfo,
                                        pt["k0"], best, jg.dims3, da, False)
        return (starts, counts, thr) + tuple(mod._items(
            starts, counts, thr, nt, da, 256, dead))

    if mod is j_st:   # one compiled program, not hundreds of eager ops
        mod_where = jnp.where
        run = jax.jit(run)
    else:
        mod_where = torch.where
    out = run(*(arr(_np(x)) for x in (xp, jg.bbox_lo, jg.bbox_hi, jg.planes,
                                      jg.rs, jg.rowinfo)))
    names = (("gidx", "tile_of", "tminb", "n_blocks", "demand", "row_ovf",
              "total_rows") if compact else
             ("starts", "counts", "thr", "gidx", "tile_of", "tminb",
              "n_blocks", "demand"))
    return {k: _np(v) for k, v in zip(names, out)}


@pytest.mark.parametrize("compact", [False, True])
def test_planner_tables_on_refined_grid_equal(compact, ref_sponza):
    """The dense planner (coherent primaries, tile 128) and the compact
    planner (fine-binned random rays, tile 64, a third of them with a
    finite tmax), closest hit, on the reference's refined and adaptive
    grid (m = 4 rows present): the integer streams equal the reference's,
    the early-out thresholds (f32 bits) within 4 ulp of the compiled
    reference's."""
    v, f, _, jg = ref_sponza
    if compact:
        tile, n = 64, 1024
        rng = np.random.default_rng(5)
        org = rng.uniform(v.min(0), v.max(0), (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        tmax = np.where(rng.random(n) < 0.3, 2.0, np.inf).astype(np.float32)
        n_pad = (-(-n // tile) + 25) * tile
        xp, _, _ = j_st._bin_rays(*(jnp.asarray(a) for a in (
            org, d, np.zeros(n, np.float32), tmax)), n_pad, tile, fine=True)
        xp = _np(xp)[:n_pad]
    else:
        tile = 128
        jr = j_primary_rays(j_scenes.sponza_camera(), 32, 32, order="block")
        xp, _ = j_st._pad_coherent(jr.org, jr.dir, jr.tmin, jr.tmax, 1024,
                                   tile)
        xp = _np(xp)[:1024]
    want = _plan_tables(j_st, jnp.asarray, jg, xp, compact, tile)
    got = _plan_tables(st, torch.as_tensor, jg, xp, compact, tile)
    bad = [k for k in want if k not in THR_TABLES
           and not np.array_equal(got[k], want[k])]
    assert not bad, f"tables differ: {bad}"
    for k in THR_TABLES & set(want):   # t >= 0: bit order is float order
        ulps = np.abs(got[k].astype(np.int64) - want[k].astype(np.int64))
        assert ulps.max() <= 4, (k, ulps.max())
    assert int(got["n_blocks"]) > 0
    assert (_np(jg.rowinfo) >> 28).max() == 2


def _break_fine_column(g):
    """Overwrite every ref of one non-empty fine column of a refined row
    with another tri's id: its tris go missing from that column."""
    ri, rs = _np(g.rowinfo), _np(g.rs)
    da, db, dc = g.dims3[0]
    for r in np.nonzero((ri[:da * db] >> 28) > 0)[0]:
        ro = int(ri[r] & 0x0FFFFFFF)
        for fc in range((1 << int(ri[r] >> 28)) * dc):
            lo, hi = int(rs[ro + fc]), int(rs[ro + fc + 1])
            if hi > lo:
                refs = g.cols[:, :120].reshape(-1, 20).clone()
                refs[lo:hi, 16] = float((int(refs[lo:hi, 16].max()) + 1)
                                        % g.tris.count)
                cols = g.cols.clone()
                cols[:, :120] = refs.reshape(-1, 120)
                return dataclasses.replace(g, cols=cols)
    raise AssertionError("no refined row with refs")


def _break_multiplier(g):
    """Drop the column multiplier of a refined row with refs past its
    first dc fine columns: its rs span no longer meets the next row's."""
    ri, rs = _np(g.rowinfo), _np(g.rs)
    dc = g.dims3[0][2]
    for r in np.nonzero((ri >> 28) > 0)[0]:
        ro, m = int(ri[r] & 0x0FFFFFFF), 1 << int(ri[r] >> 28)
        if rs[ro + dc] != rs[ro + m * dc]:
            bad = g.rowinfo.clone()
            bad[r] = int(ri[r] & 0x0FFFFFFF)
            return dataclasses.replace(g, rowinfo=bad)
    raise AssertionError("no refined row with refs past dc")


def test_check_packet_on_option_grids(sponza):
    """check_packet passes on the refined and adaptive Sponza-like grids
    (a sample of 128 tris, every fine column they cover) and on a refined
    Cornell grid (every tri), and catches a broken refined grid: a fine
    column that lost its tris, a row whose multiplier was dropped."""
    for kind in ("refine", "adaptive"):
        invariants.check_packet(sponza["grids"][kind], sample_tris=128)
    v, f = j_scenes.cornell_box()
    g = packet.build_packet(Triangles.from_mesh(v, f, device="cpu"),
                            dims=(6, 5, 4), refine=True)
    invariants.check_packet(g, sample_tris=None)
    for b in (_break_fine_column(g), _break_multiplier(g)):
        with pytest.raises(AssertionError):
            invariants.check_packet(b, sample_tris=None)
