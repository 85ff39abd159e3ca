"""PyTorch port, trace layer: planner, sweep, merge, trace_sweep, session.

The port's tracer reads the reference's own grid (handed over as numpy
through interop.packet_grid_from_numpy), so tracer parity is held apart
from build parity. The planner's integer tables must equal the
reference's when both run op by op on the same inputs; hits are held to
tests/test_sweep_trace.py::_check's thresholds against the reference
tracer (interpret mode) and the reference oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import block_index as j_block_index
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid.packet import build_packet as j_build_packet
from hagrid_tpu.ops import sweep_trace as j_st
from hagrid_tpu.render.session import RenderSession as JRenderSession
from hagrid_tpu_torch import interop
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.io.image import dhash, hamming, shade_eyelight
from hagrid_tpu_torch.ops import sweep_trace as st
from hagrid_tpu_torch.ops.sweep_kernel import (launches, sweep_blocks,
                                               sweep_blocks_plain)
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.scenes import (SPONZA_EYELIGHT_DHASH, cornell_camera,
                                     sponza_camera)

TILE = 128


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


@pytest.fixture(scope="module")
def cornell():
    """Reference grid and its port copy (same tables), 32x32 block-order
    primaries in both packages, and random interior rays."""
    v, f = j_scenes.cornell_box()
    jt = JTris.from_mesh(v, f)
    jg = j_build_packet(jt, dims=(6, 6, 6))
    g = interop.packet_grid_from_numpy(
        jg.dims3, jg.bbox_lo, jg.bbox_hi, jg.rs, jg.rowinfo, jg.cols,
        jg.planes, jg.total_refs, jg.total_pairs, jt.v0, jt.e1, jt.e2, jt.n,
        device="cpu")
    jr = j_primary_rays(j_scenes.cornell_camera(), 32, 32, order="block")
    rays = interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                   device="cpu")
    rng = np.random.default_rng(8)
    org = rng.uniform(50, 500, (512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(512) < 0.2, 100.0, np.inf).astype(np.float32)
    jrand = JRays.make(org, d, tmax=tmax)
    rand = interop.rays_from_numpy(org, d, np.zeros(512, np.float32), tmax,
                                   device="cpu")
    return dict(v=v, f=f, jt=jt, jg=jg, g=g, jr=jr, rays=rays,
                jrand=jrand, rand=rand)


def _plan_tables(mod, arr, c, jrays, *any_hit):
    """Round 0's planner and items tables of `mod` (the reference's
    sweep_trace module or the port's) on the reference's X matrix of
    `jrays` and the shared grid, tile 128, the whole grid in one slab."""
    jg = c["jg"]
    n = jrays.org.shape[0]
    nt = n // TILE
    da = max(d[0] for d in jg.dims3)
    xp, _ = j_st._pad_coherent(jrays.org, jrays.dir, jrays.tmin,
                               jrays.tmax, n, TILE)
    lo, hi = arr(_np(jg.bbox_lo)), arr(_np(jg.bbox_hi))
    tabs = mod._tile_tabs(lo, hi, jg.dims3)
    pr, pt = mod._precompute(arr(_np(xp)[:n]), *tabs, lo, hi, TILE,
                             arr(_np(jg.planes)))
    best = np.full((nt, TILE), 3e38, np.float32)
    starts, counts, thr = mod._plan(
        pr, pt, *tabs, arr(_np(jg.rs)), arr(_np(jg.rowinfo)), pt["k0"],
        arr(best), jg.dims3, da, *any_hit)
    gidx, tile_of, tminb, n_blocks, demand = mod._items(
        starts, counts, thr, nt, da, 256, jg.cols.shape[0] // 4 - 1)
    tables = dict(k0=pt["k0"], axis=pt["axis"], step=pt["step"],
                  starts=starts, counts=counts, thr=thr, gidx=gidx,
                  tile_of=tile_of, tminb=tminb, n_blocks=n_blocks,
                  demand=demand)
    return {k: _np(v) for k, v in tables.items()}


def _differing(a, b):
    return [k for k in a if not np.array_equal(a[k], b[k])]


def test_plan_and_items_tables_equal(cornell):
    """_precompute, _plan and _items on the same X matrix and grid: the
    integer tables are equal (both run op by op, so no FMA contraction
    separates them)."""
    want = _plan_tables(j_st, jnp.asarray, cornell, cornell["jr"], False)
    got = _plan_tables(st, torch.as_tensor, cornell, cornell["jr"])
    assert not _differing(got, want), \
        f"tables differ: {_differing(got, want)}"
    assert int(got["n_blocks"]) > 0


def test_planner_int32_overflow_clamped_like_xla(cornell, monkeypatch):
    """Every 5th primary ray keeps its direction at 1e-12 of the length:
    within a ray quarter the planner multiplies the short rays' huge t
    by the long rays' d, and the column bounds run past int32 before
    they are clipped to the grid. XLA's cast saturates; a plain torch
    cast wraps to INT_MIN and turns a rect's upper column into 0. The
    port's tables must equal the reference's, and with the plain cast
    they must not."""
    jr = cornell["jr"]
    d = np.array(jr.dir)
    d[::5] *= np.float32(1e-12)
    jrays = JRays.make(np.array(jr.org), d)
    want = _plan_tables(j_st, jnp.asarray, cornell, jrays, False)
    got = _plan_tables(st, torch.as_tensor, cornell, jrays)
    assert not _differing(got, want), \
        f"tables differ: {_differing(got, want)}"
    assert want["counts"].sum() > 0
    monkeypatch.setattr(st, "trunc_i32", lambda x: x.to(torch.int32))
    naive = _plan_tables(st, torch.as_tensor, cornell, jrays)
    assert _differing(naive, want), "the case never reaches the cast"


def test_merge_equal(cornell):
    rng = np.random.default_rng(9)
    nt, tile = 5, 64
    best_t = rng.uniform(1, 10, (nt, tile)).astype(np.float32)
    best_t[0] = 3e38
    best_id = rng.integers(-1, 50, (nt, tile)).astype(np.int32)
    best_u = rng.random((nt, tile)).astype(np.float32)
    best_v = rng.random((nt, tile)).astype(np.float32)
    n_cols = (nt + 1) * tile
    t_new = np.where(rng.random(n_cols) < 0.3, best_t.reshape(-1).tolist()
                     + [1.0] * tile, rng.uniform(1, 10, n_cols))
    t_new = t_new.astype(np.float32)
    id_new = rng.integers(-1, 50, n_cols).astype(np.int32)
    u_new = rng.random(n_cols).astype(np.float32)
    v_new = rng.random(n_cols).astype(np.float32)
    tile_of = np.array([0, 0, 2, 3, 3, 5, 5], np.int32)
    out_ext = np.zeros((8, n_cols), np.float32)
    out_ext[0], out_ext[1], out_ext[2], out_ext[3] = (t_new, id_new, u_new,
                                                      v_new)
    want = j_st._merge(tuple(jnp.asarray(a) for a in
                             (best_t, best_id, best_u, best_v)),
                       jnp.asarray(out_ext), jnp.asarray(tile_of))
    got = st._merge(tuple(torch.as_tensor(a) for a in
                          (best_t, best_id, best_u, best_v)),
                    tuple(torch.as_tensor(a) for a in
                          (t_new, id_new, u_new, v_new)),
                    torch.as_tensor(tile_of))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))


def _random_stream(g, nt=4, seed=10):
    """Random rays through the scene box, 0-3 pre-gathered blocks per tile,
    unused blocks at the end, a mix of never-skip and random early-out
    thresholds."""
    rng = np.random.default_rng(seed)
    n_cols = (nt + 1) * TILE
    lo, hi = _np(g.bbox_lo), _np(g.bbox_hi)
    # Origins on a sphere around the scene, aimed at points inside it:
    # t stays large against the coordinates, so the f - o.n cancellation
    # does not magnify one-ulp differences between the two sides.
    centre, radius = (lo + hi) / 2, 1.5 * np.linalg.norm(hi - lo)
    u = rng.normal(size=(n_cols, 3))
    org = (centre + radius * u / np.linalg.norm(u, axis=1, keepdims=True))
    d = rng.uniform(lo, hi, (n_cols, 3)) - org
    org = org.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    x = st.rays_to_x(torch.as_tensor(org), torch.as_tensor(d),
                     torch.zeros(n_cols), torch.full((n_cols,), np.inf))
    xt = _np(x.t()).copy()
    xt[14] = np.where(rng.random(n_cols) < 0.2, -3e38, 3e38)
    xt[14, nt * TILE:] = -3e38
    per_tile = np.array([2, 0, 3, 1])[:nt]
    tile_of = np.concatenate([np.repeat(np.arange(nt), per_tile),
                              [nt] * 3]).astype(np.int32)
    nb = tile_of.size
    n_units = g.cols.shape[0] // 4
    gidx = rng.integers(0, n_units, nb * 32).astype(np.int32)
    g_round = _np(g.cols).reshape(-1, 4, 128)[gidx].reshape(-1, 128)
    thr = rng.uniform(0, 3 * radius, nb).astype(np.float32).view(np.int32)
    tminb = np.where(rng.random(nb) < 0.6, 0, thr).astype(np.int32)
    return xt.astype(np.float32), g_round, gidx, tile_of, tminb


def test_plain_sweep_matches_pallas_kernel(cornell):
    """sweep_blocks_plain against the reference kernel (_sweep, interpret
    mode) on one random pre-gathered stream: ids equal but for exact-t
    ties, t at rtol 1e-5."""
    xt, g_round, _, tile_of, tminb = _random_stream(cornell["g"])
    nt = xt.shape[1] // TILE - 1
    out = np.asarray(j_st._sweep(jnp.asarray(xt), jnp.asarray(g_round),
                                 jnp.asarray(tile_of), jnp.asarray(tminb),
                                 0, TILE, False, True))
    gidx1 = np.arange(g_round.shape[0] // 4, dtype=np.int32)
    got = sweep_blocks_plain(*(torch.as_tensor(a) for a in
                               (xt, g_round, gidx1, tile_of, tminb)), TILE)
    swept = np.zeros(nt + 1, bool)
    swept[tile_of] = True
    rays = np.repeat(swept[:nt], TILE)
    t, ids = _np(got[0])[:nt * TILE][rays], _np(got[1])[:nt * TILE][rays]
    jt_, jid = out[0, :nt * TILE][rays], out[1, :nt * TILE][rays]
    jid = jid.astype(np.int32)
    assert (ids >= 0).sum() > 20
    same = ids == jid
    # Where the ids differ, both found a hit at the same t (a tie).
    np.testing.assert_allclose(t[~same], jt_[~same], rtol=1e-5)
    assert (ids[~same] >= 0).all() and (jid[~same] >= 0).all()
    assert same.mean() > 0.99
    hit = same & (ids >= 0)
    np.testing.assert_allclose(t[hit], jt_[hit], rtol=1e-5)
    np.testing.assert_allclose(_np(got[2])[:nt * TILE][rays][hit],
                               out[2, :nt * TILE][rays][hit], atol=1e-5)


def test_wrapper_on_cpu_takes_plain_version(cornell):
    xt, g_round, gidx, tile_of, tminb = _random_stream(cornell["g"], seed=11)
    args = [torch.as_tensor(a) for a in (xt, _np(cornell["g"].cols), gidx,
                                         tile_of, tminb)]
    before = dict(launches)
    got = sweep_blocks(*args, TILE)
    assert launches == before
    for a, b in zip(got, sweep_blocks_plain(*args, TILE)):
        assert torch.equal(a, b)
    # The pre-gathered (K1-style) call gives the same result.
    gidx1 = torch.arange(gidx.size, dtype=torch.int32)
    for a, b in zip(got, sweep_blocks(args[0], torch.as_tensor(g_round),
                                      gidx1, *args[3:], TILE)):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        sweep_blocks(args[0], args[1], args[2].long(), *args[3:], TILE)


@pytest.mark.parametrize("rays_key", ["primary", "random"])
def test_trace_sweep_matches_reference(cornell, rays_key):
    """trace_sweep(coherent=True) on the reference's grid against the
    reference tracer (interpret mode) and the reference oracle."""
    c = cornell
    jrays = c["jr"] if rays_key == "primary" else c["jrand"]
    rays = c["rays"] if rays_key == "primary" else c["rand"]
    hits, ovf = st.trace_sweep(c["g"], rays, tile=TILE, coherent=True,
                               return_overflow=True)
    assert not bool(ovf)
    want = j_st.trace_sweep(c["jg"], jrays, interpret=True, tile=TILE,
                            coherent=True)
    ref = j_oracle.closest_hit(jrays, c["jt"])
    check_hits(hits, want)
    check_hits(hits, ref)
    if rays_key == "primary":
        assert (_np(hits.tri_id) >= 0).mean() > 0.9


def test_trace_sweep_budget_overflow_flag(cornell):
    hits, ovf, demand = st.trace_sweep(
        cornell["g"], cornell["rays"], tile=TILE, coherent=True, bmax=1,
        return_overflow=True, return_demand=True)
    d = int(demand[0])
    assert bool(ovf) == (d > 128)
    # The binned compact path: same flag, and the live-row peak reported.
    for any_hit in (False, True):
        _, ovf, demand = st.trace_sweep(
            cornell["g"], cornell["rays"], any_hit=any_hit, tile=TILE,
            bmax=1, return_overflow=True, return_demand=True)
        d, rows = (int(x) for x in demand)
        assert bool(ovf) == (d > 128) and rows > 0


def test_render_session_cornell(cornell):
    c = cornell
    tris = Triangles.from_mesh(c["v"], c["f"], device="cpu")
    s = RenderSession.create(tris, structure="packet", verts=c["v"])
    rays = primary_rays(cornell_camera(), 32, 32, order="block",
                        device="cpu")
    ref = j_oracle.closest_hit(c["jr"], c["jt"])
    check_hits(s.trace(rays, coherent=True), ref)
    assert len(s._bmax_cal) == 1
    s.rebuild(tris)                          # warm, sync-free
    assert not bool(s.grid.overflowed)
    check_hits(s.trace(rays, coherent=True), ref)
    assert not s.poll_overflow(recalibrate=False)
    assert "packet" in s.describe()
    with pytest.raises(ValueError):
        RenderSession.create(tris, structure="bvh")


def _eyelight_dhash(tri_id, tris_n, dirs, pix, size):
    """dhash of an eye-light image traced in block order: pixel pix[i]
    holds ray i."""
    tri = np.empty(size * size, np.int32)
    d = np.empty((size * size, 3), np.float32)
    tri[pix], d[pix] = _np(tri_id), _np(dirs)
    return dhash(shade_eyelight(tri, None, _np(tris_n), d, size, size))


@pytest.mark.slow
def test_sponza_eyelight_reference_dhash():
    """The 128x128 eye-light render of sponza_like(262144), traced in
    block order: the JAX package's packet session (coherent trace) and
    its brute-force oracle both give SPONZA_EYELIGHT_DHASH, which
    chip_smoke.py holds the card's render against; the port's render on
    the CPU is within the goldens' tolerance of it."""
    size, tol = 128, 6
    v, f = j_scenes.sponza_like(262144)
    cam = sponza_camera()
    pix = j_block_index(size, size)
    jt = JTris.from_mesh(v, f)
    js = JRenderSession.create(jt, verts=v)
    jr = j_primary_rays(j_scenes.sponza_camera(), size, size, order="block")
    j_hash = _eyelight_dhash(js.trace(jr, coherent=True).tri_id, jt.n,
                             jr.dir, pix, size)
    o_hash = _eyelight_dhash(j_oracle.closest_hit(jr, jt, chunk=128).tri_id,
                             jt.n, jr.dir, pix, size)
    tris = Triangles.from_mesh(v, f, device="cpu")
    s = RenderSession.create(tris, structure="packet", verts=v)
    rays = primary_rays(cam, size, size, order="block", device="cpu")
    hits = s.trace(rays, coherent=True)
    assert not s.poll_overflow(recalibrate=False)
    p_hash = _eyelight_dhash(hits.tri_id, tris.n, rays.dir, pix, size)
    assert (j_hash, o_hash) == (SPONZA_EYELIGHT_DHASH,) * 2, (j_hash, o_hash)
    assert hamming(p_hash, SPONZA_EYELIGHT_DHASH) <= tol, p_hash
