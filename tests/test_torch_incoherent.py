"""PyTorch port, incoherent waves: binning, the compact planner, any hit,
ray sorting, sampling and the AO / shadow / path integrators.

Inputs are made with numpy and go through the JAX package and the port
alike. Integer tables must be equal; the reference runs its planner
eagerly (op by op, so XLA contracts no FMAs that torch would not) and its
Pallas kernel in interpret mode. Hits are held to
tests/test_sweep_trace.py::_check's thresholds; any-hit hit/miss must be
equal. The JAX side shares one grid and one budget per scene, so each
of its traced frames compiles once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import Camera as JCamera
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid.packet import build_packet as j_build_packet
from hagrid_tpu.ops import segment as j_segment
from hagrid_tpu.ops import sortrays as j_sortrays
from hagrid_tpu.ops import sweep_trace as j_st
from hagrid_tpu.render import integrators as j_integrators
from hagrid_tpu.render import sampling as j_sampling
from hagrid_tpu.render.session import RenderSession as JRenderSession
from hagrid_tpu_torch import interop, oracle, scenes
from hagrid_tpu_torch.core.camera import Camera, primary_rays
from hagrid_tpu_torch.core.types import Hits, Triangles
from hagrid_tpu_torch.ops import segment, sortrays
from hagrid_tpu_torch.ops import sweep_trace as st
from hagrid_tpu_torch.ops.sweep_kernel import sweep_blocks_plain
from hagrid_tpu_torch.render import integrators, sampling
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils.config import BuildParams

CPU = "cpu"
TILE = 64
N_RAYS = 24 * 24
# One fixed budget for every JAX frame of the floor scene, so AO samples,
# the shadow wave and the any-hit trace share one compiled frame.
BMAX, ROWMAX = 256, 8192


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _floor_scene():
    """tests/test_integrators.py's scene: a ground quad at y=0 and a small
    blocker slab above part of it."""
    floor = j_scenes.grid_quad([-5, 0, -5], [10, 0, 0], [0, 0, 10], 4, 4)
    block = j_scenes.box([-1, 0.5, -1], [1, 0.7, 1], n=1)
    return j_scenes.merge([floor, block])


def _port_grid(jg, jt):
    return interop.packet_grid_from_numpy(
        jg.dims3, jg.bbox_lo, jg.bbox_hi, jg.rs, jg.rowinfo, jg.cols,
        jg.planes, jg.total_refs, jg.total_pairs, jt.v0, jt.e1, jt.e2, jt.n,
        device=CPU)


def _port_rays(jr):
    return interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                   device=CPU)


@pytest.fixture(scope="module")
def floor():
    """The floor scene's reference grid and its port copy, 24x24 primary
    rays with the oracle's hits (fed to both packages), and a JAX session
    whose budgets are preset (no calibration probes)."""
    v, f = _floor_scene()
    jt = JTris.from_mesh(v, f)
    jg = j_build_packet(jt)
    cam = JCamera(eye=(0, 6, 6.5), center=(0, 0, 0), fov_deg=50)
    jr = j_primary_rays(cam, 24, 24)
    jh = j_oracle.closest_hit(jr, jt)
    js = JRenderSession.create(jt, verts=v)
    js.grid = jg
    for key in ("ao", "shadow"):
        js._bmax_cal[(True, False, N_RAYS, key)] = (BMAX, ROWMAX)
    g = _port_grid(jg, jt)
    s = RenderSession(params=BuildParams(), structure="packet", grid=g)
    hits = Hits(*(_t(getattr(jh, k)) for k in ("tri_id", "t", "u", "v")))
    return dict(v=v, f=f, jt=jt, jg=jg, g=g, jr=jr, rays=_port_rays(jr),
                jh=jh, hits=hits, js=js, s=s)


def _random_rays(lo, hi, n, seed, tmax_frac=0.0):
    """Origins around and inside the box, unit directions; a fraction of
    the rays get a finite tmax and a few are dead (tmax 0)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo), np.asarray(hi)
    ext = hi - lo
    org = rng.uniform(lo - 0.3 * ext, hi + 0.3 * ext, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, np.inf)
    r = rng.random(n)
    tmax[r < tmax_frac] = rng.uniform(0.1, 2.0, n)[r < tmax_frac] * ext.max()
    tmax[r > 0.97] = 0.0
    return (org.astype(np.float32), d.astype(np.float32),
            np.zeros(n, np.float32), tmax.astype(np.float32))


# ----------------------------------------------------------------------
# Primitives: expand_by_counts, binning, sorting, sampling
# ----------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [64, 200])
def test_expand_by_counts_equal(capacity):
    """Zero counts inside and at the ends, capacity below and above the
    total (93)."""
    counts = np.array([0, 3, 0, 0, 7, 1, 0, 40, 2, 0, 40, 0], np.int32)
    want = j_segment.expand_by_counts(jnp.asarray(counts), capacity)
    got = segment.expand_by_counts(torch.as_tensor(counts), capacity)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    empty = segment.expand_by_counts(torch.zeros(0, dtype=torch.int32), 8)
    for a, b in zip(empty, j_segment.expand_by_counts(
            jnp.zeros(0, jnp.int32), 8)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_bin_rays_and_unbin_equal():
    """(axis, sign) binning of 300 rays with dead ones, tile 64: the row
    layout and inverse map are equal; _unbin of per-row results too."""
    n = 300
    n_pad = (-(-n // TILE) + 7) * TILE
    org, d, tmin, tmax = _random_rays((0, 0, 0), (1, 1, 1), n, seed=1,
                                      tmax_frac=0.3)
    jx, jxt, jinv = j_st._bin_rays(*(jnp.asarray(a) for a in
                                     (org, d, tmin, tmax)), n_pad, TILE)
    x, xt, inv = st._bin_rays(*(torch.as_tensor(a) for a in
                                (org, d, tmin, tmax)), n_pad, TILE)
    np.testing.assert_array_equal(_np(inv), _np(jinv))
    np.testing.assert_array_equal(_np(x), _np(jx))
    np.testing.assert_array_equal(_np(xt), _np(jxt))
    assert (_np(inv) >= 0).sum() == n
    rng = np.random.default_rng(2)
    t_f = rng.uniform(0, 5, n_pad).astype(np.float32)
    id_i = rng.integers(-1, 20, n_pad).astype(np.int32)
    u_f, v_f = rng.random((2, n_pad)).astype(np.float32)
    want = j_st._unbin(*(jnp.asarray(a) for a in (t_f, id_i, u_f, v_f)),
                       jinv, n)
    got = st._unbin(tuple(torch.as_tensor(a) for a in (t_f, id_i, u_f, v_f)),
                    inv, n)
    for k in ("tri_id", "t", "u", "v"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      _np(getattr(want, k)))


@pytest.mark.parametrize("origin_major", [False, True])
def test_sortrays_equal(origin_major):
    org, d, tmin, tmax = _random_rays((-2, 0, -1), (3, 1, 2), 257, seed=3)
    lo = np.array([-2, 0, -1], np.float32)
    hi = np.array([3, 1, 2], np.float32)
    bits = 10 if origin_major else 7
    jr = JRays.make(org, d, tmax=tmax)
    r = interop.rays_from_numpy(org, d, tmin, tmax, device=CPU)
    jk = j_sortrays.coherence_keys(jr, lo, hi, bits=bits,
                                   origin_major=origin_major)
    k = sortrays.coherence_keys(r, torch.as_tensor(lo), torch.as_tensor(hi),
                                bits=bits, origin_major=origin_major)
    np.testing.assert_array_equal(_np(k), _np(jk))
    mask = np.random.default_rng(4).random(257) < 0.8
    jsr, jperm = j_sortrays.sort_rays(jr, lo, hi, mask=jnp.asarray(mask),
                                      bits=bits, origin_major=origin_major)
    sr, perm = sortrays.sort_rays(r, torch.as_tensor(lo), torch.as_tensor(hi),
                                  mask=torch.as_tensor(mask), bits=bits,
                                  origin_major=origin_major)
    np.testing.assert_array_equal(_np(perm), _np(jperm))
    np.testing.assert_array_equal(_np(sr.org), _np(jsr.org))
    np.testing.assert_array_equal(_np(sortrays.unsort(sr.org, perm)), org)
    back = sortrays.unsort(sr, perm)
    np.testing.assert_array_equal(_np(back.dir), d)


def test_sampling_equal_with_reference_uniforms():
    """The cosine mapping fed JAX's own uniforms gives JAX's directions;
    basis, face_forward and hit points/normals are equal too. rtol 1e-6,
    atol 1e-6 for components near 0 (sin/cos differ by an ulp)."""
    rng = np.random.default_rng(5)
    n = rng.normal(size=(200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    key = jax.random.PRNGKey(3)
    want = j_sampling.cosine_hemisphere(key, jnp.asarray(n))
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (200,))
    u2 = jax.random.uniform(k2, (200,))
    got = sampling.cosine_from_uniforms(_t(u1), _t(u2), torch.as_tensor(n))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    for a, b in zip(sampling.orthonormal_basis(torch.as_tensor(n)),
                    j_sampling.orthonormal_basis(jnp.asarray(n))):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(sampling.face_forward(torch.as_tensor(n), torch.as_tensor(d))),
        _np(j_sampling.face_forward(jnp.asarray(n), jnp.asarray(d))))
    gen = torch.Generator().manual_seed(0)
    dirs = sampling.cosine_hemisphere(torch.as_tensor(n), gen)
    cos = (dirs * torch.as_tensor(n)).sum(1)
    assert (cos >= -1e-6).all() and torch.allclose(
        dirs.norm(dim=1), torch.ones(200), atol=1e-5)


def test_hit_points_normals_equal(floor):
    c = floor
    want = j_sampling.hit_points_normals(c["jr"], c["jh"], c["jt"].n)
    got = sampling.hit_points_normals(c["rays"], c["hits"], c["g"].tris.n)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# The compact planner and the any-hit sweep
# ----------------------------------------------------------------------

def _items2_tables(mod, arr, c, any_hit, rowcap, bcap):
    """Round 0 of the compact planner on the reference's binned X matrix
    of 576 random rays in the floor scene (tile 64, slab 8), some of
    whose rays already carry a hit."""
    jg = c["jg"]
    org, d, tmin, tmax = _random_rays(jg.bbox_lo, jg.bbox_hi, N_RAYS, 6,
                                      tmax_frac=0.4)
    n_pad = (-(-N_RAYS // TILE) + 7) * TILE
    xp, _, _ = j_st._bin_rays(*(jnp.asarray(a) for a in
                                (org, d, tmin, tmax)), n_pad, TILE)
    xp = _np(xp)[:n_pad]
    lo, hi = arr(_np(jg.bbox_lo)), arr(_np(jg.bbox_hi))
    tabs = mod._tile_tabs(lo, hi, jg.dims3)
    pr, pt = mod._precompute(arr(xp), *tabs, lo, hi, TILE,
                             arr(_np(jg.planes)))
    rng = np.random.default_rng(7)
    best = np.where(xp[:, 13] > 0, 3e38, -3e38).astype(np.float32)
    best[rng.random(n_pad) < 0.3] = 0.5
    out = mod._plan_items2(
        pr, pt, *tabs, arr(_np(jg.rs)), arr(_np(jg.rowinfo)), pt["k0"],
        arr(best.reshape(-1, TILE)), jg.dims3, 8, any_hit, rowcap, bcap,
        jg.cols.shape[0] // 4 - 1)
    names = ("gidx", "tile_of", "tminb", "n_blocks", "demand", "row_ovf",
             "total_rows")
    return {k: _np(v) for k, v in zip(names, out)}


@pytest.mark.parametrize("any_hit,rowcap", [(False, 4096), (True, 4096),
                                            (False, 24)])
def test_plan_items2_tables_equal(floor, any_hit, rowcap):
    """_plan_items2 called eagerly on both sides: every output equal,
    including a row budget below the live rows (overflow)."""
    want = _items2_tables(j_st, jnp.asarray, floor, any_hit, rowcap, 64)
    got = _items2_tables(st, torch.as_tensor, floor, any_hit, rowcap, 64)
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, f"tables differ: {bad}"
    assert int(got["n_blocks"]) > 0
    assert bool(got["row_ovf"]) == (rowcap < int(got["total_rows"]))


def test_plain_anyhit_sweep_matches_pallas_kernel(floor):
    """sweep_blocks_plain(any_hit=True) against the reference kernel's
    any-hit instance (_sweep, interpret mode) on one random pre-gathered
    stream with finite tmax and raw-best seeds: hit/miss equal."""
    g = floor["g"]
    rng = np.random.default_rng(10)
    nt = 4
    n_cols = (nt + 1) * TILE
    org, d, tmin, tmax = _random_rays(_np(g.bbox_lo), _np(g.bbox_hi),
                                      n_cols, seed=11, tmax_frac=0.5)
    x = st.rays_to_x(*(torch.as_tensor(a) for a in (org, d, tmin, tmax)))
    xt = _np(x.t()).copy()
    xt[14] = np.where(xt[13] > 0, 3e38, -3e38)
    xt[14, nt * TILE:] = -3e38
    tile_of = np.concatenate([np.repeat(np.arange(nt), [2, 0, 3, 1]),
                              [nt] * 3]).astype(np.int32)
    nb = tile_of.size
    gidx = rng.integers(0, g.cols.shape[0] // 4, nb * 32).astype(np.int32)
    g_round = _np(g.cols).reshape(-1, 4, 128)[gidx].reshape(-1, 128)
    tminb = np.full(nb, st._BIG_BITS - 1, np.int32)
    out = np.asarray(j_st._sweep(jnp.asarray(xt), jnp.asarray(g_round),
                                 jnp.asarray(tile_of), jnp.asarray(tminb),
                                 0, TILE, True, True))
    seq = np.arange(nb * 32, dtype=np.int32)
    got = sweep_blocks_plain(*(torch.as_tensor(a) for a in
                               (xt, g_round, seq, tile_of, tminb)), TILE,
                             any_hit=True)
    swept = np.zeros(nt + 1, bool)
    swept[tile_of] = True
    rays = np.repeat(swept[:nt], TILE)
    hit = _np(got[1])[:nt * TILE][rays] >= 0
    jhit = out[1, :nt * TILE][rays] >= 0
    np.testing.assert_array_equal(hit, jhit)
    assert 10 < hit.sum() < hit.size
    # Every hit lies inside (tmin, tmax).
    t_hit = _np(got[0])[:nt * TILE][rays][hit]
    assert (t_hit < xt[13, :nt * TILE][rays][hit]).all()


def test_trace_sweep_any_hit_matches_reference(floor):
    """trace_sweep(any_hit=True, coherent=False) on random rays: hit/miss
    equal to the reference tracer's and to oracle.any_hit's (both
    packages)."""
    c = floor
    org, d, tmin, tmax = _random_rays(c["jg"].bbox_lo, c["jg"].bbox_hi,
                                      N_RAYS, seed=12, tmax_frac=0.5)
    jr = JRays.make(org, d, tmax=tmax)
    hits, ovf = st.trace_sweep(c["g"], _port_rays(jr), any_hit=True,
                               bmax=BMAX, rowmax=ROWMAX,
                               return_overflow=True)
    assert not bool(ovf)
    want = j_st.trace_sweep(c["jg"], jr, any_hit=True, interpret=True,
                            bmax=BMAX, rowmax=ROWMAX)
    ref = np.asarray(j_oracle.any_hit(jr, c["jt"]))
    got = _np(hits.tri_id) >= 0
    np.testing.assert_array_equal(got, np.asarray(want.tri_id) >= 0)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, _np(oracle.any_hit(_port_rays(jr), c["g"].tris)))
    assert 0 < got.sum() < got.size
    t = _np(hits.t)[got]
    assert (t > 0).all() and (t < tmax[got]).all()


@pytest.mark.parametrize("scene", ["floor", "cornell"])
def test_trace_sweep_closest_incoherent_matches_oracle(floor, scene):
    """Closest hit through the binned compact path (the path tracer's
    bounces) against the reference oracle, _check's thresholds."""
    if scene == "floor":
        jt, g, lo, hi = floor["jt"], floor["g"], floor["jg"].bbox_lo, \
            floor["jg"].bbox_hi
    else:
        v, f = j_scenes.cornell_box()
        jt = JTris.from_mesh(v, f)
        jg = j_build_packet(jt)
        g, lo, hi = _port_grid(jg, jt), jg.bbox_lo, jg.bbox_hi
    org, d, tmin, tmax = _random_rays(lo, hi, 700, seed=13, tmax_frac=0.2)
    jr = JRays.make(org, d, tmax=tmax)
    hits, ovf = st.trace_sweep(g, _port_rays(jr), return_overflow=True)
    assert not bool(ovf)
    check_hits(hits, j_oracle.closest_hit(jr, jt))


def test_finite_tmax_respected():
    """tests/test_compact_trace.py::test_finite_tmax_respected on the
    port's session: rays with finite tmax ignore hits beyond it, closest
    and any hit."""
    v, f = scenes.random_soup(120, seed=9)
    s = RenderSession.create(Triangles.from_mesh(v, f, device=CPU))
    org, d, tmin, _ = _random_rays(_np(s.grid.bbox_lo), _np(s.grid.bbox_hi),
                                   256, seed=21)
    inf = np.full(256, np.inf, np.float32)
    base = s.trace(interop.rays_from_numpy(org, d, tmin, inf, device=CPU))
    t = _np(base.t)
    hit = _np(base.tri_id) >= 0
    assert hit.sum() > 5
    check_hits(base, j_oracle.closest_hit(JRays.make(org, d),
                                          JTris.from_mesh(v, f)))
    cut = interop.rays_from_numpy(
        org, d, tmin, np.where(hit, t * 0.9, 1e-3).astype(np.float32),
        device=CPU)
    assert (_np(s.trace(cut).tri_id)[hit] == -1).all()
    assert (_np(s.trace(cut, any_hit=True).tri_id)[hit] == -1).all()
    keep = interop.rays_from_numpy(
        org, d, tmin, np.where(hit, t * 1.1, 1e-3).astype(np.float32),
        device=CPU)
    np.testing.assert_array_equal(_np(s.trace(keep).tri_id)[hit],
                                  _np(base.tri_id)[hit])
    assert not s.poll_overflow(recalibrate=False)


# ----------------------------------------------------------------------
# Integrators
# ----------------------------------------------------------------------

def _jax_uniform_draws(keys):
    """The (u1, u2) pairs jax's cosine_hemisphere draws from each key, in
    order."""
    out = []
    for k in keys:
        k1, k2 = jax.random.split(k)
        out.append((_t(jax.random.uniform(k1, (N_RAYS,))),
                    _t(jax.random.uniform(k2, (N_RAYS,)))))
    return out


def test_ao_and_shadow_match_reference(floor, monkeypatch):
    """AO (4 samples) and shadow on the floor scene, the reference's
    uniforms fed to the port's draw: per-ray AO equal on >= 99% of rays,
    shadow visibility equal within 1e-5 on >= 99.9%; and the
    reference test's own checks (floor under the blocker darker)."""
    c = floor
    key = jax.random.PRNGKey(1)
    draws = iter(_jax_uniform_draws(jax.random.split(key, 4)))
    monkeypatch.setattr(sampling, "_draw", lambda *a: next(draws))
    ao = _np(integrators.ambient_occlusion(
        c["s"], c["rays"], c["hits"], torch.Generator(), n_samples=4))
    jao = np.asarray(j_integrators.ambient_occlusion(
        c["js"], c["jr"], c["jh"], key, n_samples=4))
    assert (ao == jao).mean() >= 0.99
    light = (0.0, 50.0, 0.0)
    vis = _np(integrators.shadow(c["s"], c["rays"], c["hits"], light))
    jvis = np.asarray(j_integrators.shadow(c["js"], c["jr"], c["jh"],
                                           light))
    assert (np.abs(vis - jvis) <= 1e-5).mean() >= 0.999
    assert not c["s"].poll_overflow(recalibrate=False)
    tid = _np(c["hits"].tri_id)
    p = _np(c["rays"].org) + _np(c["hits"].t)[:, None] * _np(c["rays"].dir)
    on_floor = (tid >= 0) & (np.abs(p[:, 1]) < 1e-3)
    under = on_floor & (np.abs(p[:, 0]) < 0.8) & (np.abs(p[:, 2]) < 0.8)
    open_ = on_floor & (np.abs(p[:, 0]) > 2.0)
    assert under.sum() > 0 and open_.sum() > 0
    assert ao[under].mean() < ao[open_].mean() - 0.2
    assert vis[under].max() == 0.0 and vis[open_].min() > 0.9


def test_render_ao_and_path_trace_bounded():
    """render_ao and path_trace on the Cornell box, port only (the
    reference's path tracer is too slow on the CPU to run beside it):
    shapes, ranges and the bounds of test_path_trace_runs_and_bounded;
    the calibrated budgets are (blocks, rows) pairs."""
    v, f = scenes.cornell_box()
    s = RenderSession.create(Triangles.from_mesh(v, f, device=CPU),
                             verts=v)
    img, hits = integrators.render_ao(s, scenes.cornell_camera(), 32, 32,
                                      n_samples=2)
    img = _np(img)
    assert img.shape == (32, 32, 3)
    assert 0.0 < img.mean() < 1.0 and img.min() >= 0 and img.max() <= 1
    assert (_np(hits.tri_id) >= 0).mean() > 0.9
    pt = _np(integrators.path_trace(s, scenes.cornell_camera(), 16, 16,
                                    spp=2, max_bounces=3))
    assert pt.shape == (16, 16, 3)
    assert np.all(pt >= 0) and np.all(pt <= 1.0 + 1e-5)
    assert pt.mean() > 0.001
    cal = s._bmax_cal
    assert {k[3] for k in cal} == {None, "ao", "path"}
    for (any_hit, coherent, _, _), (bmax, rowmax) in cal.items():
        assert bmax % 1024 == 0
        assert (rowmax is None) == coherent
        if not coherent:
            assert rowmax % 8192 == 0
    assert not s.poll_overflow(recalibrate=False)


def test_poll_overflow_grows_rows_budget():
    """poll_overflow grows an offending incoherent wave's (blocks, rows)
    budgets one rung each, clears its flag in place and drops its
    graph."""
    v, f = scenes.cornell_box()
    s = RenderSession.create(Triangles.from_mesh(v, f, device=CPU),
                             verts=v)
    org, d, tmin, tmax = _random_rays(_np(s.grid.bbox_lo),
                                      _np(s.grid.bbox_hi), 256, seed=22)
    s.trace(interop.rays_from_numpy(org, d, tmin, tmax, device=CPU),
            any_hit=True)
    key = (True, False, 256, None)
    bmax0, rows0 = s._bmax_cal[key]
    assert s.poll_overflow() is False
    s._ovf[key] = torch.tensor(True)
    assert s.poll_overflow() is True
    bmax1, rows1 = s._bmax_cal[key]
    assert bmax1 >= 2 * bmax0 and rows1 >= 2 * rows0
    assert ("trace", key) not in s._graphs.keys()
    assert not s._ovf[key].item() and s.poll_overflow() is False


def test_entry_points_default_to_the_card():
    """Without a device, entry points put tensors on the card, and raise
    where there is none; they never fall back to the CPU."""
    cam = Camera(eye=(0, 0, 5), center=(0, 0, 0))
    v, f = j_scenes.cornell_box()
    calls = [lambda: primary_rays(cam, 32, 32),
             lambda: Triangles.from_mesh(v, f),
             lambda: interop.rays_from_numpy(np.zeros((1, 3)),
                                             np.ones((1, 3)), [0.0], [1.0])]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            assert out.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
