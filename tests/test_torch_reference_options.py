"""PyTorch port, the reference's options: trace_sweep's planner apart from
the ray layout (`compact`), trace_sorted's `sort`, ambient_occlusion's
`max_dist`, path_trace's `sky` and `albedo`, the AO distance from the
session's host bounds, and the lockstep entry points trace_irregular /
trace_uniform, whose plain version trace_wavefront serves CPU tensors.

Inputs are made with numpy and go through the JAX package (its Pallas
sweep in interpret mode, budgets preset so that no calibration probe
compiles) and the port alike. Hits are held to
tests/test_sweep_trace.py::_check's thresholds; any-hit hit/miss must be
equal; images traced from the reference's own random draws must be
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.ops import sweep_trace as j_st
from hagrid_tpu.render import integrators as j_integrators
from hagrid_tpu.render.session import RenderSession as JRenderSession
from hagrid_tpu_torch import interop, scenes
from hagrid_tpu_torch.core.types import Hits, Rays, Triangles
from hagrid_tpu_torch.grid import irregular, uniform
from hagrid_tpu_torch.ops import sortrays
from hagrid_tpu_torch.ops import sweep_trace as st
from hagrid_tpu_torch.ops import wavefront
from hagrid_tpu_torch.render import integrators, sampling
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils import profiling
from hagrid_tpu_torch.utils.config import BuildParams

CPU = "cpu"
# Every wave has N rays (32x32 primaries, N random rays, a 32x32 path
# frame), so that the JAX side compiles each sweep and sort once.
SIZE = 32
N = SIZE * SIZE
# Budgets of the JAX session's waves, preset (no calibration probes).
# The random waves get a calibration key of their own: the reference's
# poll_overflow sorts its keys, and None beside "ao" in one place of the
# key does not sort.
BUDGETS = {(False, True, N, None): (1024, None),
           (False, False, N, "path"): (1024, 8192),
           (False, False, N, "rand"): (1024, 8192),
           (True, False, N, "rand"): (1024, 8192),
           (True, False, N, "ao"): (1024, 8192)}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def cornell():
    """The reference's Cornell session (its grid shared with a port
    session through interop), block-order primaries with the
    oracle's hits, and random rays inside the box, a fifth of them with a
    finite tmax."""
    v, f = j_scenes.cornell_box()
    jt = JTris.from_mesh(v, f)
    js = JRenderSession.create(jt, verts=v)
    js._bmax_cal.update(BUDGETS)
    jg = js.grid
    g = interop.packet_grid_from_numpy(
        jg.dims3, jg.bbox_lo, jg.bbox_hi, jg.rs, jg.rowinfo, jg.cols,
        jg.planes, jg.total_refs, jg.total_pairs, jt.v0, jt.e1, jt.e2, jt.n,
        device=CPU)
    s = RenderSession(params=BuildParams(), structure="packet", grid=g)
    jr = j_primary_rays(j_scenes.cornell_camera(), SIZE, SIZE,
                        order="block")
    jh = j_oracle.closest_hit(jr, jt)
    rng = np.random.default_rng(8)
    org = rng.uniform(50, 500, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(N) < 0.2, 100.0, np.inf).astype(
        np.float32)
    jrand = JRays.make(org, d, tmax=tmax)
    return dict(
        v=v, f=f, jt=jt, js=js, jg=jg, g=g, s=s, jr=jr, jh=jh,
        rays=interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                     device=CPU),
        hits=Hits(*(_t(getattr(jh, k)) for k in ("tri_id", "t", "u", "v"))),
        jrand=jrand,
        rand=interop.rays_from_numpy(org, d, np.zeros(N, np.float32),
                                     tmax, device=CPU))


# ----------------------------------------------------------------------
# trace_sweep(compact=): the planner apart from the layout
# ----------------------------------------------------------------------

@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("coherent,compact", [(True, True), (False, False)],
                         ids=["coherent-compact", "binned-dense"])
def test_trace_sweep_planner_apart_from_layout(cornell, coherent, compact,
                                               any_hit):
    """The compact planner on camera-ordered primaries and the dense
    planner on binned random rays, each with the reference's defaults
    for the planner (tile, slab, row budgets): no overflow; closest hit
    against the reference tracer and its oracle by _check, any hit
    hit/miss equal to both. The live-row demand shows which planner ran
    (the dense planner reports 0)."""
    c = cornell
    jrays, rays = (c["jr"], c["rays"]) if coherent else (c["jrand"],
                                                         c["rand"])
    hits, ovf, demand = st.trace_sweep(
        c["g"], rays, any_hit=any_hit, coherent=coherent, compact=compact,
        return_overflow=True, return_demand=True)
    assert not bool(ovf)
    assert (int(demand[1]) > 0) == compact and int(demand[0]) > 0
    want = j_st.trace_sweep(c["jg"], jrays, any_hit=any_hit,
                            coherent=coherent, compact=compact,
                            interpret=True)
    if any_hit:
        got = _np(hits.tri_id) >= 0
        np.testing.assert_array_equal(got, np.asarray(want.tri_id) >= 0)
        np.testing.assert_array_equal(
            got, np.asarray(j_oracle.any_hit(jrays, c["jt"])))
        assert 0 < got.sum() < got.size
    else:
        check_hits(hits, want)
        check_hits(hits, j_oracle.closest_hit(jrays, c["jt"]))


def test_budgets_follow_compact(cornell):
    """The defaults that follow the planner: tile 256 / slab 8 / row
    budgets for the compact one, tile 512 / the whole grid in one slab /
    no row budgets for the dense one; n_pad follows the layout (binned
    waves add the 7 groups' tiles)."""
    g = cornell["g"]
    da_max = max(d[0] for d in g.dims3)
    for coherent in (True, False):
        groups = 0 if coherent else 7
        tile, slab, n_pad, bcaps, rowcaps = st._budgets(
            g, 1000, False, coherent, None, None, None, None, compact=True)
        assert (tile, slab) == (256, 8) and rowcaps is not None
        assert n_pad == (4 + groups) * 256
        assert len(rowcaps) == len(bcaps) == -(-da_max // 8)
        tile, slab, n_pad, bcaps, rowcaps = st._budgets(
            g, 1000, False, coherent, None, None, None, None, compact=False)
        assert (tile, slab, rowcaps) == (512, da_max, None)
        assert n_pad == (2 + groups) * 512 and len(bcaps) == 1
    assert st._budgets(g, 1000, True, True, None, None, None, None) == \
        st._budgets(g, 1000, True, True, None, None, None, None,
                    compact=False)


# ----------------------------------------------------------------------
# Integrators: trace_sorted(sort=), ambient_occlusion(max_dist=),
# path_trace(sky=, albedo=)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("sort", ["origin", "octant", False])
def test_trace_sorted_sort_options_match_reference(cornell, sort,
                                                   monkeypatch):
    """trace_sorted with each sort on the random rays: closest hit against
    the reference's trace_sorted by _check, any hit hit/miss equal; with
    sort=False no ray is sorted (sortrays is never called)."""
    c = cornell
    if not sort:
        def refuse(*a, **k):
            raise AssertionError("sort=False sorted the rays")

        monkeypatch.setattr(sortrays, "sort_rays", refuse)
    kw = dict(sort=sort, cal_key="rand")
    got = integrators.trace_sorted(c["s"], c["rand"], **kw)
    got_any = integrators.trace_sorted(c["s"], c["rand"], any_hit=True, **kw)
    want = j_integrators.trace_sorted(c["js"], c["jrand"], **kw)
    want_any = j_integrators.trace_sorted(c["js"], c["jrand"], any_hit=True,
                                          **kw)
    check_hits(got, want)
    np.testing.assert_array_equal(_np(got_any.tri_id) >= 0,
                                  np.asarray(want_any.tri_id) >= 0)
    assert not c["s"].poll_overflow(recalibrate=False)
    assert not c["js"].poll_overflow(recalibrate=False)


def _jax_cosine_draws(keys, n):
    """The (u1, u2) pairs the reference's cosine_hemisphere draws from
    each key, in order."""
    out = []
    for k in keys:
        k1, k2 = jax.random.split(k)
        out.append((_t(jax.random.uniform(k1, (n,))),
                    _t(jax.random.uniform(k2, (n,)))))
    return out


def test_ambient_occlusion_max_dist_matches_reference(cornell, monkeypatch):
    """ambient_occlusion(max_dist=) on the primaries' hits, 2 samples from
    the reference's draws: equal to the reference's per-ray estimate on
    >= 99% of rays (as tests/test_torch_incoherent.py's AO test) at a
    distance short enough to leave some rays open. Given
    default_ao_distance, the estimate is bit-equal to the default call
    with the same draws."""
    c = cornell
    key = jax.random.PRNGKey(4)
    n = c["rays"].count
    dist = 0.2 * integrators.default_ao_distance(c["s"])

    def ao(max_dist):
        draws = iter(_jax_cosine_draws(jax.random.split(key, 2), n))
        monkeypatch.setattr(sampling, "_draw", lambda *a: next(draws))
        return _np(integrators.ambient_occlusion(
            c["s"], c["rays"], c["hits"], torch.Generator(), n_samples=2,
            max_dist=max_dist))

    got = ao(dist)
    want = np.asarray(j_integrators.ambient_occlusion(
        c["js"], c["jr"], c["jh"], key, n_samples=2, max_dist=dist))
    assert (got == want).mean() >= 0.99
    assert not c["js"].poll_overflow(recalibrate=False)
    assert 0.0 < got.mean() < 1.0
    np.testing.assert_array_equal(
        ao(integrators.default_ao_distance(c["s"])), ao(None))
    assert (got >= ao(None)).all()


def test_path_trace_sky_albedo_match_reference(cornell, monkeypatch):
    """path_trace(sky=<per-pixel tensor>, albedo=0.5) at 32x32, 1 spp, 2
    bounces, from the reference's jitter and bounce draws: the image
    equals the reference's bit for bit; sky=2.0 doubles the default image
    exactly."""
    c = cornell
    seed, bounces = 3, 2
    key = jax.random.PRNGKey(seed)
    key, kj = jax.random.split(key)
    jitter = _t(jax.random.uniform(kj, (N, 2)))
    kds = []
    for _ in range(bounces):
        key, kd = jax.random.split(key)
        kds.append(kd)

    def trace(**kw):
        draws = iter(_jax_cosine_draws(kds, N))
        monkeypatch.setattr(integrators, "_jitter", lambda *a: jitter)
        monkeypatch.setattr(sampling, "_draw", lambda *a: next(draws))
        return _np(integrators.path_trace(
            c["s"], scenes.cornell_camera(), SIZE, SIZE, seed=seed,
            max_bounces=bounces, **kw))

    sky = np.linspace(0.5, 1.5, N).astype(np.float32)
    got = trace(sky=torch.as_tensor(sky), albedo=0.5)
    want = np.asarray(j_integrators.path_trace(
        c["js"], j_scenes.cornell_camera(), SIZE, SIZE, seed=seed,
        max_bounces=bounces, sky=jnp.asarray(sky), albedo=0.5))
    np.testing.assert_array_equal(got, want)
    assert not c["js"].poll_overflow(recalibrate=False)
    assert got.shape == (SIZE, SIZE, 3) and got.max() > 0
    base = trace()
    np.testing.assert_array_equal(trace(sky=2.0), 2.0 * base)
    assert not np.array_equal(base, got)


@pytest.mark.parametrize("margin", [None, 0.0, 0.05])
def test_default_ao_distance_from_host_bounds(margin, monkeypatch):
    """default_ao_distance reads no device when the packet session built
    its grid itself: the host bounds (with and without verts, with and
    without bbox_margin, before and after a warm rebuild) give the value
    of the grid's device bounds bit for bit. A grid set from outside has
    no host bounds and is read from the device."""
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device=CPU)
    kw = {} if margin is None else dict(verts=v, bbox_margin=margin)
    s = RenderSession.create(tris, **kw)

    def device_read(session):
        g = session.grid
        return float((g.bbox_hi - g.bbox_lo).max()) * 0.1

    for _ in range(2):                      # cold build, then warm
        lo, hi = s.host_bounds()
        np.testing.assert_array_equal(lo, s.grid.bbox_lo.numpy())
        np.testing.assert_array_equal(hi, s.grid.bbox_hi.numpy())
        want = device_read(s)
        monkeypatch.setattr(torch.Tensor, "__float__", _refuse_read)
        got = integrators.default_ao_distance(s)
        monkeypatch.undo()
        assert got == want
        s.rebuild(tris)
    s.grid = dataclasses.replace(s.grid)
    assert s.host_bounds() is None
    assert integrators.default_ao_distance(s) == device_read(s)


def _refuse_read(*a):
    raise AssertionError("read the device")


# ----------------------------------------------------------------------
# trace_irregular / trace_uniform: the plain version on CPU tensors
# ----------------------------------------------------------------------

@pytest.mark.parametrize("structure", ["irregular", "uniform"])
def test_lockstep_entry_points_take_trace_wavefront_on_cpu(structure,
                                                           monkeypatch):
    """On CPU tensors trace_irregular / trace_uniform call
    trace_wavefront (the plain version) once and never wavefront.trace;
    their hits equal trace_plain's bit for bit, ids and t/u/v, and
    last_trace_stats records one round with no ray truncated. Rays on
    another device (meta) raise."""
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device=CPU)
    if structure == "irregular":
        g = irregular.build_irregular(tris)
        entry, lookup = irregular.trace_irregular, irregular.irregular_lookup
    else:
        g = uniform.build_uniform(tris)
        entry, lookup = uniform.trace_uniform, uniform.uniform_lookup
    rng = np.random.default_rng(5)
    lo, hi = v.min(0), v.max(0)
    org = rng.uniform(lo, hi, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(org, d, None, None, device=CPU)
    want = {ah: wavefront.trace_plain(g, lookup, rays, any_hit=ah)
            for ah in (False, True)}
    calls = []
    plain = wavefront.trace_wavefront

    def counted(*a, **k):
        calls.append(k["any_hit"])
        return plain(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the march kernel's entry ran on CPU tensors")

    monkeypatch.setattr(wavefront, "trace_wavefront", counted)
    monkeypatch.setattr(wavefront, "trace", refuse)
    for ah in (False, True):
        got = entry(g, rays, any_hit=ah)
        assert torch.equal(got.tri_id, want[ah].tri_id)
        for k in ("t", "u", "v"):
            assert torch.equal(getattr(got, k).view(torch.int32),
                               getattr(want[ah], k).view(torch.int32)), k
        stats = wavefront.last_trace_stats
        assert stats["rounds"] == 1 and stats["truncated_rays"] == 0
        assert stats["mean_steps"] > 1
    assert calls == [False, True]
    assert (_np(got.tri_id) >= 0).mean() > 0.5
    monkeypatch.undo()
    meta = Rays(*(getattr(rays, k).to("meta")
                  for k in ("org", "dir", "tmin", "tmax")))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        entry(g, meta)


def test_trace_wavefront_records_its_cut():
    """trace_wavefront with max_iters below the march's length: the rays
    still marching are counted in last_trace_stats, with a warning."""
    v, f = scenes.cornell_box()
    g = uniform.build_uniform(Triangles.from_mesh(v, f, device=CPU))
    centre = (v.min(0) + v.max(0)) / 2
    rays = Rays.make(centre[None].astype(np.float32),
                     np.array([[1.0, 0.0, 0.0]], np.float32), None, None,
                     device=CPU)

    def trace(max_iters):
        return wavefront.trace_wavefront(
            rays, g.tris, lambda vox: uniform.uniform_lookup(g, vox),
            g.cell_starts, g.ref_ids, g.bbox_lo, g.bbox_hi, g.dims,
            max_iters=max_iters)

    full = trace(None)
    steps = wavefront.last_trace_stats["mean_steps"]
    assert int(full.tri_id[0]) >= 0 and steps > 1
    with pytest.warns(UserWarning, match="safety cap 1 expired with 1 rays"):
        trace(1)
    assert wavefront.last_trace_stats == {"truncated_rays": 1, "rounds": 1,
                                          "mean_steps": 1.0}


def test_stage_timer_block_on():
    """StageTimer.stage(name, block_on=...) takes the reference's
    argument: tensors, nested in lists, dicts and dataclasses, that the
    stage waits for (on the CPU there is nothing to wait for)."""
    timer = profiling.StageTimer()
    x = torch.arange(10.0)
    hits = Hits(tri_id=torch.zeros(2, dtype=torch.int32), t=x[:2],
                u=x[:2], v=x[:2])
    with timer.stage("a", block_on=[x, {"h": hits}, (x,)]):
        x = x * 2
    with timer.stage("a", block_on=x):
        pass
    assert set(timer.stages) == {"a"} and timer.stages["a"] >= 0
