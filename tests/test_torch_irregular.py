"""PyTorch port, two-level irregular grid: every build stage, the merge
hash and the demanded resolution, the wavefront tracers on the packed
and generic lookups, check_irregular, the irregular checkpoint kind and
RenderSession(structure="irregular").

The build runs in both packages in lockstep from the same numpy mesh:
the reference's stages and passes (jitted, as its build runs them) and
the port's, and every table is compared after every stage. Integer
tables must be equal, and so must `ref_tris` (a gather of the triangle
rows). Hits are held to tests/test_sweep_trace.py::_check's thresholds
against the reference's brute-force oracle, on a grid carried across
from the reference; any-hit hit/miss must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits
from test_uniform_grid import random_rays

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid import irregular as j_irr
from hagrid_tpu.io import checkpoint as j_checkpoint
from hagrid_tpu.utils.config import BuildParams as JParams
from hagrid_tpu.utils.config import density_dims as j_density_dims
from hagrid_tpu_torch import interop, oracle
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.grid import invariants, irregular
from hagrid_tpu_torch.io import checkpoint
from hagrid_tpu_torch.ops import wavefront
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.sampling import hit_points_normals
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils.config import BuildParams

CPU = "cpu"
# tests/test_irregular_grid.py's small-scene parameters.
SMALL = dict(top_density=0.3, snd_density=2.0, levels=2, merge_passes=2,
             expansion_passes=2)
# (scene, params): Cornell and random soups, with the small parameters,
# the defaults, the dynamic preset, no merge and no expansion, and
# Cornell with many SAH merges (tests/test_irregular_grid.py's p1).
CASES = {
    "cornell-small": ("cornell", SMALL),
    "soup120-small": ("soup120-2", SMALL),
    "soup150-default": ("soup150-0", {}),
    "soup150-dynamic": ("soup150-1", "dynamic"),
    "soup100-nomerge": ("soup100-4", dict(top_density=0.3, snd_density=2.0,
                                          levels=2, merge_passes=0,
                                          expansion_passes=0)),
    "cornell-merges": ("cornell", dict(top_density=0.3, snd_density=2.0,
                                       levels=1, ref_growth=1e9,
                                       merge_passes=3, expansion_passes=2,
                                       buddy_passes=0)),
}
GRID_FIELDS = ("top_res_log", "top_offset", "entries", "cell_min",
               "cell_max", "cell_starts", "ref_ids", "alive", "preexpanded",
               "top_info", "erec", "num_entries", "total_refs", "bbox_lo",
               "bbox_hi")
TOP_FIELDS = ("top_starts", "top_keys", "top_refs", "rt_total", "res_log",
              "offsets", "e_total")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


def _mesh(scene):
    if scene == "cornell":
        return j_scenes.cornell_box()
    n, seed = scene[4:].split("-")
    return j_scenes.random_soup(int(n), seed=int(seed))


def _params(p):
    if p == "dynamic":
        return JParams.dynamic(), BuildParams.dynamic()
    return JParams(**p), BuildParams(**p)


def _diff(g, jg, fields=GRID_FIELDS):
    return [k for k in fields if not np.array_equal(
        _np(getattr(g, k)), np.asarray(getattr(jg, k)))]


def _lockstep(v, f, jp, p):
    """Both builds, stage by stage as the reference's build_irregular
    runs them; returns ([(stage, differing fields)], jax grid, port
    grid)."""
    jt = JTris.from_mesh(v, f)
    tris = Triangles.from_mesh(v, f, device=CPU)
    g, top = irregular.build_stages(tris, p)
    # The reference's host wrapper, stage by stage.
    tlo, thi = jax.device_get(jt.bounds())
    lo, hi = tlo.min(0), thi.max(0)
    pad = (hi - lo) * 1e-4 + 1e-4
    lo, hi = lo - pad, hi + pad
    top_dims = j_density_dims(hi - lo, jt.count, jp.top_density)
    levels = jp.levels + 1
    blo, bhi = jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32)
    rt_cap = j_irr._bucket(int(jt.count * 2.5 * jp.ref_slack))
    while True:
        jtop = j_irr._stage_top(jt, blo, bhi, top_dims, levels,
                                jp.snd_density, jp.ref_growth, rt_cap)
        t = int(jtop[3])
        if t <= rt_cap:
            break
        rt_cap = j_irr._bucket(int(t * 1.25))
    stages = [("top", [k for k, a, b in zip(TOP_FIELDS, top, jtop)
                       if not np.array_equal(_np(a), np.asarray(b))])]
    top_starts, top_keys, top_refs, _, res_log, offsets, e_total = jtop
    e_cap = j_irr._bucket(int(e_total) + 1)
    r2_cap = j_irr._bucket(int(t * 3.0 * jp.ref_slack))
    while True:
        cells = j_irr._stage_cells(jt, blo, bhi, top_keys, top_refs, res_log,
                                   offsets, e_total, top_dims, levels, e_cap,
                                   r2_cap)
        t2 = int(cells[-1])
        if t2 <= r2_cap:
            break
        r2_cap = j_irr._bucket(int(t2 * 1.25))
    entries, cmin, cmax, cell_starts, refs, alive, r2_total = cells
    cmin, cmax, preexp = j_irr._stage_airboxes(
        top_starts, offsets, cmin, cmax, top_dims, levels, jp.air_levels,
        e_cap)
    n_top = int(np.prod(top_dims))
    jg = j_irr.IrregularGrid(
        top_dims=top_dims, levels=levels, bbox_lo=blo, bbox_hi=bhi,
        top_res_log=res_log, top_offset=offsets, entries=entries,
        cell_min=cmin, cell_max=cmax, cell_starts=cell_starts, ref_ids=refs,
        alive=alive, num_entries=e_total, total_refs=r2_total, tris=jt,
        preexpanded=preexp, top_info=jnp.zeros((n_top,), jnp.int32),
        erec=jnp.zeros((e_cap, 8), jnp.int32),
        ref_tris=jnp.zeros((r2_cap, 12), jnp.float32))
    assert g.top_dims == jg.top_dims and g.levels == jg.levels
    stages.append(("cells+airboxes", _diff(g, jg)))
    # The optimisation passes (irregular._optimize), one at a time.
    for i in range(jp.buddy_passes):
        for axis in range(3):
            jg = j_irr._buddy_jit(jg, axis=axis)
            g = irregular._buddy_pass(g, axis)
            stages.append((f"buddy{i}.{axis}", _diff(g, jg)))
    for i in range(jp.merge_passes):
        for axis in range(3):
            salt = i * 3 + axis + 1
            jg = j_irr._merge_jit(jg, jnp.int32(salt), axis=axis,
                                  alpha=float(jp.alpha))
            g = irregular._merge_pass(g, salt, axis, float(p.alpha))
            stages.append((f"merge{i}.{axis}", _diff(g, jg)))
    if jp.compact:
        cap = j_irr._bucket(int(jnp.sum(jg.alive.astype(jnp.int32))))
        jg = j_irr._compact_jit(jg, cell_capacity=cap)
        g = irregular.compact_cells(g, cap)
        stages.append(("compact", _diff(g, jg)))
    for i in range(jp.expansion_passes):
        for axis in range(3):
            sub = jp.subset_expansion and i == 0
            jg = j_irr._expand_jit(jg, axis=axis, subset=sub)
            g = irregular._expand_pass(g, axis, subset=sub)
            stages.append((f"expand{i}.{axis}", _diff(g, jg)))
    jg = j_irr._pack_jit(jg)
    g = irregular._pack_tables(g)
    stages.append(("pack", _diff(g, jg, GRID_FIELDS + ("ref_tris",))))
    return stages, jg, g


@pytest.fixture(scope="module")
def built():
    """Per case: the stage-by-stage comparison, both final grids, and the
    port's one-call build."""
    out = {}
    for case, (scene, params) in CASES.items():
        v, f = _mesh(scene)
        jp, p = _params(params)
        stages, jg, g = _lockstep(v, f, jp, p)
        full = irregular.build_irregular(
            Triangles.from_mesh(v, f, device=CPU), p)
        out[case] = dict(v=v, f=f, jp=jp, p=p, stages=stages, jg=jg, g=g,
                         full=full)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_every_stage_equal(built, case):
    bad = [(s, d) for s, d in built[case]["stages"] if d]
    assert not bad, f"tables differ after: {bad}"
    # Every optimisation pass ran and was compared.
    names = [s for s, _ in built[case]["stages"]]
    jp = built[case]["jp"]
    assert len(names) == 3 + 3 * (jp.buddy_passes + jp.merge_passes
                                  + jp.expansion_passes) + int(jp.compact)


@pytest.mark.parametrize("case", list(CASES))
def test_build_irregular_equals_the_stages(built, case):
    """The one-call build equals the lockstep build, and its stats the
    reference's."""
    c = built[case]
    assert not _diff(c["full"], c["jg"], GRID_FIELDS + ("ref_tris",))
    assert c["full"].stats() == c["jg"].stats()


def test_merges_reduce_cells(built):
    """With SAH merges the Cornell build ends with fewer alive cells
    than entries (tests/test_irregular_grid.py::test_merging_reduces_cells)."""
    st = built["cornell-merges"]["full"].stats()
    assert st["cells"] < st["entries"]


@pytest.mark.parametrize("snd", [2.0, 2.4, 0.5, 3.0])
def test_res_demand_equals_reference(snd):
    """The demanded resolution for every cell count 0..2^16, against the
    reference's jitted cbrt/log2/ceil."""
    n = np.arange(0, (1 << 16) + 1, dtype=np.int32)

    @jax.jit
    def ref(n_c):
        side = jnp.cbrt(snd * n_c.astype(jnp.float32))
        return jnp.ceil(jnp.log2(jnp.maximum(side, 1.0))).astype(jnp.int32)

    want = np.minimum(np.asarray(ref(jnp.asarray(n))), 8)
    got = _np(irregular.res_demand(torch.as_tensor(n), snd, 8))
    np.testing.assert_array_equal(got, want)


def test_hash_bit_equals_reference():
    ids = np.concatenate([np.arange(0, (1 << 20) + 1),
                          [(1 << 31) - 1, (1 << 31) - 2, 123456789]]
                         ).astype(np.int32)
    for salt in (1, 2, 3, 5, 7, 1000, (1 << 31) - 1):
        want = np.asarray(j_irr._hash_bit(jnp.asarray(ids), jnp.int32(salt)))
        got = _np(irregular._hash_bit(torch.as_tensor(ids), salt))
        np.testing.assert_array_equal(got, want, f"salt {salt}")


def test_two_key_sort_equals_reference():
    rng = np.random.default_rng(0)
    k1 = rng.integers(0, 50, 3000).astype(np.int32)
    k2 = rng.integers(-(1 << 31), (1 << 31) - 1, 3000).astype(np.int32)
    k2[::3] = rng.integers(-3, 3, 1000)
    want = jax.lax.sort((jnp.asarray(k1), jnp.asarray(k2)), num_keys=2)
    got = irregular._sort2(torch.as_tensor(k1), torch.as_tensor(k2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_levels_validated_and_empty_scene():
    v, f = j_scenes.cornell_box()
    with pytest.raises(ValueError):
        irregular.build_irregular(Triangles.from_mesh(v, f, device=CPU),
                                  BuildParams(levels=7))
    tris = Triangles.from_mesh(np.zeros((0, 3), np.float32),
                               np.zeros((0, 3), np.int32), device=CPU)
    g = irregular.build_irregular(tris)
    rays = interop.rays_from_numpy(np.zeros((4, 3)), np.ones((4, 3)),
                                   np.zeros(4), np.full(4, np.inf),
                                   device=CPU)
    assert bool((irregular.trace_irregular_fast(g, rays).tri_id == -1).all())


@pytest.fixture(scope="module")
def traced(built):
    """Rays and the reference oracle's hits for two carried-across grids:
    Cornell 48x48 primaries and 256 random rays around a soup."""
    out = {}
    for case in ("cornell-small", "soup150-default"):
        c = built[case]
        jg, jt = c["jg"], c["jg"].tris
        if case.startswith("cornell"):
            jr = j_primary_rays(j_scenes.cornell_camera(), 48, 48)
        else:
            jr = random_rays(256, np.asarray(jg.bbox_lo),
                             np.asarray(jg.bbox_hi), seed=31)
        out[case] = dict(
            cg=interop.irregular_grid_from_reference(jg, device=CPU),
            rays=interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                         device=CPU),
            want=j_oracle.closest_hit(jr, jt),
            want_any=np.asarray(j_oracle.any_hit(jr, jt)))
    return out


TRACERS = {"fast": irregular.trace_irregular_fast,
           "lockstep": irregular.trace_irregular}


@pytest.mark.parametrize("tracer", list(TRACERS))
@pytest.mark.parametrize("case", ["cornell-small", "soup150-default"])
def test_wavefront_closest_hit(traced, case, tracer):
    c = traced[case]
    check_hits(TRACERS[tracer](c["cg"], c["rays"]), c["want"])
    if tracer == "fast":
        assert wavefront.last_trace_stats["truncated_rays"] == 0


@pytest.mark.parametrize("tracer", list(TRACERS))
@pytest.mark.parametrize("case", ["cornell-small", "soup150-default"])
def test_wavefront_any_hit(traced, case, tracer):
    c = traced[case]
    got = _np(TRACERS[tracer](c["cg"], c["rays"], any_hit=True).tri_id) >= 0
    np.testing.assert_array_equal(got, c["want_any"])


def test_packed_per_row_path(traced):
    """A ref table whose rows are not a multiple of 4 takes the per-row
    packed branch instead of quad rows; same hits."""
    c = traced["soup150-default"]
    g = c["cg"]
    odd = g.replace(ref_tris=torch.cat([g.ref_tris, g.ref_tris[:1]]))
    check_hits(irregular.trace_irregular_fast(odd, c["rays"]), c["want"])


@pytest.mark.parametrize("case", list(CASES))
def test_check_irregular_on_port_builds(built, case):
    invariants.check_irregular(built[case]["full"])


def test_check_irregular_sampled_and_finds_faults(built):
    g = built["soup120-small"]["full"]
    invariants.check_irregular(g, sample=512, seed=1)
    # A tri dropped from a cell of two or more (replaced by its
    # neighbour in the list) breaks completeness and uniqueness.
    n = g.cell_starts[1:] - g.cell_starts[:-1]
    c = int(torch.nonzero(n[:g.alive.shape[0]] > 1)[0])
    refs = g.ref_ids.clone()
    refs[int(g.cell_starts[c])] = refs[int(g.cell_starts[c]) + 1]
    with pytest.raises(AssertionError):
        invariants.check_irregular(g.replace(ref_ids=refs))
    # A bbox grown over a neighbour with foreign refs breaks expansion
    # safety (or bbox containment).
    cmax = g.cell_max.clone()
    cmax[c] = torch.tensor(g.fine_dims) - 1
    cmin = g.cell_min.clone()
    cmin[c] = 0
    with pytest.raises(AssertionError):
        invariants.check_irregular(g.replace(cell_min=cmin, cell_max=cmax))


def test_checkpoint_round_trip(built, traced, tmp_path):
    c = built["soup150-default"]
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    checkpoint.save_grid(p1, c["full"])
    jg2 = j_checkpoint.load_grid(p1)
    assert isinstance(jg2, j_irr.IrregularGrid)
    assert not _diff(c["full"], jg2, GRID_FIELDS + ("ref_tris",))
    j_checkpoint.save_grid(p2, c["jg"])
    for got in (checkpoint.load_grid(p1, device=CPU),
                checkpoint.load_grid(p2, device=CPU)):
        assert isinstance(got, irregular.IrregularGrid)
        assert got.top_dims == c["jg"].top_dims
        assert not _diff(got, c["jg"], GRID_FIELDS + ("ref_tris",))
        t = traced["soup150-default"]
        check_hits(irregular.trace_irregular_fast(got, t["rays"]), t["want"])


@pytest.mark.parametrize("dynamic", [False, True], ids=["default", "dynamic"])
def test_session_irregular_cornell(dynamic):
    """Create, trace primaries and one AO wave, warm rebuild (same top
    dims, same tables); against the port's brute-force oracle."""
    v, f = j_scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device=CPU)
    params = BuildParams.dynamic() if dynamic else None
    s = RenderSession.create(tris, params, structure="irregular", verts=v)
    g0 = s.grid
    rays = primary_rays(j_scenes.cornell_camera(), 32, 32, order="block",
                        device=CPU)
    hits = s.trace(rays, coherent=True)
    check_hits(hits, oracle.closest_hit(rays, tris))
    p, n, found = hit_points_normals(rays, hits, tris.n)
    wave = integrators.ao_rays(p, n, found, integrators.default_ao_distance(s),
                               torch.Generator().manual_seed(4))
    occ = integrators.trace_sorted(s, wave, any_hit=True,
                                   cal_key="ao").tri_id >= 0
    assert float((occ == oracle.any_hit(wave, tris)).float().mean()) > 0.999
    s.rebuild(tris)
    assert s.grid.top_dims == g0.top_dims
    for k in ("entries", "cell_starts", "ref_ids", "erec", "top_info"):
        assert torch.equal(getattr(s.grid, k), getattr(g0, k)), k
    assert not s.poll_overflow()
    assert s.describe().startswith("irregular top=")
