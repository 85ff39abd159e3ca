"""PyTorch port, uniform grid: the build, the DDA oracle, the compacted
wavefront tracer, check_uniform, the uniform checkpoint kind and
RenderSession(structure="uniform"); and the session's one-read
poll_overflow.

Scenes come from the JAX package's generators (numpy) and go through
both packages. Integer tables must be equal. Hits are held to
tests/test_sweep_trace.py::_check's thresholds against the reference's
brute-force oracle, on a grid carried across from the reference
(`interop.uniform_grid_from_reference`), so the tracers are tested apart
from the build. Any-hit hit/miss and the DDA oracle's ids must be equal.
"""

import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits
from test_uniform_grid import random_rays

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid import traverse_ref as j_traverse_ref
from hagrid_tpu.grid import uniform as j_uniform
from hagrid_tpu.io import checkpoint as j_checkpoint
from hagrid_tpu.ops import wavefront as j_wavefront
from hagrid_tpu_torch import interop, oracle
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.grid import invariants, traverse_ref, uniform
from hagrid_tpu_torch.io import checkpoint
from hagrid_tpu_torch.ops import wavefront
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.sampling import hit_points_normals
from hagrid_tpu_torch.render.session import RenderSession, _rung

CPU = "cpu"
SCENES = ["cornell", "soup0", "soup1"]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


def _mesh(name):
    if name == "cornell":
        return j_scenes.cornell_box()
    return j_scenes.random_soup(150, seed=int(name[-1]))


def _rays(name, jg):
    """Cornell: 48x48 camera primaries; soups: 256 random rays through
    and around the box (tests/test_uniform_grid.py)."""
    if name == "cornell":
        jr = j_primary_rays(j_scenes.cornell_camera(), 48, 48)
    else:
        jr = random_rays(256, np.asarray(jg.bbox_lo), np.asarray(jg.bbox_hi),
                         seed=30)
    return jr, interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                       device=CPU)


@pytest.fixture(scope="module")
def built():
    """Per scene: both packages' grids, the carried-across grid, rays and
    the reference oracle's hits."""
    out = {}
    for name in SCENES:
        v, f = _mesh(name)
        jt = JTris.from_mesh(v, f)
        jg = j_uniform.build_uniform(jt, density=2.4)
        g = uniform.build_uniform(Triangles.from_mesh(v, f, device=CPU),
                                  density=2.4)
        jr, rays = _rays(name, jg)
        out[name] = dict(v=v, f=f, jt=jt, jg=jg, g=g, jr=jr, rays=rays,
                         cg=interop.uniform_grid_from_reference(jg,
                                                                device=CPU),
                         want=j_oracle.closest_hit(jr, jt),
                         want_any=np.asarray(j_oracle.any_hit(jr, jt)))
    return out


@pytest.mark.parametrize("name", SCENES)
def test_build_tables_equal(built, name):
    c = built[name]
    g, jg = c["g"], c["jg"]
    assert g.dims == jg.dims and g.num_cells == jg.num_cells
    for k in ("bbox_lo", "bbox_hi", "cell_starts", "ref_ids", "total_refs"):
        np.testing.assert_array_equal(_np(getattr(g, k)),
                                      np.asarray(getattr(jg, k)), k)
    assert not g.overflowed()
    np.testing.assert_array_equal(_np(g.cell_size), np.asarray(jg.cell_size))


def test_build_retries_on_overflow_and_keeps_dims():
    v, f = j_scenes.random_soup(120, seed=5)
    jg = j_uniform.build_uniform(JTris.from_mesh(v, f), ref_capacity=64,
                                 dims=(5, 4, 3))
    g = uniform.build_uniform(Triangles.from_mesh(v, f, device=CPU),
                              ref_capacity=64, dims=(5, 4, 3))
    assert g.dims == jg.dims == (5, 4, 3)
    assert g.ref_ids.shape[0] == jg.ref_ids.shape[0] > 64
    for k in ("cell_starts", "ref_ids", "total_refs"):
        np.testing.assert_array_equal(_np(getattr(g, k)),
                                      np.asarray(getattr(jg, k)), k)


def test_empty_scene_misses():
    tris = Triangles.from_mesh(np.zeros((0, 3), np.float32),
                               np.zeros((0, 3), np.int32), device=CPU)
    g = uniform.build_uniform(tris)
    assert g.dims == (1, 1, 1) and int(g.total_refs) == 0
    rays = interop.rays_from_numpy(np.zeros((4, 3)), np.ones((4, 3)),
                                   np.zeros(4), np.full(4, np.inf),
                                   device=CPU)
    assert bool((uniform.trace_uniform_fast(g, rays).tri_id == -1).all())


def test_linear_cell_and_lookup():
    rng = np.random.default_rng(0)
    vox = rng.integers(0, 7, (100, 3)).astype(np.int32)
    dims = (7, 5, 6)
    np.testing.assert_array_equal(
        _np(uniform.linear_cell(*torch.as_tensor(vox).unbind(1), dims)),
        np.asarray(j_uniform.linear_cell(vox[:, 0], vox[:, 1], vox[:, 2],
                                         dims)))
    assert wavefront.max_march_iters((9, 8, 7), 37, 2) == \
        j_wavefront.max_march_iters((9, 8, 7), 37, 2)


@pytest.mark.parametrize("name", SCENES)
def test_check_uniform_on_port_builds(built, name):
    invariants.check_uniform(built[name]["g"])


def test_check_uniform_finds_a_missing_ref(built):
    import dataclasses
    g = built["cornell"]["g"]
    refs = g.ref_ids.clone()
    refs[int(g.cell_starts[1]) - 1] = refs[0]   # drop cell 0's last tri
    with pytest.raises(AssertionError):
        invariants.check_uniform(dataclasses.replace(g, ref_ids=refs))


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "lockstep"])
@pytest.mark.parametrize("name", SCENES)
def test_wavefront_closest_hit(built, name, fast):
    c = built[name]
    tracer = uniform.trace_uniform_fast if fast else uniform.trace_uniform
    check_hits(tracer(c["cg"], c["rays"]), c["want"])
    if fast:
        assert wavefront.last_trace_stats["truncated_rays"] == 0


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "lockstep"])
@pytest.mark.parametrize("name", SCENES)
def test_wavefront_any_hit(built, name, fast):
    c = built[name]
    tracer = uniform.trace_uniform_fast if fast else uniform.trace_uniform
    got = _np(tracer(c["cg"], c["rays"], any_hit=True).tri_id) >= 0
    np.testing.assert_array_equal(got, c["want_any"])


def test_compaction_rounds_match_one_march(built):
    """Small batches force compaction every round: the hits equal one
    march to completion, and the round count and mean steps equal the
    reference tracer's."""
    c = built["cornell"]
    one = uniform.trace_uniform(c["cg"], c["rays"], refs_per_iter=2)
    rounds = wavefront.trace(c["cg"], uniform.uniform_lookup, c["rays"],
                             min_batch=64)
    for k in ("tri_id", "t", "u", "v"):
        torch.testing.assert_close(getattr(rounds, k), getattr(one, k),
                                   rtol=0, atol=0)
    got = dict(wavefront.last_trace_stats)
    j_wavefront.trace(c["jg"], j_uniform.uniform_lookup, c["jr"],
                      min_batch=64)
    want = j_wavefront.last_trace_stats
    assert got["rounds"] == want["rounds"] and got["truncated_rays"] == 0
    assert got["mean_steps"] == pytest.approx(want["mean_steps"], rel=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_dda_oracle_matches_reference(built, name):
    c = built[name]
    got = traverse_ref.closest_hit(c["cg"], c["rays"])
    want = j_traverse_ref.closest_hit_jit(c["jg"], c["jr"])
    np.testing.assert_array_equal(_np(got.tri_id), np.asarray(want.tri_id))
    check_hits(got, c["want"])
    np.testing.assert_array_equal(
        _np(traverse_ref.any_hit(c["cg"], c["rays"])),
        np.asarray(j_traverse_ref.any_hit_jit(c["jg"], c["jr"])))


def test_checkpoint_round_trip(built, tmp_path):
    c = built["soup0"]
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    checkpoint.save_grid(p1, c["g"])
    jg2 = j_checkpoint.load_grid(p1)
    assert isinstance(jg2, j_uniform.UniformGrid)
    j_checkpoint.save_grid(p2, c["jg"])
    for got in (checkpoint.load_grid(p1, device=CPU),
                checkpoint.load_grid(p2, device=CPU)):
        assert isinstance(got, uniform.UniformGrid)
        assert got.dims == c["jg"].dims
        for k in ("bbox_lo", "bbox_hi", "cell_starts", "ref_ids",
                  "total_refs"):
            np.testing.assert_array_equal(_np(getattr(got, k)),
                                          np.asarray(getattr(c["jg"], k)))
        check_hits(uniform.trace_uniform_fast(got, c["rays"]), c["want"])


def test_session_uniform_cornell():
    """Create, trace primaries and one AO wave, warm rebuild; against the
    port's brute-force oracle."""
    v, f = j_scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device=CPU)
    s = RenderSession.create(tris, structure="uniform", verts=v)
    g0 = s.grid
    rays = primary_rays(j_scenes.cornell_camera(), 32, 32, order="block",
                        device=CPU)
    hits = s.trace(rays, coherent=True, cal_key="ignored")
    check_hits(hits, oracle.closest_hit(rays, tris))
    p, n, found = hit_points_normals(rays, hits, tris.n)
    wave = integrators.ao_rays(p, n, found, integrators.default_ao_distance(s),
                               torch.Generator().manual_seed(3))
    occ = integrators.trace_sorted(s, wave, any_hit=True).tri_id >= 0
    assert float((occ == oracle.any_hit(wave, tris)).float().mean()) > 0.999
    s.rebuild(tris)                 # warm: frame 1's capacity and dims
    assert s.grid.dims == g0.dims
    assert s.grid.ref_ids.shape == g0.ref_ids.shape
    assert torch.equal(s.grid.ref_ids, g0.ref_ids)
    assert not s.poll_overflow() and s.trace_overflow is None
    assert s.describe().startswith("uniform dims=")


class _Reads:
    """Counts device-to-host reads of tensors: tolist, item, bool, int."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("tolist", "item", "__bool__", "__int__"):
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._wrap(orig))

    def _wrap(self, orig):
        def f(t, *a, **kw):
            self.n += 1
            return orig(t, *a, **kw)
        return f


def test_poll_overflow_reads_once(monkeypatch):
    """Three wave keys, two overflowed: one read; only the offending
    keys grow, and their flags and trace_overflow are zeroed in place
    (the waves' graphs write them)."""
    s = RenderSession(params=None, structure="packet", grid=None)
    flag = lambda b: torch.tensor(b)  # noqa: E731
    s._bmax_cal = {"a": (2048, 8192), "b": (4096, None), "c": (1024, 8192)}
    s._ovf = {"a": flag(True), "b": flag(False), "c": flag(True)}
    s.trace_overflow = flag(True)
    held = dict(s._ovf, total=s.trace_overflow)
    reads = _Reads(monkeypatch)
    assert s.poll_overflow() is True
    assert reads.n == 1
    grown = lambda b, r: (_rung(b * 2, 1024), _rung(r * 2, 8192))  # noqa
    assert s._bmax_cal == {"a": grown(2048, 8192), "b": (4096, None),
                           "c": grown(1024, 8192)}
    assert all(s._ovf[k] is held[k] for k in "abc")    # the same tensors
    assert s.trace_overflow is held["total"]
    assert not any(t.item() for t in held.values())
    # Without recalibration: the OR only, nothing grows, one read.
    monkeypatch.undo()
    s._ovf["a"] = flag(True)
    reads = _Reads(monkeypatch)
    assert s.poll_overflow(recalibrate=False) is True
    assert reads.n == 1 and s._bmax_cal["a"] == grown(2048, 8192)
    s._ovf = {"b": flag(False)}
    assert s.poll_overflow() is False and reads.n == 2


def test_unknown_structure_raises():
    v, f = j_scenes.cornell_box()
    with pytest.raises(ValueError):
        RenderSession.create(Triangles.from_mesh(v, f, device=CPU),
                             structure="bvh")
