"""PyTorch port, captured graphs of the paper's structures
(hagrid_tpu_torch/utils/graphs.py through render/session.py and
render/dynamic.py): the irregular and uniform sessions' warm rebuilds,
whose spans of device work replay as graphs on the card and run here on
CPU tensors through the same static-buffer path, and AnimatedScene's
frame; and, for all three structures, a warm grid that a caller keeps,
which the next warm rebuild must leave as its frame's grid.

The same numpy meshes, deformed by the JAX package's wave_deform, go
through both packages (so that an ulp of the deform cannot move a
triangle across a cell face, as in tests/test_torch_dynamic.py): each
warm grid's tables must equal the reference's build_irregular /
build_uniform on the session's top dims (capacity and dims), ref_tris
included, as tests/test_torch_irregular.py holds them, and the port's
eager build bit for bit. Every body passes tests/test_torch_graphs.py's
capture guard.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits
from test_torch_graphs import _guarded
from test_torch_packet import assert_grids_equal
from test_torch_uniform import _Reads

from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid import irregular as j_irr
from hagrid_tpu.grid.packet import build_packet as j_build_packet
from hagrid_tpu.grid import uniform as j_uniform
from hagrid_tpu.render import dynamic as j_dynamic
from hagrid_tpu.utils.config import BuildParams as JParams
from hagrid_tpu_torch import interop
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.grid import irregular, packet, uniform
from hagrid_tpu_torch.render import dynamic
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils.config import BuildParams

CPU = "cpu"
# Waves sized to each scene (the default is sized for a 30 x 15 x 12
# hall): Cornell spans 556 units, the soup one.
WAVES = {"cornell": dict(amplitude=12.0, freq=0.01),
         "soup": dict(amplitude=0.05, freq=6.0)}
TIMES = (0.1, 0.2)
SPANS = ("top", "cells", "merge", "finish")
IRREGULAR = ("top_res_log", "top_offset", "entries", "cell_min", "cell_max",
             "cell_starts", "ref_ids", "alive", "preexpanded", "top_info",
             "erec", "num_entries", "total_refs", "bbox_lo", "bbox_hi",
             "ref_tris")
UNIFORM = ("cell_starts", "ref_ids", "total_refs", "bbox_lo", "bbox_hi")
PACKET = ("rs", "rowinfo", "cols", "planes", "total_refs", "total_pairs",
          "bbox_lo", "bbox_hi")


def _mesh(scene):
    if scene == "cornell":
        return j_scenes.cornell_box()
    return j_scenes.random_soup(150, seed=0)


@functools.lru_cache(maxsize=None)
def _frames(scene):
    """(faces, [(t, vertices)]): the base mesh at t = None and the JAX
    package's wave_deform of it at TIMES, as numpy."""
    v, f = _mesh(scene)
    out = [(None, v)]
    for t in TIMES:
        out.append((t, np.array(j_dynamic.wave_deform(
            jnp.asarray(v), jnp.float32(t), **WAVES[scene]))))
    return f, out


def _params(name):
    return {"default": (JParams(), BuildParams()),
            "dynamic": (JParams.dynamic(), BuildParams.dynamic())}[name]


def _differ(got, want, fields):
    """Fields of two grids whose values differ (either package)."""
    def a(x):
        return x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return [k for k in fields
            if not np.array_equal(a(getattr(got, k)), a(getattr(want, k)))]


def _spans(s):
    return {k: s._graphs.captured(k) for k in s._graphs.keys()}


@pytest.mark.parametrize("scene,params", [("cornell", "default"),
                                          ("cornell", "dynamic"),
                                          ("soup", "dynamic")])
def test_irregular_warm_rebuilds_match_reference(scene, params,
                                                 monkeypatch):
    """Cold, then warm rebuilds on two deformed frames: each warm grid
    equals the reference's build_irregular on the session's top dims and
    the port's eager build, table by table; a warm rebuild reads the
    device three times (rt_total with e_total, r2_total, n_alive), each
    span keeps its one capture, and the tables keep their addresses."""
    jp, p = _params(params)
    f, frames = _frames(scene)
    s = None
    ptrs = seen = None
    for t, v in frames:
        tris = Triangles.from_mesh(v, f, device=CPU)
        if s is None:
            s = RenderSession.create(tris, p, structure="irregular")
            continue
        reads = _Reads(monkeypatch)
        s.rebuild(tris)
        assert reads.n == 3, t
        monkeypatch.undo()
        jg = j_irr.build_irregular(JTris.from_mesh(v, f), jp,
                                   top_dims=s.grid.top_dims)
        assert not _differ(s.grid, jg, IRREGULAR), t
        eager = irregular.build_irregular(tris, p, top_dims=s.grid.top_dims)
        assert not _differ(s.grid, eager, IRREGULAR), t
        assert s.grid.tris is tris
        assert set(s._graphs.keys()) == set(SPANS)
        got = tuple(getattr(s.grid, k).data_ptr() for k in IRREGULAR)
        assert ptrs in (None, got)
        assert seen is None or all(_spans(s)[k] is seen[k] for k in SPANS)
        ptrs, seen = got, _spans(s)


@pytest.mark.parametrize("scene", ["cornell", "soup"])
def test_uniform_warm_rebuilds_match_reference(scene, monkeypatch):
    """The same for the uniform session: one span and one read a warm
    rebuild, tables equal to the reference's build_uniform at the
    session's capacity and dims."""
    f, frames = _frames(scene)
    s = None
    for t, v in frames:
        tris = Triangles.from_mesh(v, f, device=CPU)
        if s is None:
            s = RenderSession.create(tris, structure="uniform")
            continue
        cap, dims = s.grid.ref_ids.shape[0], s.grid.dims
        reads = _Reads(monkeypatch)
        s.rebuild(tris)
        assert reads.n == 1, t
        monkeypatch.undo()
        jg = j_uniform.build_uniform(JTris.from_mesh(v, f),
                                     ref_capacity=cap, dims=dims)
        assert s.grid.dims == jg.dims
        assert not _differ(s.grid, jg, UNIFORM), t
        eager = uniform.build_uniform(tris, ref_capacity=cap, dims=dims)
        assert not _differ(s.grid, eager, UNIFORM), t
        assert list(s._graphs.keys()) == ["uniform"]


def test_animated_frame_equals_eager_and_reference():
    """AnimatedScene.frame through its graph: bit-equal to the eager
    wave_deform and Triangles.from_mesh, within test_torch_dynamic.py's
    atol of the reference's wave_deform; one capture per deform, fresh
    tensors a frame."""
    v, f = _mesh("soup")
    kw = WAVES["soup"]
    scene = dynamic.AnimatedScene(v, f, device=CPU,
                                  deform=functools.partial(
                                      dynamic.wave_deform, **kw))
    held = None
    for t in (0.0, 0.1, 0.73, 12.5):
        got = scene.frame(t)
        want = Triangles.from_mesh(dynamic.wave_deform(
            scene.base_vertices, t, **kw), scene.faces)
        for k in ("v0", "e1", "e2", "n"):
            assert torch.equal(getattr(got, k), getattr(want, k)), (t, k)
        jv = np.asarray(j_dynamic.wave_deform(jnp.asarray(v),
                                              jnp.float32(t), **kw))
        np.testing.assert_allclose(got.v0.numpy(), jv[f[:, 0]], rtol=0,
                                   atol=4e-6)
        if held is not None:          # the last frame was not overwritten
            assert torch.equal(held[1], held[0].v0)
        held = (got, got.v0.clone())
    assert list(scene._graphs.keys()) == ["frame"]
    first = scene._graphs.captured("frame")
    scene.deform = dynamic.wave_deform
    scene.frame(0.5)
    assert scene._graphs.captured("frame") is not first


def test_bodies_pass_the_capture_guard(monkeypatch):
    """Every span of the irregular (both presets) and the uniform warm
    rebuild and the animated frame does nothing a capture refuses; a
    host read planted in the air octree (span C) is caught."""
    v, f = _mesh("cornell")
    tris = Triangles.from_mesh(v, f, device=CPU)
    sessions = []
    for p in (BuildParams(), BuildParams.dynamic()):
        s = RenderSession.create(tris, p, structure="irregular")
        s.rebuild(tris)
        sessions.append(s)
    u = RenderSession.create(tris, structure="uniform")
    u.rebuild(tris)
    scene = dynamic.AnimatedScene(v, f, device=CPU)
    scene.frame(0.3)
    caps = [c for s in sessions + [u] for c in _spans(s).values()]
    caps.append(scene._graphs.captured("frame"))
    assert len(caps) == 2 * len(SPANS) + 2
    for cap in caps:
        assert _guarded(cap) == [], cap.what
    airboxes = irregular._stage_airboxes

    def reading_airboxes(top_starts, *a):
        bool(top_starts.max() > 0)
        return airboxes(top_starts, *a)

    monkeypatch.setattr(irregular, "_stage_airboxes", reading_airboxes)
    found = _guarded(sessions[0]._graphs.captured("merge"))
    assert any("_local_scalar_dense" in x or "is_nonzero" in x
               for x in found), found


def test_grown_compaction_recaptures_its_span_alone(monkeypatch):
    """A compaction capacity that moves recaptures span D alone: the
    other spans keep their keys and captures, and the grid equals the
    eager build at that capacity."""
    v, f = _mesh("soup")
    tris = Triangles.from_mesh(v, f, device=CPU)
    p = BuildParams()
    s = RenderSession.create(tris, p, structure="irregular")
    s.rebuild(tris)
    keys, spans = s._graphs.keys(), _spans(s)
    rows = s.grid.alive.shape[0]
    bucket = irregular._cell_capacity
    monkeypatch.setattr(irregular, "_cell_capacity",
                        lambda n: bucket(n) + 1024)
    s.rebuild(tris)
    now = s._graphs.keys()
    assert [k for k in SPANS if now[k] != keys[k]] == ["finish"]
    assert all(_spans(s)[k] is spans[k] for k in SPANS[:3])
    assert s.grid.alive.shape[0] == rows + 1024
    eager = irregular.build_irregular(tris, p, top_dims=s.grid.top_dims)
    assert not _differ(s.grid, eager, IRREGULAR)


def test_alternating_compaction_replays_its_kept_captures(monkeypatch):
    """A compaction capacity that moves between two buckets and back, as
    n_alive does when the deform sweeps across a bucket edge: over four
    warm rebuilds of deformed frames each grid equals the eager build at
    its capacity bit for bit, span D's capture for a bucket is the same
    object when the bucket comes back (the other spans keep theirs), and
    a grid kept from the first warm frame stays that frame's after both
    captures have replayed."""
    v, f = _mesh("soup")
    # A fifth of the soup's wave, so that spans A-C keep their capacities.
    kw = dict(WAVES["soup"], amplitude=0.01)
    anim = dynamic.AnimatedScene(v, f, device=CPU, deform=functools.partial(
        dynamic.wave_deform, **kw))
    p = BuildParams()
    s = RenderSession.create(anim.frame(0.0), p, structure="irregular")
    bucket, extra = irregular._cell_capacity, [0]
    monkeypatch.setattr(irregular, "_cell_capacity",
                        lambda n: bucket(n) + extra[0])
    finish, rows, kept, spans = {}, set(), None, None
    for i, t in enumerate((0.1, 0.2, 0.3, 0.4)):
        extra[0] = 1024 * (i % 2)
        tris = anim.frame(t)
        s.rebuild(tris)
        eager = irregular.build_irregular(tris, p, top_dims=s.grid.top_dims)
        assert not _differ(s.grid, eager, IRREGULAR), t
        if kept is None:
            kept = (s.grid, eager, {k: getattr(s.grid, k).clone()
                                    for k in IRREGULAR})
            spans = _spans(s)
        assert finish.setdefault(i % 2, _spans(s)["finish"]) is \
            _spans(s)["finish"], t
        assert all(_spans(s)[k] is spans[k] for k in SPANS[:3]), t
        rows.add(s.grid.alive.shape[0])
    assert finish[0] is not finish[1] and len(rows) == 2
    assert len(s._graphs.kept("finish")) == 2
    g, eager, tables = kept
    assert _differ(s.grid, eager, IRREGULAR), "t = 0.4 built t = 0.1's grid"
    assert not _differ(g, eager, IRREGULAR)
    assert all(torch.equal(getattr(g, k), x) for k, x in tables.items())


def test_overflowed_cell_refs_recapture_and_match_reference():
    """A warm rebuild whose cell stage overflows the capacity it starts
    at (forced small, captured anew there) runs span B again at the
    reference's capacity, a key the slot keeps: B replays its capture of
    the last build, so the spans that read its buffers keep theirs, as
    span A does, and the grid equals the reference's."""
    v, f = _mesh("cornell")
    tris = Triangles.from_mesh(v, f, device=CPU)
    jp, p = _params("default")
    s = RenderSession.create(tris, p, structure="irregular")
    s.rebuild(tris)
    keys, spans = s._graphs.keys(), _spans(s)
    (first, cap), = [(k[1], c) for k, c in s._caps.items() if k != "rt"]
    assert cap == s.grid.ref_ids.shape[0]
    s._caps[("r2", first)] = 256
    s.rebuild(tris)
    now = s._graphs.keys()
    assert now["top"] == keys["top"] and _spans(s)["top"] is spans["top"]
    # B ends at its old key and capture; C and D read the same buffers.
    assert sorted(k[0][3] for k in s._graphs.kept("cells")) == [256, cap]
    assert all(now[k] == keys[k] for k in SPANS[1:])
    assert all(_spans(s)[k] is spans[k] for k in SPANS[1:])
    assert s._caps[("r2", first)] == cap
    jg = j_irr.build_irregular(JTris.from_mesh(v, f), jp,
                               top_dims=s.grid.top_dims)
    assert not _differ(s.grid, jg, IRREGULAR)


@pytest.mark.parametrize("structure", ["irregular", "uniform"])
def test_trace_on_graphed_grid_matches_reference(structure):
    """session.trace on a graphed warm grid of a deformed Cornell frame
    against the reference's trace on its own build of that frame, by
    _check."""
    f, frames = _frames("cornell")
    v = frames[-1][1]
    jt = JTris.from_mesh(v, f)
    tris = Triangles.from_mesh(v, f, device=CPU)
    s = RenderSession.create(Triangles.from_mesh(frames[0][1], f,
                                                 device=CPU),
                             structure=structure)
    s.rebuild(tris)
    jr = j_primary_rays(j_scenes.cornell_camera(), 32, 32)
    rays = interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                   device=CPU)
    if structure == "irregular":
        jg = j_irr.build_irregular(jt, JParams(), top_dims=s.grid.top_dims)
        want = j_irr.trace_irregular_fast(jg, jr)
    else:
        jg = j_uniform.build_uniform(jt, ref_capacity=s.grid.ref_ids.shape[0],
                                     dims=s.grid.dims)
        want = j_uniform.trace_uniform_fast(jg, jr)
    check_hits(s.trace(rays, coherent=True), want)


def _eager_build(structure, s, tris):
    """The port's eager build of `tris` at the session's capacity and
    dims, and the JAX package's of the same vertices `v` (a function of
    v, f); the fields to compare."""
    g = s.grid
    if structure == "packet":
        cap, dims3, bbox = g.ref_capacity, g.dims3, s.bbox
        return (packet.build_packet(tris, bbox=bbox, ref_capacity=cap,
                                    dims3=dims3, check=False),
                lambda v, f: j_build_packet(JTris.from_mesh(v, f),
                                            ref_capacity=cap, dims3=dims3,
                                            bbox=bbox, check=False),
                PACKET)
    if structure == "irregular":
        top = g.top_dims
        return (irregular.build_irregular(tris, BuildParams(), top_dims=top),
                lambda v, f: j_irr.build_irregular(JTris.from_mesh(v, f),
                                                   JParams(), top_dims=top),
                IRREGULAR)
    cap, dims = g.ref_ids.shape[0], g.dims
    return (uniform.build_uniform(tris, ref_capacity=cap, dims=dims),
            lambda v, f: j_uniform.build_uniform(JTris.from_mesh(v, f),
                                                 ref_capacity=cap, dims=dims),
            UNIFORM)


@pytest.mark.parametrize("structure", ["packet", "irregular", "uniform"])
def test_kept_warm_grid_stays_its_frame(structure):
    """A grid kept from the warm rebuild at t = 0.1 and the ref total
    that rebuild returned, after a warm rebuild at t = 0.2: still the
    t = 0.1 frame's, table by table against the JAX package's build of
    that frame at the session's capacity and dims (packet:
    assert_grids_equal, `overflowed` included) and bit for bit against
    the port's eager build; the new grid is the t = 0.2 frame's and
    keeps the buffers' addresses."""
    v, f = _mesh("cornell")
    kw = WAVES["cornell"]
    anim = dynamic.AnimatedScene(v, f, device=CPU, deform=functools.partial(
        dynamic.wave_deform, **kw))
    ext = v.max(0) - v.min(0)
    s = RenderSession.create(anim.frame(0.0), structure=structure, verts=v,
                             bbox_margin=(kw["amplitude"] + 1) / ext.min())
    tris = anim.frame(0.1)
    n = s.rebuild(tris)
    g = s.grid
    eager, reference, fields = _eager_build(structure, s, tris)
    v1 = dynamic.wave_deform(anim.base_vertices, 0.1, **kw).numpy()
    assert not _differ(g, eager, fields)
    kept = {k: getattr(g, k).clone() for k in fields}
    ptrs = [getattr(g, k).data_ptr() for k in fields]
    s.rebuild(anim.frame(0.2))
    assert s.grid is not g
    assert [getattr(s.grid, k).data_ptr() for k in fields] == ptrs
    assert _differ(s.grid, eager, fields), "t = 0.2 built the same grid"
    assert not _differ(g, eager, fields)
    assert all(torch.equal(getattr(g, k), t) for k, t in kept.items())
    jg = reference(v1, f)
    if structure == "packet":
        assert_grids_equal(g, jg)
        assert bool(g.overflowed) == bool(eager.overflowed)
    else:
        assert not _differ(g, jg, fields)
    assert int(n) == int(eager.total_refs) == int(np.asarray(jg.total_refs))
    assert g.tris is tris
