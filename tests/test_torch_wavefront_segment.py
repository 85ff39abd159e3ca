"""PyTorch port, the wavefront segment: `segment_plain` (the body of
`trace_plain`, the plain version of csrc/wavefront.cu's march kernel)
against the JAX package's `_jit_segment`, state for state, the per-ray
property the one-thread-per-ray kernel rests on, and the kernel's
argument block.

Both packages march the same start state: the reference's `_jit_init` on
its grids (Cornell and random_soup(150, seed=0); the irregular grid in
quad rows and per row, the uniform grid), carried across with `interop`.
After each segment every field of the state is compared, two ways:
- against the reference run op by op (`jax.disable_jit()`: each primitive
  is a program of its own, so each product and sum rounds on its own, as
  in the port and in the kernel): every field equal, the floats bit for
  bit;
- against the compiled reference: the integer fields (alive, cursor, end,
  cmin, cmax, best_id, steps) and the live count equal; the float fields
  (t_cur, best_t, best_u, best_v) to rtol 1e-5 and atol 1e-5. The
  compiled program contracts a product and a sum into one FMA on the CPU
  (ROADMAP.md section 3); on these inputs that moves best_t by up to
  6.2e-7 of its value and best_u, a cancelling sum over det, by up to
  8.3e-7 absolute (22,408 ulp near 0), and no integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_uniform_grid import random_rays

from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid import irregular as j_irr
from hagrid_tpu.grid import uniform as j_uniform
from hagrid_tpu.ops import wavefront as j_wavefront
from hagrid_tpu_torch import interop
from hagrid_tpu_torch.grid import irregular, uniform
from hagrid_tpu_torch.ops import wavefront

CPU = "cpu"
SCENES = ("cornell", "soup150")
# Grid kinds: the irregular grid's packed tables in quad rows, the same
# tables with one row more (the per-row packed path), the uniform grid.
KINDS = ("quad", "rows", "uniform")
CAPS = (1, 7, 16)
INT_KEYS = ("alive", "cursor", "end", "cmin", "cmax", "best_id", "steps")
FLOAT_KEYS = ("t_cur", "best_t", "best_u", "best_v")
# Segments compared per case at most (every case's rays are all dead by
# the last one at cap 16; at cap 1 the first segments are compared).
MAX_SEGMENTS = 12


def _mesh(scene):
    if scene == "cornell":
        return j_scenes.cornell_box()
    return j_scenes.random_soup(150, seed=0)


def _rays(scene, jg):
    """Primaries (Cornell's camera at 24x24; around the soup, 256 random
    rays with infinite tmax) and 256 random directions whose tmax is
    finite on every other ray."""
    lo, hi = np.asarray(jg.bbox_lo), np.asarray(jg.bbox_hi)
    if scene == "cornell":
        p = j_primary_rays(j_scenes.cornell_camera(), 24, 24)
    else:
        p = random_rays(256, lo, hi, seed=40)
    r = random_rays(256, lo, hi, seed=41)
    tmax = np.asarray(r.tmax).copy()
    tmax[::2] = np.random.default_rng(42).uniform(
        0.05, 1.5, 128).astype(np.float32) * float((hi - lo).max())
    cat = lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)])  # noqa: E731
    return JRays(org=jnp.asarray(cat(p.org, r.org)),
                 dir=jnp.asarray(cat(p.dir, r.dir)),
                 tmin=jnp.asarray(cat(p.tmin, r.tmin)),
                 tmax=jnp.asarray(cat(p.tmax, tmax)))


def _port_state(js):
    """The reference's state dict (its rays in `rays`) as the port's."""
    r = js["rays"]
    return interop.wavefront_state_from_numpy(
        **{k: np.asarray(js[k]) for k in ("alive", "cursor", "end", "cmin",
                                           "cmax", "t_cur", "idx", "best_t",
                                           "best_id", "best_u", "best_v",
                                           "steps")},
        org=np.asarray(r.org), dir=np.asarray(r.dir),
        tmin=np.asarray(r.tmin), tmax=np.asarray(r.tmax), device=CPU)


@pytest.fixture(scope="module")
def grids():
    """Per (scene, kind): the reference's grid and lookup, the port's
    grid carried across, and the rays in both packages."""
    out = {}
    for scene in SCENES:
        v, f = _mesh(scene)
        jt = JTris.from_mesh(v, f)
        ji = j_irr.build_irregular(jt)
        rows = ji.replace(ref_tris=jnp.concatenate([ji.ref_tris,
                                                    ji.ref_tris[:1]]))
        ju = j_uniform.build_uniform(jt, density=2.4)
        for kind, jg in (("quad", ji), ("rows", rows), ("uniform", ju)):
            if kind == "uniform":
                g = interop.uniform_grid_from_reference(jg, device=CPU)
                jl, lk = j_uniform.uniform_lookup, uniform.uniform_lookup
            else:
                g = interop.irregular_grid_from_reference(jg, device=CPU)
                jl, lk = j_irr.irregular_lookup, irregular.irregular_lookup
            jr = _rays(scene, jg)
            out[scene, kind] = dict(
                jg=jg, jl=jl, g=g, lk=lk, jr=jr,
                rays=interop.rays_from_numpy(jr.org, jr.dir, jr.tmin,
                                             jr.tmax, device=CPU))
    return out


def _start(c):
    """The reference's start state (steps 0) and the port's copy."""
    js = dict(j_wavefront._jit_init(c["jg"], c["jr"], c["jl"]))
    js["steps"] = jnp.zeros((c["jr"].count,), jnp.int32)
    return js, _port_state(js)


def _ulps(a, b):
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def _assert_state_equal(got, want, what):
    for k in INT_KEYS:
        assert torch.equal(got[k], want[k]), f"{what}: {k} differs"
    for k in FLOAT_KEYS:
        assert torch.equal(got[k].view(torch.int32),
                           want[k].view(torch.int32)), \
            f"{what}: {k} differs by up to {_ulps(got[k], want[k])} ulp"


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("kind", KINDS)
def test_init_state_equals_reference(grids, scene, kind):
    c = grids[scene, kind]
    js, want = _start(c)
    got = wavefront._init_state(c["g"], c["lk"], c["rays"])
    got["steps"] = torch.zeros_like(got["cursor"])
    _assert_state_equal(got, want, "init")
    assert torch.equal(got["idx"], want["idx"])


def _assert_close_compiled(got, want, what):
    for k in INT_KEYS:
        assert torch.equal(got[k], want[k]), f"{what}: {k} differs"
    for k in FLOAT_KEYS:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   msg=f"{what}: {k}")


def _chain(c, any_hit, cap, compare, op_by_op):
    """Segments of `cap` iterations chained from the same start state in
    both packages, compared after each; until every ray is dead (or
    MAX_SEGMENTS)."""
    js, st = _start(c)
    rpi = 2
    for seg in range(MAX_SEGMENTS):
        if op_by_op:
            with jax.disable_jit():
                js, jlive, _ = j_wavefront._jit_segment(
                    c["jg"], js, c["jl"], rpi, any_hit, cap)
        else:
            js, jlive, _ = j_wavefront._jit_segment(c["jg"], js, c["jl"],
                                                    rpi, any_hit, cap)
        st, live = wavefront.segment_plain(c["g"], c["lk"], st, rpi, any_hit,
                                           cap)
        compare(st, _port_state(js), f"segment {seg}")
        assert int(live) == int(jlive)
        if int(live) == 0:
            break
    if cap == 16:
        assert int(live) == 0, "rays still alive after the last segment"


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scene", SCENES)
def test_segment_plain_equals_reference_op_by_op(grids, scene, kind,
                                                 any_hit, cap):
    _chain(grids[scene, kind], any_hit, cap, _assert_state_equal,
           op_by_op=True)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scene", SCENES)
def test_segment_plain_equals_jit_segment(grids, scene, kind, any_hit, cap):
    _chain(grids[scene, kind], any_hit, cap, _assert_close_compiled,
           op_by_op=False)


def _march(c, any_hit, cap, rpi=2):
    """Segments of `cap` until every ray is dead; the final state."""
    st = wavefront._init_state(c["g"], c["lk"], c["rays"])
    st["steps"] = torch.zeros_like(st["cursor"])
    for _ in range(10000):
        st, live = wavefront.segment_plain(c["g"], c["lk"], st, rpi, any_hit,
                                           cap)
        if int(live) == 0:
            return st
    raise AssertionError("the march did not end")


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scene", SCENES)
def test_subset_of_batch_equals_batch_of_subset(grids, scene, kind, any_hit):
    """No ray's update reads another's: a segment over a random subset of
    the batch equals that subset of the segment over the batch, at every
    segment of a march."""
    c = grids[scene, kind]
    st = wavefront._init_state(c["g"], c["lk"], c["rays"])
    st["steps"] = torch.zeros_like(st["cursor"])
    sub = torch.as_tensor(np.sort(np.random.default_rng(7).choice(
        c["rays"].count, c["rays"].count // 3, replace=False)))
    part = {k: v[sub] for k, v in st.items()}
    for seg in range(6):
        st, live = wavefront.segment_plain(c["g"], c["lk"], st, 2, any_hit, 5)
        part, plive = wavefront.segment_plain(c["g"], c["lk"], part, 2,
                                              any_hit, 5)
        _assert_state_equal(part, {k: v[sub] for k, v in st.items()},
                            f"segment {seg}")
        assert int(plive) == int(st["alive"][sub].sum())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", KINDS)
def test_one_segment_equals_segments_of_cap(grids, kind, any_hit):
    """Marching each ray to its end in one segment (as many iterations as
    the longest march) equals marching it in segments of 1, 7 and 16
    iterations: a dead ray is a fixed point."""
    c = grids["soup150", kind]
    runs = {cap: _march(c, any_hit, cap) for cap in CAPS}
    longest = int(runs[16]["steps"].max())
    st = wavefront._init_state(c["g"], c["lk"], c["rays"])
    st["steps"] = torch.zeros_like(st["cursor"])
    whole, live = wavefront.segment_plain(c["g"], c["lk"], st, 2, any_hit,
                                          longest)
    assert int(live) == 0
    for cap, st in runs.items():
        _assert_state_equal(st, whole, f"cap {cap}")


def test_wavefront_state_from_numpy_defaults_and_devices(grids):
    c = grids["cornell", "quad"]
    js, st = _start(c)
    r = js["rays"]
    again = interop.wavefront_state_from_numpy(
        **{k: np.asarray(js[k]) for k in ("alive", "cursor", "end", "cmin",
                                           "cmax", "t_cur", "idx", "best_t",
                                           "best_id", "best_u", "best_v")},
        org=np.asarray(r.org), dir=np.asarray(r.dir),
        tmin=np.asarray(r.tmin), tmax=np.asarray(r.tmax), device=CPU)
    assert torch.equal(again["steps"], torch.zeros_like(st["cursor"]))
    for k, x in st.items():
        assert x.device.type == "cpu" and x.dtype == again[k].dtype, k


def test_kernel_mode_and_dispatch(grids):
    """The march kernel's lookups: quad rows, per-row and uniform; any
    other lookup raises (naming it) before a launch; a device that is
    neither CPU nor CUDA raises before a launch; the plain version counts
    no work; rays of the wrong type raise."""
    assert wavefront.kernel_mode(grids["cornell", "quad"]["g"], None) == 0
    assert wavefront.kernel_mode(grids["cornell", "rows"]["g"], None) == 1
    c = grids["cornell", "uniform"]
    assert wavefront.kernel_mode(c["g"], uniform.uniform_lookup) == 2

    def my_lookup(grid, voxel):
        return uniform.uniform_lookup(grid, voxel)

    with pytest.raises(ValueError, match="my_lookup"):
        wavefront.kernel_mode(c["g"], my_lookup)
    with pytest.raises(ValueError, match="my_lookup"):
        wavefront.march_args(c["g"], my_lookup, c["rays"], 2)
    with pytest.raises(ValueError, match="counts no work"):
        wavefront.trace(c["g"], c["lk"], c["rays"],
                        work=torch.zeros(5, dtype=torch.int64))
    r = c["rays"]
    meta = type(r)(*(getattr(r, k).to("meta")
                     for k in ("org", "dir", "tmin", "tmax")))
    before = dict(wavefront.launches)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        wavefront.trace(c["g"], c["lk"], meta)
    assert wavefront.launches == before
    bad = type(r)(r.org.double(), r.dir, r.tmin, r.tmax)
    with pytest.raises(ValueError, match="rays.org"):
        wavefront.march_args(c["g"], c["lk"], bad, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_args_point_into_the_state(grids, kind):
    """The march kernel's argument block on CPU tensors: sizes, the cap's
    base, the refill threshold and every pointer as the kernel reads them:
    the rays, the outputs, the stats, the bbox and the tables (the launch
    itself needs the card)."""
    c = grids["cornell", kind]
    g, rays = c["g"], c["rays"]
    mode, a, outs, stats, keep = wavefront.march_args(g, c["lk"], rays, 3,
                                                      refill=9)
    assert (a.n, a.refs_per_iter, a.no_tris, a.refill) == (
        rays.count, 3, 0, 9)
    assert list(a.dims) == list(g.fine_dims)
    assert a.cap_base == 8 * sum(g.fine_dims) + 256
    assert a.bbox_lo == g.bbox_lo.data_ptr()
    assert a.bbox_hi == g.bbox_hi.data_ptr()
    assert a.stats == stats.data_ptr() and a.work is None
    assert stats.dtype == torch.int64 and stats.tolist() == [0, 0, 0, 0]
    for k in ("org", "dir", "tmin", "tmax"):
        assert getattr(a, k) == getattr(rays, k).data_ptr()
    for k, dt in (("t", torch.float32), ("id", torch.int32),
                  ("u", torch.float32), ("v", torch.float32),
                  ("steps", torch.int32)):
        assert getattr(a, k) == outs[k].data_ptr()
        assert outs[k].shape == (rays.count,) and outs[k].dtype == dt
    assert all(any(x.data_ptr() == p for x in keep)
               for p in (a.max_cell_refs, a.stats, a.org, a.t))
    if kind == "uniform":
        assert (a.n_starts, a.n_ref_ids, a.n_tris) == (
            g.cell_starts.shape[0], g.ref_ids.shape[0], g.tris.count)
        assert a.cell_starts == g.cell_starts.data_ptr()
        assert a.top_info is None and a.erec is None
    else:
        assert (a.n_top, a.n_erec, a.n_ref_rows, a.levels) == (
            g.top_info.shape[0], g.erec.shape[0], g.ref_tris.shape[0],
            g.levels)
        assert list(a.top_dims) == list(g.top_dims)
        assert a.erec % 16 == 0 and a.ref_tris % 16 == 0
        assert a.cell_starts is None
