"""PyTorch port, captured graphs (hagrid_tpu_torch/utils/graphs.py): the
packet session's waves and warm rebuilds through the static-buffer path
that the card captures and replays; here, on CPU tensors, the same
bodies run directly on the buffers.

The waves are held against the JAX package's RenderSession.trace on the
same budgets (its frame runs as its own CPU tests run it), the warm
rebuilds' tables against its build_packet. A guard stands in for the
capture: it fails the bodies' second run (the first is the warm-up that
a capture also makes) on any op that a stream capture on the card
refuses, and it catches a read planted in a body.
"""

import gc
import sys

import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits
from test_torch_packet import assert_grids_equal
from torch.utils._python_dispatch import TorchDispatchMode

from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid.packet import build_packet as j_build_packet
from hagrid_tpu.render.session import RenderSession as JRenderSession
from hagrid_tpu_torch import interop
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.grid.packet import build_packet
from hagrid_tpu_torch.ops import sweep_kernel, sweep_trace
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils import graphs, profiling

CPU = "cpu"
SIZE = 16                     # primaries: SIZE x SIZE, block order
N_RAND = 256                  # random any-hit rays
PRIMARY = (False, True, SIZE * SIZE, None)
ANYHIT = (True, False, N_RAND, "ao")
# Budgets both sessions trace with in the reference test: (blocks, live
# rows); small, since the reference's kernel runs in interpret mode here.
BUDGETS = {PRIMARY: (128, None), ANYHIT: (128, 4096)}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _random(lo, hi, n, seed):
    """Rays from inside the box in random directions; a fifth of them
    with a short tmax."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.2, 100.0, np.inf).astype(np.float32)
    return org, d, np.zeros(n, np.float32), tmax


@pytest.fixture(scope="module")
def cornell():
    """A port session on the CPU and the JAX package's, their rays, and
    the numpy inputs."""
    v, f = j_scenes.cornell_box()
    s = RenderSession.create(Triangles.from_mesh(v, f, device=CPU), verts=v)
    jr = j_primary_rays(j_scenes.cornell_camera(), SIZE, SIZE,
                        order="block")
    lo, hi = _np(s.grid.bbox_lo), _np(s.grid.bbox_hi)
    rand = _random(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), N_RAND, 3)
    js = JRenderSession.create(JTris.from_mesh(v, f), verts=v)
    return dict(v=v, f=f, s=s, js=js, jr=jr, rand=rand,
                prim=interop.rays_from_numpy(jr.org, jr.dir, jr.tmin,
                                             jr.tmax, device=CPU),
                rays=interop.rays_from_numpy(*rand, device=CPU))


def _wave(c, key):
    return (c["prim"], dict(coherent=True)) if key == PRIMARY else \
        (c["rays"], dict(any_hit=True, cal_key="ao"))


@pytest.mark.parametrize("key", [PRIMARY, ANYHIT], ids=["closest", "any"])
def test_session_waves_match_reference(cornell, key):
    """A coherent closest-hit wave and an incoherent any-hit wave through
    the session's static buffers, against the JAX session's trace on the
    same budgets (test_render_session_cornell's thresholds; any hit:
    hit/miss equal), twice (the second call is the replay's path)."""
    c = cornell
    s = RenderSession.create(Triangles.from_mesh(c["v"], c["f"],
                                                 device=CPU), verts=c["v"])
    s._bmax_cal[key] = BUDGETS[key]
    rays, kw = _wave(c, key)
    first = s.trace(rays, **kw)
    assert ("trace", key) in s._graphs.keys()
    again = s.trace(rays, **kw)
    for k in ("tri_id", "t", "u", "v"):
        assert torch.equal(getattr(first, k), getattr(again, k)), k
    js = c["js"]
    js._bmax_cal[key] = BUDGETS[key]
    jrays = c["jr"] if key == PRIMARY else JRays.make(
        c["rand"][0], c["rand"][1], tmax=c["rand"][3])
    want = js.trace(jrays, **kw)
    if key == PRIMARY:
        check_hits(first, want)
    else:
        hit = _np(first.tri_id) >= 0
        np.testing.assert_array_equal(hit, np.asarray(want.tri_id) >= 0)
        assert 0 < hit.sum() < hit.size
        assert (_np(first.t)[hit] < c["rand"][3][hit]).all()
    assert not s.poll_overflow(recalibrate=False)


def test_warm_rebuilds_match_reference(cornell):
    """Cold, then two warm rebuilds of moving geometry: each grid equal to
    the JAX package's warm build_packet (integer tables exactly); the warm
    grids share their tables' addresses, the cold grid is left as it
    was, and the grid's tris are the frame's."""
    c = cornell
    v, f = c["v"], c["f"]
    s = RenderSession.create(Triangles.from_mesh(v, f, device=CPU), verts=v,
                             bbox_margin=0.05)
    cold = s.grid
    cold_rs = cold.rs.clone()
    ptrs = None
    for k, shift in enumerate((4.0, -6.0)):
        vk = (v + np.float32(shift)).astype(np.float32)
        tris = Triangles.from_mesh(vk, f, device=CPU)
        s.rebuild(tris)
        jg = j_build_packet(JTris.from_mesh(vk, f),
                            ref_capacity=cold.ref_capacity, dims3=cold.dims3,
                            bbox=s.bbox, check=False)
        assert_grids_equal(s.grid, jg)
        assert s.grid.tris is tris
        got = tuple(t.data_ptr() for t in (s.grid.rs, s.grid.cols,
                                           s.grid.rowinfo, s.grid.planes))
        assert ptrs in (None, got)
        ptrs = got
    assert torch.equal(cold.rs, cold_rs)
    assert list(s._graphs.keys()) == ["rebuild"]


def test_held_hits_survive_later_calls(cornell):
    """Hits of one call are not changed by a later call of the same key
    on other rays (the outputs are copies, not the buffers)."""
    c = cornell
    s = c["s"]
    a = s.trace(c["rays"], any_hit=True, cal_key="ao")
    saved = {k: getattr(a, k).clone() for k in ("tri_id", "t", "u", "v")}
    org, d, tmin, tmax = c["rand"]
    other = interop.rays_from_numpy(org[::-1].copy(), -d, tmin, tmax,
                                    device=CPU)
    b = s.trace(other, any_hit=True, cal_key="ao")
    assert not torch.equal(a.tri_id, b.tri_id)
    for k, t in saved.items():
        assert torch.equal(getattr(a, k), t), k
    cap = s._graphs.captured(("trace", ANYHIT))
    assert all(o.data_ptr() != getattr(b, k).data_ptr()
               for o, k in zip(cap.outputs, ("tri_id", "t", "u", "v")))


def test_poll_overflow_drops_exactly_the_grown_key(cornell):
    """A flag set on one key: poll_overflow grows that key's budgets,
    drops its capture alone and zeroes the flags in place; the key's next
    call captures anew on the grown budgets and equals trace_sweep."""
    c = cornell
    s = RenderSession.create(Triangles.from_mesh(c["v"], c["f"],
                                                 device=CPU), verts=c["v"])
    for key in (PRIMARY, ANYHIT):
        rays, kw = _wave(c, key)
        s.trace(rays, **kw)
    kept = s._graphs.captured(("trace", PRIMARY))
    flags, total = dict(s._ovf), s.trace_overflow
    before, primary = s._bmax_cal[ANYHIT], s._bmax_cal[PRIMARY]
    s._ovf[ANYHIT].fill_(True)
    total.fill_(True)
    assert s.poll_overflow() is True
    assert s._bmax_cal[ANYHIT][0] >= 2 * before[0]
    assert s._bmax_cal[PRIMARY] == primary
    assert set(s._graphs.keys()) == {("trace", PRIMARY)}
    assert s._graphs.captured(("trace", PRIMARY)) is kept
    assert all(s._ovf[k] is flags[k] for k in flags)
    assert s.trace_overflow is total
    assert not any(t.item() for t in (*flags.values(), total))
    got = s.trace(c["rays"], any_hit=True, cal_key="ao")
    bmax, rowmax = s._bmax_cal[ANYHIT]
    assert s._graphs.keys()[("trace", ANYHIT)][0][1:] == (bmax, rowmax)
    want = sweep_trace.trace_sweep(s.grid, c["rays"], any_hit=True,
                                   bmax=bmax, rowmax=rowmax)
    for k in ("tri_id", "t", "u", "v"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert s.poll_overflow() is False


def test_new_grid_address_gets_new_key(cornell):
    """The key holds the addresses of the tables a graph reads in place:
    the first warm rebuild moves the tables and the wave captures again;
    the second keeps them and the wave keeps its capture; a grid built
    elsewhere gets another."""
    c = cornell
    tris = Triangles.from_mesh(c["v"], c["f"], device=CPU)
    s = RenderSession.create(tris, verts=c["v"])
    slot = ("trace", PRIMARY)
    seen = []
    for step in ("cold", "warm", "warm again", "elsewhere"):
        if step == "elsewhere":
            s.grid = build_packet(tris, dims3=s.grid.dims3)
        elif step != "cold":
            s.rebuild(tris)
        hits = s.trace(c["prim"], coherent=True)
        seen.append((s._graphs.keys()[slot], s._graphs.captured(slot)))
        want = sweep_trace.trace_sweep(s.grid, c["prim"], coherent=True,
                                       bmax=s._bmax_cal[PRIMARY][0])
        assert torch.equal(hits.tri_id, want.tri_id)
    keys = [k for k, _ in seen]
    assert keys[0] != keys[1] and keys[1] == keys[2] and keys[3] != keys[2]
    assert seen[1][1] is seen[2][1] and seen[0][1] is not seen[1][1]
    assert len(s._graphs.keys()) == 2       # the wave and the rebuild


def test_warm_rebuilds_keep_every_wave_capture(cornell):
    """After the first warm rebuild, two more: each wave's capture (a
    coherent closest-hit wave and an incoherent any-hit wave) and the
    rebuild's stay the same objects under the same keys, though each
    rebuild moves the grid before it to storage of its own; each wave
    still equals trace_sweep on the current grid."""
    c = cornell
    v, f = c["v"], c["f"]
    s = RenderSession.create(Triangles.from_mesh(v, f, device=CPU), verts=v,
                             bbox_margin=0.05)
    slots = ("rebuild", ("trace", PRIMARY), ("trace", ANYHIT))
    seen = None
    for shift in (1.0, 3.0, -2.0):
        before = s.grid
        s.rebuild(Triangles.from_mesh((v + np.float32(shift)).astype(
            np.float32), f, device=CPU))
        held = s._graphs.buffers()
        assert seen is None or not any(
            getattr(before, k).untyped_storage().data_ptr() in held
            for k in ("rs", "rowinfo", "cols", "planes", "total_refs"))
        for key in (PRIMARY, ANYHIT):
            rays, kw = _wave(c, key)
            got = s.trace(rays, **kw)
            bmax, rowmax = s._bmax_cal[key]
            want = sweep_trace.trace_sweep(
                s.grid, rays, bmax=bmax, rowmax=rowmax,
                **{k: x for k, x in kw.items() if k != "cal_key"})
            assert torch.equal(got.tri_id, want.tri_id), (shift, key)
        now = ({k: s._graphs.keys()[k] for k in slots},
               [s._graphs.captured(k) for k in slots])
        assert seen is None or (now[0] == seen[0] and all(
            a is b for a, b in zip(now[1], seen[1]))), shift
        seen = now


class _CaptureGuard(TorchDispatchMode):
    """Records what a stream capture on the card would refuse: reading a
    tensor's value on the host, a tensor made from host data that an op
    then reads (on the card a copy from the host), and ops whose output
    size depends on the data. The plain sweep (the kernel's CPU stand-in)
    and _take's CPU-only range check are exempt."""

    _SYNC = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.is_nonzero.default,
             torch.ops.aten.equal.default,
             torch.ops.aten.nonzero.default,
             torch.ops.aten.masked_select.default,
             torch.ops.aten.repeat_interleave.Tensor}
    _EXEMPT = {sweep_kernel.sweep_blocks_plain.__code__,
               sweep_trace._take.__code__}

    def __init__(self):
        super().__init__()
        self.found, self._lifted = [], []

    def _exempt(self):
        f = sys._getframe(2)
        while f is not None:
            if f.f_code in self._EXEMPT:
                return True
            f = f.f_back
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._exempt():
            return out
        flat = [a for a in list(args) + list((kwargs or {}).values())
                for a in (a if isinstance(a, (list, tuple)) else (a,))]
        if func is torch.ops.aten.lift_fresh.default:
            self._lifted.append(out)
        elif func is not torch.ops.aten.fill_.Tensor and any(
                a is t for a in flat for t in self._lifted):
            self.found.append(f"{func} of a tensor made on the host")
        if func in self._SYNC or (
                func is torch.ops.aten.index.Tensor and any(
                    torch.is_tensor(a) and a.dtype == torch.bool
                    for a in flat[1:])):
            self.found.append(str(func))
        return out


def _guarded(cap):
    """The capture's body run once more on its buffers under the guard."""
    with _CaptureGuard() as guard:
        cap.body(*cap.static)
    return guard.found


def test_bodies_pass_the_capture_guard(cornell, monkeypatch):
    """Every captured body (a dense closest-hit wave, a compact any-hit
    wave, the warm rebuild) does nothing a capture refuses; a host read
    planted in the merge is caught."""
    c = cornell
    tris = Triangles.from_mesh(c["v"], c["f"], device=CPU)
    s = RenderSession.create(tris, verts=c["v"])
    s.rebuild(tris)
    for key in (PRIMARY, ANYHIT):
        rays, kw = _wave(c, key)
        s.trace(rays, **kw)
    slots = ("rebuild", ("trace", PRIMARY), ("trace", ANYHIT))
    for slot in slots:
        assert _guarded(s._graphs.captured(slot)) == [], slot
    merge = sweep_trace._merge

    def reading_merge(best, out, tile_of):
        bool(tile_of.max() > 0)
        return merge(best, out, tile_of)

    monkeypatch.setattr(sweep_trace, "_merge", reading_merge)
    found = _guarded(s._graphs.captured(("trace", PRIMARY)))
    assert any("_local_scalar_dense" in f or "is_nonzero" in f
               for f in found), found


def test_launches_count_each_replay():
    """count_launch adds at once outside a capture; inside one it fills
    the capture's record, which each replay adds (the card's path, as
    Captured replays its graph)."""
    counter = {"k": 0}
    profiling.count_launch(counter, "k")
    assert counter["k"] == 1
    with profiling.capture() as record:
        profiling.count_launch(counter, "k")
        profiling.count_launch(counter, "k")
    assert counter["k"] == 1
    profiling.replay(record)
    profiling.replay(record)
    assert counter["k"] == 5


def test_capturing_tallies_a_graph_captured_elsewhere():
    """profiling.capture, as exp/kernel_mt20.graphed wraps a graph
    captured outside a Graphs slot: the launches counted inside the
    block go to its record and not to the counters, each replay (one a
    replay of the graph) adds the record again, the cyclic collector is
    off inside the block and back after it, and a capture inside a
    capture raises."""
    counter = {"a": 0, "b": 0}
    collecting = gc.isenabled()
    with profiling.capture() as record:
        assert not gc.isenabled()
        for _ in range(4):
            profiling.count_launch(counter, "a")
        profiling.count_launch(counter, "b")
        with pytest.raises(RuntimeError), profiling.capture():
            pass
    assert gc.isenabled() == collecting
    assert counter == {"a": 0, "b": 0}
    assert sorted((name, n) for _, name, n in record.launches.values()) == [
        ("a", 4), ("b", 1)]
    for _ in range(3):
        profiling.replay(record)
    assert counter == {"a": 12, "b": 3}
    profiling.count_launch(counter, "a")
    assert counter["a"] == 13


def test_buffers_refuse_other_inputs():
    """An input of another shape, dtype or device than its buffer
    raises."""
    g = graphs.Graphs()
    body = lambda x: (x * 2,)  # noqa: E731
    x = torch.arange(4, dtype=torch.float32)
    out, = g.call("s", (), body, (x,))
    assert torch.equal(out, x * 2)
    cap = g.captured("s")
    for bad in (torch.zeros(5), torch.zeros(4, dtype=torch.float64)):
        with pytest.raises(ValueError):
            cap((bad,))


@pytest.fixture
def traced():
    """The program's tracing on inside the test alone, with no records."""
    profiling.tracing(True)
    profiling.reset()
    yield
    profiling.tracing(False)
    profiling.reset()


def _scaled(k):
    """A body whose result shows its key: (x * k + 1,)."""
    return lambda x: (x * k + 1,)


def test_alternating_keys_replay_their_kept_captures(traced):
    """Keys k1, k2, k1, k2 on one slot: two captures, one recapture and
    two graph hits; each call's outputs are its body's on its key and its
    inputs, the second visit to a key replays the first visit's capture,
    and a capture's output buffers outlive the other key's replay."""
    g = graphs.Graphs()
    held, kept = {}, {}
    for i, k in enumerate((2, 3, 2, 3)):
        x = torch.arange(4, dtype=torch.float32) + i
        out, = g.call("s", (k,), _scaled(k), (x,), fresh=False)
        assert torch.equal(out, x * k + 1), (i, k)
        assert held.setdefault(k, g.captured("s")) is g.captured("s")
        assert g.keys()["s"][0] == (k,)
        kept[k] = (out, x * k + 1)
    for out, want in kept.values():     # each key's last call, unmoved
        assert torch.equal(out, want)
    profiling.close_frame()
    (rec,) = profiling.frames()
    assert rec["counts"] == {"captures.s": 2, "recaptures.s": 1,
                             "graph_hits.s": 2}
    assert [r["changed"] for r in rec["recaptures"]] == [
        [["key[0]", "2", "3"]]]
    assert rec["spans"]["graph.s"]["n"] == 4


def test_buffers_and_drop_cover_every_kept_capture(traced):
    """buffers() holds both kept captures' inputs and outputs, not only
    the last call's; drop(slot) forgets both, and the slot's next call
    captures anew, a recapture."""
    g = graphs.Graphs()
    x = torch.arange(4, dtype=torch.float32)
    caps = []
    for k in (2, 3):
        g.call("s", (k,), _scaled(k), (x,))
        caps.append(g.captured("s"))
    assert caps[0] is not caps[1]
    want = {b.untyped_storage().data_ptr()
            for c in caps for b in c.static + c.outputs}
    assert len(want) == 4 and g.buffers() == want
    g.drop("s")
    assert g.keys() == {} and g.captured("s") is None
    assert g.buffers() == set()
    out, = g.call("s", (2,), _scaled(2), (x,))
    assert torch.equal(out, x * 2 + 1)
    assert g.captured("s") not in caps
    profiling.close_frame()
    (rec,) = profiling.frames()
    assert rec["counts"] == {"captures.s": 3, "recaptures.s": 2}


@pytest.mark.parametrize("order,dropped", [
    ((1, 2, 3, 4, 5), 1),            # the oldest is the least recent
    ((1, 2, 3, 4, 1, 5), 2)],        # a replay makes k1 recent again
    ids=["oldest", "least-recent"])
def test_a_slot_keeps_its_last_keys(traced, order, dropped):
    """Five distinct keys on one slot: it keeps graphs.KEEP (4) captures,
    each of the other four replays (a graph hit), and the least recently
    called key is the one captured again."""
    assert graphs.KEEP == 4
    g = graphs.Graphs()
    x = torch.arange(4, dtype=torch.float32)
    first = {}
    for k in order:
        g.call("s", (k,), _scaled(k), (x,))
        first.setdefault(k, g.captured("s"))
    assert len(g.kept("s")) == graphs.KEEP
    assert sorted(k[0][0] for k in g.kept("s")) == sorted(
        set(order) - {dropped})
    for k in sorted(set(order) - {dropped}):
        out, = g.call("s", (k,), _scaled(k), (x,))
        assert torch.equal(out, x * k + 1)
        assert g.captured("s") is first[k], k
    out, = g.call("s", (dropped,), _scaled(dropped), (x,))
    assert torch.equal(out, x * dropped + 1)
    assert g.captured("s") is not first[dropped]
    profiling.close_frame()
    (rec,) = profiling.frames()
    replays = len(order) - len(set(order))
    assert rec["counts"] == {"captures.s": 6, "recaptures.s": 5,
                             "graph_hits.s": 4 + replays}
