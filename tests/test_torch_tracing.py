"""PyTorch port, the program's own spans and counters
(hagrid_tpu_torch/utils/profiling.py) on the CPU, at the Cornell box's
size: tracing off adds nothing (the shared null context, no record, no
CUDA event, profiler range or sync); tracing on records the spans of a
dynamic loop a frame at a time, for the packet and the irregular
session, and leaves every hit, AO value and grid table bit-equal; a
graph slot's recapture names the key positions that changed; a budget
that poll_overflow grows counts one recalibration.
"""

import functools

import numpy as np
import pytest
import torch

from hagrid_tpu_torch import scenes
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.dynamic import AnimatedScene
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils import graphs, profiling

TIMES = (0.1, 0.2, 0.3)
WAVE = dict(amplitude=12.0, freq=0.01)   # sized to the Cornell box
PACKET = ("rs", "rowinfo", "cols", "planes", "total_refs", "total_pairs",
          "bbox_lo", "bbox_hi")
IRREGULAR = ("top_info", "erec", "ref_tris", "entries", "cell_starts",
             "ref_ids", "total_refs", "num_entries", "bbox_lo", "bbox_hi")


@pytest.fixture(autouse=True)
def _untraced():
    """Every test starts and ends with tracing off and no records."""
    profiling.tracing(False)
    profiling.reset()
    yield
    profiling.tracing(False)
    profiling.reset()


def _deform(v, t, amplitude, freq):
    from hagrid_tpu_torch.render.dynamic import wave_deform
    return wave_deform(v, t, amplitude=amplitude, freq=freq)


def _loop(structure: str, traced: bool, frames: int = len(TIMES)):
    """A dynamic loop at 16x16: deform, warm rebuild, primaries, one AO
    sample (packet), the overflow poll; (hits, AO values, grid tables)
    of each frame as host copies, and the frames' records."""
    profiling.tracing(traced)
    profiling.reset()
    v, f = scenes.cornell_box()
    rays = primary_rays(scenes.cornell_camera(), 16, 16, order="block",
                        device="cpu")
    anim = AnimatedScene(v, f, device="cpu",
                         deform=functools.partial(_deform, **WAVE))
    s = RenderSession.create(anim.frame(0.0), structure=structure, verts=v,
                             bbox_margin=0.05)
    s.poll_overflow()
    keep = PACKET if structure == "packet" else IRREGULAR
    out = []
    for i, t in enumerate(TIMES[:frames]):
        s.rebuild(anim.frame(t))
        hits = s.trace(rays, coherent=True)
        ao = None
        if structure == "packet":
            gen = torch.Generator().manual_seed(i)
            ao = integrators.ambient_occlusion(s, rays, hits, gen,
                                               n_samples=1, max_dist=60.0)
        s.poll_overflow()
        out.append(([getattr(hits, k).clone() for k in ("tri_id", "t", "u",
                                                         "v")],
                    ao, [getattr(s.grid, k).clone() for k in keep]))
    records = profiling.frames()
    profiling.tracing(False)
    return out, records


@functools.lru_cache(maxsize=None)
def _both(structure: str):
    return _loop(structure, False), _loop(structure, True)


def test_tracing_off_adds_nothing(monkeypatch):
    """Off: span() is one shared null context, count() keeps nothing, and
    a packet and an irregular dynamic frame run with CUDA events,
    profiler ranges and syncs refused; no frame is recorded."""
    assert not profiling.tracing()
    assert profiling.span("rebuild") is profiling.span("trace")
    assert profiling.span("x") is profiling._NULL

    def refuse(*a, **kw):
        raise AssertionError("tracing off made a CUDA event, a profiler "
                             "range or a sync")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.count("calibrations")
    for structure in ("packet", "irregular"):
        _loop(structure, False, frames=1)
    assert profiling.frames() == []


@pytest.mark.parametrize("structure", ["packet", "irregular"])
def test_traced_loop_records_its_spans(structure):
    """On: one record a poll (the cold build's, then one a frame); a warm
    frame holds the spans of its steps, with their counts, and each
    span's self time is its time outside its children."""
    (_, _), (_, records) = _both(structure)
    assert len(records) == 1 + len(TIMES)
    assert not any(r["profiled"] for r in records)
    cold = records[0]
    assert cold["spans"]["rebuild"]["n"] == 1
    assert "rebuild.detach" not in cold["spans"]
    first = records[1]["counts"]
    if structure == "packet":
        assert first["captures.rebuild"] == 1
        assert first["calibrations"] == 2          # the primary, AO
        assert first["captures.trace"] == 2
    else:
        for slot in ("top", "cells", "merge", "finish"):
            assert first[f"captures.{slot}"] == 1
    for rec in records[2:]:
        sp, counts = rec["spans"], rec["counts"]
        n = {k: v["n"] for k, v in sp.items()}
        assert not any(k.startswith("captures.") for k in counts)
        assert rec["recaptures"] == []
        assert n["rebuild"] == n["rebuild.detach"] == n["graph.frame"] == 1
        if structure == "packet":
            assert n["trace"] == 2 and "calibrate" not in n   # primary, AO
            assert n["graph.rebuild"] == 1 and n["graph.trace"] == 2
            assert n["ao"] == n["sort"] == n["unsort"] == 1
            assert n["sweep.layout"] == 2            # one a wave
            assert n["sweep.plan"] == n["sweep.kernel"] == n["sweep.merge"]
            assert n["sweep.plan"] >= 2
            assert n["read.poll"] == 1
        else:
            assert n["trace"] == 1
            for slot in ("top", "cells", "merge", "finish"):
                assert n[f"graph.{slot}"] == 1
            assert n["read.build"] == counts["host_reads.build"] == 3
            assert n["march"] == 1
            assert counts["march.rays"] == 16 * 16
            assert counts["march.steps"] > 0
            assert "read.poll" not in n
        for name, s in sp.items():
            assert s["device_ms"] >= 0.0 and s["host_ms"] >= 0.0, name
            assert s["self_ms"] <= s["device_ms"] + 1e-9, name
        kids = sum(sp[k]["device_ms"] for k in sp
                   if k.startswith("graph.") and k != "graph.frame")
        assert kids <= sp["rebuild"]["device_ms"] + sp["trace"]["device_ms"]


@pytest.mark.parametrize("structure", ["packet", "irregular"])
def test_tracing_leaves_results_bit_equal(structure):
    """Hits, AO values and grid tables of every frame are bit-equal with
    tracing on and off."""
    (off, _), (on, _) = _both(structure)
    for (h0, a0, g0), (h1, a1, g1) in zip(off, on):
        for x, y in zip(h0 + g0, h1 + g1):
            assert torch.equal(x, y)
        if a0 is not None:
            assert torch.equal(a0, a1)


def test_recapture_names_the_changed_key_position():
    """A slot captured again for a changed capacity counts one capture
    more and one recapture, with the position that changed, old and new;
    a key of the other tracing state is another capture too."""
    g = graphs.Graphs()
    body = lambda x: (x * 2,)                          # noqa: E731
    x = torch.arange(4.0)
    g.call("cells", ((2, 2, 2), 3, 128), body, (x,))   # untraced
    profiling.tracing(True)
    g.call("cells", ((2, 2, 2), 3, 128), body, (x,))
    g.call("cells", ((2, 2, 2), 3, 128), body, (x,))   # a replay
    g.call("cells", ((2, 2, 2), 3, 256), body, (x,))
    profiling.close_frame()
    (rec,) = profiling.frames()
    assert rec["counts"] == {"captures.cells": 2, "recaptures.cells": 2}
    assert [r["changed"] for r in rec["recaptures"]] == [
        [["tracing", False, True]], [["key[2]", "128", "256"]]]
    assert rec["recaptures"][1]["slot"] == "cells"
    assert rec["spans"]["graph.cells"]["n"] == 3


def test_planted_overflow_counts_one_recalibration():
    """An overflow flag that poll_overflow finds grows the wave's budget
    (counter recalibrations.<wave>) and drops its graph: the next trace
    captures the wave again, a recapture of its budget's position."""
    profiling.tracing(True)
    v, f = scenes.cornell_box()
    from hagrid_tpu_torch.core.types import Triangles
    s = RenderSession.create(Triangles.from_mesh(v, f, device="cpu"),
                             verts=v)
    rays = primary_rays(scenes.cornell_camera(), 16, 16, order="block",
                        device="cpu")
    s.trace(rays, coherent=True)
    assert not s.poll_overflow()
    (key,) = s._ovf
    s._ovf[key].fill_(True)
    assert s.poll_overflow()
    s.trace(rays, coherent=True)
    s.poll_overflow()
    first, planted, after = profiling.frames()
    assert first["counts"]["calibrations"] == 1
    assert planted["counts"] == {"recalibrations.primary": 1}
    assert after["counts"] == {"captures.trace": 1, "recaptures.trace": 1}
    assert [c[0] for c in after["recaptures"][0]["changed"]] == ["key[1]"]


def test_spans_nest_and_see_the_profiler():
    """Self time is a span's time outside its children; a frame recorded
    under torch.profiler is marked profiled, and its span is a
    "hagrid.<name>" range of the profiler's."""
    profiling.tracing(True)
    with profiling.span("outer"):
        with profiling.span("inner"):
            np.linalg.svd(np.ones((64, 64)))
    profiling.close_frame()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("inner"):
            pass
        profiling.close_frame()
    plain, profiled = profiling.frames()
    o, i = plain["spans"]["outer"], plain["spans"]["inner"]
    assert o["self_ms"] == pytest.approx(o["device_ms"] - i["device_ms"])
    assert not plain["profiled"] and profiled["profiled"]
    assert "hagrid.inner" in {e.key for e in prof.key_averages()}


def test_kernel_launches_count_in_the_frame():
    """count_launch adds to the wrapper's counter and, tracing on, to the
    frame's counter "launches.<name>"; a launch made during a capture
    counts only at each replay of the graph (profiling.replay), in
    both."""
    counter = {"k": 0}
    profiling.count_launch(counter, "k")         # tracing off
    with profiling.capture() as record:
        profiling.count_launch(counter, "k")
        profiling.count_launch(counter, "k")
    assert counter["k"] == 1 and \
        list(record.launches.values()) == [[counter, "k", 2]]
    profiling.tracing(True)
    profiling.count_launch(counter, "k")
    for _ in range(3):
        profiling.replay(record)
    profiling.close_frame()
    assert counter["k"] == 1 + 1 + 3 * 2
    assert profiling.frames()[-1]["counts"] == {"launches.k": 7}


@pytest.mark.parametrize("traced", [False, True])
def test_path_bounces_record_their_spans(traced):
    """On: path_bounces opens span "path" once a call and "path.spawn"
    once a wave (the primary's included), and counts max_bounces - 1
    incoherent waves in "path.waves"; the radiance is bit-equal to the
    untraced call's. Off: nothing is recorded."""
    from hagrid_tpu_torch.core.types import Triangles
    v, f = scenes.cornell_box()
    s = RenderSession.create(Triangles.from_mesh(v, f, device="cpu"),
                             verts=v)
    rays = primary_rays(scenes.cornell_camera(), 16, 16, order="block",
                        device="cpu")
    hits = s.trace(rays, coherent=True)
    s.poll_overflow()

    def bounces():
        return integrators.path_bounces(
            s, rays, hits, torch.Generator().manual_seed(3), max_bounces=4)

    want = bounces()
    s.poll_overflow()
    profiling.tracing(traced)
    profiling.reset()
    got = bounces()
    s.poll_overflow()
    records = profiling.frames()
    profiling.tracing(False)
    assert torch.equal(got, want)
    if not traced:
        assert records == []
        return
    (rec,) = records
    sp = rec["spans"]
    assert sp["path"]["n"] == 1 and sp["path.spawn"]["n"] == 4
    assert rec["counts"]["path.waves"] == 3
    assert sp["trace"]["n"] == 3 and sp["sort"]["n"] == 3
    assert sp["path"]["device_ms"] >= sp["path.spawn"]["device_ms"]
