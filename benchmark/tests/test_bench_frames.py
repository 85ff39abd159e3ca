"""Each mix's frames through the program's plain paths on the CPU, at
the Cornell box's size, judged against the reference; and the faults
the comparison has to catch, planted in the program underneath a run."""

import json
import time

import pytest
import torch

import control
import run
from conftest import ROOT, SEED

CELLS = tuple(w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"])
DYNAMIC = tuple(c for c in CELLS if c.endswith(".dynamic"))
AO = tuple(c for c in CELLS if c.endswith(".ao1"))


def _run(manifest, cell, trace=False):
    return run.run_cell(ROOT, manifest, cell, SEED, 0.3, trace, "cpu",
                        time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_frames_are_correct(manifest, cell):
    line = _run(manifest, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", ("sponza-irregular.dynamic",
                                  "sponza-packet.ao1"))
def test_traced_run_reports_its_spans(manifest, cell):
    line = _run(manifest, cell, trace=True)
    assert line["correct"]
    want = {"primary_ms"} | ({"build_ms"} if "dynamic" in cell
                             else {"ao_ms"})
    assert set(line["metrics"]) == want


def _half(fn):
    """Trace the first half of a wave; the rest come back as misses."""
    def traced(self, rays, *a, **kw):
        h = rays.count // 2
        head = fn(self, rays.take(torch.arange(h)), *a, **kw)
        n = rays.count - h
        pad = dict(tri_id=torch.full((n,), -1, dtype=torch.int32),
                   t=torch.full((n,), float("inf")), u=torch.zeros(n),
                   v=torch.zeros(n))
        return type(head)(*(torch.cat([getattr(head, k), pad[k]])
                            for k in ("tri_id", "t", "u", "v")))
    return traced


def _altered(fn):
    """One answer of the wave altered where it is produced: the first
    hit names the triangle half the list away."""
    def traced(self, rays, *a, **kw):
        hits = fn(self, rays, *a, **kw)
        i = int(torch.nonzero(hits.tri_id >= 0)[0])
        tri = hits.tri_id.clone()
        tri[i] = (tri[i] + self.grid.tris.count // 2) % self.grid.tris.count
        return type(hits)(tri, hits.t, hits.u, hits.v)
    return traced


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_a_planted_fault_is_not_correct(manifest, cell, fault, monkeypatch):
    from hagrid_tpu_torch.render import integrators
    from hagrid_tpu_torch.render.session import RenderSession

    ao, rebuild = integrators.ambient_occlusion, RenderSession.rebuild
    if fault == "unchanged" and cell in DYNAMIC:
        # A warm rebuild returns the grid it had: every frame traces the
        # cold build's.
        def stale(self, tris):
            if self.grid is None:
                return rebuild(self, tris)
            return self.grid.total_refs.clone()
        monkeypatch.setattr(RenderSession, "rebuild", stale)
    elif fault == "unchanged":
        # The AO estimate is left as it starts, all zero.
        monkeypatch.setattr(integrators, "ambient_occlusion",
                            lambda s, rays, *a, **kw: torch.zeros(rays.count))
    elif fault == "half" and cell in DYNAMIC:
        monkeypatch.setattr(RenderSession, "trace",
                            _half(RenderSession.trace))
    elif fault == "half":
        def half_ao(session, rays, hits, *a, **kw):
            out = ao(session, rays, hits, *a, **kw).clone()
            out[rays.count // 2:] = 0.0
            return out
        monkeypatch.setattr(integrators, "ambient_occlusion", half_ao)
    elif cell in DYNAMIC:
        monkeypatch.setattr(RenderSession, "trace",
                            _altered(RenderSession.trace))
    else:
        # One AO answer in each tile of 256 pixels flipped.
        def flipped(session, rays, hits, *a, **kw):
            out = ao(session, rays, hits, *a, **kw).clone()
            out[::256] = 1.0 - out[::256]
            return out
        monkeypatch.setattr(integrators, "ambient_occlusion", flipped)
    line = _run(manifest, cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ("sponza-packet.dynamic",
                                  "sponza-packet.ao1"))
def test_an_altered_primary_answer_is_not_correct(manifest, cell,
                                                  monkeypatch):
    from hagrid_tpu_torch.render.session import RenderSession
    monkeypatch.setattr(RenderSession, "trace", _altered(RenderSession.trace))
    line = _run(manifest, cell)
    assert not line["correct"]
    assert line["checks"]["primary_gap_max"]["value"] > \
        line["checks"]["primary_gap_max"]["limit"]


@pytest.mark.parametrize("cell", ("sponza-packet.dynamic",
                                  "sponza-packet.ao1"))
@pytest.mark.parametrize("precision", ("tf32", "bfloat16"))
def test_the_control_is_not_correct(manifest, cell, precision):
    nums = control.control_numbers(ROOT, manifest, cell, SEED, 2, "cpu",
                                   precision)
    found = run.discover(ROOT, manifest, cell, False)
    ok, _ = control.judge.verdict(nums, found["traffic"]["limits"])
    assert not ok, nums
