"""program_spans.window() and the three metrics that read the program's
own records (recapture_ms, build_gap_ms, sweep_plan_ms), on synthetic
records: which frames make the window, and what each metric sums."""

import types

import pytest

import program_spans
import run
from conftest import BENCH


@pytest.fixture(autouse=True)
def _program_off():
    """Importing program_spans switches the program's tracing on: these
    tests put it back as they found it."""
    from hagrid_tpu_torch.utils import profiling
    was = profiling.tracing()
    yield
    profiling.tracing(was)


def _frame(profiled=False, rebuild_self=None, plan=None, capture=None,
           calibrate=None):
    spans, counts, recaps = {}, {}, []
    if rebuild_self is not None:
        spans["rebuild"] = {"n": 1, "host_ms": 9.0, "device_ms": 60.0,
                            "self_ms": rebuild_self}
    if plan is not None:
        spans["sweep.plan"] = {"n": 1, "host_ms": 0.0, "device_ms": plan,
                               "self_ms": plan}
    if calibrate is not None:
        spans["calibrate"] = {"n": 1, "host_ms": calibrate,
                              "device_ms": calibrate, "self_ms": 0.0}
    if capture is not None:
        counts["captures.cells"] = 1
        counts["recaptures.cells"] = 1
        recaps.append({"slot": "cells", "ms": capture,
                       "changed": [["key[2]", "1024", "2048"]]})
    return {"spans": spans, "counts": counts, "recaptures": recaps,
            "profiled": profiled}


def _rec(frames, n, profile=True):
    lines = []
    program = types.SimpleNamespace(frames=lambda: list(frames))
    rec = {"frames_ms": [1.0] * n, "log": lines.append}
    if profile:
        rec["profile"] = {"whole": True}
    return rec, lines, program


def _metric(name):
    return run.load_module(BENCH / "metrics" / f"{name}.py", f"t_{name}")


def test_the_window_is_the_last_unprofiled_frames(monkeypatch):
    warm = [_frame(rebuild_self=99.0, capture=500.0)] * 3
    window = [_frame(rebuild_self=2.0, plan=1.5),
              _frame(rebuild_self=4.0, plan=2.5, capture=300.0),
              _frame(rebuild_self=6.0, plan=3.5, calibrate=20.0)]
    after = [_frame(profiled=True, rebuild_self=50.0, plan=9.0)] * 8
    rec, lines, program = _rec(warm + window + after, 3)
    monkeypatch.setattr(program_spans, "profiling", program)
    assert program_spans.window(rec) == window
    assert _metric("recapture_ms").read(rec) == pytest.approx(320.0 / 3)
    # The frame with a capture is left out of the rebuild's gap.
    assert _metric("build_gap_ms").read(rec) == pytest.approx(4.0)
    assert _metric("sweep_plan_ms").read(rec) == pytest.approx(2.5)
    text = "\n".join(lines)
    assert "over 3 window frames" in text
    assert "recaptures in the window: 1" in text and "key[2]" in text
    assert text.count("program spans") == 1     # one summary a run


def test_nothing_to_read(monkeypatch):
    """No device profile (the CPU), too few records, a program without
    records, or a window with no planner span: no value."""
    frames = [_frame(rebuild_self=1.0)] * 2
    rec, _, program = _rec(frames, 2, profile=False)
    monkeypatch.setattr(program_spans, "profiling", program)
    assert program_spans.window(rec) is None
    rec, _, _ = _rec(frames, 3)
    assert _metric("build_gap_ms").read(rec) is None
    monkeypatch.setattr(program_spans, "profiling", None)
    rec, _, _ = _rec(frames, 2)
    assert _metric("recapture_ms").read(rec) is None
    monkeypatch.setattr(program_spans, "profiling", program)
    rec, _, _ = _rec(frames, 2)
    assert _metric("sweep_plan_ms").read(rec) is None
    rec, _, program = _rec([_frame(capture=1.0)] * 2, 2)
    monkeypatch.setattr(program_spans, "profiling", program)
    assert _metric("build_gap_ms").read(rec) is None
    assert _metric("recapture_ms").read(rec) == pytest.approx(1.0)
