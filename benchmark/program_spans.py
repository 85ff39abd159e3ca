"""The program's own spans and counters, read a frame at a time: the
shared reader of the per-layer metrics recapture_ms, build_gap_ms and
sweep_plan_ms.

The program (hagrid_tpu_torch/utils/profiling.py) keeps, with its tracing
switched on, one record a frame, closed at the session's frame boundary
(the overflow poll that ends every frame here): for each span its count,
host ms, device ms and self ms (its device time outside its child
spans), the frame's counters, its graph recaptures with the key
positions that changed, and whether a torch.profiler session was on.

Importing this module switches the program's tracing on. run.py loads
the per-layer metric files, which import it, only for --trace 1, and
before it makes the session: so the program traces in traced runs from
its first capture on, and never in the --trace 0 runs that time the
cell. A program without the switch (no `tracing` in its profiling
module) is left as it is, and every metric here reads nothing.
"""

from __future__ import annotations

import importlib
import statistics

import guard

try:
    profiling = importlib.import_module(guard.PROGRAM + ".utils.profiling")
except ImportError:
    profiling = None
if hasattr(profiling, "tracing"):
    profiling.tracing(True)


def window(rec):
    """The program's records of the measured window's frames, or None.

    Only on the card (a run with its device `profile`): the last
    len(rec["frames_ms"]) records not marked `profiled`. The warm-up's
    frames come before the window and every frame after it runs under
    the profiler. None where the program keeps no records, or fewer than
    the window's frames. The first call for a run prints a summary on
    the run's log."""
    if "program_window" in rec:
        return rec["program_window"]
    got = None
    if rec.get("profile") and hasattr(profiling, "frames"):
        n = len(rec["frames_ms"])
        every = profiling.frames()
        kept = [f for f in every if not f["profiled"]]
        if n and len(kept) >= n:
            got = kept[-n:]
            summary(got, rec["log"])
            profiled = [f for f in every if f["profiled"]]
            rec["log"](f"program: {len(profiled)} profiled frames after the "
                       f"window, their captures: " + ", ".join(
                           f"frame {i} {k} {v}"
                           for i, f in enumerate(profiled)
                           for k, v in f["counts"].items()
                           if k.startswith("captures.")))
    rec["program_window"] = got
    return got


def summary(frames: list, log):
    """One summary of a window's records: mean host and device ms a frame
    of each span, counters a frame, and each recapture by slot with the
    key positions that changed."""
    n = len(frames)
    spans, counts, recaps = {}, {}, {}
    for f in frames:
        for name, s in f["spans"].items():
            acc = spans.setdefault(name, [0, 0.0, 0.0, 0.0])
            for i, k in enumerate(("n", "host_ms", "device_ms", "self_ms")):
                acc[i] += s[k]
        for name, c in f["counts"].items():
            counts[name] = counts.get(name, 0) + c
        for r in f["recaptures"]:
            where = tuple(c[0] for c in r["changed"])
            key = (r["slot"], where)
            acc = recaps.setdefault(key, [0, 0.0, r["changed"]])
            acc[0] += 1
            acc[1] += r["ms"] or 0.0
    log(f"program spans over {n} window frames (a frame: n, host ms, "
        f"device ms, self ms):")
    for name, (c, h, d, s) in sorted(spans.items(), key=lambda kv: -kv[1][2]):
        log(f"  {name}: {c / n:.2f}, {h / n:.4f}, {d / n:.4f}, {s / n:.4f}")
    log("program counters a frame: " + ", ".join(
        f"{k} {v / n:.4g}" for k, v in sorted(counts.items())))
    log(f"program recaptures in the window: "
        f"{sum(v[0] for v in recaps.values())}")
    for (slot, where), (c, ms, changed) in sorted(recaps.items()):
        log(f"  {slot}: {c} ({ms:.1f} ms), changed {list(where)}, "
            f"e.g. {changed}")


def mean(values):
    values = list(values)
    return statistics.fmean(values) if values else None
