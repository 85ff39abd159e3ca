"""Reading the device trace of a short stretch of frames: the profiler's
chrome trace parsed into device intervals and the benchmark's own host
ranges (`frame.<step>`, where the host was profiled too); the device's
busy time as the union of its intervals, the operations that took most
time, the kernels the profiler lost against the program's launch
counters, and the idle gaps labelled by the step the host was in.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_PREFIX = "frame."


def read_chrome_trace(prof) -> dict:
    """{"device": [(name, start_us, end_us)], "ranges": [(name, start_us,
    end_us)]} from a finished torch.profiler.profile. The trace goes
    through a temporary file, deleted at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    device, ranges = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            device.append((e["name"], start, end))
        elif (e.get("cat") == "user_annotation"
              and e["name"].startswith(RANGE_PREFIX)):
            ranges.append((e["name"], start, end))
    return {"device": device, "ranges": ranges}


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(trace: dict) -> float:
    """The seconds in which some operation ran on the device."""
    return sum(e - s for s, e in _union((s, e) for _, s, e
                                        in trace["device"])) * 1e-6


def top_ops(trace: dict, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    ops = {}
    for name, s, e in trace["device"]:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
    by_time = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return [[k[:200], v] for k, v in by_time]


def kernel_stats(trace: dict, patterns) -> tuple:
    """(events, seconds) of the device intervals whose names contain any
    of `patterns`."""
    n, sec = 0, 0.0
    for name, s, e in trace["device"]:
        if any(p in name for p in patterns):
            n += 1
            sec += (e - s) * 1e-6
    return n, sec


def lost_events(trace: dict, launches: dict, counted) -> list:
    """For each (kernel name pattern, launch counters): a line where the
    trace holds another number of such kernels than the counters say
    were launched in the stretch."""
    lost = []
    for pattern, counters in counted:
        seen, _ = kernel_stats(trace, (pattern,))
        want = sum(launches.get(c, 0) for c in counters)
        if seen != want:
            lost.append(f"{pattern} seen {seen}, launched {want}")
    return lost


def idle_gaps(trace: dict, top: int = 10) -> list:
    """[[step, seconds]]: the device's idle time between the first and
    the last `frame.all` range, by the innermost step range the host was
    in at each gap's middle (`frame.between` outside every step)."""
    frames = [r for r in trace["ranges"] if r[0] == "frame.all"]
    lo = min(r[1] for r in frames)
    hi = max(r[2] for r in frames)
    merged = _union((max(s, lo), min(e, hi)) for _, s, e in trace["device"]
                    if e > lo and s < hi)
    gaps, cur = [], lo
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    steps = [r for r in trace["ranges"] if r[0] != "frame.all"]
    idle = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        owner = [r for r in steps if r[1] <= mid <= r[2]]
        label = (min(owner, key=lambda r: r[2] - r[1])[0] if owner
                 else "frame.between")
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    return sorted(([k, v] for k, v in idle.items()),
                  key=lambda kv: -kv[1])[:top]
