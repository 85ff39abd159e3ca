"""sweep_plan_ms: the device ms of the sweep's planner ("sweep.plan": the
plan and the block stream of each round, timed by event nodes inside the
wave's graph) a frame, over every wave of the frame, averaged over the
measured window's frames (program_spans.py; on the card, with the
program's tracing on)."""

import program_spans


def read(rec):
    frames = program_spans.window(rec)
    if frames is None or not any("sweep.plan" in f["spans"]
                                 for f in frames):
        return None
    return program_spans.mean(
        f["spans"].get("sweep.plan", {}).get("device_ms", 0.0)
        for f in frames)
