"""build_ms: the mean CUDA-event time of the frame's "rebuild" step over
the traced window's frames."""

import statistics


def read(rec):
    ms = rec.get("spans_ms", {}).get("rebuild")
    return statistics.fmean(ms) if ms else None
