"""primary_ms: the mean CUDA-event time of the frame's "primary" step over
the traced window's frames."""

import statistics


def read(rec):
    ms = rec.get("spans_ms", {}).get("primary")
    return statistics.fmean(ms) if ms else None
