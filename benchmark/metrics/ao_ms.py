"""ao_ms: the mean CUDA-event time of the frame's "ao" step over
the traced window's frames."""

import statistics


def read(rec):
    ms = rec.get("spans_ms", {}).get("ao")
    return statistics.fmean(ms) if ms else None
