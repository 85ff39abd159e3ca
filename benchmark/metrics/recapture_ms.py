"""recapture_ms: the window's graph recaptures and budget calibrations, a
frame: the host ms of the program's "graph.capture" spans that were
recaptures of a slot, plus its "calibrate" spans, summed over the
measured window's frames and divided by their number (program_spans.py;
on the card, with the program's tracing on)."""

import program_spans


def read(rec):
    frames = program_spans.window(rec)
    if frames is None:
        return None
    ms = sum(r["ms"] or 0.0 for f in frames for r in f["recaptures"])
    ms += sum(f["spans"].get("calibrate", {}).get("host_ms", 0.0)
              for f in frames)
    return ms / len(frames)
