"""build_gap_ms: the card's idle inside the warm rebuild between its
spans: the mean self time (device ms outside its child spans: the graph
replays, the host reads, the detach copies) of the program's "rebuild"
span over the measured window's frames that captured no graph
(program_spans.py; on the card, with the program's tracing on)."""

import program_spans


def read(rec):
    frames = program_spans.window(rec)
    if frames is None:
        return None
    return program_spans.mean(
        f["spans"]["rebuild"]["self_ms"] for f in frames
        if "rebuild" in f["spans"]
        and not any(k.startswith("captures.") for k in f["counts"]))
