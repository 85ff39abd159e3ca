"""path_spawn_ms: the device ms of the path bounces' spawns a frame (the
program's span "path.spawn": each wave's hit points, normals, direction
draw and new rays), summed over the frame's waves and averaged over the
measured window's frames (program_spans.py; on the card, with the
program's tracing on). None where no frame has the span."""

import program_spans


def read(rec):
    frames = program_spans.window(rec)
    if frames is None or not any("path.spawn" in f["spans"]
                                 for f in frames):
        return None
    return program_spans.mean(
        f["spans"].get("path.spawn", {}).get("device_ms", 0.0)
        for f in frames)
