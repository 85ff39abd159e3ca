"""frame_ms_p95: the 95th percentile of every frame's own wall time in
the measured window (host clock)."""

import frozen


def read(rec):
    return frozen.percentile(rec["frames_ms"], 95)
