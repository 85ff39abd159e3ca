"""frame_ms: the measured window's wall time over the frames it
completed (host clock)."""


def read(rec):
    return 1e3 * rec["window_s"] / len(rec["frames_ms"])
