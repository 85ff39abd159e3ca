"""idle_share: the share (%) of a frame's wall time in which no kernel,
copy or memset runs on the device: the device's busy time a frame in the
stretch profiled for the device alone, over the mean frame of the same
run's measured window (host clock), which runs without the profiler and
so without its cost (about 1-3 ms a frame on the H100). Read only where
the profiler saw every counted kernel the program launched in the
stretch."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["whole"] or not rec["frames_ms"]:
        return None
    busy = prof["busy_s"] / prof["frames"]
    frame = rec["window_s"] / len(rec["frames_ms"])
    return 100.0 * (1.0 - busy / frame)
