"""A trace's least time on the chip, counted from what its inputs need
and nothing the implementation chooses: each ray read once (org, dir,
tmin, tmax: 32 B), each hit written once (tri id, t, u, v: 16 B), the
frame's triangles read once (v0, e1, e2, n: 48 B each), and one
Moller-Trumbore test a ray (45 floating-point operations). The bound is
the larger of the bytes at the memory rate and the operations at the
FP32 rate; at these counts the bytes bound it.
"""

from __future__ import annotations

import devtrace

RAY_BYTES = 32
HIT_BYTES = 16
TRI_BYTES = 48
MT_FLOPS = 45


def least_seconds(traces, peaks: dict) -> float:
    """traces: (rays, triangles) of each trace; peaks: {"bytes_per_s",
    "flops_per_s"}."""
    nbytes = sum(r * (RAY_BYTES + HIT_BYTES) + t * TRI_BYTES
                 for r, t in traces)
    flops = sum(r * MT_FLOPS for r, _ in traces)
    return max(nbytes / peaks["bytes_per_s"], flops / peaks["flops_per_s"])


def kernel_share(rec: dict, kernels, counters, peaks: dict):
    """The share (%) of the profiled frames' traces' least time in the
    time of the named kernels, or None: where the stretch ran none of
    them (by the program's launch counters), or where the profiler lost
    kernel events in it (a share from a partial sum would read high)."""
    prof = rec.get("profile")
    if not prof or not prof["whole"]:
        return None
    if sum(prof["launches"].get(c, 0) for c in counters) == 0:
        return None
    _, sec = devtrace.kernel_stats(prof["trace"], kernels)
    return 100.0 * least_seconds(prof["traces"], peaks) / sec
