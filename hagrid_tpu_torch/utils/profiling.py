"""Timing and profiling (port of hagrid_tpu/utils/profiling.py).

On the card, times come from CUDA events (PyTorch returns before the
device has finished, so a host clock alone would time the enqueue); on
the CPU from the host clock. `device_trace` wraps `torch.profiler`.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class _Clock:
    """Seconds between start() and stop() of work on `device`."""

    def __init__(self, device):
        self.card = _on_card(device)

    def start(self):
        if self.card:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.card:
            self.t1.record()
            self.t1.synchronize()
            return self.t0.elapsed_time(self.t1) * 1e-3
        return time.perf_counter() - self.t0


class StageTimer:
    """Accumulates per-stage times (device time between CUDA events for
    device="cuda", host time otherwise); prints a breakdown table."""

    def __init__(self, device=None):
        self.device = device
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        clock = _Clock(self.device)
        clock.start()
        yield
        self.stages[name] = self.stages.get(name, 0.0) + clock.stop()

    def report(self) -> str:
        total = sum(self.stages.values()) or 1.0
        lines = [f"{'stage':<24}{'ms':>10}{'%':>7}"]
        for name, s in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<24}{s * 1e3:>10.2f}{100 * s / total:>6.1f}%")
        return "\n".join(lines)


def timed(fn, *args, warmup: int = 1, iters: int = 5, chain: int = 1,
          device=None, **kw) -> float:
    """Median seconds per call of fn(*args, **kw) over `iters` timings
    after `warmup` untimed calls. A timing spans `chain` back-to-back
    calls (so that a short kernel's launch latency overlaps the previous
    call's run): between two CUDA events for device="cuda", on the host
    clock otherwise."""
    for _ in range(warmup):
        fn(*args, **kw)
    if _on_card(device):
        torch.cuda.synchronize(device)
    clock = _Clock(device)
    ts = []
    for _ in range(iters):
        clock.start()
        for _ in range(chain):
            fn(*args, **kw)
        ts.append(clock.stop() / chain)
    return float(statistics.median(ts))


@contextlib.contextmanager
def device_trace(path: str | None = None):
    """torch.profiler over a region, host and card; yields the profiler
    (`key_averages()` after the block) and, given `path`, writes a Chrome
    trace there."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if path:
        prof.export_chrome_trace(path)
