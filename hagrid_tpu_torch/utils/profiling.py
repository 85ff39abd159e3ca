"""Timing and profiling (port of hagrid_tpu/utils/profiling.py).

On the card, times come from CUDA events (PyTorch returns before the
device has finished, so a host clock alone would time the enqueue); on
the CPU from the host clock. `time_runs` keeps both for the benches
(bench_torch.py), `timed` its median. `device_trace` wraps
`torch.profiler`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time

import torch


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class _Clock:
    """Seconds between start() and stop() of work on `device`: between
    CUDA events on the card, by the host clock elsewhere. stop() waits
    for the card (torch.cuda.synchronize) and leaves in `wall` the host
    clock's seconds of the same span."""

    def __init__(self, device):
        self.device = device
        self.card = _on_card(device)

    def start(self):
        if self.card:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t1 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        self.h0 = time.perf_counter()

    def stop(self) -> float:
        if self.card:
            self.t1.record()
            torch.cuda.synchronize(self.device)
        self.wall = time.perf_counter() - self.h0
        if self.card:
            return self.t0.elapsed_time(self.t1) * 1e-3
        return self.wall


def _block(x):
    """Wait for the card work that produces the tensors in x."""
    if torch.is_tensor(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _block(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _block(v)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _block(getattr(x, f.name))


class StageTimer:
    """Accumulates per-stage times (device time between CUDA events for
    device="cuda", host time otherwise); prints a breakdown table."""

    def __init__(self, device=None):
        self.device = device
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the body. block_on: tensors (one, or a list, tuple, dict
        or dataclass of them) whose card work the host clock waits for
        before it stops; CUDA events already time that work."""
        clock = _Clock(self.device)
        clock.start()
        yield
        if block_on is not None:
            _block(block_on)
        self.stages[name] = self.stages.get(name, 0.0) + clock.stop()

    def report(self) -> str:
        total = sum(self.stages.values()) or 1.0
        lines = [f"{'stage':<24}{'ms':>10}{'%':>7}"]
        for name, s in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<24}{s * 1e3:>10.2f}{100 * s / total:>6.1f}%")
        return "\n".join(lines)


def time_runs(fn, *args, warmup: int = 1, iters: int = 5, chain: int = 1,
              device=None, **kw) -> dict:
    """fn(*args, **kw) timed over `iters` runs after `warmup` untimed
    calls. A run spans `chain` back-to-back calls (so that a short
    kernel's launch latency overlaps the previous call's run) and one
    synchronisation. Returns the seconds a call of each run on both
    clocks: {"seconds": [...], between CUDA events for device="cuda",
    on the host clock otherwise; "wall": [...], the host clock from a
    synchronised start to the synchronisation after the run}."""
    for _ in range(warmup):
        fn(*args, **kw)
    if _on_card(device):
        torch.cuda.synchronize(device)
    clock = _Clock(device)
    secs, wall = [], []
    for _ in range(iters):
        clock.start()
        for _ in range(chain):
            fn(*args, **kw)
        secs.append(clock.stop() / chain)
        wall.append(clock.wall / chain)
    return {"seconds": secs, "wall": wall}


def timed(fn, *args, warmup: int = 1, iters: int = 5, chain: int = 1,
          device=None, **kw) -> float:
    """Median seconds a call of `time_runs`'s runs (CUDA events on the
    card, the host clock otherwise)."""
    return float(statistics.median(time_runs(
        fn, *args, warmup=warmup, iters=iters, chain=chain, device=device,
        **kw)["seconds"]))


def spread(ms) -> dict | None:
    """median, min and max of a list of times (None for None)."""
    if ms is None:
        return None
    return {"median": float(statistics.median(ms)), "min": float(min(ms)),
            "max": float(max(ms)), "runs": len(ms)}


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
