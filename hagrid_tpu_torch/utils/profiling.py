"""Timing and profiling (port of hagrid_tpu/utils/profiling.py).

On the card, times come from CUDA events (PyTorch returns before the
device has finished, so a host clock alone would time the enqueue); on
the CPU from the host clock. `time_runs` keeps both for the benches
(bench_torch.py), `timed` its median. `device_trace` wraps
`torch.profiler`.

The program's own spans and counters, off by default (`tracing`): the
session, the graphs, the sweep, the wavefront and the integrators open
`span(name)` around their steps and `count(name)` what they do. Off,
`span` returns one shared null context and `count` returns at once: no
event, no profiler range, no host sync. On, a span takes the host clock,
CUDA events on the current stream (once CUDA is initialised; else its
device time is its host time) and a `torch.profiler.record_function`
range "hagrid.<name>", so that a profiler trace shows it beside the
kernels.

A capture's record: a graph captured inside `capture()` (a `Captured`
body of utils/graphs.py, or a graph captured elsewhere) keeps a
`Record` of what ran inside the block, which `replay(record)` adds
again at each replay of the graph, in one pass:
- the kernel launches: a wrapper calls `count_launch`, which outside a
  capture adds to its counter at once (and, tracing on, to the frame's
  counter "launches.<name>"), and inside one to the record;
- the spans: a span opened while a graph captures records its two
  events as nodes of the graph and no host range or time; each replay
  adds the pair to the frame, so every replay times it. A graph
  replayed more than once in a frame shows its in-graph spans at the
  last replay's times, counted once a replay.

The records: `RenderSession.poll_overflow`, the session's frame boundary,
closes the current frame (`close_frame`): one wait for the card, then
every event of the frame turned into milliseconds before a replay
overwrites a graph's nodes. `frames()` returns the last 4096 frames,
each {"spans": {name: {"n", "host_ms", "device_ms", "self_ms"}},
"counts": {name: n}, "recaptures": [{"slot", "changed", "ms"}],
"profiled": whether a torch.profiler session was on during the frame}.
`self_ms` is a span's device time outside its child spans: where the
children hold all of its device work, the time the card idled between
them (host reads, key building, Python).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import statistics
import time

import torch
import torch.autograd.profiler as _autograd_profiler


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


# ----------------------------------------------------------------------
# The program's spans and counters
# ----------------------------------------------------------------------

_on = False
_NULL = contextlib.nullcontext()
_FRAMES = 4096
_frames: collections.deque = collections.deque(maxlen=_FRAMES)
_frame = None     # the frame being recorded (_Frame), or None
_stack = []       # the open host spans, (frame, row) each
_capture = None   # the record of the capture in progress (Record), or None
_pool = []        # timing events of closed frames' host spans, for reuse


def tracing(on: bool | None = None) -> bool:
    """The process-wide switch of the program's spans and counters (off
    by default); with no argument, its state. Switch it before a session
    is made: graphs captured with it on hold its event nodes, and a
    graph's key holds the switch, so each state replays its own."""
    global _on
    if on is not None:
        _on = bool(on)
    return _on


class _Frame:
    def __init__(self):
        # Rows [name, parent row or -1, host ms (None: replayed, or still
        # open), event0, event1, closed].
        self.spans = []
        self.counts = collections.Counter()
        self.recaptures = []
        self.profiled = False


class Record:
    """What a graph's capture recorded, for `replay`: `launches`,
    {(id(counter), name): [counter, name, n]}, and `spans`, (name,
    parent index in this list or -1 for the span open at replay, event0,
    event1) each; `open` the stack of the spans still open in the
    capture."""

    def __init__(self):
        self.launches = {}
        self.spans = []
        self.open = []


def _current() -> _Frame:
    global _frame
    if _frame is None:
        _frame = _Frame()
    if _autograd_profiler._is_profiler_enabled:
        _frame.profiled = True
    return _frame


def _parent(fr: _Frame) -> int:
    """The row of the innermost open span of frame `fr`, or -1."""
    return _stack[-1][1] if _stack and _stack[-1][0] is fr else -1


def _card() -> bool:
    return torch.cuda.is_initialized()


class _Span:
    """One span of a frame (see `span`); `host_s` its host seconds once
    closed. record=False keeps the host clock alone (`clocked`)."""

    def __init__(self, name: str, record: bool = True):
        self.name, self.record = name, record
        self.host_s = None
        self.in_graph = False
        self.events = None

    def __enter__(self):
        if self.record and _card() and \
                torch.cuda.is_current_stream_capturing():
            self.in_graph = True
            if _capture is not None:   # else a capture elsewhere: untimed
                self._enter_graph(_capture)
            return self
        if self.record:
            fr = _current()
            if _card():
                self.events = tuple(
                    _pool.pop() if _pool else
                    torch.cuda.Event(enable_timing=True) for _ in range(2))
                self.stream = torch.cuda.current_stream()
            self.row = [self.name, _parent(fr), None,
                        *(self.events or (None, None)), False]
            _stack.append((fr, len(fr.spans)))
            fr.spans.append(self.row)
            # A range only where a profiler is on to keep it.
            self.range = None
            if _autograd_profiler._is_profiler_enabled:
                self.range = torch.profiler.record_function(
                    "hagrid." + self.name)
                self.range.__enter__()
            if self.events:
                self.events[0].record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def _enter_graph(self, rec):
        self.events = (torch.cuda.Event(enable_timing=True, external=True),
                       torch.cuda.Event(enable_timing=True, external=True))
        rec.open.append(len(rec.spans))
        rec.spans.append((self.name,
                          rec.open[-2] if len(rec.open) > 1 else -1,
                          *self.events))
        self.events[0].record()

    def __exit__(self, *exc):
        if self.in_graph:
            if self.events is not None:
                self.events[1].record()
                _capture.open.pop()
            return False
        self.host_s = time.perf_counter() - self.t0
        if self.record:
            if self.events:
                self.events[1].record(self.stream)
            if self.range is not None:
                self.range.__exit__(*exc)
            _stack.pop()
            self.row[2], self.row[5] = self.host_s * 1e3, True
        return False


def span(name: str):
    """A context manager around one step of the program (see the module
    docstring); tracing off, one shared null context."""
    if not _on:
        return _NULL
    return _Span(name)


def clocked(name: str) -> _Span:
    """A span that keeps its host seconds (`host_s` after the block) with
    tracing off too, where the program times a step anyway (a capture)."""
    return _Span(name, record=_on)


def count(name: str, n: int = 1):
    """Add n to the current frame's counter `name` (tracing off: nothing)."""
    if not _on:
        return
    _current().counts[name] += n


def recaptured(slot: str, changed: list, ms: float | None):
    """A recapture of graph slot `slot`: the key positions that changed
    ([position, old, new]) and the capture's host ms (None where nothing
    was captured: CPU tensors)."""
    if not _on:
        return
    _current().recaptures.append({"slot": slot, "changed": changed,
                                  "ms": ms})


def count_launch(counter: dict, name: str):
    """One launch of kernel `name`, counted in `counter` and, tracing on,
    in the current frame's counter "launches.<name>"; during a capture
    (`capture`) the graph's replays count it instead."""
    if _capture is None:
        counter[name] += 1
        count("launches." + name)
        return
    entry = _capture.launches.setdefault((id(counter), name),
                                         [counter, name, 0])
    entry[2] += 1


@contextlib.contextmanager
def capture():
    """The block captures a graph: the launches counted and the spans
    opened inside it go to the `Record` the block yields (complete when
    the block ends), for `replay` at each replay of the graph. No cyclic
    collection runs meanwhile: one can free tensors whose release the
    capture refuses (a failed capture's leftovers did, in a process that
    had caught its error; torch.cuda.graph collects before the capture
    begins)."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a capture is already in progress")
    rec = _capture = Record()
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield rec
    finally:
        _capture = None
        if collecting:
            gc.enable()


def replay(rec: Record):
    """One replay of a graph whose capture recorded `rec`: its launches
    to their counters (and the frame's), its spans' event pairs into the
    current frame, under the span open now."""
    for counter, name, n in rec.launches.values():
        counter[name] += n
        count("launches." + name, n)
    if not _on or not rec.spans:
        return
    fr = _current()
    base, outer = len(fr.spans), _parent(fr)
    for name, parent, e0, e1 in rec.spans:
        fr.spans.append([name, base + parent if parent >= 0 else outer,
                         None, e0, e1, True])


def close_frame():
    """Close the current frame's record (the session's frame boundary):
    wait for the card once, turn every event into milliseconds, keep the
    record (an empty one where the frame opened nothing). Tracing off:
    nothing."""
    global _frame
    if not _on:
        return
    fr = _current()
    _frame = None
    # A span still open (around the boundary) is left out.
    rows = [s for s in fr.spans if s[5]]
    if any(s[3] is not None for s in rows):
        torch.cuda.synchronize()
    dev = {id(s): (s[3].elapsed_time(s[4]) if s[3] is not None
                   else (s[2] or 0.0)) for s in rows}
    child = collections.Counter()
    for s in rows:
        if s[1] >= 0:
            child[id(fr.spans[s[1]])] += dev[id(s)]
    spans = {}
    for s in rows:
        d, c = dev[id(s)], child[id(s)]
        agg = spans.setdefault(s[0], {"n": 0, "host_ms": 0.0,
                                      "device_ms": 0.0, "self_ms": 0.0})
        agg["n"] += 1
        agg["host_ms"] += s[2] or 0.0
        agg["device_ms"] += d
        agg["self_ms"] += d - c
    # The host spans' events are free again (a graph's stay its own).
    _pool.extend(e for s in rows if s[2] is not None and s[3] is not None
                 for e in s[3:5])
    _frames.append({"spans": spans, "counts": dict(fr.counts),
                    "recaptures": fr.recaptures, "profiled": fr.profiled})


def frames() -> list:
    """The closed frames' records, oldest first (the last 4096)."""
    return list(_frames)


def reset():
    """Forget every record, and the frame being recorded."""
    global _frame
    _frames.clear()
    _frame = None
