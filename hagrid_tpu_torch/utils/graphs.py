"""Captured CUDA graphs: the port's counterpart of the reference's
`jax.jit` programs: on the packet path the whole-frame `_frame` of
hagrid_tpu/ops/sweep_trace.py with its ray layout and the warm build
`_build` of hagrid_tpu/grid/packet.py; the stages and passes of the
irregular build (hagrid_tpu/grid/irregular.py:118, 191, 277, 781-785),
the uniform build's `_build` (grid/uniform.py:122) and `wave_deform`
(render/dynamic.py:18).

A `Graphs` cache holds `Captured` bodies by slot, one a key. A body is
a function of its static input buffers (none, if it reads all it needs
in place) that returns a tuple of tensors:
- on the card, its first call copies the caller's tensors into the
  buffers, runs the body once eagerly on a side stream (which loads the
  kernels and makes the constants of `device.const`), captures it into a
  `torch.cuda.CUDAGraph` and replays it once; later calls copy and
  replay. A capture that fails raises; nothing runs eagerly instead;
- on CPU tensors the same calls copy into the buffers and run the body
  on them directly, with no capture.
Either way the outputs live at fixed addresses that each call
overwrites: `Graphs.call` hands out fresh copies unless asked for the
buffers themselves. A caller that hands such buffers on (a session's
warm grid) moves what it handed out to storage of its own before the
next call overwrites them (`Graphs.buffers` finds the tensors to move).

A key holds the body's static arguments and (data_ptr, shape, dtype) of
every tensor the body reads in place instead of copying, so a table at
other addresses gets a new capture, never a stale read. A slot keeps a
capture for each of the last `KEEP` keys it was called with (each with
its own memory pool, so a replay of one overwrites no other's buffers):
a call with a kept key replays it, only a key the slot does not hold is
captured, and past `KEEP` the least recently called key is dropped. So a
capacity that moves between two buckets and back (the irregular build's
compaction rows) replays the capture of each.

A capture's kernel launches and spans go to its record
(utils/profiling.py `capture`), which each replay adds again
(`profiling.replay`).

With tracing on, `Graphs.call` is span "graph.<slot>" (the input copies,
the replay or the capture, the output clones), a capture span
"graph.capture" (whose host seconds are `capture_s`), and counters
"captures.<slot>" and "recaptures.<slot>": a recapture is any capture of
a slot after its first, whether the slot held other keys or was
dropped, recorded with the key positions that changed since the slot's
last call; and "graph_hits.<slot>": a replay of a kept capture whose key
differs from the slot's last call (a recapture saved). A key holds
the tracing switch, so a graph captured with its event nodes is never
replayed untraced.
"""

from __future__ import annotations

import torch

from . import profiling

KEEP = 4    # captures a slot keeps, one a key


def eager(slot, key, body, inputs, reads=(), fresh=True) -> tuple:
    """`Graphs.call`'s signature, run op by op: body(*inputs) on the
    caller's tensors, nothing captured or kept."""
    return tuple(body(*inputs))


def _reads_key(reads) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in reads)


class Captured:
    """One body with its static input buffers, and on the card its graph
    and what its capture recorded (launches and spans)."""

    def __init__(self, what, body, inputs, device=None):
        self.what = what
        self.body = body
        self.device = torch.device(device or inputs[0].device)
        self.static = tuple(torch.empty(x.shape, dtype=x.dtype,
                                        device=x.device) for x in inputs)
        self.outputs = None
        self.graph = None
        self.record = None      # the capture's (profiling.capture)
        self.capture_s = None   # seconds of the warm-up, capture, replay

    def __call__(self, inputs) -> tuple:
        if len(inputs) != len(self.static):
            raise ValueError(f"{self.what}: {len(inputs)} inputs, the "
                             f"buffers take {len(self.static)}")
        for s, x in zip(self.static, inputs):
            if (x.device, x.shape, x.dtype) != (s.device, s.shape, s.dtype):
                raise ValueError(
                    f"{self.what}: input {tuple(x.shape)} {x.dtype} on "
                    f"{x.device}, the buffer is {tuple(s.shape)} {s.dtype} "
                    f"on {s.device}")
            s.copy_(x)
        if self.device.type != "cuda":
            out = tuple(self.body(*self.static))
            if self.outputs is None:
                self.outputs = out
            else:
                for o, n in zip(self.outputs, out):
                    o.copy_(n)
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            profiling.replay(self.record)
        return self.outputs

    def _capture(self):
        with profiling.clocked("graph.capture") as clock:
            self._warm_capture_replay()
        self.capture_s = clock.host_s

    def _warm_capture_replay(self):
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.body(*self.static)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with profiling.capture() as record, torch.cuda.graph(graph):
                out = tuple(self.body(*self.static))
        except RuntimeError as e:
            root = e
            while root.__context__ is not None:   # the op that broke it
                root = root.__context__
            raise RuntimeError(f"capture of {self.what} failed: "
                               f"{root}") from e
        self.record = record
        self.graph, self.outputs = graph, out
        graph.replay()
        profiling.replay(record)
        torch.cuda.synchronize()


class Graphs:
    """Captured bodies by slot, up to KEEP keys a slot."""

    def __init__(self):
        # slot -> (the key of its last call, {key: Captured} least
        # recently called first)
        self._slots = {}

    def call(self, slot, key, body, inputs, reads=(), fresh=True) -> tuple:
        """body's outputs on `inputs`, from the slot's capture for `key`
        and the addresses of `reads` (captured now if the slot holds
        none). fresh=False returns the capture's own output buffers,
        which the capture's next call overwrites."""
        key = (tuple(key), _reads_key(reads), profiling.tracing())
        name = slot if isinstance(slot, str) else slot[0]
        with profiling.span("graph." + name):
            last, held = self._slots.get(slot, (None, {}))
            cap = held.pop(key, None)
            if cap is None:
                while len(held) >= KEEP:          # the least recent goes
                    del held[next(iter(held))]
                cap = Captured((slot, key[0]), body, inputs,
                               (tuple(inputs) + tuple(reads))[0].device)
                out = cap(inputs)
                self._counted(name, last, key, cap)
            else:
                out = cap(inputs)
                if last != key:
                    profiling.count("graph_hits." + name)
            held[key] = cap
            self._slots[slot] = (key, held)
            return tuple(o.clone() for o in out) if fresh else out

    @staticmethod
    def _counted(name, old, key, cap):
        """Count a capture of slot `name` (tracing on), and a recapture
        with the key positions that changed since the slot's last call,
        `old`."""
        if not profiling.tracing():
            return
        profiling.count("captures." + name)
        if old is None:
            return
        profiling.count("recaptures." + name)
        changed = [[f"key[{i}]", repr(a)[:80], repr(b)[:80]]
                   for i, (a, b) in enumerate(zip(old[0], key[0])) if a != b]
        if old[1] != key[1]:
            changed.append(["reads", None, None])
        if old[2] != key[2]:
            changed.append(["tracing", old[2], key[2]])
        profiling.recaptured(name, changed, None if cap.capture_s is None
                             else cap.capture_s * 1e3)

    def buffers(self) -> set:
        """The storage addresses of every kept capture's input and output
        buffers, which that capture's next call overwrites."""
        return {b.untyped_storage().data_ptr()
                for _, held in self._slots.values() for cap in held.values()
                for b in cap.static + (cap.outputs or ())}

    def drop(self, slot):
        """Forget every capture of the slot (and free their graphs'
        memory); its next call is a recapture."""
        if slot in self._slots:
            self._slots[slot] = (self._slots[slot][0], {})

    def kept(self, slot) -> dict:
        """key -> Captured, each capture the slot keeps, least recently
        called first."""
        return dict(self._slots.get(slot, (None, {}))[1])

    def keys(self) -> dict:
        """slot -> the key of its last call's capture."""
        return {s: next(reversed(held))
                for s, (_, held) in self._slots.items() if held}

    def captured(self, slot) -> Captured | None:
        """The capture of the slot's last call."""
        held = self._slots.get(slot, (None, {}))[1]
        return held[next(reversed(held))] if held else None
