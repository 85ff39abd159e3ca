"""Captured CUDA graphs: the port's counterpart of the reference's
`jax.jit` programs: on the packet path the whole-frame `_frame` of
hagrid_tpu/ops/sweep_trace.py with its ray layout and the warm build
`_build` of hagrid_tpu/grid/packet.py; the stages and passes of the
irregular build (hagrid_tpu/grid/irregular.py:118, 191, 277, 781-785),
the uniform build's `_build` (grid/uniform.py:122) and `wave_deform`
(render/dynamic.py:18).

A `Graphs` cache holds one `Captured` body per slot. A body is a function
of its static input buffers (none, if it reads all it needs in place)
that returns a tuple of tensors:
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
other addresses gets a new capture, never a stale read; a slot holds one
key at a time.

A capture's kernel launches and spans go to its record
(utils/profiling.py `capture`), which each replay adds again
(`profiling.replay`).

With tracing on, `Graphs.call` is span "graph.<slot>" (the input copies,
the replay or the capture, the output clones), a capture span
"graph.capture" (whose host seconds are `capture_s`), and counters
"captures.<slot>" and "recaptures.<slot>": a recapture is any capture of
a slot after its first, whether the slot held another key or was
dropped, recorded with the key positions that changed. A key holds the
tracing switch, so a graph captured with its event nodes is never
replayed untraced.
"""

from __future__ import annotations

import torch

from . import profiling


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
    """Captured bodies by slot, one key a slot."""

    def __init__(self):
        self._slots = {}     # slot -> (key, Captured)
        self._last = {}      # slot -> the key of its last capture

    def call(self, slot, key, body, inputs, reads=(), fresh=True) -> tuple:
        """body's outputs on `inputs`, from the slot's capture for `key`
        and the addresses of `reads` (captured now if the slot holds
        another). fresh=False returns the capture's own output buffers,
        which the next call of the slot overwrites."""
        key = (tuple(key), _reads_key(reads), profiling.tracing())
        name = slot if isinstance(slot, str) else slot[0]
        with profiling.span("graph." + name):
            held = self._slots.get(slot)
            if held is None or held[0] != key:
                self._slots.pop(slot, None)
                cap = Captured((slot, key[0]), body, inputs,
                               (tuple(inputs) + tuple(reads))[0].device)
                out = cap(inputs)
                self._slots[slot] = (key, cap)
                self._counted(slot, name, key, cap)
            else:
                out = held[1](inputs)
            return tuple(o.clone() for o in out) if fresh else out

    def _counted(self, slot, name, key, cap):
        """Count a capture of `slot` (tracing on), and a recapture with
        the key positions that changed since its last capture."""
        old = self._last.get(slot)
        self._last[slot] = key
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
        """The storage addresses of every capture's input and output
        buffers, which the capture's next call overwrites."""
        return {b.untyped_storage().data_ptr()
                for _, cap in self._slots.values()
                for b in cap.static + (cap.outputs or ())}

    def drop(self, slot):
        """Forget the slot's capture (and free its graph's memory)."""
        self._slots.pop(slot, None)

    def keys(self) -> dict:
        """slot -> the key its capture holds."""
        return {s: k for s, (k, _) in self._slots.items()}

    def captured(self, slot) -> Captured | None:
        held = self._slots.get(slot)
        return held and held[1]
