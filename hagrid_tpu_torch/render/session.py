"""RenderSession: build + trace under one object (port of
hagrid_tpu/render/session.py).

Structures:
- "packet" (default): the slice-major packet grid and the planned sweep
  (the CUDA sweep kernel on the card). Frames after the first rebuild at
  the frame-1 capacity and dims with no host sync. The sweep's budgets
  (blocks, and live rows for the compact planner) are calibrated once
  per wave shape off the timed path (one host read per probe);
  calibrated frames read nothing back, and overflow stays a device flag
  that `poll_overflow` reads at frame boundaries. As the reference
  compiles its frame and its warm build, each calibrated wave and each
  warm rebuild runs as one captured CUDA graph on the card, replayed
  with the sweep kernel inside (utils/graphs.py); on CPU tensors the
  same bodies run directly.
- "irregular": the two-level irregular grid and the wavefront tracer on
  its packed tables.
- "uniform": the single-level grid and the same wavefront.
The wavefront structures read the device once per trace on the card (one
march kernel launch; on the CPU once per round of the plain version's
compacted rounds) and where the reference's build reads it; they have no
budgets to calibrate. As the reference compiles its build stages and
passes, a warm rebuild replays each span of device work between those
reads as one captured graph (irregular: four spans, three reads;
uniform: one span, one read).

A warm grid's tables are its graphs' output buffers, at fixed addresses,
so that the waves that read them in place keep their captures. As the
reference builds a new grid every frame, a grid the session handed out
stays that frame's: just before a warm rebuild replays over the buffers,
the session moves the grid it handed out last to storage of its own (one
device copy of its tables), and the new grid takes the buffers.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..core.types import Hits, Rays, Triangles
from ..device import const
from ..grid import irregular, packet, uniform
from ..ops.sweep_trace import trace_frame, trace_sweep
from ..utils import profiling
from ..utils.config import BuildParams
from ..utils.graphs import Graphs

_STRUCTURES = ("packet", "irregular", "uniform")
# Ceiling on the calibrated block budget: the frame's transient arrays
# grow with it (gidx 128 B/block, forward-fill scans, tile_of/tminb).
_BMAX_CAP = 1 << 20
# Calibration growth steps before giving up (each grows >= the margin).
_CAL_TRIES = 6


def _rung(x: int, base: int) -> int:
    """Round x up to base * {1, 1.5} * 2^k (1024 -> 1536 -> 2048 -> 3072
    -> 4096 ...): a geometric ladder keeps the distinct budgets per wave
    class few, at <= 33% slack."""
    u = max(1, -(-x // base))
    k = max(0, (u - 1).bit_length() - 1)
    for g in (1 << k, 3 << max(k - 1, 0), 2 << k, 3 << k):
        if g >= u:
            return g * base
    return (4 << k) * base


def _wave(key) -> str:
    """A wave key's name in the counters: its cal_key, else "primary"
    (coherent) or "secondary"."""
    _, coherent, _, cal_key = key
    return str(cal_key) if cal_key is not None else (
        "primary" if coherent else "secondary")


@dataclasses.dataclass
class RenderSession:
    params: BuildParams
    structure: str
    grid: object
    bbox: tuple | None = None  # host-side scene bounds (warm rebuilds)
    # Device bool: OR of the sweep's overflow flags since session start
    # (or the last poll_overflow that grew a budget); written in place.
    trace_overflow: torch.Tensor | None = None
    # Calibrated (block budget, live-row budget or None) per wave key.
    _bmax_cal: dict = dataclasses.field(default_factory=dict)
    # Per-wave-key accumulated overflow flags (device bools, written in
    # place by the wave's graph).
    _ovf: dict = dataclasses.field(default_factory=dict)
    # (packet grid, its (lo, hi) as the build computed them on the host).
    _host_bounds: tuple | None = None
    # The captures: the packet paths' ("trace", wave key) and "rebuild";
    # the irregular build's spans "top", "cells", "merge", "finish"; the
    # uniform build's "uniform".
    _graphs: Graphs = dataclasses.field(default_factory=Graphs)
    # The irregular build's ref capacities where its last build ended.
    _caps: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def create(tris: Triangles, params: BuildParams | None = None,
               structure: str = "packet", verts=None,
               bbox_margin: float = 0.0) -> "RenderSession":
        """The reference's signature. params: the irregular build's knobs
        (the uniform build reads snd_density, the packet build none).
        verts: optional host vertex array; gives the packet build its
        bounds without a device read. bbox_margin: fraction of the scene
        extent added on every side of the packet session's bbox, which
        warm rebuilds reuse (geometry that moves outside it is clamped
        into boundary cells, and hits can be missed)."""
        if structure not in _STRUCTURES:
            raise ValueError(f"unknown structure {structure!r}; one of "
                             f"{_STRUCTURES}")
        s = RenderSession(params=params or BuildParams(),
                          structure=structure, grid=None)
        if verts is not None and len(verts):
            v = np.asarray(verts, np.float32)
            lo, hi = v.min(0), v.max(0)
            pad = (hi - lo) * np.float32(bbox_margin)
            s.bbox = (lo - pad, hi + pad)
        s.rebuild(tris)
        return s

    def rebuild(self, tris: Triangles):
        """Per-frame rebuild; returns the new grid's ref total (a 0-d
        tensor of its own). Warm packet frames reuse frame 1's capacity
        and dims and run with no host synchronisation, as one captured
        graph; warm uniform frames reuse its ref capacity and dims, warm
        irregular frames its top dims, and both replay their build's
        spans as captured graphs. A warm grid's tables are the graphs'
        buffers; the grid handed out before it moves to storage of its
        own first (_detach), so a grid a caller kept stays its frame's."""
        with profiling.span("rebuild"):
            return self._rebuild(tris)

    def _rebuild(self, tris: Triangles):
        warm = self.grid is not None and tris.count > 0
        if warm:
            self._detach()
        if self.structure == "uniform":
            density = self.params.snd_density
            if warm:
                self.grid = uniform.build_spans(
                    tris, density, self.grid.ref_ids.shape[0],
                    self.grid.dims, run=self._graphs.call)
            else:
                self.grid = uniform.build_uniform(tris, density=density)
            return self.grid.total_refs.clone()
        if self.structure == "irregular":
            if warm:
                self.grid = irregular.build_spans(
                    tris, self.params, self.grid.top_dims,
                    run=self._graphs.call, caps=self._caps)
            else:
                self.grid = irregular.build_irregular(tris, self.params)
            return self.grid.total_refs.clone()
        if self.grid is None:
            self.grid = packet.build_packet(tris, bbox=self.bbox)
        else:
            self.grid = self._warm_packet(tris)
        if self.bbox is None:
            self.bbox = (self.grid.bbox_lo.cpu().numpy(),
                         self.grid.bbox_hi.cpu().numpy())
            bounds = self.bbox
        else:
            bounds = packet.padded_bounds(*self.bbox)
        self._host_bounds = (self.grid, bounds) if tris.count else None
        return self.grid.total_refs.clone()

    def _detach(self):
        """Move each table of the current grid that lies in a capture's
        buffers to storage of its own (a device copy, in place on the
        grid object the caller may hold), before a warm rebuild replays
        over the buffers; a cold grid has none there."""
        with profiling.span("rebuild.detach"):
            g, held = self.grid, self._graphs.buffers()
            for f in dataclasses.fields(g):
                x = getattr(g, f.name)
                if (torch.is_tensor(x)
                        and x.untyped_storage().data_ptr() in held):
                    setattr(g, f.name, x.clone())

    def _warm_packet(self, tris: Triangles):
        """build_packet at the grid's capacity and dims with check=False,
        replayed as one captured graph per (tris, dims3, capacity,
        bounds)."""
        g = self.grid
        if not 0 < tris.count < packet.MAX_TRIS:   # empty, or it raises
            return packet.build_packet(
                tris, bbox=self.bbox, ref_capacity=g.ref_capacity,
                dims3=g.dims3, check=False)
        lo, hi = (tuple(x.tolist())
                  for x in packet.grid_bounds(tris, self.bbox))
        lo_t, hi_t = (const(x, torch.float32, tris.device) for x in (lo, hi))
        dims3, cap = g.dims3, g.ref_capacity

        def body(v0, e1, e2, n):
            w = packet.build_fixed(Triangles(v0, e1, e2, n), lo_t, hi_t,
                                   dims3, cap)
            return (w.rs, w.rowinfo, w.cols, w.total_refs, w.total_pairs,
                    w.planes)

        rs, rowinfo, cols, total, pairs, planes = self._graphs.call(
            "rebuild", (tris.count, dims3, cap, lo, hi), body,
            (tris.v0, tris.e1, tris.e2, tris.n), reads=(lo_t, hi_t),
            fresh=False)
        return packet.PacketGrid(
            dims3=dims3, bbox_lo=lo_t, bbox_hi=hi_t, rs=rs, cols=cols,
            total_refs=total, total_pairs=pairs, tris=tris,
            rowinfo=rowinfo, planes=planes)

    def host_bounds(self):
        """The current grid's (lo, hi) on the host, float32, where the
        session knows them without a device read (the packet grid it
        built itself); else None."""
        grid, bounds = self._host_bounds or (None, None)
        return bounds if grid is self.grid else None

    def trace(self, rays: Rays, any_hit: bool = False,
              coherent: bool = False, cal_key=None) -> Hits:
        """Trace a wave; coherent=True for camera-ordered waves, which
        skip the binning (the wavefront structures' march kernel takes it
        to pick its refill threshold). cal_key distinguishes wave kinds of
        one shape that need separate budgets (AO samples share one, path
        bounces another); the wavefront structures ignore it."""
        with profiling.span("trace"):
            return self._trace(rays, any_hit, coherent, cal_key)

    def _trace(self, rays: Rays, any_hit: bool, coherent: bool,
               cal_key) -> Hits:
        if self.structure == "uniform":
            return uniform.trace_uniform_fast(self.grid, rays,
                                              any_hit=any_hit,
                                              coherent=coherent)
        if self.structure == "irregular":
            return irregular.trace_irregular_fast(self.grid, rays,
                                                  any_hit=any_hit,
                                                  coherent=coherent)
        key = (any_hit, coherent, rays.count, cal_key)
        cal = self._bmax_cal.get(key)
        if cal is None:
            cal = self._calibrate(key, rays, any_hit, coherent)
        bmax, rowmax = cal
        dev = rays.device
        if self.trace_overflow is None:
            self.trace_overflow = torch.zeros((), dtype=torch.bool,
                                              device=dev)
        if key not in self._ovf:
            self._ovf[key] = torch.zeros((), dtype=torch.bool, device=dev)
        # The body holds a copy of the grid object: _detach moves the
        # tables of the session's grid object, not the buffers it reads.
        grid = dataclasses.replace(self.grid)
        flag, total = self._ovf[key], self.trace_overflow

        def body(org, dir, tmin, tmax):
            hits, ovf, _, _ = trace_frame(
                grid, Rays(org, dir, tmin, tmax), any_hit, coherent,
                bmax=bmax, rowmax=rowmax)
            flag.logical_or_(ovf)
            total.logical_or_(ovf)
            return hits.tri_id, hits.t, hits.u, hits.v

        return Hits(*self._graphs.call(
            ("trace", key), (grid.dims3, bmax, rowmax), body,
            (rays.org, rays.dir, rays.tmin, rays.tmax),
            reads=(grid.rs, grid.rowinfo, grid.cols, grid.planes,
                   grid.bbox_lo, grid.bbox_hi, flag, total)))

    def _calibrate(self, key, rays: Rays, any_hit: bool, coherent: bool):
        """Budget calibration, once per wave shape and off any timed
        frame (one host read per probe): probe with the default budgets,
        set bmax = block demand * margin and rowmax = live rows * margin
        on the rung ladders, and re-probe until the wave completes (its
        own overflow flag clear). Incoherent and any-hit waves vary more
        from frame to frame and get the larger margin."""
        profiling.count("calibrations")
        with profiling.span("calibrate"):
            return self._calibrate_budgets(key, rays, any_hit, coherent)

    def _calibrate_budgets(self, key, rays: Rays, any_hit: bool,
                           coherent: bool):
        margin = 1.3 if (coherent and not any_hit) else 1.5
        bmax = rowmax = None                # first probe: default budgets
        for _ in range(_CAL_TRIES):
            _, ovf, demand = trace_sweep(
                self.grid, rays, any_hit=any_hit, coherent=coherent,
                bmax=bmax, rowmax=rowmax, return_overflow=True,
                return_demand=True)
            ovf_h = bool(ovf)
            d, rows = (int(x) for x in demand.tolist())
            want_b = _rung(int(d * margin), 1024)
            want_r = _rung(int(rows * margin), 8192) if rows else None
            if bmax is not None and not ovf_h:
                # Complete under the current budgets: keep them unless they
                # are more than two growth steps above what demand asks.
                if bmax <= max(want_b * 2, 2048):
                    break
                bmax, rowmax = want_b, want_r
                continue
            grow = max(want_b, _rung(int((bmax or 0) * 3 // 2), 1024))
            if grow > _BMAX_CAP:
                print(f"WARNING: sweep demand ({d} blocks) needs a budget "
                      f"beyond the {_BMAX_CAP}-block cap; the wave will "
                      f"trace incomplete (flagged)", file=sys.stderr)
                bmax, rowmax = _BMAX_CAP, want_r
                break
            bmax, rowmax = grow, want_r
        self._bmax_cal[key] = (bmax, rowmax)
        return bmax, rowmax

    def poll_overflow(self, recalibrate: bool = True) -> bool:
        """Read the accumulated overflow flags (one host sync; call at
        frame boundaries). With recalibrate=True, grow each offending
        wave's budgets one step (x2 on the ladders), drop its graph and
        zero its flag and trace_overflow in place (a graph writes them).
        Returns the OR of the flags. It closes the frame's record of the
        program's spans and counters (utils/profiling.py), with tracing
        on: span "read.poll" around the read, a counter
        "recalibrations.<wave>" for each budget it grows."""
        if not self._ovf:
            profiling.close_frame()
            return False
        keys = list(self._ovf)
        # One read of all the flags at once.
        with profiling.span("read.poll"):
            flags = dict(zip(keys, torch.stack(
                [self._ovf[k].reshape(()) for k in keys]).tolist()))
        any_ovf = any(flags.values())
        if any_ovf and recalibrate:
            for key, v in flags.items():
                bmax, rowmax = self._bmax_cal.get(key, (None, None))
                if not v or bmax is None:
                    continue
                self._bmax_cal[key] = (
                    min(_rung(bmax * 2, 1024), _BMAX_CAP),
                    _rung(rowmax * 2, 8192) if rowmax else rowmax)
                self._ovf[key].zero_()
                self._graphs.drop(("trace", key))
                if profiling.tracing():
                    profiling.count("recalibrations." + _wave(key))
            if self.trace_overflow is not None:
                self.trace_overflow.zero_()
        profiling.close_frame()
        return any_ovf

    def describe(self) -> str:
        g = self.grid
        if self.structure == "uniform":
            return (f"uniform dims={g.dims} cells={g.num_cells} "
                    f"refs={int(g.total_refs)}")
        if self.structure == "irregular":
            st = g.stats()
            return (f"irregular top={st['top_dims']} levels={st['levels']} "
                    f"cells={st['cells']} refs={st['refs']} "
                    f"mean_refs={st['refs_per_cell_mean']:.2f} "
                    f"empty={st['empty_cell_frac']:.2f}")
        return f"packet dims3={g.dims3} ref_capacity={g.ref_capacity}"
