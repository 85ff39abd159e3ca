"""RenderSession: build + trace under one object (port of
hagrid_tpu/render/session.py).

Structures:
- "packet" (default): the slice-major packet grid and the planned sweep
  (the CUDA sweep kernel on the card). Frames after the first rebuild at
  the frame-1 capacity and dims with no host sync. The sweep's budgets
  (blocks, and live rows for the compact planner) are calibrated once
  per wave shape off the timed path (one host read per probe);
  calibrated frames read nothing back, and overflow stays a device flag
  that `poll_overflow` reads at frame boundaries.
- "irregular": the two-level irregular grid and the compacted wavefront
  tracer on its packed tables.
- "uniform": the single-level grid and the same wavefront.
The wavefront structures read the device once per round of the trace and
a few times per build; they have no budgets to calibrate.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..core.types import Hits, Rays, Triangles
from ..grid import irregular, packet, uniform
from ..ops.sweep_trace import trace_sweep
from ..utils.config import BuildParams

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


@dataclasses.dataclass
class RenderSession:
    params: BuildParams
    structure: str
    grid: object
    bbox: tuple | None = None  # host-side scene bounds (warm rebuilds)
    # Device bool: OR of the sweep's overflow flags since session start.
    trace_overflow: torch.Tensor | None = None
    # Calibrated (block budget, live-row budget or None) per wave key.
    _bmax_cal: dict = dataclasses.field(default_factory=dict)
    # Per-wave-key accumulated overflow flags (device bools).
    _ovf: dict = dataclasses.field(default_factory=dict)

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
        """Per-frame rebuild. Warm packet frames reuse frame 1's capacity
        and dims and run with no host synchronisation; warm uniform
        frames reuse its ref capacity and dims, warm irregular frames its
        top dims."""
        if self.structure == "uniform":
            kw = {}
            if self.grid is not None:
                kw = dict(ref_capacity=self.grid.ref_ids.shape[0],
                          dims=self.grid.dims)
            self.grid = uniform.build_uniform(
                tris, density=self.params.snd_density, **kw)
            return self.grid.total_refs
        if self.structure == "irregular":
            kw = {}
            if self.grid is not None:
                kw = dict(top_dims=self.grid.top_dims)
            self.grid = irregular.build_irregular(tris, self.params, **kw)
            return self.grid.total_refs
        kw = dict(bbox=self.bbox)
        if self.grid is not None:
            kw.update(ref_capacity=self.grid.ref_capacity,
                      dims3=self.grid.dims3, check=False)
        self.grid = packet.build_packet(tris, **kw)
        if self.bbox is None:
            self.bbox = (self.grid.bbox_lo.cpu().numpy(),
                         self.grid.bbox_hi.cpu().numpy())
        return self.grid.total_refs

    def trace(self, rays: Rays, any_hit: bool = False,
              coherent: bool = False, cal_key=None) -> Hits:
        """Trace a wave; coherent=True for camera-ordered waves, which
        skip the binning. cal_key distinguishes wave kinds of one shape
        that need separate budgets (AO samples share one, path bounces
        another). The wavefront structures ignore both."""
        if self.structure == "uniform":
            return uniform.trace_uniform_fast(self.grid, rays,
                                              any_hit=any_hit)
        if self.structure == "irregular":
            return irregular.trace_irregular_fast(self.grid, rays,
                                                  any_hit=any_hit)
        key = (any_hit, coherent, rays.count, cal_key)
        cal = self._bmax_cal.get(key)
        if cal is None:
            cal = self._calibrate(key, rays, any_hit, coherent)
        bmax, rowmax = cal
        hits, ovf = trace_sweep(self.grid, rays, any_hit=any_hit,
                                coherent=coherent, bmax=bmax, rowmax=rowmax,
                                return_overflow=True)
        prev = self._ovf.get(key)
        self._ovf[key] = ovf if prev is None else prev | ovf
        self.trace_overflow = ovf if self.trace_overflow is None \
            else self.trace_overflow | ovf
        return hits

    def _calibrate(self, key, rays: Rays, any_hit: bool, coherent: bool):
        """Budget calibration, once per wave shape and off any timed
        frame (one host read per probe): probe with the default budgets,
        set bmax = block demand * margin and rowmax = live rows * margin
        on the rung ladders, and re-probe until the wave completes (its
        own overflow flag clear). Incoherent and any-hit waves vary more
        from frame to frame and get the larger margin."""
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
        wave's budgets one step (x2 on the ladders) and clear its flag.
        Returns the OR of the flags."""
        if not self._ovf:
            return False
        keys = list(self._ovf)
        # One read of all the flags at once.
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
                del self._ovf[key]
            self.trace_overflow = None
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
