"""Frozen pieces of the yardstick that the program also has: the
benchmark's deform, the percentile of the frame times, and the grid
overflow test of the port's bench (bench_torch.py), copied here so that
a change to the program cannot move them.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def wave_deform(vertices: torch.Tensor, time, amplitude: float = 0.25,
                freq: float = 1.5) -> torch.Tensor:
    """A travelling sine displacement of y, standing in for skinning or
    cloth: new vertices, the argument untouched. `time` is a number or a
    0-d tensor; its phase is computed in f32 either way. The benchmark
    hands this to the program's AnimatedScene as its deform."""
    v = vertices
    phase = v[:, 0] * freq + v[:, 2] * 0.7 * freq
    if torch.is_tensor(time):
        shift = time.to(torch.float32) * 2.0 * math.pi
    else:
        shift = float(np.float32(time) * np.float32(2.0)
                      * np.float32(math.pi))
    dy = amplitude * torch.sin(phase + shift)
    return torch.stack([v[:, 0], v[:, 1] + dy, v[:, 2]], dim=1)


def percentile(values, q: int) -> float:
    """The q-th percentile (1-99) of `values`, by Python's
    statistics.quantiles (inclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return float(statistics.quantiles(values, n=100,
                                      method="inclusive")[q - 1])


def grid_overflow_flag(session) -> torch.Tensor:
    """The grid's own overflow as a device bool, read later with the
    window's other flags: the packet grid's pairs beyond its capacity,
    a wavefront grid's refs beyond its table."""
    g = session.grid
    if session.structure == "packet":
        return g.overflowed.reshape(())
    return (g.total_refs > g.ref_ids.shape[0]).reshape(())
