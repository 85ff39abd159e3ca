"""Dynamic geometry: per-frame animated meshes with full grid rebuilds
(port of hagrid_tpu/render/dynamic.py).

The grid is rebuilt every frame for animated scenes. The vertex animation
is a few elementwise torch ops on the card and the rebuild reuses the
session's frame-1 capacity and dims, so steady-state frames read nothing
back to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import Triangles
from ..device import resolve


def wave_deform(vertices: torch.Tensor, time, amplitude: float = 0.25,
                freq: float = 1.5) -> torch.Tensor:
    """Benchmark deformation: a traveling sine displacement of y (stands
    in for skinning or cloth updates; any f(verts, t) works). Returns new
    vertices; the argument is not modified. `time` is a number or a 0-d
    tensor; its phase is computed in f32 either way."""
    v = vertices
    phase = v[:, 0] * freq + v[:, 2] * 0.7 * freq
    if torch.is_tensor(time):
        shift = time.to(torch.float32) * 2.0 * math.pi
    else:   # f32 arithmetic on the host: no copy to the card per frame
        shift = float(np.float32(time) * np.float32(2.0)
                      * np.float32(math.pi))
    dy = amplitude * torch.sin(phase + shift)
    return torch.stack([v[:, 0], v[:, 1] + dy, v[:, 2]], dim=1)


class AnimatedScene:
    """Owns base geometry; produces per-frame Triangles on its device
    (default: the card)."""

    def __init__(self, vertices, faces, deform=wave_deform, device=None):
        dev = resolve(device, like=vertices)
        self.base_vertices = torch.as_tensor(vertices, dtype=torch.float32,
                                             device=dev)
        self.faces = torch.as_tensor(faces, dtype=torch.int64,
                                     device=dev).reshape(-1, 3)
        self.deform = deform

    def frame(self, time: float) -> Triangles:
        return Triangles.from_mesh(self.deform(self.base_vertices, time),
                                   self.faces)


def animate(session, scene: AnimatedScene, times):
    """Run the per-frame rebuild loop; yields (time, grid_total_refs)."""
    for t in times:
        yield t, session.rebuild(scene.frame(t))
