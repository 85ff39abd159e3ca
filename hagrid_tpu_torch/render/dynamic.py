"""Dynamic geometry: per-frame animated meshes with full grid rebuilds
(port of hagrid_tpu/render/dynamic.py).

The grid is rebuilt every frame for animated scenes. As the reference
jits `wave_deform`, a frame's deformation and its triangles replay as one
captured graph on the card, and the rebuild reuses the session's frame-1
capacity and dims, so steady-state packet frames read nothing back to
the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.types import Triangles
from ..device import resolve
from ..utils.graphs import Graphs


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
        # The frame's time, filled from the host (no copy from host
        # memory), and the frame's capture.
        self._time = torch.zeros((), dtype=torch.float32, device=dev)
        self._graphs = Graphs()

    def frame(self, time: float) -> Triangles:
        """deform(base vertices, time) and Triangles.from_mesh as one
        captured graph on the card (run directly on CPU tensors), keyed on
        the deform and the base vertices' and faces' addresses; the deform
        gets the time as a 0-d f32 tensor. Returns fresh tensors."""
        self._time.fill_(time)
        base, faces, t, deform = (self.base_vertices, self.faces,
                                  self._time, self.deform)

        def body():
            tris = Triangles.from_mesh(deform(base, t), faces)
            return tris.v0, tris.e1, tris.e2, tris.n

        return Triangles(*self._graphs.call("frame", (deform,), body, (),
                                            reads=(base, faces, t)))


def animate(session, scene: AnimatedScene, times):
    """Run the per-frame rebuild loop; yields (time, grid_total_refs)."""
    for t in times:
        yield t, session.rebuild(scene.frame(t))
