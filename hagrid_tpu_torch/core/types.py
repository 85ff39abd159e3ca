"""Core SoA data types (port of hagrid_tpu/core/types.py).

Plain dataclasses of tensors: every field is a dense ``(N, ...)`` tensor on
one device, so the same objects feed the torch planner and the CUDA sweep
kernel without conversion.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve

INVALID_ID = -1


def _f32(x, device=None) -> torch.Tensor:
    """x as f32 on `device`; with none, a tensor keeps its device and
    anything else goes to the card."""
    return torch.as_tensor(x, dtype=torch.float32,
                           device=resolve(device, like=x))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product of (N, 3) tensors."""
    return torch.linalg.cross(a, b, dim=-1)


@dataclasses.dataclass
class Rays:
    """org/dir: f32[N, 3]; tmin/tmax: f32[N]."""

    org: torch.Tensor
    dir: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor

    @property
    def count(self) -> int:
        return self.org.shape[0]

    @property
    def device(self) -> torch.device:
        return self.org.device

    @staticmethod
    def make(org, dir, tmin=None, tmax=None, device=None) -> "Rays":
        org = _f32(org, device)
        dir = _f32(dir, org.device)
        n = org.shape[0]
        if tmin is None:
            tmin = torch.zeros((n,), dtype=torch.float32, device=org.device)
        if tmax is None:
            tmax = torch.full((n,), float("inf"), dtype=torch.float32,
                              device=org.device)
        return Rays(org=org, dir=dir, tmin=_f32(tmin, org.device),
                    tmax=_f32(tmax, org.device))

    def take(self, idx: torch.Tensor) -> "Rays":
        """Subset of rays by index (e.g. a sample of a frame)."""
        return Rays(self.org[idx], self.dir[idx], self.tmin[idx],
                    self.tmax[idx])


@dataclasses.dataclass
class Hits:
    """Closest-hit records, SoA. tri_id == -1 means miss."""

    tri_id: torch.Tensor  # i32[N]
    t: torch.Tensor       # f32[N]
    u: torch.Tensor       # f32[N]
    v: torch.Tensor       # f32[N]

    @staticmethod
    def none(n: int, device=None) -> "Hits":
        return Hits(
            tri_id=torch.full((n,), INVALID_ID, dtype=torch.int32,
                              device=device),
            t=torch.full((n,), float("inf"), dtype=torch.float32,
                         device=device),
            u=torch.zeros((n,), dtype=torch.float32, device=device),
            v=torch.zeros((n,), dtype=torch.float32, device=device),
        )


@dataclasses.dataclass
class Triangles:
    """Triangle soup, SoA: v0 f32[T,3], e1 = v1 - v0, e2 = v2 - v0,
    n = cross(e1, e2) (unnormalized geometric normal)."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: torch.Tensor

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    @staticmethod
    def from_vertices(v0, v1, v2, device=None) -> "Triangles":
        v0 = _f32(v0, device)
        e1 = _f32(v1, v0.device) - v0
        e2 = _f32(v2, v0.device) - v0
        return Triangles(v0=v0, e1=e1, e2=e2, n=cross(e1, e2))

    @staticmethod
    def from_mesh(vertices, faces, device=None) -> "Triangles":
        """vertices f32[V,3], faces i32[T,3] -> Triangles on `device`
        (default: the vertices' device if a tensor, else the card)."""
        vertices = _f32(vertices, device)
        faces = torch.as_tensor(faces, dtype=torch.int64,
                                device=vertices.device).reshape(-1, 3)
        tri = vertices[faces]  # [T,3,3]
        return Triangles.from_vertices(tri[:, 0], tri[:, 1], tri[:, 2])

    def bounds(self):
        """Per-triangle AABBs: (lo f32[T,3], hi f32[T,3])."""
        v1 = self.v0 + self.e1
        v2 = self.v0 + self.e2
        lo = torch.minimum(torch.minimum(self.v0, v1), v2)
        hi = torch.maximum(torch.maximum(self.v0, v1), v2)
        return lo, hi


@dataclasses.dataclass
class AABB:
    """Axis-aligned bounding box; lo/hi are f32[3] (or batched f32[...,3])."""

    lo: torch.Tensor
    hi: torch.Tensor

    @staticmethod
    def of_points(pts, device=None) -> "AABB":
        pts = _f32(pts, device)
        return AABB(lo=pts.min(dim=0).values, hi=pts.max(dim=0).values)

    @staticmethod
    def of_triangles(tris: Triangles) -> "AABB":
        lo, hi = tris.bounds()
        return AABB(lo=lo.min(dim=0).values, hi=hi.max(dim=0).values)

    def extents(self) -> torch.Tensor:
        return self.hi - self.lo

    def half_area(self) -> torch.Tensor:
        """SAH surface-area metric: the box's half surface area."""
        e = self.extents()
        return e[..., 0] * (e[..., 1] + e[..., 2]) + e[..., 1] * e[..., 2]

    def pad(self, eps: float = 1e-4) -> "AABB":
        """Slightly enlarged box so boundary triangles bin robustly."""
        d = self.extents() * eps + eps
        return AABB(lo=self.lo - d, hi=self.hi + d)
