"""Sampling utilities for secondary rays: AO, shadows, path tracing (port
of hagrid_tpu/render/sampling.py).

Random numbers come from an explicit `torch.Generator`. torch cannot
reproduce `jax.random`'s bits, so the draw (`_draw`) is kept apart from
the mapping (`cosine_from_uniforms`): tests feed the reference's own
uniforms to the mapping.
"""

from __future__ import annotations

import math

import torch


def orthonormal_basis(n):
    """Branchless ONB from unit normals n f32[N,3] (Frisvad/Duff et al.)."""
    s = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b,
                     -s * n[:, 0]], dim=-1)
    bt = torch.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=-1)
    return t, bt


def _draw(count: int, generator: torch.Generator, device):
    """Two uniform [0, 1) f32 vectors of `count` values on `device` (the
    generator must live there too)."""
    u = torch.rand((2, count), generator=generator, device=device)
    return u[0], u[1]


def cosine_from_uniforms(u1, u2, n):
    """Cosine-weighted directions about unit normals n f32[N,3] from two
    uniform vectors."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    t, bt = orthonormal_basis(n)
    return x[:, None] * t + y[:, None] * bt + z[:, None] * n


def cosine_hemisphere(n, generator: torch.Generator):
    """Cosine-weighted directions about unit normals n f32[N,3]."""
    u1, u2 = _draw(n.shape[0], generator, n.device)
    return cosine_from_uniforms(u1, u2, n)


def face_forward(n, dirs):
    """Flip normals to face against the incoming ray direction."""
    sign = torch.where((n * dirs).sum(dim=-1, keepdim=True) > 0, -1.0, 1.0)
    return n * sign


def hit_points_normals(rays, hits, tri_n):
    """Surface points and outward unit normals for hit rays.

    tri_n: f32[T,3] unnormalized geometric normals. Misses get point org
    and the normal of tri 0 (callers mask them with `found`)."""
    found = hits.tri_id >= 0
    n = tri_n[hits.tri_id.clamp(min=0).long()]
    n = n / (torch.sqrt((n * n).sum(dim=-1, keepdim=True)) + 1e-20)
    n = face_forward(n, rays.dir)
    t = torch.where(found, hits.t, 0.0)
    p = rays.org + t[:, None] * rays.dir
    return p, n, found
