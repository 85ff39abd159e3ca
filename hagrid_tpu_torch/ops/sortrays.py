"""Ray coherence sorting (port of hagrid_tpu/ops/sortrays.py).

Secondary rays are sorted by an origin Morton code (optionally behind the
direction octant) before the sweep tracer bins them, and results are
scattered back through the permutation. The sort is stable, so rays with
equal keys keep the caller's order.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import Rays
from .segment import trunc_i32


def _part1by2(x):
    """Spread 10 bits to every 3rd bit (Morton helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3(ix, iy, iz):
    return _part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)


def coherence_keys(rays: Rays, bbox_lo, bbox_hi, bits: int = 7,
                   origin_major: bool = False) -> torch.Tensor:
    """i32 sort key: the origin's `bits`-bit Morton code in the box, behind
    the direction octant (3 bits) unless origin_major. Origin-major (bits
    <= 10) is the reference's choice for hemisphere waves (AO, diffuse
    bounces): the per-tile origin spread is what widens their frusta."""
    scale = (1 << bits) / (bbox_hi - bbox_lo + 1e-20)
    q = trunc_i32((rays.org - bbox_lo) * scale).clamp(0, (1 << bits) - 1)
    m = morton3(q[:, 0], q[:, 1], q[:, 2])
    if origin_major:
        return m
    d = rays.dir
    octant = ((d[:, 0] >= 0).to(torch.int32)
              | ((d[:, 1] >= 0).to(torch.int32) << 1)
              | ((d[:, 2] >= 0).to(torch.int32) << 2))
    return (octant << (3 * bits)) | m


def sort_rays(rays: Rays, bbox_lo, bbox_hi, mask=None, bits: int = 7,
              origin_major: bool = False):
    """(sorted rays, perm): row i of the sorted rays is ray perm[i]. mask:
    optional bool[N]; False rays sort to the back."""
    keys = coherence_keys(rays, bbox_lo, bbox_hi, bits=bits,
                          origin_major=origin_major)
    if mask is not None:
        keys = torch.where(mask, keys, 1 << 30)
    perm = torch.sort(keys, stable=True).indices.to(torch.int32)
    return rays.take(perm.long()), perm


def unsort(values, perm):
    """Scatter results aligned with sorted rays back to the original order
    (row i belongs to ray perm[i]). `values` is a tensor or a dataclass of
    tensors (Hits, Rays)."""
    def one(a):
        out = torch.zeros_like(a)
        out[perm.long()] = a
        return out
    if torch.is_tensor(values):
        return one(values)
    return dataclasses.replace(values, **{
        f.name: one(getattr(values, f.name))
        for f in dataclasses.fields(values)})
