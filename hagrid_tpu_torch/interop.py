"""State carried across from the JAX package, handed over as numpy arrays.

The functions take numpy arrays (what `np.asarray` gives of the JAX
package's jnp fields) and return the port's objects, so one grid or ray
batch can be fed to both tracers: tracer parity is then held apart from
build parity. Nothing here imports JAX. With no `device`, the objects
land on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import Rays, Triangles
from .device import resolve
from .grid.packet import PacketGrid


def _t(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=resolve(device))


def triangles_from_numpy(v0, e1, e2, n, device=None) -> Triangles:
    f = torch.float32
    return Triangles(v0=_t(v0, f, device), e1=_t(e1, f, device),
                     e2=_t(e2, f, device), n=_t(n, f, device))


def rays_from_numpy(org, dir, tmin, tmax, device=None) -> Rays:
    f = torch.float32
    return Rays(org=_t(org, f, device), dir=_t(dir, f, device),
                tmin=_t(tmin, f, device), tmax=_t(tmax, f, device))


def packet_grid_from_numpy(dims3, bbox_lo, bbox_hi, rs, rowinfo, cols,
                           planes, total_refs, total_pairs, v0, e1, e2, n,
                           device=None) -> PacketGrid:
    f, i = torch.float32, torch.int32
    return PacketGrid(
        dims3=tuple(tuple(int(x) for x in d) for d in dims3),
        bbox_lo=_t(bbox_lo, f, device), bbox_hi=_t(bbox_hi, f, device),
        rs=_t(rs, i, device), cols=_t(cols, f, device),
        total_refs=_t(total_refs, i, device),
        total_pairs=_t(total_pairs, i, device),
        tris=triangles_from_numpy(v0, e1, e2, n, device),
        rowinfo=_t(rowinfo, i, device), planes=_t(planes, f, device))
