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
from .grid.irregular import IrregularGrid
from .grid.packet import PacketGrid
from .grid.uniform import UniformGrid
from .render.dynamic import AnimatedScene


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


def animated_scene_from_numpy(vertices, faces, device=None) -> AnimatedScene:
    """An AnimatedScene (wave deformation) from a mesh's numpy vertices
    and faces."""
    return AnimatedScene(np.array(vertices, np.float32),
                         np.array(faces, np.int64), device=resolve(device))


def packet_grid_from_reference(jg, device=None) -> PacketGrid:
    """The port's PacketGrid from the JAX package's (any object with its
    fields; each is read through np.asarray)."""
    t = jg.tris
    return packet_grid_from_numpy(
        jg.dims3, jg.bbox_lo, jg.bbox_hi, jg.rs, jg.rowinfo, jg.cols,
        jg.planes, jg.total_refs, jg.total_pairs, t.v0, t.e1, t.e2, t.n,
        device=device)


def _tris_from_reference(t, device) -> Triangles:
    return triangles_from_numpy(t.v0, t.e1, t.e2, t.n, device)


def uniform_grid_from_reference(jg, device=None) -> UniformGrid:
    """The port's UniformGrid from the JAX package's."""
    i = torch.int32
    return UniformGrid(
        dims=tuple(int(d) for d in jg.dims),
        bbox_lo=_t(jg.bbox_lo, torch.float32, device),
        bbox_hi=_t(jg.bbox_hi, torch.float32, device),
        cell_starts=_t(jg.cell_starts, i, device),
        ref_ids=_t(jg.ref_ids, i, device),
        total_refs=_t(jg.total_refs, i, device),
        tris=_tris_from_reference(jg.tris, device))


_IRREGULAR_INT = ("top_res_log", "top_offset", "entries", "cell_min",
                  "cell_max", "cell_starts", "ref_ids", "num_entries",
                  "total_refs", "top_info", "erec")


def irregular_grid_from_reference(jg, device=None) -> IrregularGrid:
    """The port's IrregularGrid from the JAX package's."""
    f, b = torch.float32, torch.bool
    return IrregularGrid(
        top_dims=tuple(int(d) for d in jg.top_dims), levels=int(jg.levels),
        bbox_lo=_t(jg.bbox_lo, f, device), bbox_hi=_t(jg.bbox_hi, f, device),
        alive=_t(jg.alive, b, device),
        preexpanded=_t(jg.preexpanded, b, device),
        ref_tris=_t(jg.ref_tris, f, device),
        tris=_tris_from_reference(jg.tris, device),
        **{k: _t(getattr(jg, k), torch.int32, device)
           for k in _IRREGULAR_INT})
