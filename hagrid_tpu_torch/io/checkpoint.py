"""Packet-grid serialization (port of hagrid_tpu/io/checkpoint.py): the
reference's npz + JSON format, so a grid saved by either package loads in
the other. Only the packet structure is ported.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.types import Triangles
from ..device import resolve
from ..grid.packet import PacketGrid

_PACKET_FIELDS = ("bbox_lo", "bbox_hi", "rs", "rowinfo", "cols",
                  "total_refs", "total_pairs", "planes")
_TRI_FIELDS = ("v0", "e1", "e2", "n")


def save_grid(path: str, grid: PacketGrid) -> None:
    if not isinstance(grid, PacketGrid):
        raise TypeError(f"only packet grids are ported, got {type(grid)}")
    meta = {"kind": "packet", "dims3": [list(d) for d in grid.dims3]}
    arrays = {name: getattr(grid, name).detach().cpu().numpy()
              for name in _PACKET_FIELDS}
    for name in _TRI_FIELDS:
        arrays["tri_" + name] = getattr(grid.tris, name).detach().cpu().numpy()
    # Meta is JSON, never repr/eval: loading a checkpoint must not be able
    # to execute code from the file.
    np.savez_compressed(path, __meta__=np.asarray([json.dumps(meta)]),
                        **arrays)


def load_grid(path: str, device=None) -> PacketGrid:
    """The saved packet grid on `device` (default: the card)."""
    dev = resolve(device)
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"][0]))
    if meta["kind"] != "packet":
        raise ValueError(f"checkpoint holds a {meta['kind']!r} grid; only "
                         f"packet grids are ported")
    tris = Triangles(**{k: torch.as_tensor(z["tri_" + k], device=dev)
                        for k in _TRI_FIELDS})
    fields = {k: torch.as_tensor(z[k], device=dev) for k in _PACKET_FIELDS}
    return PacketGrid(dims3=tuple(tuple(int(x) for x in d)
                                  for d in meta["dims3"]),
                      tris=tris, **fields)
