"""Grid serialization (port of hagrid_tpu/io/checkpoint.py): the
reference's npz + JSON format for the packet, irregular and uniform
grids, so a grid saved by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.types import Triangles
from ..device import resolve
from ..grid.irregular import IrregularGrid
from ..grid.packet import PacketGrid
from ..grid.uniform import UniformGrid

_PACKET_FIELDS = ("bbox_lo", "bbox_hi", "rs", "rowinfo", "cols",
                  "total_refs", "total_pairs", "planes")
_IRREGULAR_FIELDS = ("bbox_lo", "bbox_hi", "top_res_log", "top_offset",
                     "entries", "cell_min", "cell_max", "cell_starts",
                     "ref_ids", "alive", "num_entries", "total_refs",
                     "preexpanded", "top_info", "erec", "ref_tris")
_UNIFORM_FIELDS = ("bbox_lo", "bbox_hi", "cell_starts", "ref_ids",
                   "total_refs")
_TRI_FIELDS = ("v0", "e1", "e2", "n")


def save_grid(path: str, grid) -> None:
    if isinstance(grid, PacketGrid):
        meta = {"kind": "packet", "dims3": [list(d) for d in grid.dims3]}
        fields = _PACKET_FIELDS
    elif isinstance(grid, IrregularGrid):
        meta = {"kind": "irregular", "top_dims": list(grid.top_dims),
                "levels": grid.levels}
        fields = _IRREGULAR_FIELDS
    elif isinstance(grid, UniformGrid):
        meta = {"kind": "uniform", "dims": list(grid.dims)}
        fields = _UNIFORM_FIELDS
    else:
        raise TypeError(f"not a grid of the port: {type(grid)}")
    arrays = {name: getattr(grid, name).detach().cpu().numpy()
              for name in fields}
    for name in _TRI_FIELDS:
        arrays["tri_" + name] = getattr(grid.tris, name).detach().cpu().numpy()
    # Meta is JSON, never repr/eval: loading a checkpoint must not be able
    # to execute code from the file.
    np.savez_compressed(path, __meta__=np.asarray([json.dumps(meta)]),
                        **arrays)


def load_grid(path: str, device=None):
    """The saved grid on `device` (default: the card)."""
    dev = resolve(device)
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"][0]))
    tris = Triangles(**{k: torch.as_tensor(z["tri_" + k], device=dev)
                        for k in _TRI_FIELDS})
    kind = meta["kind"]
    fields = {"packet": _PACKET_FIELDS, "irregular": _IRREGULAR_FIELDS,
              "uniform": _UNIFORM_FIELDS}.get(kind)
    if fields is None:
        raise ValueError(f"unknown grid kind {kind!r} in {path}")
    a = {k: torch.as_tensor(z[k], device=dev) for k in fields}
    if kind == "packet":
        return PacketGrid(dims3=tuple(tuple(int(x) for x in d)
                                      for d in meta["dims3"]),
                          tris=tris, **a)
    if kind == "irregular":
        return IrregularGrid(top_dims=tuple(int(d) for d in meta["top_dims"]),
                             levels=int(meta["levels"]), tris=tris, **a)
    return UniformGrid(dims=tuple(int(d) for d in meta["dims"]), tris=tris,
                       **a)
