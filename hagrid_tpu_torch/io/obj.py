"""Wavefront OBJ loader (port of hagrid_tpu/io/obj.py).

v/f records, fan triangulation of polygons, negative (relative) indices;
vt, vn and materials are ignored. `load_obj` runs the native C++ parser
(native/objloader.cpp, built with g++ at first use); `load_obj_python` is
its plain Python version, which the tests hold it against.
"""

from __future__ import annotations

import numpy as np

from ..native import objloader_native


def load_obj(path: str):
    """Parse an OBJ file -> (vertices f32[V,3], faces i32[T,3])."""
    return objloader_native.load(path)


def load_obj_python(path: str):
    """The Python parser: same arrays as load_obj, far slower on large
    files."""
    verts: list = []
    faces: list = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    # f v, f v/vt, f v//vn, f v/vt/vn: field 0 is the vertex.
                    s = tok.split("/")[0]
                    if not s:
                        continue
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    """Minimal OBJ writer (fixtures and tests): a float32 prints its
    shortest repr, which both parsers read back to the same float32."""
    with open(path, "w") as fh:
        for v in np.asarray(vertices):
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in np.asarray(faces):
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
