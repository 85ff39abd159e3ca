"""ctypes bridge to the native OBJ parser (objloader.cpp).

g++ builds the parser at first use into hagrid_tpu_torch/build/<hash>/,
keyed by a hash of the source and the flags, as ops/_build.py keys the
CUDA kernels; later loads reuse the library. A failed build raises with
the compiler's output: there is no silent fallback to the Python parser.
"""

from __future__ import annotations

import ctypes
import errno
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

from ..ops._build import BUILD_DIR

SRC = pathlib.Path(__file__).resolve().parent / "objloader.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libobjloader.so"


def build() -> pathlib.Path:
    """Compile objloader.cpp unless the library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = ["g++", *CXX_FLAGS, "-o", lib, str(SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: the native OBJ parser "
                               f"cannot be built ({e})") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out


def load_library():
    """The parser's shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, lp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)
            lib.obj_load.restype = p
            lib.obj_load.argtypes = [ctypes.c_char_p, lp, lp]
            lib.obj_copy.restype = None
            lib.obj_copy.argtypes = [p, p, p]
            lib.obj_free.restype = None
            lib.obj_free.argtypes = [p]
            _lib = lib
        return _lib


def load(path: str):
    """Parse `path` -> (verts f32[V,3], faces i32[T,3]); raises when the
    file cannot be read (FileNotFoundError when it does not exist, as
    the reference's open() does)."""
    if not os.path.exists(path):
        raise FileNotFoundError(errno.ENOENT, os.strerror(errno.ENOENT), path)
    lib = load_library()
    nv, nf = ctypes.c_long(), ctypes.c_long()
    handle = lib.obj_load(os.fsencode(path), ctypes.byref(nv),
                          ctypes.byref(nf))
    if not handle:
        raise OSError(f"cannot read OBJ file {path!r}")
    try:
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        lib.obj_copy(handle, verts.ctypes.data_as(ctypes.c_void_p),
                     faces.ctypes.data_as(ctypes.c_void_p))
        return verts, faces
    finally:
        lib.obj_free(handle)
