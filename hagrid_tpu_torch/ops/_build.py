"""Build and load the package's CUDA kernels (csrc/*.cu).

nvcc compiles every source into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in hagrid_tpu_torch/build/<hash>/, keyed by a
hash of the sources and flags, at first use; later loads reuse it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# -fmad=false: no FMA contraction, so the kernel rounds exactly like its
# plain torch version (each op rounded on its own).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None
# What the last build did: {"seconds", "path", "log"} (log = nvcc's
# output, including ptxas's register and shared-memory report).
last_build: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils import cpp_extension
        home = cpp_extension.CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels cannot be built")
    return found


def library_path() -> pathlib.Path:
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libhagrid_kernels.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        last_build.update(seconds=0.0, path=str(out), log="(cached)")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    sources = [str(s) for s in sorted(SRC_DIR.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    last_build.update(seconds=secs, path=str(out), log=log)
    return out


def load():
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hagrid_sweep.argtypes = [p, i, p, p, p, p, p, p, p, p, p, i, i,
                                     i, p, p]
        lib.hagrid_sweep.restype = i
        lib.hagrid_error_string.argtypes = [i]
        lib.hagrid_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
