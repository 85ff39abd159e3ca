"""Build and load the package's CUDA kernels (csrc/*.cu, csrc/*.cuh).

nvcc compiles every source to an object, all sources at once (one nvcc
process each), and links the objects into one shared library with a plain
C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in hagrid_tpu_torch/build/<hash>/, keyed by a
hash of the sources, the headers and the flags, at first use; later loads
reuse it.
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
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def _sources() -> list:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libhagrid_kernels.so"


def _fail(cmd, returncode, log):
    raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{log}")


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        if last_build.get("path") != str(out):   # keep this process's log
            last_build.update(seconds=0.0, path=str(out), log="(cached)")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = [], None
        for cmd, _, proc in jobs:      # wait for all before raising
            log = "".join(proc.communicate())
            logs.append(log)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, log)
        if failed:
            _fail(*failed)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            _fail(cmd, proc.returncode, logs[-1])
        os.replace(lib, out)
    last_build.update(seconds=time.perf_counter() - t0, path=str(out),
                      log="".join(logs))
    return out


def load():
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hagrid_sweep.argtypes = [p, i, p, p, p, i, p, p, p, p, p, i, i,
                                     i, i, i, p, p, p, p]
        lib.hagrid_sweep.restype = i
        lib.hagrid_sweep_plan.argtypes = [p, i, i, i, i, p, p]
        lib.hagrid_sweep_plan.restype = i
        lib.hagrid_det_sweep.argtypes = [p, i, p, p, p, i, p, p, p, p, p, i,
                                         i, p, p]
        lib.hagrid_det_sweep.restype = i
        lib.hagrid_dots_fp32.argtypes = [p, p, p, p, i, i, p]
        lib.hagrid_dots_fp32.restype = i
        lib.hagrid_dots_bf16.argtypes = [p, p, p, p, i, i, p]
        lib.hagrid_dots_bf16.restype = i
        lib.hagrid_wavefront_march.argtypes = [p, i, i, p, p]
        lib.hagrid_wavefront_march.restype = i
        lib.hagrid_sweep_occupancy.argtypes = [i, i, p]
        lib.hagrid_sweep_occupancy.restype = i
        q = ctypes.c_longlong
        lib.hagrid_scatter_add_drop.argtypes = [p, i, q, p, i, q, q, q, i, p,
                                                i, p]
        lib.hagrid_scatter_add_drop.restype = i
        lib.hagrid_running_scan_workspace.argtypes = [q, i]
        lib.hagrid_running_scan_workspace.restype = q
        lib.hagrid_running_scan.argtypes = [p, p, q, i, i, p, q, p]
        lib.hagrid_running_scan.restype = i
        lib.hagrid_error_string.argtypes = [i]
        lib.hagrid_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def raise_on(lib, err: int, what: str):
    """Raise when a kernel's C entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.hagrid_error_string(err).decode()}")
