"""Ray sharding over devices (port of hagrid_tpu/parallel/mesh.py).

Ray tracing is embarrassingly parallel across rays, so the design is pure
data parallelism: the grid and its triangles are replicated on every
device of the mesh, the rays are cut into contiguous equal shards, and
each device traces its shard with the same single-device path (same
kernels, nothing shard-specific inside). Each shard's hits stay on its
device; `gather` puts them together where the caller asks, which is the
only cross-device traffic.

A mesh is a tuple of torch devices: the CUDA devices by default, or the
ones given (the tests use CPU "devices", repeated).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..core.types import Hits, Rays

RAYS_AXIS = "rays"


def make_mesh(n_devices: int | None = None, devices=None) -> tuple:
    """The devices rays shard over: every CUDA device (the first
    `n_devices` of them), or `devices`: a list, or one device repeated
    `n_devices` times (make_mesh(8, devices="cpu"))."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh shards over the CUDA devices by default and "
                "torch.cuda.is_available() is false; pass devices='cpu'")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * (n_devices or 1)
    devices = [_indexed(torch.device(d)) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("empty mesh")
    return tuple(devices)


def _indexed(device: torch.device) -> torch.device:
    """"cuda" -> "cuda:<current>", so that a mesh entry equals the device
    of the tensors made on it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def pad_rays(rays: Rays, multiple: int):
    """Pad the ray batch with dead rays (tmax = 0, dir (1, 0, 0)) to a
    multiple; returns (padded_rays, original_count)."""
    n = rays.count
    m = pad_to_multiple(n, multiple)
    if m == n:
        return rays, n
    pad = m - n
    f32 = dict(dtype=torch.float32, device=rays.device)
    zeros = torch.zeros((pad,), **f32)
    return Rays(
        org=torch.cat([rays.org, torch.zeros((pad, 3), **f32)]),
        dir=torch.cat([rays.dir, torch.tensor([[1.0, 0.0, 0.0]], **f32)
                       .expand(pad, 3)]),
        tmin=torch.cat([rays.tmin, zeros]),
        tmax=torch.cat([rays.tmax, zeros])), n


def to_device(obj, device):
    """A copy of a grid (packet, uniform or irregular), Triangles or Rays
    with every tensor on `device` (tensors already there are shared)."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def _device_context(device):
    """Make `device` current for the kernels a trace launches."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_trace(trace_fn, mesh):
    """Wrap `trace_fn(grid, rays) -> Hits` to run ray-sharded over `mesh`.

    The returned callable replicates the grid on every device, cuts the
    rays into len(mesh) contiguous equal shards (the count must divide:
    pad with `pad_rays` first), traces shard i on mesh[i] and returns the
    list of per-shard Hits, each on its device (no implicit gather)."""
    mesh = tuple(_indexed(torch.device(d)) for d in mesh)

    def sharded(grid, rays: Rays) -> list:
        n, k = rays.count, len(mesh)
        if n % k:
            raise ValueError(f"{n} rays do not split over {k} devices; "
                             f"pad with pad_rays(rays, {k}) first")
        s = n // k
        out = []
        for i, dev in enumerate(mesh):
            with _device_context(dev):
                shard = Rays(*(to_device(x[i * s:(i + 1) * s], dev)
                               for x in (rays.org, rays.dir, rays.tmin,
                                         rays.tmax)))
                out.append(trace_fn(to_device(grid, dev), shard))
        return out

    return sharded


def gather(shards, device=None, n: int | None = None) -> Hits:
    """Concatenate per-shard Hits in shard order on `device` (default: the
    first shard's), keeping the first `n` rays (the unpadded count)."""
    device = torch.device(device) if device is not None \
        else shards[0].tri_id.device
    return Hits(*(torch.cat([getattr(h, k).to(device) for h in shards])[:n]
                  for k in ("tri_id", "t", "u", "v")))
