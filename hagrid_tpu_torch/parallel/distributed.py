"""Multi-process ray sharding over torch.distributed (port of
hagrid_tpu/parallel/distributed.py).

Every process holds the whole scene and grid (both are rebuilt per frame
and are small next to device memory), traces its own contiguous shard of
the ray batch on its own device, and the hits come together on the
coordinator (rank 0) by one explicit gather: NCCL between cards, gloo on
the CPU. Nothing here reads the environment of a cluster: the caller
gives the rendezvous (`init_method`, for example "tcp://localhost:29500"
or "file:///tmp/rendezvous"), the world size and the rank.

On a single-process run every function is a no-op or a passthrough, so
the same program runs unchanged on one device or many.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.types import Hits, Rays
from .mesh import make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None) -> None:
    """Join the process group: NCCL when the process has a card (it then
    drives card rank % device_count), gloo on the CPU. A no-op for a
    single process (world_size None or 1) and when the group already
    exists."""
    if world_size is None or world_size <= 1 or dist.is_initialized():
        return
    if init_method is None or rank is None:
        raise ValueError("a multi-process run needs init_method and rank")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def _local_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(devices=None) -> tuple:
    """The devices this process traces on: its own device in a
    multi-process run, else make_mesh(devices=devices) (every card)."""
    if process_count() > 1:
        return (_local_device(),)
    return make_mesh(devices=devices)


def local_rays(rays: Rays) -> Rays:
    """This process's contiguous shard of a batch whose count divides by
    the process count (pad with mesh.pad_rays first)."""
    k, r = process_count(), process_index()
    if rays.count % k:
        raise ValueError(f"{rays.count} rays do not split over {k} "
                         f"processes; pad with pad_rays first")
    s = rays.count // k
    return Rays(*(x[r * s:(r + 1) * s] for x in (rays.org, rays.dir,
                                                   rays.tmin, rays.tmax)))


def gather_hits(hits: Hits, n: int | None = None) -> Hits | None:
    """Gather every process's shard of hits (equal sizes, rank order) to
    the coordinator, keeping the first `n` rays; other ranks get None.
    A single process gets its hits back."""
    if process_count() == 1:
        return Hits(*(getattr(hits, k)[:n] for k in ("tri_id", "t", "u",
                                                      "v")))
    dev = _local_device()
    root = is_coordinator()
    out = []
    for k in ("tri_id", "t", "u", "v"):
        x = getattr(hits, k).to(dev).contiguous()
        parts = [torch.empty_like(x) for _ in range(process_count())] \
            if root else None
        dist.gather(x, parts, dst=0)
        if root:
            out.append(torch.cat(parts)[:n])
    return Hits(*out) if root else None
