"""PyTorch port, ray sharding: pad_rays against the JAX package's,
shard_trace over CPU shards against one trace (hits equal exactly), the
single-process no-ops of parallel/distributed.py, and a two-process gloo
run whose gathered hits equal one trace.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.parallel import mesh as j_mesh
from hagrid_tpu_torch import scenes
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.core.types import Hits, Rays, Triangles
from hagrid_tpu_torch.grid.irregular import build_irregular, \
    trace_irregular_fast
from hagrid_tpu_torch.grid.packet import build_packet
from hagrid_tpu_torch.ops.sweep_trace import trace_sweep
from hagrid_tpu_torch.parallel import distributed, mesh
from hagrid_tpu_torch.utils.config import BuildParams

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = BuildParams(top_density=0.3, snd_density=2.0, levels=2,
                    merge_passes=1, expansion_passes=1)
PROC_TIMEOUT = 120


def _hits_equal(a: Hits, b: Hits):
    for k in ("tri_id", "t", "u", "v"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_pad_rays_dead_padding_equals_reference():
    rng = np.random.default_rng(0)
    org = rng.normal(size=(37, 3)).astype(np.float32)
    d = rng.normal(size=(37, 3)).astype(np.float32)
    tmax = rng.uniform(1, 9, 37).astype(np.float32)
    rays = Rays.make(org, d, tmax=tmax, device="cpu")
    got, n = mesh.pad_rays(rays, 16)
    want, jn = j_mesh.pad_rays(JRays.make(jnp.asarray(org), jnp.asarray(d),
                                          tmax=jnp.asarray(tmax)), 16)
    assert n == jn == 37 and got.count == 48
    for k in ("org", "dir", "tmin", "tmax"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    assert (got.tmax[37:] == 0).all() and (got.dir[37:, 0] == 1).all()
    same, n2 = mesh.pad_rays(got, 16)
    assert same is got and n2 == 48
    assert mesh.pad_to_multiple(37, 16) == 48


@pytest.fixture(scope="module")
def cornell():
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device="cpu")
    rays = primary_rays(scenes.cornell_camera(), 48, 40, device="cpu")
    c = dict(
        packet=(build_packet(tris, dims=(6, 6, 6)), _packet_trace),
        irregular=(build_irregular(tris, SMALL), trace_irregular_fast),
        rays=rays)
    c["want"] = {k: c[k][1](c[k][0], rays) for k in ("packet", "irregular")}
    return c


def _packet_trace(g, r):
    return trace_sweep(g, r, coherent=True, tile=128, bmax=512)


@pytest.mark.parametrize("structure", ["packet", "irregular"])
@pytest.mark.parametrize("k", [2, 8])
def test_shard_trace_equals_one_trace(cornell, structure, k):
    """1920 primaries padded to whole 128-ray tiles per shard, traced over
    k CPU shards: the per-shard hits stay separate (no implicit gather),
    each on its mesh device, and gathered they equal one trace of the
    unpadded rays."""
    grid, fn = cornell[structure]
    rays = cornell["rays"]
    want = cornell["want"][structure]
    padded, n = mesh.pad_rays(rays, k * 128)
    m = mesh.make_mesh(k, devices="cpu")
    assert len(m) == k
    shards = mesh.shard_trace(fn, m)(grid, padded)
    assert isinstance(shards, list) and len(shards) == k
    for dev, h in zip(m, shards):
        assert h.tri_id.device == dev and h.tri_id.numel() == padded.count // k
    _hits_equal(mesh.gather(shards, n=n), want)
    with pytest.raises(ValueError):
        mesh.shard_trace(fn, m)(grid, rays.take(torch.arange(k * 64 + 1)))


def test_to_device_replicates_every_grid(cornell):
    for structure in ("packet", "irregular"):
        grid = cornell[structure][0]
        copy = mesh.to_device(grid, "cpu")
        assert type(copy) is type(grid)
        for f in grid.__dataclass_fields__:
            a, b = getattr(grid, f), getattr(copy, f)
            if torch.is_tensor(a):
                assert torch.equal(a, b)


def test_distributed_single_process_is_a_no_op(cornell):
    distributed.initialize(world_size=1)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0 and distributed.is_coordinator()
    assert distributed.global_mesh(devices="cpu") == (torch.device("cpu"),)
    rays = cornell["rays"]
    assert distributed.local_rays(rays).count == rays.count
    hits = cornell["want"]["packet"]
    _hits_equal(distributed.gather_hits(hits), hits)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    from hagrid_tpu_torch import scenes
    from hagrid_tpu_torch.core.camera import primary_rays
    from hagrid_tpu_torch.core.types import Triangles
    from hagrid_tpu_torch.grid.packet import build_packet
    from hagrid_tpu_torch.ops.sweep_trace import trace_sweep
    from hagrid_tpu_torch.parallel import distributed, mesh

    init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    distributed.initialize(init, world_size=2, rank=rank)
    assert distributed.process_count() == 2
    v, f = scenes.cornell_box()
    grid = build_packet(Triangles.from_mesh(v, f, device="cpu"),
                        dims=(6, 6, 6))
    rays = primary_rays(scenes.cornell_camera(), 48, 40, device="cpu")
    padded, n = mesh.pad_rays(rays, 2 * 128)
    mine = distributed.local_rays(padded)
    hits = trace_sweep(grid, mine, coherent=True, tile=128, bmax=512)
    full = distributed.gather_hits(hits, n=n)
    if distributed.is_coordinator():
        np.savez(out, **{k: getattr(full, k).numpy()
                         for k in ("tri_id", "t", "u", "v")})
    else:
        assert full is None
    # Leave together and tear the group down before exit: a rank whose
    # peer has gone can abort in gloo's threads at interpreter shutdown.
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    """)


def test_two_process_gloo_gather_equals_one_trace(cornell, tmp_path):
    """Two processes (gloo, a file:// rendezvous in tmp_path) each trace
    their half of the rays; rank 0's gathered hits equal one trace. Each
    process has its own time limit: a hang fails the test."""
    init = f"file://{tmp_path / 'rendezvous'}"
    out = str(tmp_path / "hits.npz")
    # No card for the workers: initialize picks gloo on the CPU.
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, init, str(r),
                               out], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=PROC_TIMEOUT)
            logs.append(stdout + stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    want = cornell["want"]["packet"]
    got = np.load(out)
    for k in ("tri_id", "t", "u", "v"):
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy())
