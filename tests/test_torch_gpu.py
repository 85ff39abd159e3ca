"""PyTorch port on the card: the CUDA sweep kernel (closest hit and any
hit) against its plain version, and traced waves against the oracle, all
on an NVIDIA GPU.

These tests skip without a GPU (the CUDA kernel has no CPU mode). The
module imports no JAX, so it also runs on a machine without it; there,
skip the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from hagrid_tpu_torch import oracle, scenes
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.grid.packet import build_packet, rays_to_x
from hagrid_tpu_torch.ops.sweep_kernel import (launches, sweep_blocks,
                                               sweep_blocks_plain)
from hagrid_tpu_torch.ops.sweep_trace import _BIG_BITS
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.sampling import (cosine_hemisphere,
                                              hit_points_normals)
from hagrid_tpu_torch.render.session import RenderSession


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _stream(grid, device, nt=6, tile=512, seed=0, any_hit=False):
    """Random rays through the scene box, 0-3 blocks per tile, unused
    blocks at the end, never-skip and random early-out thresholds; for
    any hit, finite tmax on half the rays and the any-hit threshold."""
    rng = np.random.default_rng(seed)
    n = (nt + 1) * tile
    lo, hi = grid.bbox_lo.cpu().numpy(), grid.bbox_hi.cpu().numpy()
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)
    if any_hit:
        tmax[rng.random(n) < 0.5] = 200.0
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    xt = rays_to_x(t(org), t(d), t(np.zeros(n, np.float32)),
                   t(tmax)).t().contiguous()
    seed_t = np.where(rng.random(n) < 0.2, -3e38, 3e38).astype(np.float32)
    seed_t[nt * tile:] = -3e38
    xt[14] = t(seed_t)
    tile_of = np.concatenate([np.repeat(np.arange(nt), [2, 0, 3, 1, 1, 2]),
                              [nt] * 5]).astype(np.int32)
    nb = tile_of.size
    gidx = rng.integers(0, grid.cols.shape[0] // 4, nb * 32)
    thr = rng.uniform(0, 800, nb).astype(np.float32).view(np.int32)
    tminb = np.where(rng.random(nb) < 0.6, 0, thr)
    if any_hit:
        tminb[:] = _BIG_BITS - 1
    return (xt, grid.cols, t(gidx.astype(np.int32)), t(tile_of),
            t(tminb.astype(np.int32)), tile)


@pytest.mark.gpu
def test_sweep_kernel_matches_plain_on_card(cuda):
    v, f = scenes.cornell_box()
    grid = build_packet(Triangles.from_mesh(v, f, device=cuda),
                        dims=(6, 6, 6))
    args = _stream(grid, cuda)
    before = launches["sweep_blocks"]
    got = sweep_blocks(*args)
    torch.cuda.synchronize()
    assert launches["sweep_blocks"] == before + 1
    want = sweep_blocks_plain(*args)
    assert int((got[1] >= 0).sum()) > 50
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_session_trace_on_card_matches_oracle(cuda):
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device=cuda)
    s = RenderSession.create(tris, verts=v)
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                        device=cuda)
    before = launches["sweep_blocks"]
    hits = s.trace(rays, coherent=True)
    assert launches["sweep_blocks"] > before
    ref = oracle.closest_hit(rays, tris)
    # tests/test_sweep_trace.py::_check's thresholds.
    both = (hits.tri_id >= 0) & (ref.tri_id >= 0)
    assert ((hits.tri_id >= 0) == (ref.tri_id >= 0)).float().mean() > 0.999
    same = both & (hits.tri_id == ref.tri_id)
    assert same.sum() > 0.995 * both.sum()
    torch.testing.assert_close(hits.t[same], ref.t[same], rtol=1e-3,
                               atol=1e-5)
    assert not s.poll_overflow(recalibrate=False)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [256, 512])
def test_anyhit_kernel_matches_plain_on_card(cuda, tile):
    """K3: hit/miss equal to the plain version; every kernel hit inside
    (tmin, tmax) and no closer than the plain version's closest hit; the
    skip counter counts only blocks of tiles with blocks."""
    v, f = scenes.cornell_box()
    grid = build_packet(Triangles.from_mesh(v, f, device=cuda),
                        dims=(6, 6, 6))
    args = _stream(grid, cuda, tile=tile, seed=1, any_hit=True)
    xt, nt = args[0], args[0].shape[1] // tile - 1
    skipped = torch.zeros(nt, dtype=torch.int32, device=cuda)
    before = launches["sweep_blocks_anyhit"]
    got = sweep_blocks(*args, any_hit=True, skipped=skipped)
    torch.cuda.synchronize()
    assert launches["sweep_blocks_anyhit"] == before + 1
    want = sweep_blocks_plain(*args, any_hit=True)
    hit, want_hit = got[1] >= 0, want[1] >= 0
    assert torch.equal(hit, want_hit) and int(hit.sum()) > 50
    assert (got[0][hit] < xt[13][hit]).all()
    assert (got[0][hit] >= want[0][hit]).all()
    per_tile = torch.bincount(args[3].long(), minlength=nt + 1)[:nt]
    assert (skipped >= 0).all() and (skipped <= per_tile).all()


@pytest.mark.gpu
def test_ao_and_path_on_card(cuda):
    """AO and a path bounce through the session on the card: any-hit
    hit/miss equals the oracle's, closest hits meet _check's thresholds."""
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device=cuda)
    s = RenderSession.create(tris, verts=v)
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                        device=cuda)
    hits = s.trace(rays, coherent=True)
    p, n, found = hit_points_normals(rays, hits, tris.n)
    gen = torch.Generator(device=cuda).manual_seed(0)
    wave = integrators.ao_rays(p, n, found, 100.0, gen)
    before = launches["sweep_blocks_anyhit"]
    occ = integrators.trace_sorted(s, wave, any_hit=True, cal_key="ao")
    assert launches["sweep_blocks_anyhit"] > before
    assert torch.equal(occ.tri_id >= 0, oracle.any_hit(wave, tris))
    bounce = integrators._spawn(p, n, cosine_hemisphere(n, gen),
                                0.0, torch.where(found, float("inf"), 0.0))
    got = integrators.trace_sorted(s, bounce, cal_key="path")
    ref = oracle.closest_hit(bounce, tris)
    both = (got.tri_id >= 0) & (ref.tri_id >= 0)
    assert ((got.tri_id >= 0) == (ref.tri_id >= 0)).float().mean() > 0.999
    same = both & (got.tri_id == ref.tri_id)
    assert same.sum() > 0.995 * both.sum()
    torch.testing.assert_close(got.t[same], ref.t[same], rtol=1e-3,
                               atol=1e-5)
    img = integrators.path_trace(s, scenes.cornell_camera(), 32, 32,
                                 max_bounces=3)
    assert img.shape == (32, 32, 3) and 0 < float(img.mean()) <= 1
    assert not s.poll_overflow(recalibrate=False)
