"""PyTorch port on the card: the CUDA sweep kernel (closest hit and any
hit) and the sweep-cost micro-kernels against their plain versions,
traced waves (static and deformed scenes) against the oracle, the
irregular and uniform builds and the wavefront against the CPU's, and the
wavefront march kernel against its plain version, all on an NVIDIA GPU.

These tests skip without a GPU (the CUDA kernel has no CPU mode). The
module imports no JAX, so it also runs on a machine without it; there,
skip the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hagrid_tpu_torch import oracle, scenes
from hagrid_tpu_torch.core.camera import block_index, primary_rays
from hagrid_tpu_torch.core.types import Hits, Triangles
from hagrid_tpu_torch.exp import kernel_mt20, mxu_micro
from hagrid_tpu_torch.grid import invariants, irregular, uniform
from hagrid_tpu_torch.grid.packet import build_packet, rays_to_x
from hagrid_tpu_torch.io.image import dhash, hamming, shade_eyelight
from hagrid_tpu_torch.ops import micro_kernels as mk
from hagrid_tpu_torch.ops import sweep_kernel as sk
from hagrid_tpu_torch.ops.sweep_kernel import (launches, sweep_blocks,
                                               sweep_blocks_plain)
from hagrid_tpu_torch.ops.sweep_trace import _BIG_BITS
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.dynamic import AnimatedScene
from hagrid_tpu_torch.render.sampling import (cosine_hemisphere,
                                              hit_points_normals)
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils import profiling
from hagrid_tpu_torch.utils.config import BuildParams


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


def _long_stream(grid, device, tile, any_hit, seed=5, long_run=70):
    """A tile owning `long_run` blocks (cut into several chunks) beside
    tiles of 0-1 blocks, unused blocks at the end; random rays through
    the scene box and random units; never-skip thresholds (any hit: the
    any-hit threshold)."""
    rng = np.random.default_rng(seed)
    nt = 6
    n = (nt + 1) * tile
    lo, hi = grid.bbox_lo.cpu().numpy(), grid.bbox_hi.cpu().numpy()
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)
    if any_hit:
        tmax[rng.random(n) < 0.5] = 3.0
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    xt = rays_to_x(t(org), t(d), t(np.zeros(n, np.float32)),
                   t(tmax)).t().contiguous()
    seed_t = np.where(rng.random(n) < 0.1, -3e38, 3e38).astype(np.float32)
    seed_t[nt * tile:] = -3e38
    xt[14] = t(seed_t)
    tile_of = np.concatenate([np.repeat(np.arange(nt),
                                        [1, long_run, 0, 1, 0, 1]),
                              [nt] * 3]).astype(np.int32)
    nb = tile_of.size
    gidx = rng.integers(0, grid.cols.shape[0] // 4, nb * 32)
    tminb = np.full(nb, _BIG_BITS - 1 if any_hit else 0, np.int32)
    return (xt, grid.cols, t(gidx.astype(np.int32)), t(tile_of),
            t(tminb), tile)


def _cornell_grid(device):
    v, f = scenes.cornell_box()
    return build_packet(Triangles.from_mesh(v, f, device=device),
                        dims=(6, 6, 6))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("tile", [256, 512])
def test_sweep_kernel_long_run_on_card(cuda, tile, any_hit, chunk):
    """One tile of 70 blocks, split over several CTAs, beside tiles of 0-1
    blocks: closest hit equals the plain version bit for bit; any hit
    keeps its rule (hit/miss equal, hits inside (tmin, tmax), none closer
    than the plain version's); no block skipped."""
    args = _long_stream(_cornell_grid(cuda), cuda, tile, any_hit)
    xt, tile_of, nt = args[0], args[3], args[0].shape[1] // tile - 1
    assert 70 > (chunk or sk.chunk_blocks(tile_of.numel()))
    skipped = torch.zeros(nt, dtype=torch.int32, device=cuda)
    key = "sweep_blocks_anyhit" if any_hit else "sweep_blocks"
    before = launches[key]
    got = sk._sweep_cuda(*args, any_hit, skipped, chunk)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    want = sweep_blocks_plain(*args, any_hit=any_hit)
    assert int((want[1] >= 0).sum()) > 50
    assert int(skipped.sum()) == 0
    if not any_hit:
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        return
    hit, want_hit = got[1] >= 0, want[1] >= 0
    assert torch.equal(hit, want_hit)
    assert (got[0][hit] < xt[13][hit]).all()
    assert (got[0][hit] > xt[12][hit]).all()
    assert (got[0][hit] >= want[0][hit]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("seed,nt,max_run,chunk,unused", [
    (0, 40, 90, 16, 3), (1, 4099, 238, 24, 5000), (2, 2048, 8, 16, 3000),
    (3, 1500, 350, 7, 0), (4, 300, 200, 200, 10)])
def test_plan_kernel_matches_plain_on_card(cuda, seed, nt, max_run, chunk,
                                           unused):
    """The plan kernel (one CTA, several rounds of 1024 tiles beyond 1024
    tiles) equals its plain version: table, first rows and chunk
    counts."""
    rng = np.random.default_rng(seed)
    run = rng.integers(0, 4, nt)
    run[rng.random(nt) < 0.4] = 0
    long = rng.choice(nt, max(1, nt // 8), replace=False)
    run[long] = rng.integers(1, max_run + 1, long.size)
    tile_of = torch.as_tensor(np.concatenate([
        np.repeat(np.arange(nt), run), np.full(unused, nt)]).astype(np.int32),
        device=cuda)
    got = sk.chunk_plan(tile_of, nt, chunk)
    want = sk.chunk_plan_plain(tile_of, nt, chunk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _tie_stream(grid, tris, device, tile, ids_in_order):
    """Ray 0 of tile 0 aims at a triangle's centroid; two copies of the
    triangle's coefficient row, with ids ids_in_order[0] and [1], sit in
    blocks 0 and 40 of tile 0's run of 48 blocks (different chunks at
    C = 16); every other slot holds the dead unit, other rays are dead."""
    rows = grid.cols[:, :120].reshape(-1, 20)
    row = rows[rows[:, :16].abs().sum(1) > 0][0].clone()
    tri = int(row[16])
    target = tris.v0[tri] + (tris.e1[tri] + tris.e2[tri]) / 3.0
    n = 2 * tile
    org = torch.zeros((n, 3), device=device)
    org[0] = target + tris.n[tri] * 2.0 + 0.01
    d = torch.zeros((n, 3), device=device)
    d[:, 2] = 1.0
    d[0] = target - org[0]
    d[0] = d[0] / d[0].norm()
    x = rays_to_x(org, d, torch.zeros(n, device=device),
                  torch.full((n,), float("inf"), device=device))
    xt = x.t().contiguous()
    xt[14] = -3e38
    xt[14, 0] = 3e38
    cols = torch.zeros((3 * 4, 128), device=device)   # units 0 (dead), 1, 2
    for u, ident in zip((1, 2), ids_in_order):
        r = row.clone()
        r[16] = float(ident)
        cols[4 * u, :20] = r
    nb = 48
    gidx = torch.zeros(nb * 32, dtype=torch.int32, device=device)
    gidx[0 * 32 + 5] = 1
    gidx[40 * 32 + 17] = 2
    tile_of = torch.zeros(nb, dtype=torch.int32, device=device)
    tminb = torch.zeros(nb, dtype=torch.int32, device=device)
    return xt, cols, gidx, tile_of, tminb, tile


@pytest.mark.gpu
@pytest.mark.parametrize("ids", [(7, 3), (3, 7)])
def test_sweep_kernel_tie_across_chunks_on_card(cuda, ids):
    """Two tris at exactly the same t for one ray, in different chunks of
    one tile: the smaller id wins, as in the plain version, whichever
    chunk holds it."""
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device=cuda)
    args = _tie_stream(build_packet(tris, dims=(6, 6, 6)), tris, cuda, 256,
                       ids)
    assert sk.chunk_blocks(args[3].numel()) < 40
    got = sweep_blocks(*args)
    torch.cuda.synchronize()
    want = sweep_blocks_plain(*args)
    assert int(want[1][0]) == 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_kernel_all_skipped_on_card(cuda, any_hit):
    """Every block skipped (closest hit: thresholds above every bit
    pattern; any hit: every ray dead): no hits, and each tile's skip count
    is its whole run, split tile included."""
    args = list(_long_stream(_cornell_grid(cuda), cuda, 256, any_hit))
    xt, tile_of = args[0].clone(), args[3]
    nt = xt.shape[1] // 256 - 1
    if any_hit:
        xt[14] = -3e38
    else:
        args[4] = torch.full_like(args[4], 2**31 - 2)
    args[0] = xt
    skipped = torch.zeros(nt, dtype=torch.int32, device=cuda)
    got = sweep_blocks(*args, any_hit=any_hit, skipped=skipped)
    torch.cuda.synchronize()
    assert not bool((got[1] >= 0).any())
    assert bool((got[0] == 3e38).all())
    per_tile = torch.bincount(tile_of.long(), minlength=nt + 1)[:nt]
    assert torch.equal(skipped, per_tile.to(torch.int32))


@pytest.mark.gpu
def test_sweep_kernel_skip_counts_per_tile_on_card(cuda):
    """Closest hit on the long-run stream with random thresholds: each
    tile's skip count, added by several CTAs for the split tile, lies
    within its run."""
    args = list(_long_stream(_cornell_grid(cuda), cuda, 512, False))
    rng = np.random.default_rng(9)
    nb = args[3].numel()
    thr = rng.uniform(0, 2, nb).astype(np.float32).view(np.int32)
    args[4] = torch.as_tensor(thr, device=cuda)
    nt = args[0].shape[1] // 512 - 1
    skipped = torch.zeros(nt, dtype=torch.int32, device=cuda)
    sweep_blocks(*args, skipped=skipped)
    torch.cuda.synchronize()
    per_tile = torch.bincount(args[3].long(), minlength=nt + 1)[:nt]
    assert (skipped >= 0).all() and (skipped <= per_tile).all()


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


@pytest.mark.gpu
def test_path_bounces_on_card_match_cpu(cuda, monkeypatch):
    """path_bounces from the primaries' hits at 64x64, 4 waves, on the
    card and on the CPU from the same uniforms: the primary hits and
    the radiance agree on >= 99.5% of pixels (a wave's spawn may round
    differently on the card), and no wave overflows its budget."""
    from hagrid_tpu_torch.render import sampling
    v, f = scenes.cornell_box()
    n, waves = 64 * 64, 4
    gen = torch.Generator().manual_seed(2**31 + 9)
    draws = [torch.rand((2, n), generator=gen) for _ in range(waves)]
    out = []
    for dev in (torch.device("cpu"), cuda):
        s = RenderSession.create(Triangles.from_mesh(v, f, device=dev),
                                 verts=v)
        rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                            device=dev)
        hits = s.trace(rays, coherent=True)
        it = iter(draws)
        monkeypatch.setattr(sampling, "_draw",
                            lambda count, g, d: tuple(next(it).to(d)))
        rad = integrators.path_bounces(s, rays, hits,
                                       torch.Generator(device=dev),
                                       max_bounces=waves)
        assert not s.poll_overflow(recalibrate=False)
        out.append((hits.tri_id.cpu(), rad.cpu()))
    (cpu_id, cpu_rad), (card_id, card_rad) = out
    assert (cpu_id == card_id).float().mean() >= 0.995
    assert (cpu_rad == card_rad).float().mean() >= 0.995
    assert card_rad.max() > 0


@pytest.mark.gpu
def test_det_sweep_matches_plain_on_card(cuda):
    """K4 equals its plain version bit for bit (no FMA contraction), with
    every block swept, every block skipped and mixed thresholds."""
    xt, cols, gidx, tile_of, live, dead = kernel_mt20.synthetic_stream(
        tile=512, nt=6, blocks_per_tile=3, seed=2, device=cuda)
    mixed = torch.where(torch.arange(live.numel(), device=cuda) % 3 == 1,
                        torch.zeros_like(live), live)  # done once min <= +0
    for thr in (live, dead, mixed):
        before = mk.launches["det_sweep"]
        got = mk.det_sweep(xt, cols, gidx, tile_of, thr, 512)
        torch.cuda.synchronize()
        assert mk.launches["det_sweep"] == before + 1
        want = mk.det_sweep_plain(xt, cols, gidx, tile_of, thr, 512)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert torch.equal(mk.det_sweep(xt, cols, gidx, tile_of, dead, 512)[0]
                       [:6 * 512], xt[14, :6 * 512])


@pytest.mark.gpu
def test_dots_fp32_matches_plain_on_card(cuda):
    """K5 equals its plain version bit for bit: the last block's sums and
    every block's column sums. The FMA instance rounds once per
    multiply-add: within 1e-5 of the largest output and within the
    element bound of its rounding chains, not equal."""
    xt, g, _, _ = mxu_micro.inputs(blocks=3, seed=3, device=cuda)
    out, csum = _dots_fp32_on_card(xt, g, False)
    want, want_cs = mk.dots_fp32_plain(xt, g)
    assert torch.equal(out, want) and torch.equal(csum, want_cs)
    out_f, csum_f = _dots_fp32_on_card(xt, g, True)
    assert (out_f - want).abs().max() <= 1e-5 * want.abs().max()
    assert (csum_f - want_cs).abs().max() <= 1e-5 * want_cs.abs().max()
    r_out, r_cs = mk.bound_ratio((out_f, csum_f), mk.dots_fp32_exact(xt, g))
    assert r_out <= 1 and r_cs <= 1
    assert not torch.equal(out_f, want)


def _dots_fp32_on_card(xt, g, fma):
    """K5 through the wrapper; checks that exactly one launch counted."""
    key = "dots_fp32_fma" if fma else "dots_fp32"
    before = mk.launches[key]
    got = mk.dots_fp32(xt, g, fma=fma)
    torch.cuda.synchronize()
    assert mk.launches[key] == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("fma", [False, True])
@pytest.mark.parametrize("blocks", [1, 131, 133, 2049])
def test_dots_fp32_persistent_schedule_on_card(cuda, blocks, fma):
    """The persistent grid (one CTA per SM, 132 on an H100 SXM) at one
    block, fewer blocks than CTAs, one more than a round, and more than
    15 rounds: the plain instance equals its plain version bit for bit,
    the FMA instance lies within the element bound."""
    xt, g, _, _ = mxu_micro.inputs(blocks=blocks, seed=40 + blocks,
                                   device=cuda)
    got = _dots_fp32_on_card(xt, g, fma)
    if fma:
        r_out, r_cs = mk.bound_ratio(got, mk.dots_fp32_exact(xt, g))
        assert r_out <= 1 and r_cs <= 1
    else:
        for a, b in zip(got, mk.dots_fp32_plain(xt, g)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("fma", [False, True])
@pytest.mark.parametrize("where", ["last", "middle"])
def test_dots_fp32_one_hot_on_card(cuda, where, fma):
    """133 blocks, all zero but one, whose row r has a 1 at coefficient
    r % 16 of ref slot r % 6: row r of that block's sums is one term of
    the ray's linear forms (d_i - o_i, m_i, d_i or 1), exact in both
    instances. out comes from block B - 1 only: it holds those rows when
    the one-hot block is the last and zeros when it is another; csum is
    zero on every other block."""
    blocks = 133
    xt, _, _, _ = mxu_micro.inputs(blocks=1, seed=50, device=cuda)
    g = torch.zeros((blocks * mk.BLOCK_ROWS, 128), device=cuda)
    hot = blocks - 1 if where == "last" else 70
    rows = torch.arange(mk.BLOCK_ROWS, device=cuda)
    g[hot * mk.BLOCK_ROWS + rows, 20 * (rows % 6) + rows % 16] = 1.0
    out, csum = _dots_fp32_on_card(xt, g, fma)
    o, d, m = xt[1:4], xt[4:7], xt[7:10]
    per_coef = torch.cat([d - o, m, d, m, d, torch.ones_like(xt[:1])])
    want = per_coef[rows % 16]
    assert torch.equal(out, want if where == "last" else
                       torch.zeros_like(want))
    want_cs = mk.dots_fp32_plain(xt, g)[1]
    assert torch.equal(csum, want_cs)
    assert bool((want_cs[hot] != 0).any())
    others = torch.arange(blocks, device=cuda) != hot
    assert bool((csum[others] == 0).all())


@pytest.mark.gpu
def test_dots_fp32_library_on_card(cuda):
    """The library product (torch.mm in FP32) lies within its element
    bound and leaves the TF32 setting as it found it."""
    xt, g, _, _ = mxu_micro.inputs(blocks=67, seed=5, device=cuda)
    before = torch.backends.cuda.matmul.allow_tf32
    sums = mk.dots_fp32_library(xt, g)()
    torch.cuda.synchronize()
    assert torch.backends.cuda.matmul.allow_tf32 == before
    r_out, r_cs = mk.bound_ratio((sums[-1], sums.sum(1)),
                                 mk.dots_fp32_exact(xt, g),
                                 mk.LIBRARY_CHAINS)
    assert r_out <= 1 and r_cs <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True])
def test_dots_bf16_matches_plain_on_card(cuda, split):
    """K6 / K7 within 1e-4 of the largest output of their plain versions
    (the tensor cores accumulate in another order than a matmul followed
    by adds)."""
    _, _, phi, c = mxu_micro.inputs(blocks=3, seed=4, device=cuda)
    key = "dots_bf16x3" if split else "dots_bf16"
    before = mk.launches[key]
    out, csum = mk.dots_bf16(phi, c, split=split)
    torch.cuda.synchronize()
    assert mk.launches[key] == before + 1
    want, want_cs = mk.dots_bf16_plain(phi, c, split=split)
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()
    assert (csum - want_cs).abs().max() <= 1e-4 * want_cs.abs().max()


def _dots_bf16_on_card(phi, c, split):
    """K6 / K7 through the wrapper; checks that exactly one launch
    counted."""
    key = "dots_bf16x3" if split else "dots_bf16"
    before = mk.launches[key]
    got = mk.dots_bf16(phi, c, split=split)
    torch.cuda.synchronize()
    assert mk.launches[key] == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("blocks", [1, 2, 65, 66, 67, 133])
def test_dots_bf16_persistent_schedule_on_card(cuda, blocks, split):
    """The persistent grid of CTA pairs (66 on an H100 SXM) at fewer
    blocks than pairs, as many, one more, and two rounds and one: the
    last block's sums and every block's column sums within 1e-4 of the
    largest of that block's plain sums."""
    _, _, phi, c = mxu_micro.inputs(blocks=blocks, seed=20 + blocks,
                                    device=cuda)
    out, csum = _dots_bf16_on_card(phi, c, split)
    want, want_cs = mk.dots_bf16_plain(phi, c, split=split)
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()
    tol = 1e-4 * want_cs.abs().amax(1)
    assert ((csum - want_cs).abs().amax(1) <= tol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("split", [False, True])
def test_dots_bf16_one_hot_on_card(cuda, split):
    """One stream block whose C holds a 1 at depth r % 16 of row r in
    group r % 24, and for rows below 64 a second one in group
    (r + 5) % 24: row r of the sums is phi's row r % 16 (rounded to bf16)
    times the groups that carry it. A transposed or mis-strided B
    descriptor, or a misplaced A fragment, moves or mixes the rows (a
    misplaced lo tile errs by about 2^-9 of phi). K6's sums are exact.
    bf16x3 adds each group's hi, then its lo (hi.hi, hi.lo; lo.hi is 0):
    hi + lo is a float, so the rows one group carries are exact, but the
    second group's 2 hi + lo can need a 25th bit, which the tensor cores'
    accumulator drops in its own way: those rows are held within two
    roundings of 2 (hi + lo)."""
    _, _, phi, _ = mxu_micro.inputs(blocks=1, seed=31, device=cuda)
    c = torch.zeros((mk.BLOCK_C_ROWS, mk.DOT_DEPTH), device=cuda)
    rows = torch.arange(mk.BLOCK_ROWS, device=cuda)
    depth = rows % mk.DOT_DEPTH
    c[(rows % 24) * mk.BLOCK_ROWS + rows, depth] = 1.0
    c[((rows[:64] + 5) % 24) * mk.BLOCK_ROWS + rows[:64], depth[:64]] = 1.0
    hi, lo = mk.bf16_split(phi)
    rowval = hi + lo if split else hi
    want = rowval[depth] * torch.where(rows < 64, 2.0, 1.0)[:, None]
    out, csum = _dots_bf16_on_card(phi, c, split)
    assert torch.equal(out[64:], want[64:])
    if split:
        # Two roundings, each below 2^-23 of the intermediate sum; a
        # factor 2 covers that sum's binade.
        tol = 4 * 2.0 ** -23 * want[:64].abs()
        assert ((out[:64] - want[:64]).abs() <= tol).all()
    else:
        assert torch.equal(out[:64], want[:64])
    want_cs = mk.dots_bf16_plain(phi, c, split=split)[1]
    assert (csum - want_cs).abs().max() <= 1e-4 * want_cs.abs().max()


@pytest.mark.gpu
def test_dynamic_frame_on_card_matches_oracle(cuda):
    """A warm session with a motion margin, rebuilt on deformed frames:
    the last frame's hits meet _check's thresholds against the oracle on
    that frame's triangles."""
    v, f = scenes.cornell_box()
    anim = AnimatedScene(v, f, device=cuda)
    ext = v.max(0) - v.min(0)
    s = RenderSession.create(anim.frame(0.0), verts=v,
                             bbox_margin=float(0.26 / ext.min()))
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                        device=cuda)
    for t in (0.1, 0.2, 0.3):
        tris = anim.frame(t)
        s.rebuild(tris)
        hits = s.trace(rays, coherent=True)
    assert not bool(s.grid.overflowed)
    ref = oracle.closest_hit(rays, tris)
    both = (hits.tri_id >= 0) & (ref.tri_id >= 0)
    assert ((hits.tri_id >= 0) == (ref.tri_id >= 0)).float().mean() > 0.999
    same = both & (hits.tri_id == ref.tri_id)
    assert same.sum() > 0.995 * both.sum()
    torch.testing.assert_close(hits.t[same], ref.t[same], rtol=1e-3,
                               atol=1e-5)
    assert not s.poll_overflow(recalibrate=False)


@pytest.mark.gpu
def test_profiling_helpers_on_card(cuda):
    """timed and StageTimer between CUDA events; device_trace sees the
    card's kernels."""
    x = torch.randn(1 << 22, device=cuda)
    s = profiling.timed(lambda: x.sort(), warmup=1, iters=3, chain=2,
                        device=cuda)
    assert 0 < s < 1.0
    timer = profiling.StageTimer(device=cuda)
    with timer.stage("sort"):
        x.sort()
    assert timer.stages["sort"] > 0
    with profiling.device_trace() as prof:
        x.sort()
    assert sum(e.self_device_time_total for e in prof.key_averages()) > 0


_IRREGULAR_TABLES = ("top_res_log", "top_offset", "entries", "cell_min",
                     "cell_max", "cell_starts", "ref_ids", "alive",
                     "preexpanded", "top_info", "erec", "num_entries",
                     "total_refs", "ref_tris")


def _soup(seed, device):
    v, f = scenes.random_soup(150, seed=seed)
    return Triangles.from_mesh(v, f, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("params", [BuildParams(), BuildParams.dynamic(),
                                    BuildParams(merge_passes=0,
                                                expansion_passes=0)],
                         ids=["default", "dynamic", "nomerge"])
@pytest.mark.parametrize("seed", [0, 1])
def test_irregular_build_on_card_equals_cpu(cuda, seed, params):
    on = irregular.build_irregular(_soup(seed, cuda), params)
    off = irregular.build_irregular(_soup(seed, "cpu"), params)
    assert on.top_dims == off.top_dims and on.levels == off.levels
    for k in _IRREGULAR_TABLES:
        assert torch.equal(getattr(on, k).cpu(), getattr(off, k)), k


def _scatter_inputs(case, dev):
    """(n, idx i64, [addends]) of one scatter pattern at the builds'
    sizes; an addend is an i64 tensor (cast to each addend type), a
    1-element tensor (expanded) or a Python int."""
    rng = np.random.default_rng(19)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa
    small = lambda m: t(rng.integers(-3, 4, m) * (rng.random(m) < 0.6))  # noqa
    if case == "all_dropped":
        return 1000, t(rng.integers(1000, 5000, 300_000)), [small(300_000)]
    if case == "all_equal":
        return 1000, t(np.full(700_000, 417)), [small(700_000), 1]
    if case == "sorted_runs":    # runs past a warp, a warp's span and a block
        lens = rng.choice([1, 31, 33, 100, 600, 5000, 70_000], 300)
        keys = np.sort(rng.choice(50_000, 300, replace=False))
        idx = np.concatenate([np.repeat(keys, lens), np.full(2_000_000,
                                                             50_000)])
        live = (idx < 50_000).astype(np.int64)
        return 50_000, t(idx), [t(live), small(idx.size)]
    if case in ("random", "graphed", "counted"):
        return 100_000, t(rng.integers(0, 120_000, 2_000_000)), [
            t(rng.integers(-1000, 1000, 2_000_000))]
    if case == "fill":           # expand_by_counts' run starts
        offsets = np.cumsum(rng.integers(0, 3, 1_000_000))
        return 1_200_000, t(offsets), [1, -3]
    if case == "expanded":
        return 5000, t(rng.integers(0, 6000, 500_000)), [t([7]), t([0])]
    if case == "empty":
        return 10, t(np.zeros(0)), [t(np.zeros(0)), 1]
    if case == "n1":
        return 1, t(rng.integers(0, 3, 100_000)), [small(100_000)]
    # sums past 2^31: i64 (the sweep planner's threshold deltas), and i32
    # runs that wrap, as index_add_'s atomics do
    return 300, t(np.sort(rng.integers(0, 310, 1_000_000))), [
        t(rng.integers(1 << 29, 1 << 30, 1_000_000))]


@pytest.mark.gpu
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["all_dropped", "all_equal", "sorted_runs",
                                  "random", "fill", "expanded", "empty", "n1",
                                  "i64_sums", "i32_wraps", "graphed",
                                  "counted"])
def test_scatter_add_drop_on_card(cuda, case, idx_dtype):
    """csrc/scatter.cu's kernel equals index_add_ into n + 1 slots (the
    plain version) bit for bit, for i32 and i64 indices and addends;
    captured in a graph, each replay equals it too and counts one
    launch."""
    from hagrid_tpu_torch.ops import segment
    n, idx, addends = _scatter_inputs(case, cuda)
    idx = idx.to(idx_dtype)
    for a in addends:
        wide = {"i64_sums": (torch.int64,), "i32_wraps": (torch.int32,)}
        for vdt in (wide.get(case, (torch.int32, torch.int64))
                    if torch.is_tensor(a) else (torch.int64,)):
            vals = a.to(vdt).expand(idx.shape) if torch.is_tensor(a) else a
            want = segment.add_at_drop_plain(n, idx, vals)
            before = segment.launches["scatter_add_drop"]
            if case not in ("graphed", "counted"):
                got = segment.add_at_drop(n, idx, vals)
                torch.cuda.synchronize()
                assert got.dtype == want.dtype and torch.equal(got, want)
                assert segment.launches["scatter_add_drop"] - before == \
                    int(idx.numel() > 0)
                if case in wide:
                    assert int(segment.add_at_drop_plain(
                        n, idx, vals.long()).max()) > 1 << 31
                continue
            res = {}
            static_i, static_v = idx.clone(), vals.clone()
            replay = kernel_mt20.graphed(lambda: res.update(
                out=segment.add_at_drop(n, static_i, static_v)), 1, cuda)
            before = segment.launches["scatter_add_drop"]
            for k in range(3):
                perm = torch.randperm(idx.numel(), device=cuda)
                static_i.copy_(idx[perm])
                static_v.copy_(vals[perm] + k)
                replay()
                torch.cuda.synchronize()
                if case == "graphed":
                    assert torch.equal(res["out"], segment.add_at_drop_plain(
                        n, static_i, static_v))
            assert segment.launches["scatter_add_drop"] - before == 3


_SCAN_TILE_BYTES = 32768   # csrc/scan.cu's tile, checked by its workspace


def _scan_inputs(n, dtype, dev, seed):
    """Three running-scan inputs of length n: noise on a rising trend, on
    a falling one (the running max, then the min, moves in every tile),
    and full-range values with the dtype's extremes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    info = torch.iinfo(dtype)
    step = torch.arange(n, device=dev, dtype=torch.int64) // 997
    noise = torch.randint(-50, 50, (n,), generator=g, device=dev)
    wide = torch.randint(info.min // 2, info.max // 2, (n,), generator=g,
                         device=dev, dtype=torch.int64)
    wide[torch.rand(n, generator=g, device=dev) < 1e-4] = info.min
    wide[torch.rand(n, generator=g, device=dev) < 1e-4] = info.max
    return [(noise + step).to(dtype), (noise - step).to(dtype),
            wide.to(dtype)]


@pytest.mark.gpu
def test_running_scan_on_card(cuda, monkeypatch):
    """csrc/scan.cu's running max / min equal torch.cummax / cummin's
    values bit for bit on int32 and int64 at one element, a tile - 1, a
    tile, a tile + 1, 2^20 + 3 and 3 x 10^6 (and on a view that is not
    16-byte aligned); captured in a graph and replayed on new data, each
    replay equals them and counts its launches; the packet build at the
    full Sponza-scale size launches no scan and its run starts (a gather)
    equal torch.cummax of its markers; the compact planner's outputs on
    an AO wave and a closest-hit bounce are bit-equal with the kernel and
    with the plain version forced."""
    from hagrid_tpu_torch.ops import _build, segment
    from hagrid_tpu_torch.ops import sweep_trace as st
    lib = _build.load()
    plain = {"max": segment.running_max_plain,
             "min": segment.running_min_plain}
    for dtype in (torch.int32, torch.int64):
        size = torch.iinfo(dtype).bits // 8
        tile = _SCAN_TILE_BYTES // size
        assert lib.hagrid_running_scan_workspace(tile, size) == 0 < \
            lib.hagrid_running_scan_workspace(tile + 1, size)
        for n in (1, tile - 1, tile, tile + 1, (1 << 20) + 3, 3_000_000):
            for x in _scan_inputs(n, dtype, cuda, seed=n):
                for op, ref in plain.items():
                    scan = getattr(segment, f"running_{op}")
                    before = segment.launches["running_scan"]
                    got = scan(x)
                    torch.cuda.synchronize()
                    assert segment.launches["running_scan"] == before + 1
                    assert got.dtype == dtype and torch.equal(got, ref(x)), (
                        n, dtype, op)
                    if n > 1:
                        assert torch.equal(scan(x[1:]), ref(x[1:])), (
                            n, dtype, op, "offset view")

    # A captured graph replayed on new data: the status is reset.
    n = 3_000_000
    static = {dt: torch.empty(n, dtype=dt, device=cuda)
              for dt in (torch.int32, torch.int64)}
    res = {}

    def body():
        for dt, x in static.items():
            res[dt, "max"] = segment.running_max(x)
            res[dt, "min"] = segment.running_min(x)
    for dt, x in static.items():
        x.copy_(_scan_inputs(n, dt, cuda, seed=0)[0])
    replay = kernel_mt20.graphed(body, 1, cuda)
    for k in range(1, 3):
        for dt, x in static.items():
            x.copy_(_scan_inputs(n, dt, cuda, seed=k)[k])
        before = segment.launches["running_scan"]
        replay()
        torch.cuda.synchronize()
        assert segment.launches["running_scan"] - before == 4
        for (dt, op), got in res.items():
            assert torch.equal(got, plain[op](static[dt])), (k, dt, op)

    # The packet build: no scan; its run starts, a gather of the run
    # offsets, equal the reference's running max of the markers.
    from hagrid_tpu_torch.grid import packet as packet_mod
    v, f = scenes.sponza_like()
    tris = Triangles.from_mesh(v, f, device=cuda)
    starts, real_add = [], packet_mod.add_at_drop

    def add(n, idx, vals):
        if isinstance(vals, int) and vals == 1:      # the run markers
            starts.append((n, idx.clone()))
        return real_add(n, idx, vals)
    with monkeypatch.context() as mp:
        mp.setattr(packet_mod, "add_at_drop", add)
        before = segment.launches["running_scan"]
        grid = build_packet(tris)
        torch.cuda.synchronize()
        assert segment.launches["running_scan"] == before
    assert len(starts) == 3                          # one a major axis
    for cap, offsets in starts:
        markers = segment.add_at_drop(cap, offsets, 1)
        tri_idx = (segment.cumsum_i32(markers) - 1).clamp(
            0, offsets.numel() - 1)
        j = torch.arange(cap, dtype=torch.int32, device=cuda)
        assert torch.equal(offsets[tri_idx.long()], torch.cummax(
            torch.where(markers > 0, j, 0), 0).values)

    # The compact planner, kernel against plain: one scan a closest-hit
    # plan (its segmented suffix min), none an any-hit one.
    recorded = []                 # (scans it makes, its outputs) a call
    real_plan = st._plan_items2

    def plan(*a, **k):
        out = real_plan(*a, **k)
        any_hit = a[11]
        recorded.append((0 if any_hit else 1, [o.clone() for o in out]))
        return out
    monkeypatch.setattr(st, "_plan_items2", plan)
    rays = primary_rays(scenes.sponza_camera(), 512, 512, order="block",
                        device=cuda)
    prim = st.trace_sweep(grid, rays, coherent=True)
    p, nrm, found = hit_points_normals(rays, prim, tris.n)
    gen = torch.Generator(device=cuda).manual_seed(3)
    ao = integrators.ao_rays(p, nrm, found, 0.3, gen)
    bounce = integrators._spawn(p, nrm, cosine_hemisphere(nrm, gen), 0.0,
                                torch.where(found, float("inf"), 0.0))
    runs = []
    for forced in (False, True):
        with monkeypatch.context() as mp:
            if forced:
                mp.setattr(segment, "running_min_kernel",
                           segment.running_min_plain)
            recorded.clear()
            before = segment.launches["running_scan"]
            st.trace_sweep(grid, ao, any_hit=True)
            st.trace_sweep(grid, bounce)
            torch.cuda.synchronize()
            runs.append((list(recorded),
                         segment.launches["running_scan"] - before))
    (plans_k, planned_k), (plans_p, planned_p) = runs
    assert planned_k == sum(c for c, _ in plans_k) > 0 and planned_p == 0
    assert {c for c, _ in plans_k} == {0, 1}   # both waves planned
    assert len(plans_k) == len(plans_p)
    for i, ((_, a), (_, b)) in enumerate(zip(plans_k, plans_p)):
        for j, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), (i, j)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_uniform_build_on_card_equals_cpu(cuda, seed):
    on = uniform.build_uniform(_soup(seed, cuda))
    off = uniform.build_uniform(_soup(seed, "cpu"))
    assert on.dims == off.dims
    for k in ("cell_starts", "ref_ids", "total_refs"):
        assert torch.equal(getattr(on, k).cpu(), getattr(off, k)), k


@pytest.mark.gpu
def test_res_demand_on_card_equals_cpu(cuda):
    n = torch.arange(0, (1 << 16) + 1, dtype=torch.int32)
    for snd in (2.0, 2.4):
        assert torch.equal(irregular.res_demand(n.to(cuda), snd, 8).cpu(),
                           irregular.res_demand(n, snd, 8))


def _grid_to(grid, device):
    import dataclasses
    fields = {f.name: getattr(grid, f.name) for f in dataclasses.fields(grid)}
    out = {k: v.to(device) if torch.is_tensor(v) else v
           for k, v in fields.items()}
    out["tris"] = Triangles(*(getattr(grid.tris, k).to(device)
                              for k in ("v0", "e1", "e2", "n")))
    return type(grid)(**out)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("structure", ["irregular", "uniform"])
def test_wavefront_on_card_matches_cpu(cuda, structure, any_hit):
    """One CPU-built grid, traced on the card and on the CPU: hit/miss
    equal, ids equal on > 99.5% of common hits, t to rtol 1e-5."""
    v, f = scenes.cornell_box()
    off = Triangles.from_mesh(v, f, device="cpu")
    if structure == "irregular":
        g = irregular.build_irregular(off)
        trace = irregular.trace_irregular_fast
    else:
        g = uniform.build_uniform(off)
        trace = uniform.trace_uniform_fast
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                        device="cpu")
    want = trace(g, rays, any_hit=any_hit)
    rays_c = type(rays)(*(getattr(rays, k).to(cuda)
                          for k in ("org", "dir", "tmin", "tmax")))
    got = trace(_grid_to(g, cuda), rays_c, any_hit=any_hit)
    got_hit, want_hit = got.tri_id.cpu() >= 0, want.tri_id >= 0
    assert torch.equal(got_hit, want_hit)
    if not any_hit:
        both = got_hit & want_hit
        same = both & (got.tri_id.cpu() == want.tri_id)
        assert same.sum() > 0.995 * both.sum()
        torch.testing.assert_close(got.t.cpu()[same], want.t[same],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2000, 20000])
@pytest.mark.parametrize("kw", [dict(refine=True), dict(adaptive=True),
                                dict(refine=True, adaptive=True)])
def test_option_builds_on_card_equal_cpu(cuda, kw, n):
    """Refined and adaptive packet builds on the card: rs, rowinfo,
    planes, totals and the cols ids equal the CPU build's; the cols
    coefficients match at rtol 1e-6, atol 1e-6."""
    v, f = scenes.sponza_like(n)
    on = build_packet(Triangles.from_mesh(v, f, device=cuda), **kw)
    off = build_packet(Triangles.from_mesh(v, f, device="cpu"), **kw)
    for k in ("rs", "rowinfo", "planes", "total_refs", "total_pairs"):
        assert torch.equal(getattr(on, k).cpu(), getattr(off, k)), k
    cols = on.cols.cpu()
    assert torch.equal(cols[:, 16::20], off.cols[:, 16::20])
    torch.testing.assert_close(cols, off.cols, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_refined_and_fine_bin_streams_on_card(cuda, any_hit):
    """Round 0 of a fine-binned incoherent wave on a refined, adaptive
    grid: the kernel equals its plain version on that stream (ids, and t
    within rtol 1e-5 where the ids agree), and the whole trace, coherent
    primaries and fine-binned rays, agrees with the oracle (_check's
    thresholds; any hit: hit/miss on more than 99.9%)."""
    from hagrid_tpu_torch.ops.sweep_trace import (first_round_stream,
                                                  trace_sweep)
    v, f = scenes.sponza_like(20000)
    tris = Triangles.from_mesh(v, f, device=cuda)
    grid = build_packet(tris, refine=True, adaptive=True)
    rng = np.random.default_rng(3)
    n = 8192
    lo, hi = v.min(0), v.max(0)
    org = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo),
                      (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 3.0 if any_hit else np.inf, np.float32)
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    from hagrid_tpu_torch.core.types import Rays
    rays = Rays(t(org), t(d), t(np.zeros(n, np.float32)), t(tmax))
    xt, gidx, tile_of, tminb, tile = first_round_stream(
        grid, rays, any_hit=any_hit, coherent=False, bmax=8192,
        fine_bins=True)
    before = launches["sweep_blocks_anyhit" if any_hit else "sweep_blocks"]
    got = sweep_blocks(xt, grid.cols, gidx, tile_of, tminb, tile,
                       any_hit=any_hit)
    assert launches["sweep_blocks_anyhit" if any_hit
                    else "sweep_blocks"] == before + 1
    ref = sweep_blocks_plain(xt, grid.cols, gidx, tile_of, tminb, tile,
                             any_hit=any_hit)
    nt = xt.shape[1] // tile - 1
    swept = torch.zeros(nt + 1, dtype=torch.bool, device=cuda)
    swept[tile_of.long()] = True
    rows = swept[:nt].repeat_interleave(tile)
    m = rows.numel()
    if any_hit:
        assert torch.equal(got[1][:m][rows] >= 0, ref[1][:m][rows] >= 0)
    else:
        same = got[1][:m][rows] == ref[1][:m][rows]
        assert same.float().mean() >= 0.9999
        hit = same & (got[1][:m][rows] >= 0)
        torch.testing.assert_close(got[0][:m][rows][hit],
                                   ref[0][:m][rows][hit], rtol=1e-5,
                                   atol=0)
    hits, ovf = trace_sweep(grid, rays, any_hit=any_hit, fine_bins=True,
                            bmax=8192, return_overflow=True)
    assert not bool(ovf)
    if any_hit:
        want = oracle.any_hit(rays, tris)
        assert ((hits.tri_id >= 0) == want).float().mean() > 0.999
    else:
        _check_on_card(hits, oracle.closest_hit(rays, tris))
        prim = primary_rays(scenes.sponza_camera(), 128, 128,
                            order="block", device=cuda)
        ph, povf = trace_sweep(grid, prim, coherent=True, bmax=4096,
                               return_overflow=True)
        assert not bool(povf)
        _check_on_card(ph, oracle.closest_hit(prim, tris))


def _check_on_card(hits, ref):
    """tests/test_sweep_trace.py::_check's thresholds, on the card."""
    got_hit, ref_hit = hits.tri_id >= 0, ref.tri_id >= 0
    t_ok = torch.isclose(hits.t, ref.t, rtol=1e-3, atol=1e-5)
    assert ((got_hit == ref_hit) & (~ref_hit | t_ok)).float().mean() > 0.999
    both = got_hit & ref_hit
    assert (hits.tri_id[both] == ref.tri_id[both]).float().mean() > 0.995


@pytest.mark.gpu
def test_native_obj_parser_on_card_machine(cuda, tmp_path):
    """The native parser builds with the machine's g++ and reads what
    save_obj wrote; the loaded scene renders on the card."""
    from hagrid_tpu_torch.io import obj
    v, f = scenes.sponza_like(3000)
    p = str(tmp_path / "s.obj")
    obj.save_obj(p, v, f)
    nv, nf = obj.load_obj(p)
    pv, pf = obj.load_obj_python(p)
    assert np.array_equal(nv, v) and np.array_equal(nf, f)
    assert np.array_equal(pv, v) and np.array_equal(pf, f)
    lv, lf, cam = scenes.load_scene(p)
    s = RenderSession.create(Triangles.from_mesh(lv, lf, device=cuda),
                             verts=lv)
    hits = s.trace(primary_rays(cam, 64, 64, order="block", device=cuda),
                   coherent=True)
    assert hits.tri_id.device.type == "cuda"


@pytest.mark.gpu
def test_shard_trace_on_card(cuda):
    """shard_trace over every card (replicated grid, one shard each) and
    over two shards of the first card: hits equal one trace, each shard on
    its mesh device."""
    from hagrid_tpu_torch.ops.sweep_trace import trace_sweep
    from hagrid_tpu_torch.parallel import distributed, mesh
    v, f = scenes.cornell_box()
    grid = build_packet(Triangles.from_mesh(v, f, device=cuda),
                        dims=(6, 6, 6))
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                        device=cuda)

    def fn(g, r):
        return trace_sweep(g, r, coherent=True, tile=128)

    want = fn(grid, rays)
    for m in (mesh.make_mesh(), mesh.make_mesh(2, devices=cuda)):
        padded, n = mesh.pad_rays(rays, len(m) * 128)
        shards = mesh.shard_trace(fn, m)(grid, padded)
        assert [h.tri_id.device for h in shards] == \
            [torch.device(d) for d in m]
        got = mesh.gather(shards, device=cuda, n=n)
        assert torch.equal(got.tri_id, want.tri_id)
        assert torch.equal(got.t, want.t)
    distributed.initialize(world_size=1)
    assert distributed.global_mesh()[0].type == "cuda"


def _march_case(kind, scene, device):
    """(grid, lookup, rays) on `device` for the march kernel's lookups:
    the irregular grid in quad rows or per row (one row more), or the
    uniform grid; Cornell primaries or random rays around a soup, half
    of them with finite tmax."""
    v, f = scenes.cornell_box() if scene == "cornell" else \
        scenes.random_soup(150, seed=0)
    off = Triangles.from_mesh(v, f, device="cpu")
    if kind == "uniform":
        g, lk = uniform.build_uniform(off), uniform.uniform_lookup
    else:
        g, lk = irregular.build_irregular(off), irregular.irregular_lookup
        if kind == "rows":
            g = g.replace(ref_tris=torch.cat([g.ref_tris, g.ref_tris[:1]]))
    if scene == "cornell":
        rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                            device="cpu")
    else:
        rng = np.random.default_rng(3)
        lo, hi = g.bbox_lo.numpy(), g.bbox_hi.numpy()
        org = rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo),
                          (4096, 3)).astype(np.float32)
        d = rng.normal(size=(4096, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.where(rng.random(4096) < 0.5, np.inf,
                        rng.uniform(0.1, 2.0, 4096)).astype(np.float32)
        from hagrid_tpu_torch.core.types import Rays
        rays = Rays.make(org, d, None, tmax, device="cpu")
    rays = type(rays)(*(getattr(rays, k).to(device)
                        for k in ("org", "dir", "tmin", "tmax")))
    return _grid_to(g, device), lk, rays


def _assert_hits_bit_equal(got, want, what=""):
    assert torch.equal(got.tri_id, want.tri_id), f"{what}: tri_id"
    for k in ("t", "u", "v"):
        assert torch.equal(getattr(got, k).view(torch.int32),
                           getattr(want, k).view(torch.int32)), f"{what}: {k}"


def _plain_on_card(g, lk, rays, any_hit, rpi=2):
    """trace_plain on the card: (hits, steps, last_trace_stats)."""
    from hagrid_tpu_torch.ops import wavefront
    steps = torch.empty(rays.count, dtype=torch.int32, device=rays.org.device)
    hits = wavefront.trace_plain(g, lk, rays, rpi, any_hit, steps=steps)
    return hits, steps, dict(wavefront.last_trace_stats)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["quad", "rows", "uniform"])
@pytest.mark.parametrize("scene", ["cornell", "soup150"])
def test_march_kernel_matches_plain_on_card(cuda, scene, kind, any_hit):
    """wavefront.trace on the card (one launch of the march kernel)
    against trace_plain on the card: tri ids, the bits of t/u/v and every
    ray's steps equal, no ray truncated, the same mean steps; the kernel's
    hard cap is max_march_iters'. Each refill threshold gives the same
    hits and steps, and the work counters add up: SIMD efficiency (alive
    lane iterations over 32 x warp iterations) is at most 1."""
    from hagrid_tpu_torch.ops import wavefront
    g, lk, rays = _march_case(kind, scene, cuda)
    assert wavefront.kernel_mode(g, lk) == {"quad": 0, "rows": 1,
                                            "uniform": 2}[kind]
    want, want_steps, want_stats = _plain_on_card(g, lk, rays, any_hit)
    steps = torch.empty_like(want_steps)
    before = wavefront.launches["wavefront_march"]
    got = wavefront.trace(g, lk, rays, any_hit=any_hit, steps=steps)
    assert wavefront.launches["wavefront_march"] == before + 1
    stats = dict(wavefront.last_trace_stats)
    _assert_hits_bit_equal(got, want, "trace")
    assert torch.equal(steps, want_steps)
    assert stats["truncated_rays"] == want_stats["truncated_rays"] == 0
    assert stats["rounds"] == 1
    assert stats["mean_steps"] == want_stats["mean_steps"]
    starts = g.cell_starts.cpu()
    cap = wavefront.max_march_iters(g.fine_dims,
                                    int((starts[1:] - starts[:-1]).max()), 2)
    for refill in (1, 8, 32):
        work = torch.zeros(5, dtype=torch.int64, device=cuda)
        mode, a, outs, st, keep = wavefront.march_args(
            g, lk, rays, 2, refill=refill, work=work)
        wavefront.launch_march(mode, a, any_hit)
        torch.cuda.synchronize()
        tests, rows, exits, loads, warp_iters = work.tolist()
        assert tests >= rows > 0 and exits >= loads > 0
        assert 0 < int(want_steps.sum()) <= 32 * warp_iters
        _assert_hits_bit_equal(Hits(tri_id=outs["id"], t=outs["t"],
                                    u=outs["u"], v=outs["v"]), want,
                               f"refill {refill}")
        assert torch.equal(outs["steps"], want_steps)
        assert st[1:].tolist() == [0, int(want_steps.sum()), cap]


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["quad", "rows", "uniform"])
def test_march_kernel_truncates_at_its_cap_on_card(cuda, kind, any_hit):
    """With the cap lowered to 3 iterations (cap_base), a ray that
    trace_plain marches for at most 3 iterations keeps its hit and steps;
    every longer one stops after 3 and counts as truncated."""
    from hagrid_tpu_torch.ops import wavefront
    g, lk, rays = _march_case(kind, "cornell", cuda)
    want, want_steps, _ = _plain_on_card(g, lk, rays, any_hit)
    mode, a, outs, st, keep = wavefront.march_args(g, lk, rays, 2)
    starts = g.cell_starts.cpu()
    a.cap_base = 3 - 8 * (int((starts[1:] - starts[:-1]).max()) // 2)
    wavefront.launch_march(mode, a, any_hit)
    torch.cuda.synchronize()
    short = want_steps <= 3
    assert 0 < int(short.sum()) < rays.count
    assert torch.equal(outs["id"][short], want.tri_id[short])
    assert torch.equal(outs["t"][short].view(torch.int32),
                       want.t[short].view(torch.int32))
    assert torch.equal(outs["steps"], want_steps.clamp(max=3))
    _, truncated, total, cap = st.tolist()
    assert cap == 3 and truncated == int((~short).sum())
    assert total == int(want_steps.clamp(max=3).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("structure", ["irregular", "uniform"])
def test_session_trace_launches_the_march_kernel(cuda, monkeypatch,
                                                 structure):
    """RenderSession.trace on the card marches through one launch of the
    kernel a trace and never through segment_plain or trace_plain; a
    lookup the kernel does not know raises on CUDA tensors, before any
    launch."""
    from hagrid_tpu_torch.ops import wavefront

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(wavefront, "segment_plain", refuse)
    monkeypatch.setattr(wavefront, "trace_plain", refuse)
    v, f = scenes.cornell_box()
    s = RenderSession.create(Triangles.from_mesh(v, f, device=cuda),
                             structure=structure, verts=v)
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                        device=cuda)
    before = wavefront.launches["wavefront_march"]
    hits = s.trace(rays)
    assert wavefront.launches["wavefront_march"] == before + 1
    assert float((hits.tri_id >= 0).float().mean()) > 0.9
    g, lk, r = _march_case("uniform", "cornell", cuda)
    before = wavefront.launches["wavefront_march"]
    with pytest.raises(ValueError, match="no lookup"):
        wavefront.trace(g, lambda grid, vox: lk(grid, vox), r)
    assert wavefront.launches["wavefront_march"] == before


class _Reads:
    """Records each device-to-host read of a tensor (tolist, item, bool,
    int, float, cpu, numpy) with the march launches made by then."""

    def __init__(self, monkeypatch):
        from hagrid_tpu_torch.ops import wavefront
        self.at = []
        for name in ("tolist", "item", "__bool__", "__int__", "__float__",
                     "cpu", "numpy"):
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name,
                                self._wrap(orig, wavefront.launches))

    def _wrap(self, orig, launches):
        def f(t, *a, **kw):
            if t.device.type == "cuda":
                self.at.append(launches["wavefront_march"])
            return orig(t, *a, **kw)
        return f


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["quad", "uniform"])
def test_march_trace_reads_the_device_once(cuda, monkeypatch, kind,
                                           any_hit):
    """wavefront.trace on CUDA tensors reads the device exactly once, and
    only after its launch."""
    from hagrid_tpu_torch.ops import wavefront
    g, lk, rays = _march_case(kind, "soup150", cuda)
    torch.cuda.synchronize()
    reads = _Reads(monkeypatch)
    before = wavefront.launches["wavefront_march"]
    wavefront.trace(g, lk, rays, any_hit=any_hit)
    assert reads.at == [before + 1]


def _refuse(what):
    def f(*a, **k):
        raise AssertionError(f"{what} ran on the card")
    return f


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("coherent,compact", [(True, True), (False, False)],
                         ids=["coherent-compact", "binned-dense"])
def test_planner_apart_from_layout_on_card(cuda, monkeypatch, coherent,
                                           compact, any_hit):
    """trace_sweep with the compact planner on camera-ordered primaries
    and the dense planner on binned random rays: no call of
    sweep_blocks_plain, one kernel launch or more, no overflow, hits
    against the oracle (_check's thresholds; any hit: hit/miss on more
    than 99.9%). Their round-0 streams through the kernel equal its plain
    version bit for bit: closest hit ids and the bits of t, u and v on
    every ray of a swept tile; any hit, hit/miss."""
    from hagrid_tpu_torch.core.types import Rays
    from hagrid_tpu_torch.ops.sweep_trace import (first_round_stream,
                                                  trace_sweep)
    v, f = scenes.sponza_like(20000)
    tris = Triangles.from_mesh(v, f, device=cuda)
    grid = build_packet(tris)
    if coherent:
        rays = primary_rays(scenes.sponza_camera(), 128, 128,
                            order="block", device=cuda)
    else:
        rng = np.random.default_rng(4)
        n, lo, hi = 8192, v.min(0), v.max(0)
        org = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo),
                          (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.full(n, 3.0 if any_hit else np.inf, np.float32)
        rays = Rays.make(org, d, None, tmax, device=cuda)
    # Random rays cross the whole grid: the default budget (6 or 12
    # blocks a tile) is for waves with origin locality, and the dense
    # planner would overflow it (flagged).
    kw = dict(any_hit=any_hit, coherent=coherent, compact=compact,
              bmax=None if coherent else 8192)
    name = "sweep_blocks_anyhit" if any_hit else "sweep_blocks"
    with monkeypatch.context() as mp:
        mp.setattr(sk, "sweep_blocks_plain", _refuse("sweep_blocks_plain"))
        before = launches[name]
        hits, ovf, demand = trace_sweep(grid, rays, return_overflow=True,
                                        return_demand=True, **kw)
        torch.cuda.synchronize()
    assert launches[name] > before and not bool(ovf)
    assert (int(demand[1]) > 0) == compact
    if any_hit:
        want = oracle.any_hit(rays, tris)
        assert ((hits.tri_id >= 0) == want).float().mean() > 0.999
    else:
        _check_on_card(hits, oracle.closest_hit(rays, tris))
    xt, gidx, tile_of, tminb, tile = first_round_stream(grid, rays, **kw)
    got = sweep_blocks(xt, grid.cols, gidx, tile_of, tminb, tile,
                       any_hit=any_hit)
    ref = sweep_blocks_plain(xt, grid.cols, gidx, tile_of, tminb, tile,
                             any_hit=any_hit)
    nt = xt.shape[1] // tile - 1
    swept = torch.zeros(nt + 1, dtype=torch.bool, device=cuda)
    swept[tile_of.long()] = True
    rows = swept[:nt].repeat_interleave(tile)
    m = rows.numel()
    assert int(rows.sum()) > 0
    if any_hit:
        assert torch.equal(got[1][:m][rows] >= 0, ref[1][:m][rows] >= 0)
    else:
        assert torch.equal(got[1][:m][rows], ref[1][:m][rows])
        for k in (0, 2, 3):
            assert torch.equal(got[k][:m][rows].view(torch.int32),
                               ref[k][:m][rows].view(torch.int32)), k


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("structure", ["irregular", "uniform"])
def test_lockstep_entry_points_launch_the_march_kernel(cuda, monkeypatch,
                                                       structure, any_hit):
    """trace_irregular / trace_uniform on CUDA tensors: one launch of the
    march kernel a call, and never trace_wavefront, trace_plain or
    segment_plain; tri ids and the bits of t/u/v equal trace_wavefront
    run on the card; no ray truncated."""
    from hagrid_tpu_torch.ops import wavefront
    kind = "quad" if structure == "irregular" else "uniform"
    g, lk, rays = _march_case(kind, "soup150", cuda)
    entry = (irregular.trace_irregular if structure == "irregular"
             else uniform.trace_uniform)
    if structure == "irregular":
        want = wavefront.trace_wavefront(
            rays, g.tris, g.lookup, g.cell_starts, g.ref_ids, g.bbox_lo,
            g.bbox_hi, g.fine_dims, any_hit=any_hit)
    else:
        want = wavefront.trace_wavefront(
            rays, g.tris, lambda vox: lk(g, vox), g.cell_starts, g.ref_ids,
            g.bbox_lo, g.bbox_hi, g.dims, any_hit=any_hit)
    assert wavefront.last_trace_stats["truncated_rays"] == 0
    for name in ("trace_wavefront", "trace_plain", "segment_plain"):
        monkeypatch.setattr(wavefront, name, _refuse(name))
    before = wavefront.launches["wavefront_march"]
    got = entry(g, rays, any_hit=any_hit)
    assert wavefront.launches["wavefront_march"] == before + 1
    assert wavefront.last_trace_stats["truncated_rays"] == 0
    _assert_hits_bit_equal(got, want, structure)
    assert (got.tri_id >= 0).any()


def _graph_scene(name, device):
    if name == "cornell":
        v, f = scenes.cornell_box()
        cam = scenes.cornell_camera()
    else:
        v, f = scenes.random_soup(2000, seed=5)
        from hagrid_tpu_torch.core.camera import Camera
        cam = Camera(eye=(0.5, 0.5, 3.0), center=(0.5, 0.5, 0.5),
                     fov_deg=40)
    return v, f, primary_rays(cam, 64, 64, order="block", device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["cornell", "soup"])
def test_graphed_session_equals_eager_on_card(cuda, monkeypatch, scene):
    """RenderSession(structure="packet") on the card replays captured
    graphs: a coherent primary wave, an any-hit AO wave and a closest-hit
    bounce equal trace_sweep on the same grid and budgets bit for bit,
    and warm rebuilds equal build_packet(check=False) table by table;
    replays make no wrapper call and every replay adds its launches."""
    from hagrid_tpu_torch.ops import sweep_trace as st
    v, f, rays = _graph_scene(scene, cuda)
    tris = Triangles.from_mesh(v, f, device=cuda)
    s = RenderSession.create(tris, verts=v, bbox_margin=0.05)
    for frame in range(2):
        moved = Triangles.from_mesh(v + np.float32(0.01 * (frame + 1)), f,
                                    device=cuda)
        s.rebuild(moved)
        want = build_packet(moved, bbox=s.bbox,
                            ref_capacity=s.grid.ref_capacity,
                            dims3=s.grid.dims3, check=False)
        for k in ("rs", "rowinfo", "cols", "total_refs", "total_pairs",
                  "planes", "bbox_lo", "bbox_hi"):
            assert torch.equal(getattr(s.grid, k), getattr(want, k)), k
    prim = s.trace(rays, coherent=True)
    p, n, found = hit_points_normals(rays, prim, moved.n)
    gen = torch.Generator(device=cuda).manual_seed(0)
    ao = integrators.ao_rays(p, n, found, 0.3, gen)
    bounce = integrators._spawn(p, n, cosine_hemisphere(n, gen), 0.0,
                                torch.where(found, float("inf"), 0.0))
    waves = ((rays, dict(coherent=True)),
             (ao, dict(any_hit=True, cal_key="ao")),
             (bounce, dict(cal_key="path")))
    for wave, kw in waves:
        s.trace(wave, **kw)                     # calibrates and captures
    for wave, kw in waves:
        key = (kw.get("any_hit", False), kw.get("coherent", False),
               wave.count, kw.get("cal_key"))
        bmax, rowmax = s._bmax_cal[key]
        eager = dict(launches)
        want = st.trace_sweep(s.grid, wave, any_hit=key[0],
                              coherent=key[1], bmax=bmax, rowmax=rowmax)
        per = {k: launches[k] - eager[k] for k in launches}
        assert sum(per.values()) > 0
        with monkeypatch.context() as m:
            m.setattr(st, "sweep_blocks", _refuse("sweep_blocks"))
            m.setattr(sk, "sweep_blocks_plain", _refuse("sweep_blocks_plain"))
            before = dict(launches)
            got = [s.trace(wave, **kw) for _ in range(3)]
        torch.cuda.synchronize()
        assert {k: launches[k] - before[k] for k in launches} == \
            {k: 3 * n for k, n in per.items()}
        for g in got:
            _assert_hits_bit_equal(g, want, str(key))
    assert not s.poll_overflow(recalibrate=False)


@pytest.mark.gpu
def test_failed_capture_raises_on_card(cuda, monkeypatch):
    """An op of the body that reads the card breaks the capture: the
    trace raises, naming the capture, and nothing runs eagerly instead;
    the body without it captures."""
    from hagrid_tpu_torch.ops import sweep_trace as st
    v, f, rays = _graph_scene("cornell", cuda)
    s = RenderSession.create(Triangles.from_mesh(v, f, device=cuda), verts=v)
    s._bmax_cal[(False, True, rays.count, None)] = (1024, None)
    merge = st._merge

    def reading_merge(best, out, tile_of):
        bool(tile_of.max() > 0)
        return merge(best, out, tile_of)

    monkeypatch.setattr(st, "_merge", reading_merge)
    with pytest.raises(RuntimeError, match="capture of"):
        s.trace(rays, coherent=True)
    assert s._graphs.keys() == {}
    monkeypatch.undo()
    hits = s.trace(rays, coherent=True)
    assert (hits.tri_id >= 0).any()


def _structure_scene(name, device):
    """Cornell with its camera, or a 150-triangle soup seen from outside
    its unit box: (v, f, 64x64 block-order primaries)."""
    if name == "cornell":
        v, f = scenes.cornell_box()
        return v, f, primary_rays(scenes.cornell_camera(), 64, 64,
                                  order="block", device=device)
    from hagrid_tpu_torch.core.camera import Camera
    v, f = scenes.random_soup(150, seed=0)
    cam = Camera(eye=(0.5, 0.5, 3.0), center=(0.5, 0.5, 0.5), fov_deg=40)
    return v, f, primary_rays(cam, 64, 64, order="block", device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("structure,params", [
    ("irregular", BuildParams()), ("irregular", BuildParams.dynamic()),
    ("uniform", BuildParams())], ids=["irregular", "irregular-dynamic",
                                      "uniform"])
@pytest.mark.parametrize("scene", ["cornell", "soup150"])
def test_graphed_structure_rebuilds_equal_eager_on_card(cuda, scene,
                                                        structure, params):
    """RenderSession(structure="irregular" | "uniform") on the card
    replays its build's spans as captured graphs: warm rebuilds of moved
    geometry equal build_irregular / build_uniform table by table, bit for
    bit; a trace on the graphed grid launches the march kernel once and
    equals the trace on the eager grid."""
    from hagrid_tpu_torch.ops import wavefront
    v, f, rays = _structure_scene(scene, cuda)
    ext = float((v.max(0) - v.min(0)).max())
    s = RenderSession.create(Triangles.from_mesh(v, f, device=cuda), params,
                             structure=structure)
    for frame in range(2):
        moved = Triangles.from_mesh(
            v + np.float32(0.003 * ext * (frame + 1)), f, device=cuda)
        s.rebuild(moved)
        if structure == "irregular":
            want = irregular.build_irregular(moved, params,
                                             top_dims=s.grid.top_dims)
            fields = _IRREGULAR_TABLES + ("bbox_lo", "bbox_hi")
        else:
            want = uniform.build_uniform(
                moved, ref_capacity=s.grid.ref_ids.shape[0],
                dims=s.grid.dims)
            fields = ("cell_starts", "ref_ids", "total_refs", "bbox_lo",
                      "bbox_hi")
        for k in fields:
            got, ref = getattr(s.grid, k), getattr(want, k)
            if got.dtype == torch.float32:
                got, ref = got.view(torch.int32), ref.view(torch.int32)
            assert torch.equal(got, ref), (frame, k)
        for slot in s._graphs.keys():
            assert s._graphs.captured(slot).graph is not None, slot
    before = wavefront.launches["wavefront_march"]
    hits = s.trace(rays, coherent=True)
    torch.cuda.synchronize()
    assert wavefront.launches["wavefront_march"] - before == 1
    trace = (irregular.trace_irregular_fast if structure == "irregular"
             else uniform.trace_uniform_fast)
    _assert_hits_bit_equal(hits, trace(want, rays, coherent=True),
                           structure)
    assert (hits.tri_id >= 0).any()


@pytest.mark.gpu
def test_alternating_compaction_replays_kept_captures_on_card(cuda,
                                                              monkeypatch):
    """Span D's compaction capacity moving between two buckets and back
    on the card, with real captures: each warm rebuild's tables equal
    build_irregular's at that capacity bit for bit, and the second visit
    to a bucket replays its kept capture (a graph hit, no new
    captures.finish)."""
    from hagrid_tpu_torch.render.dynamic import wave_deform
    v, f = scenes.random_soup(150, seed=0)
    anim = AnimatedScene(v, f, device=cuda, deform=lambda x, t: wave_deform(
        x, t, amplitude=0.01, freq=6.0))
    params = BuildParams()
    bucket, extra = irregular._cell_capacity, [0]
    monkeypatch.setattr(irregular, "_cell_capacity",
                        lambda n: bucket(n) + extra[0])
    fields = _IRREGULAR_TABLES + ("bbox_lo", "bbox_hi")
    profiling.tracing(True)
    profiling.reset()
    try:
        s = RenderSession.create(anim.frame(0.0), params,
                                 structure="irregular")
        for i, t in enumerate((0.1, 0.2, 0.3, 0.4)):
            extra[0] = 1024 * (i % 2)
            moved = anim.frame(t)
            s.rebuild(moved)
            want = irregular.build_irregular(moved, params,
                                             top_dims=s.grid.top_dims)
            for k in fields:
                got, ref = getattr(s.grid, k), getattr(want, k)
                if got.dtype == torch.float32:
                    got, ref = got.view(torch.int32), ref.view(torch.int32)
                assert torch.equal(got, ref), (t, k)
            profiling.close_frame()
        counts = [r["counts"] for r in profiling.frames()]
    finally:
        profiling.tracing(False)
        profiling.reset()
    assert [c.get("captures.finish", 0) for c in counts] == [1, 1, 0, 0]
    assert [c.get("graph_hits.finish", 0) for c in counts] == [0, 0, 1, 1]
    assert s._graphs.captured("finish").graph is not None


@pytest.mark.gpu
def test_graphed_frame_equals_eager_on_card(cuda):
    """AnimatedScene.frame on the card replays one graph: bit-equal to
    wave_deform and Triangles.from_mesh run op by op, frame after
    frame."""
    from hagrid_tpu_torch.render.dynamic import wave_deform
    v, f = scenes.sponza_like(4096)
    anim = AnimatedScene(v, f, device=cuda)
    for t in (0.1, 0.2, 0.73):
        got = anim.frame(t)
        want = Triangles.from_mesh(wave_deform(anim.base_vertices, t),
                                   anim.faces)
        for k in ("v0", "e1", "e2", "n"):
            assert torch.equal(getattr(got, k).view(torch.int32),
                               getattr(want, k).view(torch.int32)), (t, k)
    assert anim._graphs.captured("frame").graph is not None


def _traced_loop(structure, device, traced, frames=4):
    """A dynamic loop on the soup at 64x64 (deform, warm rebuild,
    primaries, the overflow poll) with the program's tracing on or off:
    (each frame's hits, the frames' records)."""
    v, f, rays = _graph_scene("soup", device)
    profiling.tracing(traced)
    profiling.reset()
    try:
        anim = AnimatedScene(v, f, device=device)
        s = RenderSession.create(anim.frame(0.0), structure=structure,
                                 verts=v, bbox_margin=0.3)
        s.poll_overflow()
        hits = []
        for i in range(frames):
            s.rebuild(anim.frame(0.1 * (i + 1)))
            hits.append(s.trace(rays, coherent=True))
            s.poll_overflow()
        return hits, profiling.frames()
    finally:
        profiling.tracing(False)
        profiling.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("structure", ["packet", "irregular"])
def test_traced_spans_time_each_replay_on_card(cuda, structure):
    """With the program's tracing on, the card's graphs carry event nodes:
    every frame after the captures times its in-graph spans again (the
    sweep's, inside the packet wave's graph), each span's children take at
    most its device time, and the hits equal the untraced loop's."""
    plain, _ = _traced_loop(structure, cuda, False)
    traced, records = _traced_loop(structure, cuda, True)
    for a, b in zip(plain, traced):
        _assert_hits_bit_equal(b, a, structure)
    warm = records[2:]
    assert len(warm) == 3
    for rec in warm:
        sp = rec["spans"]
        assert not any(k.startswith("captures.") for k in rec["counts"])
        for name, s in sp.items():
            assert s["self_ms"] <= s["device_ms"] + 1e-3, name
        builds = [k for k in sp if k.startswith("graph.")
                  and k not in ("graph.frame", "graph.trace")]
        assert builds
        parts = sum(sp[k]["device_ms"] for k in builds + ["rebuild.detach"]
                    + (["read.build"] if "read.build" in sp else []))
        assert 0 < parts <= sp["rebuild"]["device_ms"] + 1e-3
        if structure == "packet":
            kids = ("sweep.layout", "sweep.plan", "sweep.kernel",
                    "sweep.merge")
            assert all(sp[k]["device_ms"] > 0 for k in kids)
            assert sp["sweep.plan"]["n"] == sp["sweep.kernel"]["n"]
            inner = sum(sp[k]["device_ms"] for k in kids)
            assert inner <= sp["graph.trace"]["device_ms"] + 1e-3
            assert sp["graph.trace"]["device_ms"] <= \
                sp["trace"]["device_ms"] + 1e-3
        else:
            assert sp["march"]["device_ms"] > 0
            assert rec["counts"]["march.rays"] == 64 * 64


# ------------------------------------------- the Sponza-scale scene, whole

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sponza(device):
    v, f = scenes.sponza_like()
    return v, f, Triangles.from_mesh(v, f, device=device)


@pytest.mark.gpu
def test_sponza_eyelight_dhash_on_card(cuda):
    """128x128 block-order primaries of the Sponza-scale scene through a
    warm packet session on the card: tri ids equal the oracle's on more
    than 99.9% of the pixels, and the eye-light render's dhash lies
    within 6 bits of the oracle render's and of the JAX package's
    (scenes.SPONZA_EYELIGHT_DHASH)."""
    v, f, tris = _sponza(cuda)
    s = RenderSession.create(tris, verts=v)
    s.rebuild(tris)
    rays = primary_rays(scenes.sponza_camera(), 128, 128, order="block",
                        device=cuda)
    hits = s.trace(rays, coherent=True)
    want = oracle.closest_hit(rays, tris)
    assert float((hits.tri_id == want.tri_id).float().mean()) > 0.999
    pix, normals = block_index(128, 128), tris.n.cpu().numpy()

    def render(h):
        tri = np.empty(128 * 128, np.int32)
        dirs = np.empty((128 * 128, 3), np.float32)
        tri[pix] = h.tri_id.cpu().numpy()
        dirs[pix] = rays.dir.cpu().numpy()
        return dhash(shade_eyelight(tri, None, normals, dirs, 128, 128))

    got = render(hits)
    assert hamming(got, render(want)) <= 6
    assert hamming(got, scenes.SPONZA_EYELIGHT_DHASH) <= 6
    assert not s.poll_overflow(recalibrate=False)


@pytest.mark.gpu
def test_check_irregular_at_sponza_scale_on_card(cuda):
    """The warm irregular grid of the Sponza-scale scene on the card passes
    check_irregular on a sample of 2^20 voxels and (tri, voxel) and
    (cell, voxel) pairs: ownership, completeness, expansion safety and
    sorted ref lists."""
    v, f, tris = _sponza(cuda)
    s = RenderSession.create(tris, structure="irregular", verts=v)
    s.rebuild(tris)
    invariants.check_irregular(s.grid, sample=1 << 20)


def _grid_diff(got, want, fields):
    """The fields of two grids that are not bit-equal (floats by their
    bits)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return [k for k in fields
            if not torch.equal(bits(getattr(got, k)), bits(getattr(want, k)))]


@pytest.mark.gpu
@pytest.mark.parametrize("structure,params", [
    ("irregular", BuildParams()), ("irregular", BuildParams.dynamic()),
    ("uniform", BuildParams())], ids=["irregular", "irregular-dynamic",
                                      "uniform"])
def test_forced_overflow_recaptures_at_sponza_scale_on_card(cuda, structure,
                                                            params):
    """Warm rebuilds of the deformed Sponza-scale scene at t = 0.1, 0.2 and
    0.3, the last with its cell-ref capacity (uniform: its ref capacity)
    forced below its need: that span is captured at the forced capacity,
    overflows and grows (uniform: to a capacity captured anew; irregular:
    span B back at the reference's capacity, whose kept capture replays
    unless the capacity is new to it, with spans C-D captured anew only
    then); every graphed grid equals the eager build table by table, bit
    for bit, and the grid kept from the rebuild before still equals its
    own frame's build."""
    v, f = scenes.sponza_like()
    anim = AnimatedScene(v, f, device=cuda)
    s = RenderSession.create(anim.frame(0.0), params, structure=structure,
                             verts=v)
    forced = {}
    if structure == "irregular":
        fields = _IRREGULAR_TABLES + ("bbox_lo", "bbox_hi")

        def force():
            for k in s._caps:
                if k != "rt":
                    s._caps[k] = 1024

        def eager(tris):
            return irregular.build_irregular(tris, params,
                                             top_dims=s.grid.top_dims)
    else:
        fields = ("cell_starts", "ref_ids", "total_refs", "bbox_lo",
                  "bbox_hi")

        def force():
            forced["cap"] = s.grid.ref_ids.shape[0] // 2
            s.grid = dataclasses.replace(
                s.grid, ref_ids=s.grid.ref_ids[:forced["cap"]])

        def eager(tris):
            return uniform.build_uniform(
                tris, ref_capacity=forced.get("cap", s.grid.ref_ids.shape[0]),
                dims=s.grid.dims)
    kept, times = None, (0.1, 0.2, 0.3)
    for t in times:
        tris = anim.frame(t)
        if t == times[-1]:
            force()
        held = {k: s._graphs.kept(k) for k in s._graphs.keys()}
        before = {k: s._graphs.captured(k) for k in s._graphs.keys()}
        s.rebuild(tris)
        want = eager(tris)
        assert _grid_diff(s.grid, want, fields) == [], t
        if kept is not None:
            assert _grid_diff(*kept, fields) == [], t
        kept = (s.grid, want)
    now = s._graphs.keys()
    anew = sorted(str(k) for k in now
                  if before.get(k) is not s._graphs.captured(k))
    if structure == "uniform":
        assert anew == ["uniform"]
    else:
        assert 1024 in [k[0][3] for k in s._graphs.kept("cells")]
        kept_b = now["cells"] in held["cells"]
        assert anew == ([] if kept_b else ["cells", "finish", "merge"])


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(refine=True), dict(adaptive=True)],
                         ids=["refine", "adaptive"])
def test_option_grid_warm_rebuild_at_sponza_scale_on_card(cuda, kw):
    """An option grid of the Sponza-scale scene on the card, then a warm
    rebuild at the scene's bounds and the cold grid's capacity and dims:
    no overflow, its rs, rowinfo and planes equal the cold build's, and
    check_packet passes on 256 sampled tris."""
    v, f, tris = _sponza(cuda)
    g = build_packet(tris, **kw)
    w = build_packet(tris, bbox=(v.min(0), v.max(0)),
                     ref_capacity=g.ref_capacity, dims3=g.dims3, check=False,
                     **kw)
    assert not bool(w.overflowed)
    for k in ("rs", "rowinfo", "planes"):
        assert torch.equal(getattr(w, k), getattr(g, k)), k
    invariants.check_packet(g, sample_tris=256)


@pytest.mark.gpu
@pytest.mark.parametrize("structure", ["packet", "irregular", "uniform"])
def test_cli_on_card(cuda, tmp_path, structure):
    """`python -m hagrid_tpu_torch.cli render | stats | bench --iters 3` on
    the Sponza-scale scene at 256x256 on the card, as a user runs them
    (three processes at once): each exits 0, render writes a PNG, bench
    prints the reference's keys and the device."""
    png = tmp_path / "cli.png"
    cmds = {"render": ["--out", str(png)], "stats": [],
            "bench": ["--iters", "3"]}
    procs = {cmd: subprocess.Popen(
        [sys.executable, "-m", "hagrid_tpu_torch.cli", cmd, "--scene",
         "sponza", "--size", "256x256", "--structure", structure, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for cmd, extra in cmds.items()}
    out = {}
    try:
        for cmd, p in procs.items():
            out[cmd] = (*p.communicate(timeout=400), p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, (_, err, rc) in out.items():
        assert rc == 0, (cmd, err[-2000:])
    assert png.stat().st_size > 0
    bench = json.loads(out["bench"][0].strip().splitlines()[-1])
    assert {"build_ms", "mrays_per_s", "grid", "device"} <= set(bench)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [
    ["--structure", "irregular"], ["--structure", "uniform"],
    ["--structure", "irregular", "--workload", "dynamic"]],
    ids=["irregular", "uniform", "irregular-dynamic"])
def test_bench_on_wavefront_structures_on_card(cuda, flags):
    """bench_torch.py at its defaults (the Sponza-scale scene, 1024x1024)
    on a wavefront structure: exit 0 with a value, the card named, no
    workload, trace or grid overflow, the march kernel launched; with
    every workload on the irregular grid, the hit fraction is the
    irregular session's on the same frame."""
    torch.cuda.empty_cache()            # leave the run the card's memory
    out = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                          *flags], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and line["value"] is not None, (
        line.get("error"), out.stderr[-2000:])
    extra = line["extra"]
    assert extra["device"] == torch.cuda.get_device_name(0)
    assert not any(extra["workload_overflow"].values())
    assert not extra["trace_overflow"] and not extra["grid_overflow"]
    assert extra["launches"]["wavefront_march"] > 0
    if flags == ["--structure", "irregular"]:
        v, f, tris = _sponza(cuda)
        s = RenderSession.create(tris, structure="irregular", verts=v)
        rays = primary_rays(scenes.sponza_camera(), 1024, 1024,
                            order="block", device=cuda)
        hits = s.trace(rays, coherent=True)
        assert extra["hit_fraction"] == round(
            float((hits.tri_id >= 0).float().mean()), 4)


@pytest.fixture(scope="module")
def sponza_waves():
    """The Sponza-scale scene on the card, as chip_smoke.py and the
    benchmark's cells make its waves: a warm packet session, the
    1024x1024 block-order primaries and their hits, AO wave 0 (one
    sample a pixel at default_ao_distance) and path bounce 1 from those
    hits, both origin-sorted as trace_sorted sorts them."""
    from hagrid_tpu_torch.ops import sortrays
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    v, f, tris = _sponza("cuda")
    s = RenderSession.create(tris, verts=v)
    s.rebuild(tris)
    rays = primary_rays(scenes.sponza_camera(), 1024, 1024, order="block",
                        device="cuda")
    hits = s.trace(rays, coherent=True)
    p, n, found = hit_points_normals(rays, hits, tris.n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ao = integrators.ao_rays(p, n, found,
                             integrators.default_ao_distance(s), gen)
    bounce = integrators._spawn(p, n, cosine_hemisphere(n, gen), 0.0,
                                torch.where(found, float("inf"), 0.0))
    g = s.grid

    def sort(w):
        return sortrays.sort_rays(w, g.bbox_lo, g.bbox_hi, bits=10,
                                  origin_major=True)[0]
    return dict(v=v, tris=tris, session=s, rays=rays, hits=hits, ao=ao,
                ao_sorted=sort(ao), bounce_sorted=sort(bounce))


def _probe(grid, rays, **kw):
    """trace_sweep at a generous budget (16k blocks for a coherent wave,
    512k otherwise, 4M live rows for the row budget), doubled until the
    wave completes: (hits, bmax, rowmax)."""
    from hagrid_tpu_torch.ops.sweep_trace import trace_sweep
    coherent = kw.get("coherent", False)
    rows = kw.get("compact", None)
    bmax = 1 << (15 if coherent else 19)
    rowmax = 1 << 22 if (not coherent if rows is None else rows) else None
    for _ in range(4):
        hits, ovf = trace_sweep(grid, rays, bmax=bmax, rowmax=rowmax,
                                return_overflow=True, **kw)
        if not bool(ovf):
            return hits, bmax, rowmax
        bmax, rowmax = 2 * bmax, rowmax and 2 * rowmax
    raise AssertionError("the wave overflowed every probe budget")


def _sample_against_oracle(rays, hits, tris, any_hit, k=4096, seed=0):
    """k sampled rays against the brute-force oracle on the card: any
    hit, hit/miss on more than 99.9%; closest hit, _check's thresholds
    and tri ids on more than 99.5% of the rays both hit."""
    idx = torch.as_tensor(np.random.default_rng(seed).choice(
        rays.count, min(k, rays.count), replace=False), device=rays.org.device)
    sub = rays.take(idx)
    if any_hit:
        want = oracle.any_hit(sub, tris)
        assert ((hits.tri_id[idx] >= 0) == want).float().mean() > 0.999
        return
    want = oracle.closest_hit(sub, tris)
    got = Hits(*(getattr(hits, k)[idx] for k in ("tri_id", "t", "u", "v")))
    _check_on_card(got, want)
    both = (got.tri_id >= 0) & (want.tri_id >= 0)
    assert (got.tri_id[both] == want.tri_id[both]).float().mean() > 0.995


def _against_other_hits(got, want):
    """A wave's hits against other hits of the same rays: hit/miss and t
    (rtol 1e-3) on more than 99.9% of the rays, tri ids on more than
    99.5% of the rays both hit."""
    _check_on_card(got, want)
    both = (got.tri_id >= 0) & (want.tri_id >= 0)
    assert (got.tri_id[both] == want.tri_id[both]).float().mean() > 0.995


def _stream_against_plain(grid, stream, any_hit, bit_equal=False):
    """The sweep kernel against its plain version on one round-0 stream,
    over the rays of swept tiles: the launch plan equals its plain
    version; any hit, hit/miss equal and no kernel hit closer than the
    plain closest; closest hit, ids equal on 99.99% and t within rtol
    1e-5 where they are. bit_equal: closest hit, ids and the bits of t,
    u and v equal on every such ray."""
    xt, gidx, tile_of, tminb, tile = stream
    args = (xt, grid.cols, gidx, tile_of, tminb, tile)
    nt = xt.shape[1] // tile - 1
    chunk = sk.chunk_blocks(tile_of.numel())
    for a, w in zip(sk.chunk_plan(tile_of, nt, chunk),
                    sk.chunk_plan_plain(tile_of, nt, chunk)):
        assert torch.equal(a, w)
    got = sweep_blocks(*args, any_hit=any_hit)
    ref = sweep_blocks_plain(*args, any_hit=any_hit)
    swept = torch.zeros(nt + 1, dtype=torch.bool, device=xt.device)
    swept[tile_of.long()] = True
    rows = swept[:nt].repeat_interleave(tile)
    m = rows.numel()
    assert int(rows.sum()) > 0
    if any_hit:
        hit = got[1][:m][rows] >= 0
        assert torch.equal(hit, ref[1][:m][rows] >= 0)
        assert bool((got[0][:m][rows][hit] >= ref[0][:m][rows][hit]).all())
    elif bit_equal:
        assert torch.equal(got[1][:m][rows], ref[1][:m][rows])
        for k in (0, 2, 3):
            assert torch.equal(got[k][:m][rows].view(torch.int32),
                               ref[k][:m][rows].view(torch.int32)), k
    else:
        same = got[1][:m][rows] == ref[1][:m][rows]
        assert same.float().mean() >= 0.9999
        hit = same & (got[1][:m][rows] >= 0)
        torch.testing.assert_close(got[0][:m][rows][hit],
                                   ref[0][:m][rows][hit], rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["primary-refine", "primary-adaptive",
                                  "ao-refine", "ao-fine", "path-fine"])
def test_option_streams_at_sponza_scale_on_card(sponza_waves, case):
    """The packet grid's options on the Sponza-scale scene's waves: the
    1024x1024 primaries on the refined and on the adaptive grid, AO wave
    0 on the refined grid and with fine ray bins, path bounce 1 with
    fine ray bins. Each wave launches the kernel, completes without
    overflow and agrees with the oracle on 4096 sampled rays
    (primaries: also with the default grid's frame); its round-0 stream
    through the kernel agrees with the plain version
    (_stream_against_plain)."""
    from hagrid_tpu_torch.ops.sweep_trace import first_round_stream
    w = sponza_waves
    wave, opt = case.split("-")
    grid = (build_packet(w["tris"], **{opt: True}) if opt != "fine"
            else w["session"].grid)
    rays = {"primary": w["rays"], "ao": w["ao_sorted"],
            "path": w["bounce_sorted"]}[wave]
    kw = dict(any_hit=wave == "ao", coherent=wave == "primary",
              fine_bins=opt == "fine")
    name = "sweep_blocks_anyhit" if kw["any_hit"] else "sweep_blocks"
    before = launches[name]
    hits, bmax, rowmax = _probe(grid, rays, **kw)
    assert launches[name] > before
    _sample_against_oracle(rays, hits, w["tris"], kw["any_hit"])
    if wave == "primary":
        _against_other_hits(hits, w["hits"])
    _stream_against_plain(grid, first_round_stream(
        grid, rays, bmax=bmax, rowmax=rowmax, **kw), kw["any_hit"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["primary-compact", "ao-dense"])
def test_planners_at_sponza_scale_on_card(sponza_waves, monkeypatch, case):
    """The planner apart from the layout on the Sponza-scale scene: the
    1024x1024 primaries through the compact planner, AO wave 0 through
    the dense one. No call of sweep_blocks_plain, the kernel launched,
    no overflow; the primaries agree with the default coherent frame
    and the oracle, the dense AO wave's hit/miss equals the compact
    planner's on every ray and agrees with the oracle; the round-0
    stream through the kernel equals its plain version bit for bit."""
    from hagrid_tpu_torch.ops.sweep_trace import (first_round_stream,
                                                  trace_sweep)
    w = sponza_waves
    grid = w["session"].grid
    primary = case == "primary-compact"
    rays = w["rays"] if primary else w["ao_sorted"]
    kw = dict(any_hit=not primary, coherent=primary, compact=primary)
    _, bmax, rowmax = _probe(grid, rays, **kw)
    name = "sweep_blocks" if primary else "sweep_blocks_anyhit"
    with monkeypatch.context() as mp:
        mp.setattr(sk, "sweep_blocks_plain", _refuse("sweep_blocks_plain"))
        before = launches[name]
        hits, ovf = trace_sweep(grid, rays, bmax=bmax, rowmax=rowmax,
                                return_overflow=True, **kw)
        torch.cuda.synchronize()
    assert launches[name] > before and not bool(ovf)
    _sample_against_oracle(rays, hits, w["tris"], not primary)
    if primary:
        _against_other_hits(hits, w["hits"])
    else:
        compact, _, _ = _probe(grid, rays, any_hit=True)
        assert torch.equal(hits.tri_id >= 0, compact.tri_id >= 0)
    _stream_against_plain(grid, first_round_stream(
        grid, rays, bmax=bmax, rowmax=rowmax, **kw), not primary,
        bit_equal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("structure", ["irregular", "uniform"])
def test_lockstep_at_sponza_scale_on_card(sponza_waves, monkeypatch,
                                          structure, any_hit):
    """trace_irregular / trace_uniform on the Sponza-scale scene's grids,
    on the 1024x1024 primaries (closest hit) and on AO wave 0 (any hit):
    one launch of the march kernel a call and never trace_wavefront,
    trace_plain or segment_plain, no ray truncated; on 2^16 sampled rays
    the tri ids and the bits of t/u/v equal trace_wavefront's on the
    card, which truncates none either."""
    from hagrid_tpu_torch.ops import wavefront
    w = sponza_waves
    s = RenderSession.create(w["tris"], structure=structure, verts=w["v"])
    g = s.grid
    rays = w["ao"] if any_hit else w["rays"]
    if structure == "irregular":
        entry, args = irregular.trace_irregular, (
            g.tris, g.lookup, g.cell_starts, g.ref_ids, g.bbox_lo,
            g.bbox_hi, g.fine_dims)
    else:
        entry, args = uniform.trace_uniform, (
            g.tris, lambda vox: uniform.uniform_lookup(g, vox),
            g.cell_starts, g.ref_ids, g.bbox_lo, g.bbox_hi, g.dims)
    with monkeypatch.context() as mp:
        for name in ("trace_wavefront", "trace_plain", "segment_plain"):
            mp.setattr(wavefront, name, _refuse(name))
        before = wavefront.launches["wavefront_march"]
        got = entry(g, rays, any_hit=any_hit)
        assert wavefront.launches["wavefront_march"] == before + 1
        assert wavefront.last_trace_stats["truncated_rays"] == 0
    idx = torch.as_tensor(np.random.default_rng(5).choice(
        rays.count, 1 << 16, replace=False), device="cuda")
    want = wavefront.trace_wavefront(rays.take(idx), *args, any_hit=any_hit)
    assert wavefront.last_trace_stats["truncated_rays"] == 0
    _assert_hits_bit_equal(
        Hits(*(getattr(got, k)[idx] for k in ("tri_id", "t", "u", "v"))),
        want, structure)
    assert (got.tri_id >= 0).any()


@pytest.mark.gpu
def test_reference_options_at_sponza_scale_on_card(sponza_waves):
    """The reference's options on the Sponza-scale scene's session:
    trace_sorted of AO wave 0 with sort "origin", "octant" and False
    (each its own budgets, none overflowed) agree on hit/miss with the
    origin sort on more than 99.9% of the rays; default_ao_distance
    from the host bounds equals the device read; ambient_occlusion at
    that max_dist equals the default call bit for bit, and at half of
    it darkens no pixel; path_trace(sky=2.0) on the Cornell box at
    512x512, 4 bounces, is exactly twice the default image."""
    w = sponza_waves
    s, ao = w["session"], w["ao"]
    sorts = {sort: integrators.trace_sorted(s, ao, any_hit=True, sort=sort,
                                            cal_key=f"ao {sort}")
             for sort in ("origin", "octant", False)}
    assert not s.poll_overflow(recalibrate=False)
    base = sorts["origin"].tri_id >= 0
    for sort, h in sorts.items():
        assert ((h.tri_id >= 0) == base).float().mean() > 0.999, sort
    g = s.grid
    dist = integrators.default_ao_distance(s)
    assert dist == float((g.bbox_hi - g.bbox_lo).max()) * 0.1

    def occlusion(max_dist=None):
        gen = torch.Generator(device="cuda").manual_seed(11)
        return integrators.ambient_occlusion(s, w["rays"], w["hits"], gen,
                                             max_dist=max_dist)
    ao_def = occlusion()
    assert torch.equal(ao_def, occlusion(dist))
    assert bool((occlusion(0.5 * dist) >= ao_def).all())
    assert not s.poll_overflow(recalibrate=False)
    cv, cf = scenes.cornell_box()
    box = RenderSession.create(Triangles.from_mesh(cv, cf, device="cuda"),
                               verts=cv)
    p1 = integrators.path_trace(box, scenes.cornell_camera(), 512, 512,
                                max_bounces=4)
    p2 = integrators.path_trace(box, scenes.cornell_camera(), 512, 512,
                                max_bounces=4, sky=2.0)
    assert not box.poll_overflow(recalibrate=False)
    assert float(p1.mean()) > 0 and torch.equal(p2, 2.0 * p1)
