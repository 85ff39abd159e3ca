#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (hagrid_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile [PATH]] [--variants]

Phases, one line each (any failure exits non-zero before the result):
1. the card (nvidia-smi name and power limit) and the environment;
2. build of the CUDA kernels from hagrid_tpu_torch/csrc (nvcc, sm_90a),
   ptxas's registers and spills;
3. the closest-hit sweep kernel against its plain PyTorch version on the
   card: the Sponza-scale scene's round-0 stream of a 1024x1024 frame
   (gather call and pre-gathered call) and a random stream, with both
   times, the blocks the early-out skipped and the kernel's bound, the
   stream's blocks per tile against the card's resident CTA slots and the
   sweep's launch plan, which must equal its plain version ([balance]);
   with --variants, the kernel at other chunk sizes ([variants]);
4. the main path at full size: RenderSession.create, 3 warm rebuilds,
   1024x1024 block-order primaries, coherent trace (times on the card);
5. correctness: 4096 sampled rays against the brute-force oracle on the
   card, and a 128x128 eye-light render against the oracle's render and
   the JAX package's dhash;
6. with --profile only, run last: torch.profiler over the warm frame, the
   warm rebuild, one AO wave, render_ao and ambient_occlusion (device
   time by op, device busy and idle share against the host wall time of
   synced runs); the full per-op list goes to PATH if given;
7. the any-hit sweep kernel (K3) against its plain version: the round-0
   stream of the first AO wave of the Sponza frame (4 samples' shape,
   max_dist 0.1 x the largest extent, origin-sorted, binned) and a random
   stream with finite tmax; hit/miss must agree exactly; [balance] (and
   [variants]) as in phase 3;
8. the incoherent slice at full width through the user's entry points:
   render_ao 1024x1024 x 4 samples, one shadow wave, path_trace 512x512
   x 1 spp x 4 bounces (times on the card, calibrated budgets, overflow,
   kernel launches, per run);
9. correctness on the card: 4096 sampled AO, shadow and path-bounce-1
   rays against the brute-force oracle, and the AO image's mean; then the
   closest-hit kernel against its plain version on path bounce 1's
   round-0 stream (tile 256, the calibrated "path" budgets), with its
   time, bound, [balance] (and [variants]);
10. dynamic frames at full width: AnimatedScene on the Sponza-scale scene,
   a fresh session with a motion margin, one untimed frame (calibration),
   then 5 frames of rebuild + 1024x1024 coherent trace (frames per second
   by the host clock, ms per frame between CUDA events), overflow polled
   and the frames re-timed if one clipped, and 4096 sampled rays of the
   last deformed frame against the oracle on that frame's triangles;
11. the sweep-cost micro-kernels K4-K7 (det-only sweep, FP32 dots, bf16
   and bf16x3 tensor-core dots) against their plain versions at the
   reference scripts' full shapes, with their bounds (K4 timed from CUDA
   graph replays, as path A times it); K5-K7, of which
   only the last block's sums come back, also have every block's column
   sums compared and are timed at B and B/2 blocks (the ratio shows the
   time covers every block); then the
   two records through the entry points a user calls
   (hagrid_tpu_torch.exp.kernel_mt20.run and .mxu_micro.run) with the
   launch counts from zero.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from hagrid_tpu_torch import oracle, scenes
from hagrid_tpu_torch.core.camera import block_index, primary_rays
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.exp import kernel_mt20, mxu_micro
from hagrid_tpu_torch.grid.packet import build_packet, rays_to_x
from hagrid_tpu_torch.io.image import dhash, hamming, shade_eyelight
from hagrid_tpu_torch.ops import _build, sortrays
from hagrid_tpu_torch.ops import micro_kernels as mk
from hagrid_tpu_torch.ops import sweep_kernel as sk
from hagrid_tpu_torch.ops.sweep_kernel import sweep_blocks, sweep_blocks_plain
from hagrid_tpu_torch.ops.sweep_trace import _BIG_BITS, first_round_stream
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.dynamic import AnimatedScene
from hagrid_tpu_torch.render.sampling import (cosine_hemisphere,
                                              hit_points_normals)
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils.config import BuildParams

# tests/test_golden.py pins this dhash for the 128x128 Sponza eye-light
# render, but the JAX package's session and oracle both render
# scenes.SPONZA_EYELIGHT_DHASH (hamming 44 from the pin; held by
# tests/test_torch_sweep.py::test_sponza_eyelight_reference_dhash). The
# pin is reported, not checked.
PINNED_GOLDEN = "2d2d6b4ae9c9eff3"
HAM_TOL = 6
TILE = 512
KERNEL_SOURCE = "hagrid_tpu_torch/csrc/sweep.cu"
MICRO_SOURCE = "hagrid_tpu_torch/csrc/micro.cu"
# One __global__ stands for both TPU schedules of the sweep: the gather
# call replaces _make_kernel_dma (K2), the pre-gathered call _make_kernel
# (K1).
REPLACES = ("hagrid_tpu/ops/sweep_trace.py:248 (K2, _make_kernel_dma); "
            "hagrid_tpu/ops/sweep_trace.py:210 (K1, _make_kernel)")
REPLACES_ANYHIT = ("hagrid_tpu/ops/sweep_trace.py:132-133,179-180 (K3, the "
                   "any_hit=True instances of K1/K2)")
# FP32 operations per ray-ref pair, counted from HitBody::test in
# csrc/sweep.cu: 5 (det) + 6 (t*det) + 11 (u*det) + 11 (v*det) + 1 (w) + 2
# (a*hi, a*lo) + 2 (us+vs, a+w) + 6 compares, for both instances (any hit
# folds tmax into hi). The exact path of the few pairs the test passes is
# not counted, so the bound stays a lower bound.
OPS_PER_PAIR = {False: 44, True: 44}
REFS_PER_BLOCK = 768
# One H100 SXM (NVIDIA's data sheet, at 700 W): FP32 outside the tensor
# cores, and HBM3. The peak counts an FMA as 2 operations; the kernel is
# built with -fmad=false, so each of its operations is one instruction,
# issued at half that rate (the second bound printed).
FP32_PEAK = 67e12
FP32_ISSUE = FP32_PEAK / 2
BF16_PEAK = 989e12             # dense bf16 on the tensor cores
HBM_RATE = 3.35e12
# FP32 operations per ray-ref pair of the micro-kernels (csrc/micro.cu):
# K4 3 multiplies + 2 adds + 1 min; K5 the four linear forms (5 + 6 + 11
# + 11) and the 4 adds into the row's accumulator.
DET_OPS_PER_PAIR = 6
DOTS_OPS_PER_PAIR = 37
DYN_FRAMES = 5
# K6/K7 against their plain versions: the tensor cores accumulate the 16
# products of a step and the 24 (72 for bf16x3) steps in another order
# than an f32 matmul followed by adds.
BF16_TOL = 1e-4
# K5's FMA instance against the plain version, which rounds the multiply
# and the add of each of its 33 multiply-adds separately.
FMA_TOL = 1e-5
AO_SIZE, AO_SAMPLES = 1024, 4
LIGHT = (15.0, 14.0, 6.0)       # inside the closed 30 x 15 x 12 hall
PATH_SIZE, PATH_BOUNCES = 512, 4
DEV = "cuda"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=1):
    """Mean device milliseconds of fn() over `iters` back-to-back runs,
    between two CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def swept_rays(tile_of, n_cols, tile):
    """bool[nt * tile]: the rays of tiles that own at least one block."""
    nt = n_cols // tile - 1
    swept = torch.zeros(nt + 1, dtype=torch.bool, device=tile_of.device)
    swept[tile_of.long()] = True
    return swept[:nt].repeat_interleave(tile)


def compare_sweeps(name, got, ref, tile_of, tile=TILE):
    """Kernel vs plain on one stream: ids equal on >= 99.99% of the rays
    of swept tiles (the plain version ignores the early-out, which can
    only matter on exact-t ties at a threshold), t within rtol 1e-5 where
    the ids agree. Returns max |dt| over rays with equal hit ids."""
    rays = swept_rays(tile_of, got[0].numel(), tile)
    n = rays.numel()
    t_k, id_k = got[0][:n][rays], got[1][:n][rays]
    t_p, id_p = ref[0][:n][rays], ref[1][:n][rays]
    same = id_k == id_p
    agree = float(same.float().mean()) if same.numel() else 1.0
    hit = same & (id_k >= 0)
    dt = (t_k[hit] - t_p[hit]).abs()
    max_err = float(dt.max()) if dt.numel() else 0.0
    t_ok = bool((dt <= 1e-5 * t_p[hit].abs()).all())
    print(f"[kernel] {name}: {int(rays.sum())} rays in swept tiles, "
          f"{int((id_k >= 0).sum())} hits, id agreement {agree:.6f}, "
          f"max |dt| {max_err:.3e} (t rtol 1e-5: {t_ok})", flush=True)
    check(agree >= 0.9999, f"{name}: ids agree on only {agree:.6f}")
    check(t_ok, f"{name}: t differs beyond rtol 1e-5")
    return max_err


def random_stream(grid, device, nt=64, seed=0, tile=TILE, any_hit=False):
    """(xt, gidx, tile_of, tminb) of a random sweep over `grid`: random
    rays inside the scene box, tiles with 0..3 blocks, dead rays and dead
    tiles, random units including the dead unit, unused blocks at the
    end, never-skip and random early-out thresholds. any_hit: a third of
    the rays get a finite tmax (0.5-20) and every threshold is the
    any-hit one (the largest float below BIG)."""
    rng = np.random.default_rng(seed)
    n_cols = (nt + 1) * tile
    lo = grid.bbox_lo.cpu().numpy()
    hi = grid.bbox_hi.cpu().numpy()
    org = rng.uniform(lo, hi, (n_cols, 3)).astype(np.float32)
    d = rng.normal(size=(n_cols, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n_cols, np.inf, np.float32)
    if any_hit:
        fin = rng.random(n_cols) < 0.33
        tmax[fin] = rng.uniform(0.5, 20, n_cols)[fin]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    x = rays_to_x(t(org), t(d), t(np.zeros(n_cols, np.float32)), t(tmax))
    xt = x.t().contiguous()
    seed_t = np.where(rng.random(n_cols) < 0.1, -3e38, 3e38)
    seed_t[rng.random(nt + 1).repeat(tile) < 0.1] = -3e38   # dead tiles
    seed_t[nt * tile:] = -3e38
    xt[14] = t(seed_t.astype(np.float32))
    tile_of = np.concatenate([np.repeat(np.arange(nt),
                                        rng.integers(0, 4, nt)),
                              np.full(17, nt)]).astype(np.int32)
    nb = tile_of.size
    gidx = rng.integers(0, grid.cols.shape[0] // 4, nb * 32)
    thr = rng.uniform(0, 20, nb).astype(np.float32).view(np.int32)
    tminb = np.where(rng.random(nb) < 0.7, 0, thr)
    if any_hit:
        tminb[:] = _BIG_BITS - 1
    return (xt, t(gidx.astype(np.int32)), t(tile_of),
            t(tminb.astype(np.int32)))


def both_sweeps(xt, cols, gidx, tile_of, tminb, tile=TILE, any_hit=False):
    args = (xt, cols, gidx, tile_of, tminb, tile)
    got = sweep_blocks(*args, any_hit=any_hit)
    ref = sweep_blocks_plain(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    return got, ref, args


def times(args, card, what, any_hit=False, plain_iters=3):
    ms = cuda_ms(lambda: sweep_blocks(*args, any_hit=any_hit), iters=20,
                 warmup=2)
    plain_ms = cuda_ms(lambda: sweep_blocks_plain(*args, any_hit=any_hit),
                       iters=plain_iters, warmup=0)
    print(f"[kernel] {what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"({card})", flush=True)
    return ms, plain_ms


def bound(args, any_hit, what):
    """The least time the card could take for this stream: the larger of
    the FP32 operations of the pairs the kernel actually sweeps (live
    blocks less the blocks its early-out skips, counted by the kernel)
    over the FP32 peak, and the bytes the function must move (xt, the
    block tables and the distinct units read once, the outputs written
    once) over the HBM rate. The pairs include dead lanes (padding refs
    and dead rays) and, for any hit, rays that already hit inside a block
    that was not skipped. Returns a dict of the counts, the bound and the
    operations' time at the non-FMA issue rate."""
    xt, cols, gidx, tile_of, tminb, tile = args
    nt = xt.shape[1] // tile - 1
    skipped = torch.zeros(nt, dtype=torch.int32, device=xt.device)
    sweep_blocks(*args, any_hit=any_hit, skipped=skipped)
    live_blocks = tile_of < nt
    live = int(live_blocks.sum())
    skip = int(skipped.sum())
    pairs = (live - skip) * REFS_PER_BLOCK * tile
    units = gidx.reshape(-1, 32)[live_blocks].unique().numel()
    nbytes = (xt.numel() * 4 + units * cols.shape[1] * 4 * 4
              + (gidx.numel() + 2 * tile_of.numel()) * 4
              + 4 * xt.shape[1] * 4)
    ops_ms = pairs * OPS_PER_PAIR[any_hit] / FP32_PEAK * 1e3
    issue_ms = pairs * OPS_PER_PAIR[any_hit] / FP32_ISSUE * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    out = dict(live_blocks=live, blocks_skipped=skip, pairs=pairs,
               bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               bound_ms_no_fma=max(issue_ms, bytes_ms))
    print(f"[bound] {what}: {live} live blocks, {skip} skipped by the "
          f"early-out, {pairs} pairs swept x {OPS_PER_PAIR[any_hit]} FP32 "
          f"ops = {ops_ms:.4f} ms at {FP32_PEAK / 1e12:.0f} TFLOP/s; "
          f"{nbytes} bytes = {bytes_ms:.4f} ms at {HBM_RATE / 1e12:.2f} "
          f"TB/s; bound {out['bound_ms']:.4f} ms by {out['bound_by']}; at "
          f"the non-FMA issue rate {FP32_ISSUE / 1e12:.1f} T/s "
          f"{out['bound_ms_no_fma']:.4f} ms", flush=True)
    return out


def run_lengths(tile_of, nt):
    """Blocks per tile over the tiles that own at least one live block:
    (tiles, blocks, mean, p50, p90, p99, max)."""
    per = torch.bincount(tile_of[tile_of < nt].long(), minlength=nt)
    per = per[per > 0].double()
    if per.numel() == 0:
        return dict(tiles=0, blocks=0, mean=0.0, p50=0.0, p90=0.0, p99=0.0,
                    max=0)
    q = torch.quantile(per, torch.tensor([0.5, 0.9, 0.99], device=per.device,
                                         dtype=torch.float64)).tolist()
    return dict(tiles=per.numel(), blocks=int(per.sum()),
                mean=float(per.mean()), p50=q[0], p90=q[1], p99=q[2],
                max=int(per.max()))


def balance(what, args, any_hit, ms, b):
    """What sets a sweep's time on one stream: the distribution of blocks
    per tile, the launch plan's chunks (C, CTAs with work, the longest
    chunk) against the card's resident slots (occupancy calculator x
    SMs), and the tail: the longest chunk times one CTA's time per block,
    where one CTA's time per block is the kernel's time x the busy slots
    / the blocks swept (every slot busy, each at 1/slots of the card).
    The plan is the plan kernel's, which must equal its plain version."""
    xt, tile_of, tile = args[0], args[3], args[5]
    nt = xt.shape[1] // tile - 1
    rl = run_lengths(tile_of, nt)
    per_sm, sms = sk.resident_ctas(tile, any_hit)
    slots = per_sm * sms
    chunk = sk.chunk_blocks(tile_of.numel())
    plan = sk.chunk_plan(tile_of, nt, chunk)
    same = all(torch.equal(a, w) for a, w in zip(
        plan, sk.chunk_plan_plain(tile_of, nt, chunk)))
    check(same, f"{what}: the plan kernel differs from its plain version")
    table = plan[0]
    counts = table[:, 2][table[:, 2] > 0]
    ctas = counts.numel()
    longest = int(counts.max()) if ctas else 0
    swept = max(1, b["live_blocks"] - b["blocks_skipped"])
    block_ms = ms * min(slots, ctas) / swept
    tail_ms = longest * block_ms
    print(f"[balance] {what}: {rl['tiles']} tiles own {rl['blocks']} "
          f"blocks, blocks per tile mean {rl['mean']:.2f}, p50 "
          f"{rl['p50']:.0f}, p90 {rl['p90']:.0f}, p99 {rl['p99']:.0f}, max "
          f"{rl['max']}; C {chunk}: {ctas} CTAs with work of {table.shape[0]}"
          f" launched, against {slots} resident slots ({per_sm} a SM x "
          f"{sms} SMs); one CTA's time per block {block_ms:.4f} ms; longest "
          f"chunk ({longest} blocks) x that = {tail_ms:.3f} ms beside the "
          f"kernel's {ms:.3f} ms; plan kernel equal to its plain version "
          f"{same}", flush=True)


def variants(what, args, any_hit, card, chunks=(8, 16, 32, 64, None)):
    """The kernel's time on one stream at other chunk sizes C (None: whole
    runs, one CTA a tile, the parent's balance), between two timings of
    the default, all in this call."""
    n_blocks = args[3].numel()
    rows = [("default", None)]
    rows += [(f"C={c or 'whole'}", c or n_blocks) for c in chunks]
    rows.append(("default again", None))
    got = []
    for name, c in rows:
        ms = cuda_ms(lambda: sk._sweep_cuda(*args, any_hit, None, c),
                     iters=5, warmup=1)
        got.append((name, ms))
    print(f"[variants] {what} ({card}): " + ", ".join(
        f"{n} {ms:.3f} ms" for n, ms in got), flush=True)


def tri_rows(cols, n_tris):
    """f32[n_tris, 20]: each triangle's coefficient row of the linear
    Moller-Trumbore form, taken from the grid's group rows (every ref of
    a tri carries the same row; zero rows are padding)."""
    rows = cols[:, :120].reshape(-1, 20)
    rows = rows[rows[:, :16].abs().sum(1) > 0]
    table = torch.zeros((n_tris, 20), dtype=torch.float32, device=cols.device)
    table[rows[:, 16].long()] = rows
    return table


def linear_hit(x, g):
    """The kernel's acceptance test (HitBody::exact in csrc/sweep.cu, with
    the any-hit t < tmax) of rays x f32[16, k] against coefficient rows
    g f32[k, 20], op for op: (ok, t)."""
    ox, oy, oz, dx, dy, dz, mx, my, mz = x[1:10]
    n0, n1, n2, b0, b1, b2, c0, c1, c2, d0, d1, d2, e0, e1, e2, f = g[:, :16].t()
    det = dx * n0 + dy * n1 + dz * n2
    tt = f - (ox * n0 + oy * n1 + oz * n2)
    uu = mx * b0 + my * b1 + mz * b2 + dx * c0 + dy * c1 + dz * c2
    vv = mx * d0 + my * d1 + mz * d2 + dx * e0 + dy * e1 + dz * e2
    inv = 1.0 / det
    t, u, v = tt * inv, uu * inv, vv * inv
    ok = ((u >= 0) & (v >= 0) & (1.0 - (u + v) >= 0) & (det.abs() > 1e-12)
          & (t > x[12]) & (t < x[13]))
    return ok, t


def compare_anyhit(name, got, ref, args, rows):
    """Any-hit kernel vs plain on one stream, over the rays of swept
    tiles: hit/miss must be equal (a tile is skipped only once every live
    ray has hit). The kernel keeps the closest hit of the blocks it swept,
    so each kernel hit must be a genuine hit: the kernel's own acceptance
    test recomputed for (ray, tri) accepts it at exactly the kernel's t,
    inside (tmin, tmax), and no closer than the plain version's closest t.
    Returns the max |hit_kernel - hit_plain| (0 or 1)."""
    xt, tile = args[0], args[5]
    rays = swept_rays(args[3], xt.shape[1], tile)
    n = rays.numel()
    hit_k = got[1][:n][rays] >= 0
    hit_p = ref[1][:n][rays] >= 0
    n_diff = int((hit_k != hit_p).sum())
    t_k, t_p = got[0][:n][rays][hit_k], ref[0][:n][rays][hit_k]
    x = xt[:, :n][:, rays][:, hit_k]
    ok, t = linear_hit(x, rows[got[1][:n][rays][hit_k].long()])
    genuine = bool((ok & (t == t_k)).all())
    not_closer = bool((t_k >= t_p).all())
    print(f"[kernel] {name}: {int(rays.sum())} rays in swept tiles, "
          f"{int(hit_k.sum())} kernel hits, {int(hit_p.sum())} plain hits, "
          f"hit/miss differ on {n_diff}; every kernel hit genuine at its t "
          f"inside (tmin, tmax): {genuine}; t >= plain t: {not_closer} "
          f"({int((t_k > t_p).sum())} behind the closest)", flush=True)
    check(n_diff == 0, f"{name}: hit/miss differs on {n_diff} rays")
    check(genuine, f"{name}: a kernel hit is not genuine")
    check(not_closer, f"{name}: a kernel hit is closer than the closest")
    return float(n_diff > 0)


def reset_launches():
    for counts in (sk.launches, mk.launches):
        for k in counts:
            counts[k] = 0


def sample(n, k=4096, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).choice(
        n, min(k, n), replace=False), device=DEV)


def check_anyhit_sample(name, wave, hits, tris):
    """4096 sampled rays of an any-hit wave: hit/miss against the on-card
    brute-force oracle on > 99.9% of them."""
    idx = sample(wave.count)
    want = oracle.any_hit(wave.take(idx), tris)
    agree = float(((hits.tri_id[idx] >= 0) == want).float().mean())
    print(f"[oracle] {name}: {idx.numel()} sampled rays, {int(want.sum())} "
          f"blocked "
          f"by the oracle, hit/miss agreement {agree:.5f}", flush=True)
    check(agree > 0.999, f"{name}: hit/miss disagrees with the oracle")


def check_closest_sample(name, wave, hits, tris):
    """4096 sampled rays against the oracle's closest hit, with
    tests/test_sweep_trace.py::_check's thresholds."""
    idx = sample(wave.count)
    want = oracle.closest_hit(wave.take(idx), tris)
    got_id = hits.tri_id[idx]
    got_hit, ref_hit = got_id >= 0, want.tri_id >= 0
    t_close = torch.isclose(hits.t[idx], want.t, rtol=1e-3, atol=1e-5)
    agree = float(((got_hit == ref_hit) & (~ref_hit | t_close))
                  .float().mean())
    both = got_hit & ref_hit
    id_rate = float((got_id[both] == want.tri_id[both]).float().mean()) \
        if bool(both.any()) else 1.0
    print(f"[oracle] {name}: {idx.numel()} sampled rays, "
          f"{int(ref_hit.sum())} hits, "
          f"hit/miss+t agreement {agree:.5f}, id agreement {id_rate:.5f}",
          flush=True)
    check(agree > 0.999, f"{name}: hits disagree with the oracle")
    check(id_rate > 0.995, f"{name}: tri ids disagree with the oracle")


def profile(what, fn, card, path, runs=3):
    """Device time of `runs` back-to-back calls of fn by op
    (torch.profiler), against the host wall time of `runs` synced single
    calls: device busy per call and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3 / runs
    ops = [(e.self_device_time_total / 1e3 / runs, e.count // runs, e.key)
           for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    # Kernels launched outside any torch op: the ctypes-bound CUDA kernels.
    ops.append((busy - sum(ms for ms, _, _ in ops), 0, "(no torch op)"))
    ops.sort(reverse=True)
    check(busy > 0, f"the profiler saw no device time in the {what}")
    wall = min(walls)
    top = ", ".join(f"{k} {ms:.3f} ms" for ms, _, k in ops[:6])
    print(f"[profile] {what}: host wall {wall:.3f}-{max(walls):.3f} ms "
          f"per synced call; device busy {busy:.3f} ms per call, idle "
          f"share {max(0.0, 1 - busy / wall):.3f} ({card}); by op: {top}",
          flush=True)
    if path:
        with open(path, "a") as out:
            out.write(f"# {what}, {card}: device ms per call, calls per "
                      f"call, op\n")
            out.writelines(f"{ms:.4f}\t{n}\t{k}\n" for ms, n, k in ops)


def anyhit_phase(session, rays, hits, tris, card, with_variants):
    """Phase 7: the first AO sample's wave of the Sponza frame, traced
    once through trace_sorted (which calibrates the "ao" budgets), then
    its round-0 stream at those budgets, and a random stream with finite
    tmax: the any-hit kernel against its plain version, both times, the
    skip count and the bound."""
    grid = session.grid
    p, n, found = hit_points_normals(rays, hits, tris.n)
    gen = torch.Generator(device=DEV).manual_seed(0)
    max_dist = integrators.default_ao_distance(session)
    wave = integrators.ao_rays(p, n, found, max_dist, gen)
    t0 = time.perf_counter()
    wave_hits = integrators.trace_sorted(session, wave, any_hit=True,
                                         cal_key="ao")
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    bmax, rowmax = session._bmax_cal[(True, False, wave.count, "ao")]
    srt, _ = sortrays.sort_rays(wave, grid.bbox_lo, grid.bbox_hi, bits=10,
                                origin_major=True)
    xt, gidx, tile_of, tminb, tile = first_round_stream(
        grid, srt, any_hit=True, coherent=False, bmax=bmax, rowmax=rowmax)
    nt = xt.shape[1] // tile - 1
    print(f"[anyhit] AO wave 0 ({wave.count} rays, max_dist {max_dist:.4f},"
          f" {int(found.sum())} live): calibration {cal_s:.2f} s, budgets "
          f"({bmax}, {rowmax}); round-0 stream {int((tile_of < nt).sum())} "
          f"blocks of {tile_of.numel()} budgeted, tile {tile}", flush=True)
    got, ref, args = both_sweeps(xt, grid.cols, gidx, tile_of, tminb, tile,
                                 any_hit=True)
    rows = tri_rows(grid.cols, tris.count)
    err = compare_anyhit("any-hit kernel (K3), Sponza AO wave 0 round 0",
                         got, ref, args, rows)
    ms, plain_ms = times(args, card, "any-hit kernel (K3) at Sponza AO wave "
                         "0 round 0", any_hit=True, plain_iters=1)
    b = bound(args, True, "any-hit sweep, Sponza AO wave 0 round 0")
    balance("any-hit sweep, Sponza AO wave 0 round 0", args, True, ms, b)
    if with_variants:
        variants("any-hit sweep, Sponza AO wave 0 round 0", args, True, card)
    del got, ref
    rxt, rgidx, rtile_of, rtminb = random_stream(
        grid, DEV, nt=64, seed=1, tile=tile, any_hit=True)
    got_r, ref_r, rargs = both_sweeps(rxt, grid.cols, rgidx, rtile_of,
                                      rtminb, tile, any_hit=True)
    err_r = compare_anyhit("any-hit kernel (K3), random stream with finite "
                           "tmax", got_r, ref_r, rargs, rows)
    return dict(wave=wave, wave_hits=wave_hits, err=max(err, err_r), ms=ms,
                plain_ms=plain_ms, bound=b)


def slice_phase(session, cam, card):
    """Phase 8: render_ao (1024^2 x 4 samples), one shadow wave toward
    LIGHT and path_trace (512^2, 1 spp, 4 bounces), each first run once
    (calibrating its budgets; poll_overflow then grows any that
    overflowed), then timed with the launch counts from zero. Returns the
    counts of the timed runs, the AO image and the timed calls."""
    def gen():
        return torch.Generator(device=DEV).manual_seed(0)

    runs = dict(
        render_ao=lambda: integrators.render_ao(
            session, cam, AO_SIZE, AO_SIZE, seed=0, n_samples=AO_SAMPLES),
        path_trace=lambda: integrators.path_trace(
            session, cam, PATH_SIZE, PATH_SIZE, seed=0, spp=1,
            max_bounces=PATH_BOUNCES))
    t0 = time.perf_counter()
    ao_img, prim = runs["render_ao"]()
    prim_rays = primary_rays(cam, AO_SIZE, AO_SIZE, order="block",
                             device=DEV)
    runs["shadow"] = lambda: integrators.shadow(session, prim_rays, prim,
                                                LIGHT)
    runs["ambient_occlusion"] = lambda: integrators.ambient_occlusion(
        session, prim_rays, prim, gen(), n_samples=AO_SAMPLES)
    for what in ("shadow", "path_trace"):
        runs[what]()
    torch.cuda.synchronize()
    grew = session.poll_overflow(recalibrate=True)
    print(f"[slice] first runs (calibration) {time.perf_counter() - t0:.2f} "
          f"s; overflow grown after them: {grew}", flush=True)
    reset_launches()
    ms, per_run = {}, {}
    for what, fn in runs.items():
        before = dict(sk.launches)
        ms[what] = cuda_ms(fn, iters=2, warmup=0)
        per_run[what] = {k: n - before[k] for k, n in sk.launches.items()}
    torch.cuda.synchronize()
    launches = dict(sk.launches)
    ovf = session.poll_overflow(recalibrate=False)
    n_ao = AO_SAMPLES * AO_SIZE * AO_SIZE
    n_path = PATH_BOUNCES * PATH_SIZE * PATH_SIZE
    print(f"[slice] render_ao {AO_SIZE}^2 x {AO_SAMPLES}: "
          f"{ms['render_ao']:.3f} ms (primary + AO); ambient_occlusion "
          f"alone {ms['ambient_occlusion']:.3f} ms = "
          f"{n_ao / ms['ambient_occlusion'] / 1e3:.2f} secondary Mrays/s; "
          f"shadow wave {ms['shadow']:.3f} ms = "
          f"{AO_SIZE * AO_SIZE / ms['shadow'] / 1e3:.2f} Mrays/s; "
          f"path_trace {PATH_SIZE}^2 x 1 spp x {PATH_BOUNCES} bounces "
          f"{ms['path_trace']:.3f} ms = {n_path / ms['path_trace'] / 1e3:.2f}"
          f" Mray slots/s ({card})", flush=True)
    cal = {str(k): v for k, v in session._bmax_cal.items()}
    print(f"[slice] calibrated (bmax, rowmax) per key (any_hit, coherent, "
          f"rays, cal_key): {cal}; kernel launches in the timed runs "
          f"{launches}, by run {per_run}; poll_overflow {ovf}", flush=True)
    check(not ovf, "the timed incoherent runs overflowed their budgets")
    check(launches["sweep_blocks_anyhit"] > 0,
          "the timed runs did not launch the any-hit kernel")
    check(per_run["path_trace"]["sweep_blocks"] > 0,
          "the timed path runs did not launch the closest-hit kernel")
    launches["path_trace"] = per_run["path_trace"]["sweep_blocks"]
    return launches, ao_img, runs


def correctness_phase(session, wave, wave_hits, rays, hits, cam, tris,
                      ao_img, card, with_variants):
    """Phase 9: 4096 sampled rays of an AO wave and of a shadow wave
    against oracle.any_hit, 4096 rays of path bounce 1 against
    oracle.closest_hit (_check's thresholds), and the AO image's mean;
    then the closest-hit kernel against its plain version on path bounce
    1's round-0 stream (binned, incoherent, tile 256, the calibrated
    "path" budgets): the stream path_trace spends most on. Returns that
    stream's numbers."""
    check_anyhit_sample("AO wave 0", wave, wave_hits, tris)
    p, n, found = hit_points_normals(rays, hits, tris.n)
    sh, _ = integrators.shadow_rays(p, n, found, LIGHT)
    sh_hits = integrators.trace_sorted(session, sh, any_hit=True,
                                       cal_key="shadow")
    check_anyhit_sample("shadow wave", sh, sh_hits, tris)
    # Path bounce 1, made as path_trace makes it.
    gen = torch.Generator(device=DEV).manual_seed(0)
    npix = PATH_SIZE * PATH_SIZE
    jitter = torch.rand((npix, 2), generator=gen, device=DEV)
    prim = primary_rays(cam, PATH_SIZE, PATH_SIZE, jitter=jitter,
                        order="block", device=DEV)
    ph = session.trace(prim, coherent=True)
    p, nrm, found = hit_points_normals(prim, ph, tris.n)
    d = cosine_hemisphere(nrm, gen)
    b1 = integrators._spawn(p, nrm, d, 0.0,
                            torch.where(found, float("inf"), 0.0))
    b1_hits = integrators.trace_sorted(session, b1, cal_key="path")
    check_closest_sample("path bounce 1", b1, b1_hits, tris)
    path = path_bounce_stream(session, b1, card, with_variants)
    mean = float(ao_img.mean())
    print(f"[image] AO {AO_SIZE}^2 x {AO_SAMPLES} mean {mean:.4f}",
          flush=True)
    check(0.0 < mean < 1.0, f"AO image mean {mean} outside (0, 1)")
    check(not session.poll_overflow(recalibrate=False),
          "the correctness waves overflowed")
    return path


def path_bounce_stream(session, b1, card, with_variants):
    """K2 on path bounce 1's round-0 stream, made as trace_sorted makes
    it: kernel against plain (ids, t), times, skip count, bound and
    balance."""
    grid = session.grid
    bmax, rowmax = session._bmax_cal[(False, False, b1.count, "path")]
    srt, _ = sortrays.sort_rays(b1, grid.bbox_lo, grid.bbox_hi, bits=10,
                                origin_major=True)
    xt, gidx, tile_of, tminb, tile = first_round_stream(
        grid, srt, any_hit=False, coherent=False, bmax=bmax, rowmax=rowmax)
    nt = xt.shape[1] // tile - 1
    print(f"[path] bounce 1 ({b1.count} rays): budgets ({bmax}, {rowmax}); "
          f"round-0 stream {int((tile_of < nt).sum())} blocks of "
          f"{tile_of.numel()} budgeted, tile {tile}", flush=True)
    got, ref, args = both_sweeps(xt, grid.cols, gidx, tile_of, tminb, tile)
    err = compare_sweeps("closest-hit kernel (K2), path bounce 1 round 0",
                         got, ref, tile_of, tile)
    del got, ref
    ms, plain_ms = times(args, card, "closest-hit kernel (K2) at path bounce "
                         "1 round 0", plain_iters=1)
    b = bound(args, False, "closest-hit sweep, path bounce 1 round 0")
    balance("closest-hit sweep, path bounce 1 round 0", args, False, ms, b)
    if with_variants:
        variants("closest-hit sweep, path bounce 1 round 0", args, False,
                 card)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=b)


def dynamic_phase(v, f, rays, card):
    """Phase 10: the dynamic-scene frame loop at full width, as the
    reference's bench drives it: a fresh session whose bbox has room for
    the wave's 0.25-unit motion, per frame a deformed mesh, a warm rebuild
    and a coherent trace, no host read inside the loop."""
    anim = AnimatedScene(v, f)
    ext = v.max(0) - v.min(0)
    margin = float(0.26 / max(float(ext.min()), 1e-6))
    t0 = time.perf_counter()
    session = RenderSession.create(anim.frame(0.0), BuildParams.dynamic(),
                                   "packet", verts=v, bbox_margin=margin)

    def frame(t):
        session.rebuild(anim.frame(t))
        return session.trace(rays, coherent=True)

    frame(0.0)                                  # calibrates the budget
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    times = [0.1 * (i + 1) for i in range(DYN_FRAMES)]

    def run():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        start.record()
        hits = [frame(t) for t in times]
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        return (DYN_FRAMES / wall, start.elapsed_time(end) / DYN_FRAMES,
                hits[-1])

    reset_launches()
    fps, ms, hits = run()
    launches = sk.launches["sweep_blocks"]
    retimed = 0
    while retimed < 2 and session.poll_overflow():   # grows what clipped
        retimed += 1
        print(f"[dynamic] a frame overflowed its calibrated budget; grown, "
              f"re-timing ({retimed})", flush=True)
        fps, ms, hits = run()
    ovf = session.poll_overflow(recalibrate=False)
    grid_ovf = bool(session.grid.overflowed)
    hit_frac = float((hits.tri_id >= 0).float().mean())
    print(f"[dynamic] {DYN_FRAMES} frames of deform + rebuild + trace "
          f"1024x1024 coherent: {fps:.3f} frames/s by the host clock, "
          f"{ms:.3f} ms/frame between CUDA events ({card}); session + "
          f"calibration frame {cal_s:.2f} s, bbox margin {margin:.5f}, "
          f"budget {list(session._bmax_cal.values())}, "
          f"{session.describe()}; sweep launches in the first timed run "
          f"{launches}; re-timed {retimed}x; poll_overflow {ovf}; "
          f"grid.overflowed {grid_ovf}; hit fraction {hit_frac:.4f}",
          flush=True)
    check(launches >= DYN_FRAMES, "dynamic frames did not launch the sweep")
    check(not grid_ovf, "a dynamic rebuild overflowed the ref capacity")
    check(not ovf, "dynamic frames still overflow after re-calibration")
    check(0.5 < hit_frac <= 1.0, f"implausible hit fraction {hit_frac}")
    check_closest_sample(f"dynamic frame t={times[-1]:.1f}", rays, hits,
                         anim.frame(times[-1]))
    return dict(fps=fps, ms=ms, launches=launches)


def max_diff(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def timed_pair(what, fn, fn_half, plain, card):
    """Kernel ms at the full block count and at half of it, and the plain
    version's ms (None without `plain`); fails unless full / half lies in
    1.6-2.4 (a kernel that did only its last block's work would give 1)."""
    ms = cuda_ms(fn, iters=20, warmup=2)
    ms_half = cuda_ms(fn_half, iters=20, warmup=2)
    plain_ms = cuda_ms(plain, iters=1, warmup=0) if plain else None
    ratio = ms / ms_half
    print(f"[micro] {what}: kernel {ms:.4f} ms, at half the blocks "
          f"{ms_half:.4f} ms (ratio {ratio:.3f})"
          + (f", plain {plain_ms:.3f} ms" if plain else "") + f" ({card})",
          flush=True)
    check(1.6 <= ratio <= 2.4, f"{what}: time at B / time at B/2 = "
          f"{ratio:.3f}, outside 1.6-2.4")
    return ms, plain_ms


def micro_bound(what, ops, rate, nbytes):
    ops_ms = ops / rate * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"[bound] {what}: {ops:.4g} operations = {ops_ms:.4f} ms at "
          f"{rate / 1e12:.0f} T/s; {nbytes} bytes = {bytes_ms:.4f} ms at "
          f"{HBM_RATE / 1e12:.2f} TB/s; bound {max(ops_ms, bytes_ms):.4f} "
          f"ms by {by}", flush=True)
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by=by)


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def micro_phase(card, dev):
    """Phase 11: K4-K7 against their plain versions at full shape, their
    times and bounds, then path A's two records with launch counts from
    zero. Returns the kernels' entries for the JSON line."""
    entries = {}
    # K4 on the decomposition's stream: never done, always done, and a
    # threshold of +0.0 on every second block (skipped once all mins < 0).
    xt, cols, gidx, tile_of, live, dead = kernel_mt20.synthetic_stream(
        device=DEV)
    nb = tile_of.numel()
    mixed = torch.where(torch.arange(nb, device=DEV) % 2 == 1,
                        torch.zeros_like(live), live)
    err = 0.0
    for name, thr in (("never done", live), ("always done", dead),
                      ("every second block at +0.0", mixed)):
        args = (xt, cols, gidx, tile_of, thr, TILE)
        got, want = mk.det_sweep(*args), mk.det_sweep_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(err, max_diff(got, want))
        print(f"[micro] det_sweep (K4), {nb} blocks x {TILE} rays, "
              f"thresholds {name}: equal to plain {same}", flush=True)
        check(same, f"det_sweep differs from its plain version ({name})")
    # Every tile's output was compared above, so K4 needs no B against
    # B/2 timing (its fixed part, the `skipped` time, is a fifth of it).
    # Timed from CUDA graph replays, as path A times it: device time, no
    # host time between the calls (replays do not pass the launch count).
    chain = 4
    ms = cuda_ms(kernel_mt20.graphed(
        lambda: mk.det_sweep(xt, cols, gidx, tile_of, live, TILE), chain,
        dev), iters=5, warmup=1) / chain
    plain_ms = cuda_ms(lambda: mk.det_sweep_plain(xt, cols, gidx, tile_of,
                                                  live, TILE),
                       iters=1, warmup=0)
    print(f"[micro] det_sweep (K4): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms ({card})", flush=True)
    b = micro_bound("det_sweep (K4)", nb * REFS_PER_BLOCK * TILE
                    * DET_OPS_PER_PAIR, FP32_PEAK,
                    nbytes(xt, cols, gidx, tile_of, tile_of, live)
                    + 4 * xt.shape[1] * 4)
    entries["det_sweep"] = dict(
        name="det_sweep", replaces="exp/r3_kernel_mt20.py:45 (K4, "
        "make_det_kernel)", max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)
    del xt, cols, gidx, tile_of, live, dead, mixed, got, want

    xt, g, phi, c = mxu_micro.inputs(device=DEV)
    n_blocks = g.shape[0] // mk.BLOCK_ROWS
    hb = n_blocks // 2
    pairs = n_blocks * REFS_PER_BLOCK * TILE
    got, want = mk.dots_fp32(xt, g), mk.dots_fp32_plain(xt, g)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"[micro] dots_fp32 (K5), {n_blocks} blocks x {TILE} rays: last "
          f"block's sums and all {n_blocks} blocks' column sums equal to "
          f"plain {same}", flush=True)
    check(same, "dots_fp32 differs from its plain version")
    ms, plain_ms = timed_pair(
        "dots_fp32 (K5)", lambda: mk.dots_fp32(xt, g),
        lambda: mk.dots_fp32(xt, g[:hb * mk.BLOCK_ROWS]),
        lambda: mk.dots_fp32_plain(xt, g), card)
    b = micro_bound("dots_fp32 (K5)", pairs * DOTS_OPS_PER_PAIR, FP32_PEAK,
                    nbytes(xt, g, *got))
    entries["dots_fp32"] = dict(
        name="dots_fp32", replaces="exp/r4_mxu_micro.py:68 (K5, vpu_kernel)",
        max_abs_err=max_diff(got, want), ms=ms, plain_ms=plain_ms, **b)
    # The same kernel with explicit FMAs: one rounding per multiply-add
    # where the plain version has two.
    got_f = mk.dots_fp32(xt, g, fma=True)
    torch.cuda.synchronize()
    errs = [float((a - w).abs().max()) for a, w in zip(got_f, want)]
    tols = [FMA_TOL * float(w.abs().max()) for w in want]
    print(f"[micro] dots_fp32_fma (K5 with FMAs): last block's sums max "
          f"|err| {errs[0]:.3e} (tolerance {tols[0]:.3e}), column sums max "
          f"|err| {errs[1]:.3e} (tolerance {tols[1]:.3e})", flush=True)
    check(errs[0] <= tols[0] and errs[1] <= tols[1],
          f"dots_fp32_fma differs from the plain version beyond {FMA_TOL} "
          f"x max|ref|")
    ms, _ = timed_pair(
        "dots_fp32_fma", lambda: mk.dots_fp32(xt, g, fma=True),
        lambda: mk.dots_fp32(xt, g[:hb * mk.BLOCK_ROWS], fma=True), None,
        card)
    entries["dots_fp32_fma"] = dict(
        name="dots_fp32_fma", replaces="exp/r4_mxu_micro.py:68 (K5, "
        "vpu_kernel; the instance with explicit FMAs)", max_abs_err=errs[0],
        ms=ms, plain_ms=plain_ms, **b)

    flops = 2 * n_blocks * mk.BLOCK_C_ROWS * mk.DOT_DEPTH * TILE
    exact = (c[-mk.BLOCK_C_ROWS:].double().reshape(-1, mk.BLOCK_ROWS,
                                                   mk.DOT_DEPTH).sum(0)
             @ phi.double())
    for split, key, rep in (
            (False, "dots_bf16", "exp/r4_mxu_micro.py:89 (K6, mxu1_kernel)"),
            (True, "dots_bf16x3",
             "exp/r4_mxu_micro.py:101 (K7, mxu3_kernel)")):
        got = mk.dots_bf16(phi, c, split=split)
        want = mk.dots_bf16_plain(phi, c, split=split)
        torch.cuda.synchronize()
        errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
        tols = [BF16_TOL * float(w.abs().max()) for w in want]
        rel64 = float((got[0].double() - exact).abs().max()
                      / exact.abs().max())
        print(f"[micro] {key}, {n_blocks} blocks x {TILE} rays: last "
              f"block's sums max |err| {errs[0]:.3e} (tolerance "
              f"{tols[0]:.3e}), column sums of all blocks max |err| "
              f"{errs[1]:.3e} (tolerance {tols[1]:.3e}); the kernel's last "
              f"block against the f64 product: relative error "
              f"{rel64:.3e}", flush=True)
        check(errs[0] <= tols[0] and errs[1] <= tols[1],
              f"{key} differs from its plain version beyond {BF16_TOL} x "
              f"max|ref|")
        check(rel64 < (1e-4 if split else 2e-2),
              f"{key}: relative error {rel64} against f64")
        ms, plain_ms = timed_pair(
            key, lambda: mk.dots_bf16(phi, c, split=split),
            lambda: mk.dots_bf16(phi, c[:hb * mk.BLOCK_C_ROWS], split=split),
            lambda: mk.dots_bf16_plain(phi, c, split=split), card)
        b = micro_bound(key, flops * (3 if split else 1), BF16_PEAK,
                        nbytes(phi, c, *got))
        entries[key] = dict(name=key, replaces=rep, max_abs_err=errs[0],
                            ms=ms, plain_ms=plain_ms, rel_err_f64=rel64, **b)
    del xt, g, phi, c, got, want

    # Path A through its entry points, every count from zero.
    reset_launches()
    rec_a = kernel_mt20.run()
    rec_b = mxu_micro.run()
    torch.cuda.synchronize()
    counts = dict(mk.launches)
    print(f"[path A] kernel_mt20 ({card}):\n{kernel_mt20.report(rec_a)}",
          flush=True)
    print(f"[path A] mxu_micro ({card}):\n{mxu_micro.report(rec_b)}",
          flush=True)
    print(f"[path A] records: {json.dumps(rec_a)} {json.dumps(rec_b)}; "
          f"launches {counts}, production sweep "
          f"{sk.launches['sweep_blocks']}", flush=True)
    for key, n in counts.items():
        check(n > 0, f"path A did not launch {key}")
    check(sk.launches["sweep_blocks"] > 0,
          "path A did not launch the production sweep")
    for rec in (rec_a, rec_b):
        check(all(np.isfinite(x) and x > 0 for k, x in rec.items()
                  if isinstance(x, float)), f"non-finite record {rec}")
    check(rec_a["skipped_ms"] < rec_a["det3_ms"] < rec_a["full_ms"],
          "the decomposition is not ordered skipped < det3 < full")
    for key, e in entries.items():
        # No single PyTorch call computes a kernel's fused row-group sums.
        e.update(route="cuda", source=MICRO_SOURCE, launches=counts[key],
                 library_ms=None)
    return list(entries.values())


def main(profile_path=False, with_variants=False) -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    check("jax" not in sys.modules, "the port pulled in jax")

    # 1. card and environment
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    ptxas = [ln.strip() for ln in _build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln
             or "entry function" in ln]
    print(f"[build] {_build.last_build['path']} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.last_build['seconds']:.1f} s); ptxas: "
          f"{' | '.join(ptxas)}", flush=True)

    # The scene and the 1M-ray frame, shared by phases 3-5.
    t0 = time.perf_counter()
    v, f = scenes.sponza_like()
    tris = Triangles.from_mesh(v, f, device=dev)
    cam = scenes.sponza_camera()
    rays = primary_rays(cam, 1024, 1024, order="block", device=dev)
    print(f"[scene] sponza_like: {tris.count} tris, {rays.count} rays "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 3. kernel against plain on the card
    grid = build_packet(tris)
    xt, gidx, tile_of, tminb, _ = first_round_stream(grid, rays, tile=TILE)
    print(f"[kernel] Sponza round-0 stream: "
          f"{int((tile_of < rays.count // TILE).sum())} blocks of "
          f"{tile_of.numel()} budgeted, dims3 {grid.dims3}", flush=True)
    got, ref, args = both_sweeps(xt, grid.cols, gidx, tile_of, tminb)
    err = compare_sweeps("gather call (K2), Sponza round 0", got, ref,
                         tile_of)
    ms, plain_ms = times(args, card, "gather call at Sponza 1024^2 round 0")
    bound_k12 = bound(args, False, "closest-hit sweep, Sponza 1024^2 round 0")
    balance("closest-hit sweep, Sponza 1024^2 round 0", args, False, ms,
            bound_k12)
    if with_variants:
        variants("closest-hit sweep, Sponza 1024^2 round 0", args, False,
                 card, chunks=(4, None))
    # The pre-gathered (K1) call: the gathered stream as cols, gidx = arange.
    g_round = grid.cols.reshape(-1, 4, 128)[gidx.long()].reshape(-1, 128)
    seq = torch.arange(gidx.numel(), dtype=torch.int32, device=dev)
    got1, _, args1 = both_sweeps(xt, g_round, seq, tile_of, tminb)
    err1 = compare_sweeps("pre-gathered call (K1), Sponza round 0", got1,
                          ref, tile_of)
    check(all(torch.equal(a, b) for a, b in zip(got1, got)),
          "pre-gathered call differs from the gather call")
    ms1, plain_ms1 = times(args1, card,
                           "pre-gathered call at Sponza 1024^2 round 0")
    rxt, rgidx, rtile_of, rtminb = random_stream(grid, dev)
    got_r, ref_r, _ = both_sweeps(rxt, grid.cols, rgidx, rtile_of, rtminb)
    err_r = compare_sweeps("random stream (dead tiles, unused blocks)",
                           got_r, ref_r, rtile_of)
    del g_round, got, ref, got1, got_r, ref_r, args, args1

    # 4. main path: every count from zero, then the user's entry points
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session = RenderSession.create(tris, structure="packet", verts=v)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rebuild_ms = cuda_ms(lambda: session.rebuild(tris), iters=3, warmup=0)
    check(not bool(session.grid.overflowed), "warm rebuild overflowed")
    t0 = time.perf_counter()
    session.trace(rays, coherent=True)          # calibrates the budget
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    before = sk.launches["sweep_blocks"]
    frames = 5
    frame_ms = cuda_ms(lambda: session.trace(rays, coherent=True),
                       iters=frames, warmup=1)
    hits = session.trace(rays, coherent=True)
    torch.cuda.synchronize()
    timed_launches = sk.launches["sweep_blocks"] - before
    launches = sk.launches["sweep_blocks"]
    ovf = session.poll_overflow(recalibrate=False)
    hit_frac = float((hits.tri_id >= 0).float().mean())
    print(f"[main] cold create {cold_s:.2f} s; warm rebuild "
          f"{rebuild_ms:.3f} ms ({card}); {session.describe()}", flush=True)
    print(f"[main] trace 1024x1024 coherent: {frame_ms:.3f} ms/frame = "
          f"{rays.count / frame_ms / 1e3:.2f} Mrays/s ({card}); "
          f"calibration {cal_s:.2f} s, budget "
          f"{list(session._bmax_cal.values())} blocks; hit fraction "
          f"{hit_frac:.4f}; sweep launches {launches} "
          f"({timed_launches} in the timed frames); overflow {ovf}",
          flush=True)
    check(timed_launches >= frames, "timed frames did not launch the "
          "sweep kernel")
    check(not bool(session.grid.overflowed), "grid overflowed")
    check(not ovf, "trace overflowed its calibrated budget")
    check(0.5 < hit_frac <= 1.0, f"implausible hit fraction {hit_frac}")

    # 5a. 4096 sampled rays against the oracle on the card, with
    # tests/test_sweep_trace.py::_check's thresholds
    check_closest_sample("primary frame", rays, hits, tris)

    # 5b. 128x128 eye-light render in block order, reassembled, held
    # against the oracle's render and the JAX package's
    small = primary_rays(cam, 128, 128, order="block", device=dev)
    h2 = session.trace(small, coherent=True)
    want = oracle.closest_hit(small, tris)
    id_eq = float((h2.tri_id == want.tri_id).float().mean())
    pix = block_index(128, 128)
    normals = tris.n.cpu().numpy()

    def render_hash(h):
        tri = np.empty(128 * 128, np.int32)
        dirs = np.empty((128 * 128, 3), np.float32)
        tri[pix] = h.tri_id.cpu().numpy()
        dirs[pix] = small.dir.cpu().numpy()
        return dhash(shade_eyelight(tri, None, normals, dirs, 128, 128))

    hsh, hsh_oracle = render_hash(h2), render_hash(want)
    ham_o = hamming(hsh, hsh_oracle)
    ham_ref = hamming(hsh, scenes.SPONZA_EYELIGHT_DHASH)
    print(f"[golden] sponza eyelight 128x128: dhash {hsh}; ids equal the "
          f"oracle's on {id_eq:.5f} of pixels, oracle render {hsh_oracle} "
          f"(hamming {ham_o}); JAX package render "
          f"{scenes.SPONZA_EYELIGHT_DHASH} (hamming {ham_ref}); pinned "
          f"golden {PINNED_GOLDEN} (hamming {hamming(hsh, PINNED_GOLDEN)},"
          f" stale, not checked); tolerance {HAM_TOL}", flush=True)
    check(id_eq > 0.999, "render ids disagree with the oracle")
    check(ham_o <= HAM_TOL, "render differs from the oracle's render")
    check(ham_ref <= HAM_TOL, "render differs from the JAX package's")
    check(not session.poll_overflow(recalibrate=False),
          "golden render overflowed")

    # 7. the any-hit kernel (K3) against its plain version
    ao = anyhit_phase(session, rays, hits, tris, card, with_variants)

    # 8. the incoherent slice through the user's entry points
    slice_launches, ao_img, slice_runs = slice_phase(session, cam, card)

    # 9. correctness of the incoherent waves on the card
    path = correctness_phase(session, ao["wave"], ao["wave_hits"], rays, hits,
                             cam, tris, ao_img, card, with_variants)

    # 10. dynamic frames at full width
    dyn = dynamic_phase(v, f, rays, card)

    # 11. the sweep-cost micro-kernels and path A's records
    micro_kernels = micro_phase(card, dev)

    # 6. optional device-time breakdown, run last
    if profile_path is not False:
        for what, fn in (("frame", lambda: session.trace(rays, coherent=True)),
                         ("warm rebuild", lambda: session.rebuild(tris)),
                         ("AO wave", lambda: integrators.trace_sorted(
                             session, ao["wave"], any_hit=True,
                             cal_key="ao")),
                         ("render_ao", slice_runs["render_ao"]),
                         ("ambient_occlusion",
                          slice_runs["ambient_occlusion"])):
            profile(what, fn, card, profile_path)

    # ms/plain_ms: the gather call (the main path's); *_pregathered: the
    # same kernel called K1's way in phase 3, which the main path never
    # makes. launches: the main path's count (phase 4 for closest hit,
    # phase 8 for any hit, phase 11's records for K4-K7); the dynamic
    # frames' sweep launches ride on the closest-hit entry. No single
    # PyTorch call computes the sweep: library_ms is null.
    kernels = [
        dict(name="sweep_blocks", route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES, launches=launches,
             max_abs_err=max(err, err1, err_r, path["err"]), ms=ms,
             plain_ms=plain_ms,
             bound_ms=bound_k12["bound_ms"], bound_by=bound_k12["bound_by"],
             library_ms=None, blocks_skipped=bound_k12["blocks_skipped"],
             bound_ms_no_fma=bound_k12["bound_ms_no_fma"],
             ms_pregathered=ms1, plain_ms_pregathered=plain_ms1,
             launches_dynamic=dyn["launches"],
             launches_path=slice_launches["path_trace"],
             ms_incoherent=path["ms"], plain_ms_incoherent=path["plain_ms"],
             bound_ms_incoherent=path["bound"]["bound_ms"],
             blocks_skipped_incoherent=path["bound"]["blocks_skipped"]),
        dict(name="sweep_blocks_anyhit", route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES_ANYHIT,
             launches=slice_launches["sweep_blocks_anyhit"],
             max_abs_err=ao["err"], ms=ao["ms"], plain_ms=ao["plain_ms"],
             bound_ms=ao["bound"]["bound_ms"],
             bound_by=ao["bound"]["bound_by"], library_ms=None,
             blocks_skipped=ao["bound"]["blocks_skipped"],
             bound_ms_no_fma=ao["bound"]["bound_ms_no_fma"]),
        *micro_kernels]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", nargs="?", const=None, default=False,
                    metavar="PATH", help="add phase 6; write the full "
                    "per-op device times to PATH")
    ap.add_argument("--variants", action="store_true",
                    help="also time the sweep at other chunk sizes")
    try:
        a = ap.parse_args()
        sys.exit(main(a.profile, a.variants))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
