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
   warm rebuild, one AO wave, render_ao and ambient_occlusion, and
   phase 12's irregular primary frame, AO wave and uniform frame (device
   time by op, device busy, idle share against the host wall time of
   synced runs, device kernels a call); the full per-op list goes to
   PATH if given;
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
   time covers every block); K5's plain instance must equal its plain
   version bit for bit, its FMA instance and its library product
   (`dots_fp32_library`, one FP32 torch.mm: library_ms with its own
   bound) lie within the element bound of their rounding chains
   (micro_kernels.dots_fp32_exact), and the SM clock under load is
   sampled beside each instance ([k5] lines); K6/K7 also as one library
   product (`dots_bf16_library`, checked against the plain version and
   timed: library_ms, with its own byte bound); the SASS of K5 shows its
   row loop's FP32 instructions and shared loads per pair, no local
   memory, FFMA in the FMA instance only and bulk copies, and K6/K7's
   HGMMA and no local memory (hagrid_tpu_torch.exp.sass, [sass]); then the
   two records through the entry points a user calls
   (hagrid_tpu_torch.exp.kernel_mt20.run and .mxu_micro.run) with the
   launch counts from zero;
12. the paper's structures at full width on the Sponza-scale scene:
   RenderSession(structure="irregular") with BuildParams() (cold build,
   3 warm rebuilds, describe(), capacities, device memory,
   check_irregular on a sample of 2^20 voxels and (tri, voxel) pairs),
   a 1024x1024 block-order primary frame through the wavefront
   (ms, Mrays/s, hit fraction, wavefront.last_trace_stats with no
   truncated ray), one AO wave of 1,048,576 any-hit rays and one path
   bounce 1 of 1,048,576 closest-hit rays (made from the primary hits as
   path_trace makes its bounces) through trace_sorted, each with 4096
   sampled rays against the oracle; one warm rebuild with
   BuildParams.dynamic(); the uniform grid's build and the same primary
   frame; and the irregular and uniform builds of
   Cornell and a random soup on the card, whose integer tables must
   equal the CPU builds'. The four waves march in the wavefront march
   kernel (csrc/wavefront.cu, one launch a trace): its launch counts from
   zero before the irregular frame, and each wave must launch it once a
   trace; then each wave under torch.profiler (device kernels, torch ops,
   march and segment kernels a call, device busy and idle share against
   synced calls; one march kernel a call and no segment kernel), and each
   wave's last trace once more through the kernel and through its plain
   version trace_plain on the card: tri ids, the bits of t/u/v and every
   ray's steps equal, no ray truncated (the kernel's main-path instance,
   the one timed, and its work-counting instance); the kernel's time
   alone (back-to-back launches) at the trace's refill threshold and at
   others, the plain version's, the work the trace's data needs (the
   kernel's counters), SIMD efficiency and the bound (operations; bytes
   of the rays in and the hits out; the whole tables beside it as a
   ceiling on the rows read); the irregular primary and AO waves also in
   the per-row instance; ptxas's registers, stack and spills for each
   instance ([march] lines). With --profile, phase 6 adds the irregular
   primary frame, the AO wave and the uniform frame. One JSON line
   {"structures": ...} carries the numbers.
13. the packet grid's options at full width on the Sponza-scale scene:
   build_packet(refine=True) and (adaptive=True), cold and 3 warm
   rebuilds (refs against the default grid, rows refined by 2 and 4,
   device memory, check_packet on 256 sampled tris); with the launch
   counts from zero, a 1024x1024 coherent primary frame on each (K2:
   round-0 demand against the default grid's, 4096 sampled rays against
   the oracle, every hit against the default grid's), AO wave 0 on the
   refined grid (K3), and AO wave 0 (K3) and path bounce 1 (K2) with
   fine_bins=False and True on the default grid (demand, host wall,
   device busy and idle share); then the kernel against its plain
   version on each of those round-0 streams; refined and adaptive tables
   built on the card against the CPU's (sponza_like(2000), (20000)); the
   scene written as an OBJ and read by the native and the Python parser
   (equal arrays, times), load_scene(path) -> RenderSession -> a 1024x1024
   frame; shard_trace over every card and over two shards of this one
   (hits equal the unsharded frame), distributed's single-process
   no-ops; last, `python -m hagrid_tpu_torch.cli render | stats | bench
   --iters 3` for each structure at 256x256, nine processes at once
   (exit codes, the PNG, bench's JSON keys). One JSON line
   {"options": ...} carries the numbers.
14. the reference's options at full size through the user's entry points,
   every count from zero and no plain version allowed to run (the
   phase's main path fails if sweep_blocks_plain, trace_wavefront,
   trace_plain or segment_plain is called): the 1024x1024 primaries
   through trace_sweep(coherent=True, compact=True) and AO wave 0 through
   trace_sweep(any_hit=True, coherent=False, compact=False), each on
   budgets calibrated with return_demand, without overflow (peak round
   demand of both planners on both waves; the dense budget's reckoned
   bytes and the measured device memory peak); the AO wave through
   trace_sorted with sort="origin", "octant" and False, each under its
   own calibration key (host wall, peak demand, hit/miss against the
   origin sort); ambient_occlusion with max_dist = default_ao_distance
   (bit-equal to the default call, and the distance equal to the device
   read it replaces) and with half of it (no pixel darker); path_trace
   (sky=2.0) on the Cornell box at 512x512 (exactly twice the default
   image); trace_irregular and trace_uniform on the primaries and the
   irregular AO wave (one march launch a call, no ray truncated, host
   wall and CUDA-event times, the kernel alone and its bound). Then,
   outside the main path: the compact primaries against the default
   coherent call (rays that differ) and the oracle; each new round-0
   stream through the kernel against its plain version, bit for bit on
   every ray of a swept tile (K2: ids and t/u/v; K3: hit/miss), with
   both times and the bound; each lockstep entry point against
   trace_wavefront on the card on a 65,536-ray subset (tri ids and the
   bits of t/u/v, the plain version's time and truncated rays). One
   JSON line {"reference_options": ...} carries the numbers.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hagrid_tpu_torch import oracle, scenes
from hagrid_tpu_torch.core.camera import block_index, primary_rays
from hagrid_tpu_torch.core.types import Hits, Triangles
from hagrid_tpu_torch.exp import kernel_mt20, mxu_micro, sass
from hagrid_tpu_torch.grid import invariants, irregular, uniform
from hagrid_tpu_torch.grid.packet import build_packet, rays_to_x
from hagrid_tpu_torch.io import obj
from hagrid_tpu_torch.io.image import dhash, hamming, shade_eyelight
from hagrid_tpu_torch.ops import _build, sortrays, wavefront
from hagrid_tpu_torch.ops import micro_kernels as mk
from hagrid_tpu_torch.ops import sweep_kernel as sk
from hagrid_tpu_torch.ops.sweep_kernel import sweep_blocks, sweep_blocks_plain
from hagrid_tpu_torch.ops.sweep_trace import (_BIG_BITS, first_round_stream,
                                              trace_sweep)
from hagrid_tpu_torch.parallel import distributed, mesh
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.dynamic import AnimatedScene
from hagrid_tpu_torch.render.sampling import (cosine_hemisphere,
                                              hit_points_normals)
from hagrid_tpu_torch.render.session import RenderSession, _rung
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
# cores, and HBM3. The peak counts an FMA as 2 operations; the kernels are
# built with -fmad=false, so each operation of a function that rounds
# every operation (the sweep, K5) is one instruction, issued at half that
# rate: FP32_ISSUE.
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
# K5's FP32 instructions a pair when every operation is one (37), and in
# the FMA instance: 15 FFMA, 3 FMUL, 4 FADD (22). Its innermost loop does
# one row of a stream block: 6 refs x 8 rays of a thread.
DOTS_INSNS_PER_PAIR = {False: 37, True: 22}
K5_LOOP_PAIRS = 6 * 8
AO_SIZE, AO_SAMPLES = 1024, 4
LIGHT = (15.0, 14.0, 6.0)       # inside the closed 30 x 15 x 12 hall
PATH_SIZE, PATH_BOUNCES = 512, 4
# Phase 12: warm rebuilds and frames timed per structure, the voxel
# sample of check_irregular, and the integer tables that the card's
# builds must share with the CPU's.
STRUCT_REBUILDS, STRUCT_FRAMES = 3, 2
CHECK_SAMPLE = 1 << 20
IRREGULAR_TABLES = ("top_res_log", "top_offset", "entries", "cell_min",
                    "cell_max", "cell_starts", "ref_ids", "alive",
                    "preexpanded", "top_info", "erec", "num_entries",
                    "total_refs")
UNIFORM_TABLES = ("cell_starts", "ref_ids", "total_refs")
# The wavefront march kernel (phase 12). FP32 operations counted from
# csrc/wavefront.cu: per ref tested (mt_update) 9 (cross) + 5 (det) + 2
# (|det| > eps) + 1 (1/det) + 3 (o - v0) + 6 (u) + 9 (cross) + 6 (v) + 6
# (t) + 6 (the hit's compares and u + v) + 2 (t against the best); per cell
# exit 18 (the planes and their t, 6 an axis) + 2 (argmin) + 1 (isfinite)
# + 2 (terminated) + 6 (the exit point) + 6 (into voxel units) + 3 (floor)
# + 3 (to int); per ray 3 (1/d) + 24 (the slab test, 8 an axis) + 6 (its
# reductions with tmin, tmax) + 1 (enter <= exit), and per ray that starts
# alive 6 (the entry point) + 12 (its voxel) + 1 (t_cur). Integer work and
# selects are not counted.
MARCH_SOURCE = "hagrid_tpu_torch/csrc/wavefront.cu"
MARCH_REPLACES = ("hagrid_tpu/ops/wavefront.py:290-311 (_jit_segment: an XLA "
                  "while_loop of _make_body, no Pallas kernel) and the round "
                  "loop of trace, :350-418")
MARCH_OPS_PER_TEST = 55
MARCH_OPS_PER_EXIT = 41
MARCH_OPS_PER_RAY = 34
MARCH_OPS_PER_START = 19
# Bytes a ray, read once (org 12, dir 12, tmin, tmax) and written once
# (t, id, u, v, steps).
MARCH_RAY_BYTES = 32 + 20
# Bytes gathered in 32-byte sectors, by the kernel's lookup mode: a row
# gather (quad mode: one 192-byte row of 4 refs; per-row: a 48-byte row
# over 2 sectors; uniform: the ref id and the three 12-byte vertex rows,
# a sector each) and a cell fetch (top_info's sector and the 32-byte erec
# row; uniform: the sector of cell_starts[c], c + 1).
MARCH_ROW_BYTES = {0: 192, 1: 64, 2: 128}
MARCH_CELL_BYTES = {0: 64, 1: 64, 2: 32}
MARCH_MODE_NAMES = {0: "quad rows", 1: "per row", 2: "uniform"}
# Refill thresholds timed on each wave (wavefront.REFILL holds the ones a
# trace takes, by the wave's coherence),
# and the back-to-back launches timed for each.
MARCH_REFILLS = (32, 24, 16, 12, 8, 6, 4, 2, 1)
MARCH_ITERS = 10
# Phase 13: warm rebuilds per option grid, check_packet's tri sample, the
# scenes whose option tables the card must share with the CPU, the
# calibration probes' budgets (blocks by coherence, live rows), the CLI's
# image size (smaller than the frame: nine processes share the card) and
# its time limit.
OPT_WARM = 3
OPT_CHECK_SAMPLE = 256
OPT_TABLE_SCENES = (2000, 20000)
OPT_PROBE_BMAX = {True: 1 << 15, False: 1 << 19}
OPT_PROBE_ROWMAX = 1 << 22
OPT_CLI_SIZE = "256x256"
OPT_CLI_TIMEOUT = 400
# Phase 14: the bytes a block of the dense planner's budget holds in its
# items stage (ops/sweep_trace.py::_pack_units, counted: per gather unit,
# 32 a block, 8 for the start offsets and their prefix sum, 20 for the
# thresholds' i64 deltas, their prefix sum and its i32 cast, 4 the slots,
# 1 their mask, 8 the gather indices; per block 32 for its tile, marks,
# threshold and end), and the rays of a wave that trace_wavefront also
# marches on the card.
DENSE_ITEMS_BYTES_PER_BLOCK = 32 * (8 + 20 + 4 + 1 + 8) + 32
LOCKSTEP_SUBSET = 1 << 16
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
    for counts in (sk.launches, mk.launches, wavefront.launches):
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
    kernels = sum(e.count for e in events
                  if e.device_type == DeviceType.CUDA) / runs
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
          f"share {max(0.0, 1 - busy / wall):.3f}, {kernels:.0f} device "
          f"kernels per call ({card}); by op: {top}", flush=True)
    if path:
        with open(path, "a") as out:
            out.write(f"# {what}, {card}: device ms per call, calls per "
                      f"call, op\n")
            out.writelines(f"{ms:.4f}\t{n}\t{k}\n" for ms, n, k in ops)
    return dict(wall_ms=walls, busy_ms=busy, kernels=kernels,
                idle_share=max(0.0, 1 - busy / wall))


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
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=b, b1=b1)


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


def wall_and_device_ms(fn, iters):
    """(host wall ms per synced call, list of ms between CUDA events per
    call, last result) over `iters` calls."""
    walls, devs, out = [], [], None
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - w0) * 1e3)
        devs.append(start.elapsed_time(end))
    return walls, devs, out


def span(xs):
    return f"{min(xs):.3f}-{max(xs):.3f}"


def wave_record(name, wave, fn, tris, card, any_hit, min_hit=0.5):
    """Trace a wave through a wavefront session: one untimed call, then
    STRUCT_FRAMES timed; last_trace_stats (no truncated ray), 4096
    sampled rays against the oracle, and for closest hit a hit fraction
    above min_hit (a primary frame sees the scene almost everywhere; a
    bounce escapes through the scene's openings). Returns the wave's
    record and hits."""
    fn()
    walls, devs, hits = wall_and_device_ms(fn, STRUCT_FRAMES)
    stats = dict(wavefront.last_trace_stats)
    hit_frac = float((hits.tri_id >= 0).float().mean())
    mrays = [wave.count / ms / 1e3 for ms in devs]
    print(f"[structures] {name}: {wave.count} rays, host wall "
          f"{span(walls)} ms, {span(devs)} ms between CUDA events = "
          f"{span(mrays)} Mrays/s ({card}); hit fraction {hit_frac:.4f}; "
          f"last_trace_stats {stats}", flush=True)
    check(stats["truncated_rays"] == 0, f"{name}: rays were truncated")
    if any_hit:
        check_anyhit_sample(name, wave, hits, tris)
    else:
        check(min_hit < hit_frac <= 1.0, f"{name}: hit fraction "
              f"{hit_frac}")
        check_closest_sample(name, wave, hits, tris)
    return dict(rays=wave.count, wall_ms=walls, ms=devs, mrays_s=mrays,
                hit_fraction=hit_frac, **stats), hits


def build_record(name, session, tris, card):
    """Cold build (done by the caller) and STRUCT_REBUILDS warm rebuilds:
    host wall and device ms of each."""
    walls, devs, _ = wall_and_device_ms(lambda: session.rebuild(tris),
                                        STRUCT_REBUILDS)
    print(f"[structures] {name} warm rebuild x{STRUCT_REBUILDS}: host wall "
          f"{span(walls)} ms, {span(devs)} ms between CUDA events "
          f"({card}); {session.describe()}", flush=True)
    return dict(warm_wall_ms=walls, warm_ms=devs,
                describe=session.describe())


def tables_equal(a, b, fields):
    return [k for k in fields
            if not torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu())]


@contextlib.contextmanager
def trace_calls():
    """While active, every call of wavefront.trace is recorded (grid,
    lookup, rays, refs_per_iter, any_hit, coherent) and then run as it
    is."""
    calls, orig = [], wavefront.trace

    def rec(grid, lookup_fn, rays, refs_per_iter=2, any_hit=False, *a,
            coherent=False, **kw):
        calls.append((grid, lookup_fn, rays, refs_per_iter, any_hit,
                      coherent))
        return orig(grid, lookup_fn, rays, refs_per_iter, any_hit, *a,
                    coherent=coherent, **kw)

    wavefront.trace = rec
    try:
        yield calls
    finally:
        wavefront.trace = orig


def launch_census(fn, runs=3):
    """Host wall of `runs` synced calls of fn, then torch.profiler over
    `runs` back-to-back calls: device kernels, torch ops that launched
    device work, march and segment kernels and the march's device ms, the
    device busy time, each per call, and the idle share."""
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
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    cpu = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    march = [e for e in ev if "march_kernel" in e.key]
    busy = sum(e.self_device_time_total for e in ev) / 1e3 / runs
    check(busy > 0, "the profiler saw no device time in a wavefront wave")
    return dict(device_kernels=sum(e.count for e in ev) / runs,
                torch_ops=sum(e.count for e in cpu) / runs,
                march_kernels=sum(e.count for e in march) / runs,
                segment_kernels=sum(e.count for e in ev
                                    if "segment_kernel" in e.key) / runs,
                march_ms=sum(e.self_device_time_total for e in march)
                / 1e3 / runs,
                busy_ms=busy, wall_ms=walls,
                idle_share=max(0.0, 1 - busy / min(walls)))


def march_ms(call, refill=None, iters=MARCH_ITERS):
    """Device ms of one launch of the march kernel on a trace's inputs:
    the arguments packed once, then `iters` launches of the C entry point
    back to back, each between two CUDA events with the ray counter
    zeroed before its first event (the wrapper and its read stay out of
    the time; these launches bypass the wrapper's count). Returns (ms,
    blocks an SM, blocks launched). refill: the trace's own threshold
    by default."""
    grid, lk, rays, rpi, any_hit, coherent = call
    if refill is None:
        refill = wavefront.REFILL[coherent]
    mode, args, outs, stats, keep = wavefront.march_args(grid, lk, rays, rpi,
                                                         refill=refill)
    shape = wavefront.launch_march(mode, args, any_hit)   # warm-up
    pairs = []
    for _ in range(iters):
        stats.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wavefront.launch_march(mode, args, any_hit)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del outs, keep   # the launches wrote into these until here
    return sum(s.elapsed_time(e) for s, e in pairs) / iters, shape


def table_bytes(grid, mode):
    if mode == 2:
        t = grid.tris
        return nbytes(grid.cell_starts, grid.ref_ids, t.v0, t.e1, t.e2)
    return nbytes(grid.top_info, grid.erec, grid.ref_tris)


def hits_bits_diff(got, want):
    """The fields of two Hits that are not bit-equal, and max |dt| over
    rays that both hit."""
    bad = [] if torch.equal(got.tri_id, want.tri_id) else ["tri_id"]
    bad += [k for k in ("t", "u", "v")
            if not torch.equal(getattr(got, k).view(torch.int32),
                               getattr(want, k).view(torch.int32))]
    both = (got.tri_id >= 0) & (want.tri_id >= 0)
    dt = float((got.t - want.t)[both].abs().max()) if bool(both.any()) \
        else 0.0
    return bad, dt


def march_against_plain(name, call):
    """One trace through the kernel as the main path runs it
    (wavefront.trace without work counters: the instance that the main
    path launches and march_ms times), once more with the work counters
    (the counting instance), and once through trace_plain on the card, on
    the same inputs: for both kernel runs the tri ids, the bits of t/u/v
    and every ray's steps must equal the plain version's, and no ray may
    be truncated by either version. Returns (kernel run's stats, steps and
    work counters, the plain version's stats, max |dt|)."""
    grid, lk, rays, rpi, any_hit, coherent = call
    want_steps = torch.empty(rays.count, dtype=torch.int32, device=DEV)
    want = wavefront.trace_plain(grid, lk, rays, rpi, any_hit,
                                 steps=want_steps)
    plain_stats = dict(wavefront.last_trace_stats)
    steps = torch.empty_like(want_steps)
    got = wavefront.trace(grid, lk, rays, rpi, any_hit, coherent=coherent,
                          steps=steps)
    stats = dict(wavefront.last_trace_stats)
    work = torch.zeros(5, dtype=torch.int64, device=DEV)
    work_steps = torch.empty_like(want_steps)
    got_work = wavefront.trace(grid, lk, rays, rpi, any_hit,
                               coherent=coherent, steps=work_steps,
                               work=work)
    work_stats = dict(wavefront.last_trace_stats)
    bad, dt = hits_bits_diff(got, want)
    same_steps = torch.equal(steps, want_steps)
    bad_w, _ = hits_bits_diff(got_work, want)
    same_w = torch.equal(work_steps, want_steps)
    print(f"[march] {name} ({MARCH_MODE_NAMES[wavefront.kernel_mode(grid, lk)]}"
          f", {rays.count} rays): kernel (main-path instance) against "
          f"trace_plain on every ray: "
          f"{'tri ids and the bits of t/u/v equal' if not bad else f'{bad} DIFFER'}"
          f", steps {'equal' if same_steps else 'DIFFER'} "
          f"({stats['mean_steps']} against {plain_stats['mean_steps']} a "
          f"ray), truncated {stats['truncated_rays']} and "
          f"{plain_stats['truncated_rays']}, rounds {stats['rounds']} and "
          f"{plain_stats['rounds']}; max |dt| {dt}; counting instance: "
          f"{'hits equal' if not bad_w else f'{bad_w} DIFFER'}, steps "
          f"{'equal' if same_w else 'DIFFER'}, truncated "
          f"{work_stats['truncated_rays']}", flush=True)
    check(not bad and same_steps, f"{name}: the march kernel differs from "
          f"trace_plain ({bad}, steps equal: {same_steps})")
    check(not bad_w and same_w, f"{name}: the march kernel's counting "
          f"instance differs from trace_plain ({bad_w}, steps equal: "
          f"{same_w})")
    check(stats["truncated_rays"] == work_stats["truncated_rays"]
          == plain_stats["truncated_rays"] == 0, f"{name}: rays were "
          f"truncated")
    return stats, steps, [int(x) for x in work.tolist()], plain_stats, dt


def march_bound(n, work, started):
    """The march's bound for n rays from the work the trace's data needs
    (the kernel's counters: refs tested, rows, cell exits, cell fetches,
    warp iterations) and the rays that started alive: the larger of its
    operations at the FP32 peak and the bytes a trace provably moves, its
    rays in and its hits and steps out, at the HBM rate. The rows of the
    tables that its rays visit are not counted (which rows they are is not
    measured); the whole tables stand beside the bound as a ceiling on
    them, outside it."""
    tests, _, exits, _, _ = work
    ops = (tests * MARCH_OPS_PER_TEST + exits * MARCH_OPS_PER_EXIT
           + n * MARCH_OPS_PER_RAY + started * MARCH_OPS_PER_START)
    ops_ms = ops / FP32_PEAK * 1e3
    bytes_ms = n * MARCH_RAY_BYTES / HBM_RATE * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                bound_ops_ms=ops_ms, bound_bytes_ms=bytes_ms)


def march_record(name, call, card):
    """The kernel against trace_plain on one recorded trace of a wave; its
    time alone (back-to-back launches) at the trace's refill threshold
    and at MARCH_REFILLS, the plain version's time, the work this trace's
    data needs (the kernel's counters), SIMD efficiency and the bound."""
    grid, lk, rays, rpi, any_hit, coherent = call
    refill = wavefront.REFILL[coherent]
    mode = wavefront.kernel_mode(grid, lk)
    stats, steps, work, plain_stats, dt = march_against_plain(name, call)
    tests, rows, exits, loads, warp_iters = work
    n = rays.count
    step_total = int(steps.sum())
    started = int((steps > 0).sum())
    ms, (per_sm, blocks) = march_ms(call)
    by_refill = {r: march_ms(call, refill=r)[0] for r in MARCH_REFILLS}
    plain_ms = cuda_ms(lambda: wavefront.trace_plain(grid, lk, rays, rpi,
                                                     any_hit),
                       iters=1, warmup=0)
    b = march_bound(n, work, started)
    ops_ms, bytes_ms = b["bound_ops_ms"], b["bound_bytes_ms"]
    tbytes = table_bytes(grid, mode)
    gathered = (rows * MARCH_ROW_BYTES[mode]
                + (loads + started) * MARCH_CELL_BYTES[mode])
    rec = dict(mode=MARCH_MODE_NAMES[mode], rays=n, ms=ms, plain_ms=plain_ms,
               ms_by_refill=by_refill, refill=refill, coherent=coherent,
               blocks_per_sm=per_sm, blocks=blocks, **b,
               table_bytes_ms=tbytes / HBM_RATE * 1e3,
               tests=tests, rows=rows, exits=exits, loads=loads,
               started=started, alive_iters=step_total,
               warp_iters=warp_iters,
               simd_efficiency=step_total / max(32 * warp_iters, 1),
               gathered_bytes=gathered,
               gathered_ms=gathered / HBM_RATE * 1e3,
               mean_steps=stats["mean_steps"], max_steps=int(steps.max()),
               plain_rounds=plain_stats["rounds"], max_abs_dt=dt)
    print(f"[march] {name} ({rec['mode']}, {card}): kernel {ms:.4f} ms "
          f"(one launch, {MARCH_ITERS} back to back, coherent {coherent}: "
          f"refill below {refill} live lanes; {blocks} blocks, {per_sm} an "
          f"SM) "
          f"against the plain version {plain_ms:.1f} ms "
          f"({plain_stats['rounds']} rounds); by refill threshold "
          f"{ {r: round(x, 4) for r, x in by_refill.items()} }; bound "
          f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} (operations "
          f"{ops_ms:.4f}; bytes, rays in and hits out, {bytes_ms:.4f}; "
          f"not in the bound: the whole tables {rec['table_bytes_ms']:.4f}, "
          f"a ceiling on the rows read); "
          f"{step_total} alive iterations (max {rec['max_steps']} a ray), "
          f"{warp_iters} warp iterations: SIMD efficiency "
          f"{rec['simd_efficiency']:.4f}; {tests} refs tested, {rows} row "
          f"gathers, {exits} cell exits, {loads} cell fetches, {started} "
          f"rays started; {gathered} bytes gathered in sectors = "
          f"{rec['gathered_ms']:.4f} ms at {HBM_RATE / 1e12:.2f} TB/s",
          flush=True)
    return rec


def per_row_check(name, call):
    """The same trace on the same grid with one ref row more (the
    kernel's per-row packed mode): kernel against trace_plain."""
    grid, lk, rays, rpi, any_hit, coherent = call
    odd = grid.replace(ref_tris=torch.cat([grid.ref_tris,
                                           grid.ref_tris[:1]]))
    check(wavefront.kernel_mode(odd, lk) == 1, "the padded grid is not "
          "per-row")
    return march_against_plain(f"{name}, per-row packed mode",
                               (odd, lk, rays, rpi, any_hit, coherent))[-1]


def march_ptxas():
    """ptxas's registers, stack frame and spills for each march instance
    (mode / hit kind, '+work' for the counting instances), from the
    package's build log; empty when the library came from an earlier
    build."""
    out, name = {}, None
    modes = {"0": "quad", "1": "rows", "2": "uniform"}
    for ln in _build.last_build.get("log", "").splitlines():
        if "Compiling entry function" in ln and "march_kernel" in ln:
            m, h, w = ln.split("march_kernelILi")[1].split("EEEv")[0].split(
                "ELb")
            name = (f"{modes[m]}/{'any' if h == '1' else 'closest'}"
                    f"{'+work' if w == '1' else ''}")
            out[name] = {}
        elif name and "bytes stack frame" in ln:
            nums = [int(x) for x in ln.split() if x.isdigit()]
            out[name].update(stack=nums[0], spill_stores=nums[1],
                             spill_loads=nums[2])
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split()[0])
            name = None
    return out


def structures_phase(v, tris, rays, card):
    """Phase 12: the irregular and uniform structures at full width, and
    small builds on the card against the CPU's."""
    rec = {"card": card}
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    (cold,), (cold_ms,), s_irr = wall_and_device_ms(
        lambda: RenderSession.create(tris, structure="irregular", verts=v),
        1)
    g = s_irr.grid
    caps = dict(e_cap=g.entries.shape[0], r2_cap=g.ref_ids.shape[0],
                c_cap=g.cell_min.shape[0],
                cells_alive=int(g.alive.sum()),
                entries=int(g.num_entries), refs=int(g.total_refs))
    mem = dict(grid_mb=(torch.cuda.memory_allocated() - base_mem) / 2**20,
               build_peak_mb=(torch.cuda.max_memory_allocated() - base_mem)
               / 2**20)
    print(f"[structures] irregular BuildParams(): cold build {cold:.1f} ms "
          f"host wall, {cold_ms:.1f} ms between CUDA events ({card}); "
          f"capacities {caps}; device memory {mem}", flush=True)
    irr = dict(cold_wall_ms=cold, cold_ms=cold_ms, **caps, **mem,
               **build_record("irregular", s_irr, tris, card))
    t0 = time.perf_counter()
    invariants.check_irregular(s_irr.grid, sample=CHECK_SAMPLE)
    torch.cuda.synchronize()
    irr["check_irregular_s"] = time.perf_counter() - t0
    print(f"[structures] check_irregular on {CHECK_SAMPLE} sampled voxels, "
          f"(tri, voxel) and (cell, voxel) pairs: passed in "
          f"{irr['check_irregular_s']:.2f} s", flush=True)
    # The main path of the structures: every count from zero, then the
    # irregular primary frame, the irregular AO wave, the irregular path
    # bounce 1 and (below) the uniform primary frame through the user's
    # entry points; each call of wavefront.trace recorded, to count the
    # launches a trace.
    reset_launches()
    launches, traces, last_call = {}, {}, {}
    irr_frame = lambda: s_irr.trace(rays, coherent=True)  # noqa: E731
    with trace_calls() as calls:
        irr["primary"], hits = wave_record(
            "irregular primary 1024x1024", rays, irr_frame, tris, card,
            any_hit=False)
    launches["irregular primary"] = wavefront.launches["wavefront_march"]
    traces["irregular primary"], last_call["irregular primary"] = (
        len(calls), calls[-1])
    p, n, found = hit_points_normals(rays, hits, tris.n)
    gen = torch.Generator(device=DEV).manual_seed(0)
    wave = integrators.ao_rays(p, n, found,
                               integrators.default_ao_distance(s_irr), gen)
    irr_ao = lambda: integrators.trace_sorted(  # noqa: E731
        s_irr, wave, any_hit=True)
    with trace_calls() as calls:
        irr["ao_wave"], _ = wave_record("irregular AO wave", wave, irr_ao,
                                        tris, card, any_hit=True)
    launches["irregular AO wave"] = (wavefront.launches["wavefront_march"]
                                     - sum(launches.values()))
    traces["irregular AO wave"], last_call["irregular AO wave"] = (
        len(calls), calls[-1])
    # Path bounce 1 from the primary hits, made as path_trace makes its
    # bounces and traced as it traces them: incoherent closest hit.
    bounce = integrators._spawn(p, n, cosine_hemisphere(n, gen), 0.0,
                                torch.where(found, float("inf"), 0.0))
    irr_bounce = lambda: integrators.trace_sorted(  # noqa: E731
        s_irr, bounce, cal_key="path")
    with trace_calls() as calls:
        irr["path_bounce"], _ = wave_record(
            "irregular path bounce 1", bounce, irr_bounce, tris, card,
            any_hit=False, min_hit=0.0)
    launches["irregular path bounce"] = (
        wavefront.launches["wavefront_march"] - sum(launches.values()))
    traces["irregular path bounce"], last_call["irregular path bounce"] = (
        len(calls), calls[-1])
    irr["peak_mb"] = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    t0 = time.perf_counter()
    s_dyn = RenderSession.create(tris, BuildParams.dynamic(),
                                 structure="irregular", verts=v)
    torch.cuda.synchronize()
    irr["dynamic_cold_wall_ms"] = (time.perf_counter() - t0) * 1e3
    walls, devs, _ = wall_and_device_ms(lambda: s_dyn.rebuild(tris), 1)
    irr["dynamic_warm_wall_ms"], irr["dynamic_warm_ms"] = walls[0], devs[0]
    print(f"[structures] irregular BuildParams.dynamic(): cold "
          f"{irr['dynamic_cold_wall_ms']:.1f} ms, warm rebuild {walls[0]:.1f}"
          f" ms host wall, {devs[0]:.1f} ms between CUDA events ({card}); "
          f"{s_dyn.describe()}", flush=True)
    del s_dyn
    rec["irregular"] = irr

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_uni = RenderSession.create(tris, structure="uniform", verts=v)
    torch.cuda.synchronize()
    uni = dict(cold_wall_ms=(time.perf_counter() - t0) * 1e3,
               ref_capacity=s_uni.grid.ref_ids.shape[0])
    uni.update(build_record("uniform", s_uni, tris, card))
    uni_frame = lambda: s_uni.trace(rays, coherent=True)  # noqa: E731
    before = wavefront.launches["wavefront_march"]
    with trace_calls() as calls:
        uni["primary"], _ = wave_record("uniform primary 1024x1024", rays,
                                        uni_frame, tris, card, any_hit=False)
    launches["uniform primary"] = wavefront.launches["wavefront_march"] - before
    traces["uniform primary"], last_call["uniform primary"] = (
        len(calls), calls[-1])
    rec["uniform"] = uni
    # What the main path launched (counts from zero, read before any
    # comparison with the plain version): one march launch a trace.
    rec["march_launches"], rec["traces"] = launches, traces
    print(f"[march] wavefront_march launches on the main path "
          f"{sum(launches.values())}, by wave {launches}, for {traces} "
          f"traces", flush=True)
    for name, k in launches.items():
        check(k > 0 and k == traces[name], f"{name}: {k} march launches "
              f"for {traces[name]} traces")
    # Each wave under the profiler: device kernels, torch ops, march (and
    # no segment) kernels a call, device busy and idle share.
    census = {}
    for name, fn in (("irregular primary", irr_frame),
                     ("irregular AO wave", irr_ao),
                     ("irregular path bounce", irr_bounce),
                     ("uniform primary", uni_frame)):
        census[name] = c = launch_census(fn)
        print(f"[march] {name}: host wall {span(c['wall_ms'])} ms per "
              f"synced call; {c['device_kernels']:.0f} device kernels a call "
              f"({c['torch_ops']:.0f} torch ops, {c['march_kernels']:.0f} "
              f"march, {c['segment_kernels']:.0f} segment kernels); device "
              f"busy {c['busy_ms']:.3f} ms a call, march kernel "
              f"{c['march_ms']:.4f} ms of it; idle share "
              f"{c['idle_share']:.3f} ({card})", flush=True)
        check(c["march_kernels"] == 1 and c["segment_kernels"] == 0,
              f"{name}: {c['march_kernels']} march and "
              f"{c['segment_kernels']} segment kernels a call")
    rec["census"] = census
    # Each wave's last trace once more through the kernel and through the
    # plain version on the same inputs, timed; the irregular waves also in
    # the per-row mode.
    march = {name: march_record(name, call, card)
             for name, call in last_call.items()}
    row_dt = max(per_row_check(name, last_call[name])
                 for name in ("irregular primary", "irregular AO wave"))
    del last_call
    ptx = march_ptxas()
    print(f"[march] ptxas (registers, stack frame, spill stores/loads): "
          f"{ptx or 'not available (the library came from an earlier build)'}",
          flush=True)
    rec["march"], rec["march_ptxas"] = march, ptx

    # The card's builds against the CPU's: integer tables equal.
    small = {}
    for name, (sv, sf) in (("cornell", scenes.cornell_box()),
                           ("soup150", scenes.random_soup(150, seed=0))):
        on = Triangles.from_mesh(sv, sf, device=DEV)
        off = Triangles.from_mesh(sv, sf, device="cpu")
        bad = tables_equal(irregular.build_irregular(on),
                           irregular.build_irregular(off), IRREGULAR_TABLES)
        bad += tables_equal(uniform.build_uniform(on),
                            uniform.build_uniform(off), UNIFORM_TABLES)
        small[name] = bad
        print(f"[structures] {name}: irregular and uniform builds on the "
              f"card against the CPU: "
              f"{'tables equal' if not bad else f'differ in {bad}'}",
              flush=True)
        check(not bad, f"{name}: the card's build differs from the CPU's")
    rec["card_equals_cpu"] = {k: not b for k, b in small.items()}
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[structures] phase 12 took {rec['phase_s']:.1f} s", flush=True)
    print(json.dumps({"structures": rec}), flush=True)
    march_rec = dict(launches=sum(launches.values()), march=march,
                     row_dt=row_dt, census=census, ptxas=ptx)
    return s_irr, wave, s_uni, march_rec


def hits_against(name, hits, ref, tag="options"):
    """Every ray of a wave against other hits of the same rays, with
    tests/test_sweep_trace.py::_check's thresholds; the counts of rays
    whose hit/miss, id or t bits differ are printed and returned."""
    got_hit, ref_hit = hits.tri_id >= 0, ref.tri_id >= 0
    t_ok = torch.isclose(hits.t, ref.t, rtol=1e-3, atol=1e-5)
    agree = float(((got_hit == ref_hit) & (~ref_hit | t_ok)).float().mean())
    both = got_hit & ref_hit
    id_rate = float((hits.tri_id[both] == ref.tri_id[both]).float().mean())
    n_hit = int((got_hit != ref_hit).sum())
    n_id = int((hits.tri_id != ref.tri_id).sum())
    n_t = int((hits.t.view(torch.int32) != ref.t.view(torch.int32)).sum())
    print(f"[{tag}] {name}: {hits.tri_id.numel()} rays, hit/miss+t "
          f"agreement {agree:.6f}, id agreement {id_rate:.6f}; rays that "
          f"differ: hit/miss {n_hit}, tri id {n_id}, t bits {n_t}",
          flush=True)
    check(agree > 0.999, f"{name}: hits disagree")
    check(id_rate > 0.995, f"{name}: tri ids disagree")
    return dict(agree=agree, id_rate=id_rate, differ_hit=n_hit,
                differ_id=n_id, differ_t=n_t)


def calibrate(grid, rays, any_hit, coherent, fine_bins=False, compact=None):
    """(bmax, rowmax, peak round block demand, peak live rows) of a wave:
    one probe at a generous budget (doubled until it completes), then the
    budgets RenderSession._calibrate would set (demand x margin on the
    rung ladders), kept only if the wave completes under them. compact:
    trace_sweep's planner (None: the compact one for incoherent waves)."""
    bmax = OPT_PROBE_BMAX[coherent]
    rows_budget = (not coherent) if compact is None else compact
    rowmax = OPT_PROBE_ROWMAX if rows_budget else None
    kw = dict(any_hit=any_hit, coherent=coherent, fine_bins=fine_bins,
              compact=compact, return_overflow=True)
    for _ in range(4):
        _, ovf, dem = trace_sweep(grid, rays, bmax=bmax, rowmax=rowmax,
                                  return_demand=True, **kw)
        if not bool(ovf):
            break
        bmax, rowmax = bmax * 2, rowmax and rowmax * 2
    check(not bool(ovf), "the calibration probe overflowed")
    d, rows = (int(x) for x in dem.tolist())
    margin = 1.3 if (coherent and not any_hit) else 1.5
    b = _rung(int(d * margin), 1024)
    r = _rung(int(rows * margin), 8192) if rows else None
    if bool(trace_sweep(grid, rays, bmax=b, rowmax=r, **kw)[1]):
        b, r = bmax, rowmax
    return b, r, d, rows


def kernel_vs_plain(name, cols, stream, any_hit, rows=None, tag="options",
                    bit_equal=False):
    """The sweep kernel against its plain version on one round-0 stream
    (not counted as a main-path launch): ids, t or any-hit genuineness,
    the kernel's ms over 10 calls, the plain version's over one, and the
    stream's bound. bit_equal: also every ray of a swept tile equal bit
    for bit (closest hit: ids and t/u/v; any hit: hit/miss)."""
    xt, gidx, tile_of, tminb, tile = stream
    args = (xt, cols, gidx, tile_of, tminb, tile)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = sweep_blocks_plain(*args, any_hit=any_hit)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    got = sweep_blocks(*args, any_hit=any_hit)
    if any_hit:
        err = compare_anyhit(name, got, ref, args, rows)
    else:
        err = compare_sweeps(name, got, ref, tile_of, tile)
    differ = None
    if bit_equal:
        swept = swept_rays(tile_of, xt.shape[1], tile)
        n = swept.numel()
        if any_hit:
            fields = [(got[1][:n] >= 0, ref[1][:n] >= 0)]
        else:
            fields = [(got[1][:n], ref[1][:n])] + [
                (got[k][:n].view(torch.int32), ref[k][:n].view(torch.int32))
                for k in (0, 2, 3)]
        differ = int((torch.stack([a != b for a, b in fields]).any(0)
                      & swept).sum())
        print(f"[{tag}] {name}: rays of swept tiles that differ from the "
              f"plain version ({'hit/miss' if any_hit else 'id, t, u, v bits'}"
              f"): {differ} of {int(swept.sum())}", flush=True)
        check(differ == 0, f"{name}: the kernel is not bit-equal to its "
              f"plain version on {differ} rays")
    ms = cuda_ms(lambda: sweep_blocks(*args, any_hit=any_hit), iters=10)
    b = bound(args, any_hit, name)
    print(f"[{tag}] {name}: {b['live_blocks']} blocks, kernel {ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms",
          flush=True)
    return dict(blocks=b["live_blocks"], ms=ms, plain_ms=plain_ms,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                max_abs_err=err, differ=differ)


def option_grid(name, tris, bbox, kw, base, card):
    """Cold build, OPT_WARM warm rebuilds at the cold grid's dims and
    capacity (equal tables), refs against the default grid, the shares
    of rows refined by 2 and 4, device memory and check_packet on a
    sample."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    (cold,), (cold_ms,), g = wall_and_device_ms(
        lambda: build_packet(tris, **kw), 1)
    mem = dict(grid_mb=(torch.cuda.memory_allocated() - base_mem) / 2**20,
               build_peak_mb=(torch.cuda.max_memory_allocated() - base_mem)
               / 2**20)
    walls, devs, w = wall_and_device_ms(lambda: build_packet(
        tris, bbox=bbox, ref_capacity=g.ref_capacity, dims3=g.dims3,
        check=False, **kw), OPT_WARM)
    check(not bool(w.overflowed), f"{name}: warm rebuild overflowed")
    check(all(torch.equal(getattr(w, k), getattr(g, k))
              for k in ("rs", "rowinfo", "planes")),
          f"{name}: the warm rebuild's tables differ from the cold build's")
    lgm = g.rowinfo >> 28
    refs, refs0 = int(g.total_refs), int(base.total_refs)
    t0 = time.perf_counter()
    invariants.check_packet(g, sample_tris=OPT_CHECK_SAMPLE)
    check_s = time.perf_counter() - t0
    r = dict(cold_wall_ms=cold, cold_ms=cold_ms, warm_wall_ms=walls,
             warm_ms=devs, dims3=g.dims3, ref_capacity=g.ref_capacity,
             refs=refs, refs_default=refs0, refs_ratio=refs / refs0,
             rows_m2=float((lgm == 1).float().mean()),
             rows_m4=float((lgm == 2).float().mean()),
             check_packet_s=check_s, **mem)
    print(f"[options] build_packet({', '.join(f'{k}=True' for k in kw)}): "
          f"cold {cold:.1f} ms host wall, {cold_ms:.1f} ms between CUDA "
          f"events; warm x{OPT_WARM} {span(walls)} ms host wall, "
          f"{span(devs)} ms between events ({card}); refs {refs} against "
          f"the default grid's {refs0} (x{refs / refs0:.3f}), capacity "
          f"{g.ref_capacity}; rows refined by 2: {r['rows_m2']:.4f}, by 4: "
          f"{r['rows_m4']:.4f}; device memory {mem}; check_packet on "
          f"{OPT_CHECK_SAMPLE} sampled tris passed in {check_s:.2f} s",
          flush=True)
    return g, r


def cli_runs(tmp):
    """`python -m hagrid_tpu_torch.cli render | stats | bench` for each
    structure on the card, all nine started together, at OPT_CLI_SIZE on
    the Sponza-like scene. Only exit codes and outputs are checked: the
    nine share the card and the host, so their times are no measurement."""
    procs = {}
    for st in ("packet", "irregular", "uniform"):
        out = f"{tmp}/cli_{st}.png"
        for cmd, extra in (("render", ["--out", out]), ("stats", []),
                           ("bench", ["--iters", "3"])):
            procs[(st, cmd)] = subprocess.Popen(
                [sys.executable, "-m", "hagrid_tpu_torch.cli", cmd,
                 "--scene", "sponza", "--size", OPT_CLI_SIZE,
                 "--structure", st, *extra], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    res = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=OPT_CLI_TIMEOUT)
            last = stdout.strip().splitlines()[-1] if stdout.strip() else ""
            res[key] = (p.returncode, last, stderr.strip()[-2000:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rec = {}
    for (st, cmd), (rc, last, err) in res.items():
        print(f"[cli] {cmd} --structure {st}: exit {rc}; {last}", flush=True)
        check(rc == 0, f"cli {cmd} --structure {st} failed: {err}")
        if cmd == "render":
            check(pathlib.Path(f"{tmp}/cli_{st}.png").stat().st_size > 0,
                  f"cli render --structure {st} wrote no PNG")
        if cmd == "bench":
            b = json.loads(last)
            check({"build_ms", "mrays_per_s", "grid", "device"} <= set(b),
                  f"cli bench --structure {st}: keys missing")
        rec[f"{cmd}_{st}"] = rc
    return rec


def options_phase(v, f, tris, rays, hits, grid, session, wave, b1, card):
    """Phase 13: the packet grid's options (per-row refinement, adaptive
    slice planes, fine ray bins) through K2 and K3 at full size, their
    tables on the card against the CPU's, the OBJ loader, sharding and
    the CLI. Returns (record, K2 and K3 launches of the phase's entry
    point runs)."""
    rec = {"card": card}
    t_phase = time.perf_counter()
    bbox = session.bbox
    g_ref, rec["refine"] = option_grid("refine", tris, bbox,
                                       dict(refine=True), grid, card)
    g_ada, rec["adaptive"] = option_grid("adaptive", tris, bbox,
                                         dict(adaptive=True), grid, card)
    option_grids = (("refine", g_ref), ("adaptive", g_ada))

    # The phase's main path, through trace_sweep and trace_sorted's sort,
    # every count from zero.
    reset_launches()
    budgets = {}
    b0, _, d0, _ = calibrate(grid, rays, False, True)
    budgets["primary_default"] = (b0, None)
    for name, g in option_grids:
        b, _, d, _ = calibrate(g, rays, False, True)
        budgets[f"primary_{name}"] = (b, None)
        walls, devs, h = wall_and_device_ms(
            lambda: trace_sweep(g, rays, coherent=True, bmax=b), 3)
        print(f"[options] primary 1024x1024 on the {name} grid: round-0 "
              f"demand {d} blocks against the default grid's {d0}; budget "
              f"{b}; host wall {span(walls)} ms, {span(devs)} ms between "
              f"CUDA events = {span([rays.count / ms / 1e3 for ms in devs])}"
              f" Mrays/s ({card})", flush=True)
        check_closest_sample(f"primary on the {name} grid", rays, h, tris)
        rec[name]["primary"] = dict(
            demand=d, demand_default=d0, bmax=b, wall_ms=walls, ms=devs,
            **hits_against(f"primary on the {name} grid against the "
                           f"default grid", h, hits))
    srt, perm = sortrays.sort_rays(wave, grid.bbox_lo, grid.bbox_hi,
                                   bits=10, origin_major=True)
    b1s, _ = sortrays.sort_rays(b1, grid.bbox_lo, grid.bbox_hi, bits=10,
                                origin_major=True)
    b, r, d, rows = calibrate(g_ref, srt, True, False)
    _, _, d_def, rows_def = calibrate(grid, srt, True, False)
    budgets["ao_refine"] = (b, r)
    walls, devs, h = wall_and_device_ms(lambda: trace_sweep(
        g_ref, srt, any_hit=True, bmax=b, rowmax=r), 2)
    check_anyhit_sample("AO wave 0 on the refined grid", wave,
                        sortrays.unsort(h, perm), tris)
    print(f"[options] AO wave 0 ({srt.count} rays) on the refined grid: "
          f"peak demand {d} blocks, {rows} rows against the default grid's "
          f"{d_def}, {rows_def}; budgets ({b}, {r}); host wall {span(walls)}"
          f" ms, {span(devs)} ms between CUDA events ({card})", flush=True)
    rec["refine"]["ao_wave"] = dict(demand=d, rows=rows, demand_default=d_def,
                                    rows_default=rows_def, wall_ms=walls,
                                    ms=devs)
    fine = {}
    for name, w, any_hit in (("ao_wave", srt, True),
                             ("path_bounce1", b1s, False)):
        for fb in (False, True):
            b, r, d, rows = calibrate(grid, w, any_hit, False, fb)
            budgets[f"{name}_fine{int(fb)}"] = (b, r)
            fn = (lambda w=w, any_hit=any_hit, fb=fb, b=b, r=r: trace_sweep(
                grid, w, any_hit=any_hit, fine_bins=fb, bmax=b, rowmax=r))
            prof = profile(f"{name} fine_bins={fb}", fn, card, None, runs=2)
            h = fn()
            if any_hit:
                check_anyhit_sample(f"{name} fine_bins={fb}", wave,
                                    sortrays.unsort(h, perm), tris)
            else:
                check_closest_sample(f"{name} fine_bins={fb}", w, h, tris)
            fine[f"{name}_fine{int(fb)}"] = dict(demand=d, rows=rows,
                                                 bmax=b, rowmax=r, **prof)
            print(f"[options] {name} fine_bins={fb}: peak demand {d} "
                  f"blocks, {rows} rows; budgets ({b}, {r})", flush=True)
    rec["fine_bins"] = fine
    torch.cuda.synchronize()
    launches = dict(sk.launches)
    print(f"[options] kernel launches of the phase's entry point runs: "
          f"{launches}", flush=True)
    check(launches["sweep_blocks"] > 0 and launches["sweep_blocks_anyhit"]
          > 0, "phase 13 did not launch both sweep instances")

    # The kernel against its plain version on the new streams.
    rows_t = tri_rows(grid.cols, tris.count)
    streams = {}
    for name, g in option_grids:
        streams[f"primary_{name}"] = kernel_vs_plain(
            f"K2, primary round 0 on the {name} grid", g.cols,
            first_round_stream(g, rays, tile=TILE,
                               bmax=budgets[f"primary_{name}"][0]), False)
    b, r = budgets["ao_refine"]
    streams["ao_refine"] = kernel_vs_plain(
        "K3, AO wave 0 round 0 on the refined grid", g_ref.cols,
        first_round_stream(g_ref, srt, any_hit=True, coherent=False, bmax=b,
                           rowmax=r), True, tri_rows(g_ref.cols, tris.count))
    b, r = budgets["ao_wave_fine1"]
    streams["ao_fine"] = kernel_vs_plain(
        "K3, AO wave 0 round 0 with fine bins", grid.cols,
        first_round_stream(grid, srt, any_hit=True, coherent=False, bmax=b,
                           rowmax=r, fine_bins=True), True, rows_t)
    b, r = budgets["path_bounce1_fine1"]
    streams["path_fine"] = kernel_vs_plain(
        "K2, path bounce 1 round 0 with fine bins", grid.cols,
        first_round_stream(grid, b1s, coherent=False, bmax=b, rowmax=r,
                           fine_bins=True), False)
    rec["streams"] = streams
    del g_ada

    # Tables built on the card against the CPU's.
    tables = {}
    for n in OPT_TABLE_SCENES:
        sv, sf = scenes.sponza_like(n)
        on_t = Triangles.from_mesh(sv, sf, device=DEV)
        off_t = Triangles.from_mesh(sv, sf, device="cpu")
        for kw in (dict(refine=True), dict(adaptive=True)):
            on, off = build_packet(on_t, **kw), build_packet(off_t, **kw)
            bad = tables_equal(on, off, ("rs", "rowinfo", "planes",
                                         "total_refs", "total_pairs"))
            cols = on.cols.cpu()
            if not torch.equal(cols[:, 16::20], off.cols[:, 16::20]) or \
                    not torch.allclose(cols, off.cols, rtol=1e-6, atol=1e-6):
                bad.append("cols")
            key = f"sponza{n}_{next(iter(kw))}"
            tables[key] = not bad
            print(f"[options] {key}: tables on the card against the CPU: "
                  f"{'equal' if not bad else f'differ in {bad}'}", flush=True)
            check(not bad, f"{key}: the card's tables differ from the CPU's")
    rec["card_equals_cpu"] = tables

    with tempfile.TemporaryDirectory() as tmp:
        # OBJ: write the scene, parse it natively and in Python.
        path = f"{tmp}/sponza_like.obj"
        t0 = time.perf_counter()
        obj.save_obj(path, v, f)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nv, nf = obj.load_obj(path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pv, pf = obj.load_obj_python(path)
        python_s = time.perf_counter() - t0
        same = (np.array_equal(nv, pv) and np.array_equal(nf, pf)
                and np.array_equal(nv, v) and np.array_equal(nf, f))
        lv, lf, lcam = scenes.load_scene(path)
        s_obj = RenderSession.create(Triangles.from_mesh(lv, lf, device=DEV),
                                     verts=lv)
        orays = primary_rays(lcam, 1024, 1024, order="block", device=DEV)
        oh = s_obj.trace(orays, coherent=True)
        check_closest_sample("OBJ scene primary", orays, oh, s_obj.grid.tris)
        ofrac = float((oh.tri_id >= 0).float().mean())
        rec["obj"] = dict(bytes=pathlib.Path(path).stat().st_size,
                          save_s=save_s, native_s=native_s,
                          python_s=python_s, arrays_equal=same,
                          hit_fraction=ofrac)
        print(f"[obj] {rec['obj']['bytes']} bytes; save_obj {save_s:.2f} s,"
              f" native parser {native_s:.3f} s (build included), Python "
              f"parser {python_s:.2f} s; arrays equal: {same}; load_scene "
              f"-> RenderSession -> 1024x1024 frame, hit fraction "
              f"{ofrac:.4f}", flush=True)
        check(same, "the native and Python OBJ parsers disagree")
        check(0.0 < ofrac <= 1.0, "the OBJ scene's frame hit nothing")
        del s_obj, oh

        # Sharding: every card, and two shards of this one.
        def fn(g, r):
            return trace_sweep(g, r, coherent=True, bmax=b0)

        want = fn(grid, rays)
        shard = {}
        for mname, m in (("all_cards", mesh.make_mesh()),
                         ("two_shards", mesh.make_mesh(2, devices=DEV))):
            padded, n = mesh.pad_rays(rays, len(m) * TILE)
            parts = mesh.shard_trace(fn, m)(grid, padded)
            got = mesh.gather(parts, device=DEV, n=n)
            eq = (torch.equal(got.tri_id, want.tri_id)
                  and torch.equal(got.t, want.t))
            shard[mname] = dict(devices=[str(d) for d in m], equal=eq)
            print(f"[shard] shard_trace over {[str(d) for d in m]}: hits "
                  f"equal the unsharded frame: {eq}", flush=True)
            check(eq, f"sharded frame ({mname}) differs")
        distributed.initialize(world_size=1)
        gm = distributed.global_mesh()
        shard["global_mesh"] = [str(d) for d in gm]
        check(distributed.process_count() == 1 and gm[0].type == "cuda",
              "distributed single-process set-up is not a no-op")
        rec["sharding"] = shard

        # The CLI as a user runs it, last: its nine processes share the card.
        t0 = time.perf_counter()
        rec["cli"] = cli_runs(tmp)
        rec["cli_s"] = time.perf_counter() - t0
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[options] phase 13 took {rec['phase_s']:.1f} s (CLI "
          f"{rec['cli_s']:.1f} s)", flush=True)
    print(json.dumps({"options": rec}), flush=True)
    return rec, launches


@contextlib.contextmanager
def refusing(module, *names):
    """Within the block, calling module.<name> raises: a main path that
    falls back to a plain version fails the run."""
    saved = {n: getattr(module, n) for n in names}

    def refuse(name):
        def f(*a, **k):
            raise SmokeFailure(f"{module.__name__}.{name} ran on the card "
                               f"inside a main path")
        return f

    for n in names:
        setattr(module, n, refuse(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def hits_subset(hits, idx):
    return Hits(*(getattr(hits, k)[idx] for k in ("tri_id", "t", "u", "v")))


def reference_options_phase(session, rays, hits, tris, ao_wave, s_irr,
                            irr_wave, s_uni, cam, card):
    """Phase 14: the reference's options through the user's entry points
    at full size. Returns (record, launches of the phase's main path by
    kernel, the K2/K3 streams' records, the K8 entry points' records)."""
    rec = {"card": card}
    t_phase = time.perf_counter()
    grid = session.grid
    srt, _ = sortrays.sort_rays(ao_wave, grid.bbox_lo, grid.bbox_hi,
                                bits=10, origin_major=True)
    # Budgets, off the main path: each planner on each wave.
    b_cc, r_cc, d_cc, rows_cc = calibrate(grid, rays, False, True,
                                          compact=True)
    _, _, d_cd, _ = calibrate(grid, rays, False, True)
    b_ad, _, d_ad, _ = calibrate(grid, srt, True, False, compact=False)
    b_ac, r_ac, d_ac, rows_ac = calibrate(grid, srt, True, False)
    rec["demand"] = dict(primary_compact=(d_cc, rows_cc),
                         primary_dense=d_cd, ao_dense=d_ad,
                         ao_compact=(d_ac, rows_ac))
    print(f"[refopts] peak round demand (blocks, live rows): primaries "
          f"compact ({d_cc}, {rows_cc}), dense {d_cd}; AO wave 0 dense "
          f"{d_ad}, compact ({d_ac}, {rows_ac}); budgets: primaries "
          f"compact ({b_cc}, {r_cc}), AO dense {b_ad}, AO compact ({b_ac}, "
          f"{r_ac})", flush=True)
    reckoned = b_ad * DENSE_ITEMS_BYTES_PER_BLOCK
    print(f"[refopts] AO wave 0, dense planner: budget {b_ad} blocks, "
          f"reckoned {reckoned} bytes ({reckoned / 2**20:.1f} MiB) of the "
          f"items stage's arrays at {DENSE_ITEMS_BYTES_PER_BLOCK} bytes a "
          f"block", flush=True)

    # The main path: every count from zero; no plain version may run.
    reset_launches()
    with refusing(sk, "sweep_blocks_plain"), refusing(
            wavefront, "trace_wavefront", "trace_plain", "segment_plain"):
        # 1. Primaries through the compact planner.
        walls, devs, (h_cc, ovf) = wall_and_device_ms(
            lambda: trace_sweep(grid, rays, coherent=True, compact=True,
                                bmax=b_cc, rowmax=r_cc,
                                return_overflow=True), 3)
        check(not bool(ovf), "primaries, compact planner: overflow")
        rec["primary_compact"] = dict(wall_ms=walls, ms=devs)
        print(f"[refopts] primaries ({rays.count} rays), trace_sweep("
              f"coherent=True, "
              f"compact=True): host wall {span(walls)} ms, {span(devs)} ms "
              f"between CUDA events ({card}); K2 launches "
              f"{sk.launches['sweep_blocks']}; overflow False", flush=True)
        # 2. AO wave 0 through the dense planner, and the compact call.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        walls, devs, (h_ad, ovf) = wall_and_device_ms(
            lambda: trace_sweep(grid, srt, any_hit=True, coherent=False,
                                compact=False, bmax=b_ad,
                                return_overflow=True), 2)
        peak = torch.cuda.max_memory_allocated() - base
        check(not bool(ovf), "AO wave 0, dense planner: overflow")
        walls_c, devs_c, (h_ac, ovf) = wall_and_device_ms(
            lambda: trace_sweep(grid, srt, any_hit=True, bmax=b_ac,
                                rowmax=r_ac, return_overflow=True), 2)
        check(not bool(ovf), "AO wave 0, compact planner: overflow")
        n_diff = int(((h_ad.tri_id >= 0) != (h_ac.tri_id >= 0)).sum())
        rec["ao_dense"] = dict(wall_ms=walls, ms=devs, peak_bytes=peak,
                               reckoned_bytes=reckoned,
                               compact_wall_ms=walls_c, compact_ms=devs_c,
                               differ_hit=n_diff)
        print(f"[refopts] AO wave 0 ({srt.count} rays, origin-sorted), "
              f"trace_sweep(any_hit=True, coherent=False, compact=False): "
              f"host wall {span(walls)} ms, {span(devs)} ms between CUDA "
              f"events, device memory peak {peak} bytes above the frame's "
              f"inputs (reckoned {reckoned}); compact planner {span(walls_c)}"
              f" ms, {span(devs_c)} ms ({card}); hit/miss differs from the "
              f"compact call on {n_diff} rays; overflow False", flush=True)
        check(n_diff == 0, f"dense and compact AO waves differ on {n_diff} "
              f"rays")
        # 3. The sort options on the packet session, each its own budgets.
        keys = {"origin": "ao", "octant": "ao_octant", False: "ao_caller"}
        sorts = {}
        for sort, key in keys.items():
            def run(sort=sort, key=key):
                return integrators.trace_sorted(session, ao_wave,
                                                any_hit=True, sort=sort,
                                                cal_key=key)
            run()                               # calibrates a new key
            walls, devs, h = wall_and_device_ms(run, 3)
            sorts[sort] = dict(h=h, wall_ms=walls, ms=devs,
                               budgets=session._bmax_cal[
                                   (True, False, ao_wave.count, key)])
        check(not session.poll_overflow(recalibrate=False),
              "a sort option's wave overflowed its budgets")
        # 4. ambient_occlusion(max_dist=...), one generator seed.
        dist = integrators.default_ao_distance(session)

        def ao(max_dist=None):
            gen = torch.Generator(device=DEV).manual_seed(11)
            return integrators.ambient_occlusion(session, rays, hits, gen,
                                                 max_dist=max_dist)

        ao_def, ao_given, ao_half = ao(), ao(dist), ao(0.5 * dist)
        check(not session.poll_overflow(recalibrate=False),
              "ambient_occlusion overflowed")
        # 5. path_trace(sky=2.0): the same seed, exactly twice the image,
        # on the Cornell box (open at the front: the Sponza-like hall is
        # closed, and no path of it reaches the sky).
        cv, cf = scenes.cornell_box()
        s_box = RenderSession.create(Triangles.from_mesh(cv, cf, device=DEV),
                                     verts=cv)
        p1 = integrators.path_trace(s_box, scenes.cornell_camera(),
                                    PATH_SIZE, PATH_SIZE,
                                    max_bounces=PATH_BOUNCES)
        p2 = integrators.path_trace(s_box, scenes.cornell_camera(),
                                    PATH_SIZE, PATH_SIZE,
                                    max_bounces=PATH_BOUNCES, sky=2.0)
        check(not s_box.poll_overflow(recalibrate=False),
              "path_trace overflowed")
        # 6. trace_irregular and trace_uniform through K8.
        lockstep = {}
        for sname, s_, entry, lk in (
                ("irregular", s_irr, irregular.trace_irregular,
                 irregular.irregular_lookup),
                ("uniform", s_uni, uniform.trace_uniform,
                 uniform.uniform_lookup)):
            for wname, w, any_hit in (("primaries", rays, False),
                                      ("AO wave", irr_wave, True)):
                def run(g=s_.grid, w=w, any_hit=any_hit, entry=entry):
                    return entry(g, w, any_hit=any_hit)
                before = wavefront.launches["wavefront_march"]
                h = run()
                one = wavefront.launches["wavefront_march"] - before
                stats = dict(wavefront.last_trace_stats)
                walls, devs, _ = wall_and_device_ms(run, 3)
                lockstep[f"{sname} {wname}"] = dict(
                    h=h, launches=one, stats=stats, wall_ms=walls, ms=devs,
                    call=(s_.grid, lk, w, 8, any_hit, False))
                check(one == 1, f"trace_{sname} on the {wname}: {one} "
                      f"march launches in one call")
                check(stats["truncated_rays"] == 0, f"trace_{sname} on the "
                      f"{wname}: {stats['truncated_rays']} rays truncated")
        torch.cuda.synchronize()
    launches = {**sk.launches, **wavefront.launches}
    rec["launches"] = launches
    print(f"[refopts] kernel launches of the phase's main path (counts from"
          f" zero, no plain version called): {launches}", flush=True)
    check(launches["sweep_blocks"] > 0 and launches["sweep_blocks_anyhit"]
          > 0 and launches["wavefront_march"] > 0,
          "phase 14 did not launch K2, K3 and K8")

    # 1 and 2, against the default calls and the plain sweep.
    rec["primary_compact"].update(hits_against(
        "primaries, compact planner, against the default coherent call",
        h_cc, hits, tag="refopts"))
    check_closest_sample("primaries, compact planner", rays, h_cc, tris)
    streams = dict(
        k2_compact_coherent=kernel_vs_plain(
            "K2, primaries round 0, compact planner", grid.cols,
            first_round_stream(grid, rays, coherent=True, compact=True,
                               bmax=b_cc, rowmax=r_cc), False,
            tag="refopts", bit_equal=True),
        k3_dense_incoherent=kernel_vs_plain(
            "K3, AO wave 0 round 0, dense planner", grid.cols,
            first_round_stream(grid, srt, any_hit=True, coherent=False,
                               compact=False, bmax=b_ad), True,
            tri_rows(grid.cols, tris.count), tag="refopts",
            bit_equal=True))
    check_anyhit_sample("AO wave 0, dense planner", srt, h_ad, tris)
    rec["streams"] = streams
    # 3. The sort options against the origin sort.
    base_hit = sorts["origin"]["h"].tri_id >= 0
    for sort, r in sorts.items():
        w = ao_wave if not sort else sortrays.sort_rays(
            ao_wave, grid.bbox_lo, grid.bbox_hi,
            bits=10 if sort == "origin" else 7,
            origin_major=sort == "origin")[0]
        bmax, rowmax = r["budgets"]
        dem = trace_sweep(grid, w, any_hit=True, bmax=bmax, rowmax=rowmax,
                          return_overflow=True, return_demand=True)[2]
        agree = float(((r.pop("h").tri_id >= 0) == base_hit).float().mean())
        r.update(agree=agree, demand=dem.tolist())
        print(f"[refopts] trace_sorted(AO wave 0, any_hit=True, sort="
              f"{sort!r}): host wall {span(r['wall_ms'])} ms, "
              f"{span(r['ms'])} ms between CUDA events ({card}); peak round "
              f"demand {r['demand']} (blocks, live rows), budgets "
              f"{r['budgets']}; hit/miss agrees with sort='origin' on "
              f"{agree:.6f} of rays", flush=True)
        check(agree > 0.999, f"sort={sort!r}: hit/miss disagrees with the "
              f"origin sort")
    rec["sorts"] = {str(k): v for k, v in sorts.items()}
    # 4. and 5.
    dev_read = float((grid.bbox_hi - grid.bbox_lo).max()) * 0.1
    same = torch.equal(ao_def, ao_given)
    no_darker = bool((ao_half >= ao_def).all())
    twice = torch.equal(p2, 2.0 * p1) and float(p1.mean()) > 0
    rec["ambient_occlusion"] = dict(
        max_dist=dist, device_read=dev_read, given_equal=same,
        half_no_darker=no_darker, mean=float(ao_def.mean()),
        mean_half=float(ao_half.mean()))
    rec["path_sky2_twice"] = twice
    print(f"[refopts] default_ao_distance {dist!r} from the session's host "
          f"bounds, the device read {dev_read!r}; ambient_occlusion(max_dist"
          f"=that) bit-equal to the default call: {same}; max_dist halved: "
          f"every pixel at least the default's: {no_darker} (means "
          f"{rec['ambient_occlusion']['mean']:.5f}, "
          f"{rec['ambient_occlusion']['mean_half']:.5f}); path_trace("
          f"sky=2.0) on the Cornell box, {PATH_SIZE}x{PATH_SIZE}, 1 spp, "
          f"{PATH_BOUNCES} bounces, exactly twice the default image: "
          f"{twice} (mean {float(p1.mean()):.5f})", flush=True)
    check(dist == dev_read, "the host bounds give another AO distance")
    check(same, "ambient_occlusion(max_dist=default) differs from default")
    check(no_darker, "a shorter AO distance darkened a pixel")
    check(twice, "path_trace(sky=2.0) is not twice the default image")
    # 6. Each entry point against trace_wavefront on the card, on a
    # subset; the kernel's time alone and its bound.
    march = {}
    for name, r in lockstep.items():
        g, lk, w, rpi, any_hit, _ = call = r.pop("call")
        idx = sample(w.count, k=LOCKSTEP_SUBSET, seed=5)
        sub = w.take(idx)
        if lk is irregular.irregular_lookup:
            args = (g.tris, g.lookup, g.cell_starts, g.ref_ids, g.bbox_lo,
                    g.bbox_hi, g.fine_dims)
        else:
            args = (g.tris, lambda vox, g=g: lk(g, vox), g.cell_starts,
                    g.ref_ids, g.bbox_lo, g.bbox_hi, g.dims)
        plain_ms, _, want = wall_and_device_ms(
            lambda: wavefront.trace_wavefront(sub, *args, any_hit=any_hit),
            1)
        plain_stats = dict(wavefront.last_trace_stats)
        bad, dt = hits_bits_diff(hits_subset(r.pop("h"), idx), want)
        steps = torch.empty(w.count, dtype=torch.int32, device=DEV)
        work = torch.zeros(5, dtype=torch.int64, device=DEV)
        wavefront.trace(g, lk, w, rpi, any_hit, steps=steps, work=work)
        b = march_bound(w.count, [int(x) for x in work.tolist()],
                        int((steps > 0).sum()))
        ms, _ = march_ms(call)
        r.update(kernel_ms=ms, plain_ms=plain_ms[0], subset=idx.numel(),
                 differ=bad, max_abs_dt=dt,
                 plain_truncated=plain_stats["truncated_rays"], **b)
        march[name] = r
        print(f"[refopts] trace_{name.split()[0]} on the "
              f"{name.split(' ', 1)[1]} ({w.count} rays, any_hit {any_hit}; "
              f"the AO wave is the irregular session's, phase 12; "
              f"{card}): {r['launches']} march launch a call, "
              f"{r['stats']['mean_steps']:.3f} steps a ray, truncated "
              f"{r['stats']['truncated_rays']}; host wall "
              f"{span(r['wall_ms'])} ms, {span(r['ms'])} ms between CUDA "
              f"events; kernel alone {ms:.4f} ms; bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']}; against "
              f"trace_wavefront on the card on {idx.numel()} rays "
              f"({plain_ms[0]:.1f} ms, truncated "
              f"{plain_stats['truncated_rays']}): "
              f"{'tri ids and the bits of t/u/v equal' if not bad else f'{bad} DIFFER'}"
              f"; max |dt| {dt}", flush=True)
        check(not bad, f"trace_{name}: differs from trace_wavefront ({bad})")
        check(plain_stats["truncated_rays"] == 0, f"trace_{name}: "
              f"trace_wavefront truncated rays")
    rec["lockstep"] = march
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[refopts] phase 14 took {rec['phase_s']:.1f} s", flush=True)
    print(json.dumps({"reference_options": rec}), flush=True)
    return rec, launches, streams, march


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


def sm_clock_under(fn, seconds=1.0):
    """Mean SM clock (MHz) and power draw (W) that nvidia-smi samples
    every 50 ms while fn() runs back to back for about `seconds`, after as
    long again to reach a steady clock."""
    def busy(t):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < t:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()

    busy(seconds)
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        busy(seconds)
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")][:2])
        except ValueError:   # a field nvidia-smi cannot read: [N/A]
            pass
    check(rows and all(len(r) == 2 for r in rows),
          f"nvidia-smi gave no clock samples: {out[:200]!r}")
    return (sum(r[0] for r in rows) / len(rows),
            sum(r[1] for r in rows) / len(rows))


def kernel_profile_ms(fn, name, runs=10):
    """Device time a launch of the kernel whose name holds `name`, from
    torch.profiler over `runs` back-to-back calls of fn (None when the
    profiler saw no such kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / n \
        if n else None


def dots_fp32_census(library_sass):
    """K5's two instances in the built library's SASS (exp/sass.run's
    record): their row loop's
    instructions per pair (the loop does K5_LOOP_PAIRS pairs; its count
    includes the last block's stores, a few a row), checked: no local
    memory, FFMA in the FMA instance only, the ring's bulk copies, one
    row's 24 shared coefficient loads in the loop."""
    got = {}
    for name, (counts, body) in library_sass.items():
        if "dots_fp32_kernel" not in name:
            continue
        fma = any(t in name for t in ("(bool)1", "<true>", "ILb1E"))
        print(f"[sass] {name}: " + ", ".join(
            f"{k} {v}" for k, v in counts.items()), flush=True)
        check(not (counts.get("LDL") or counts.get("STL")),
              f"{name}: local memory (LDL/STL)")
        check(bool(counts.get("FFMA")) == fma,
              f"{name}: FFMA {counts.get('FFMA', 0)} in the "
              f"{'FMA' if fma else 'plain'} instance")
        check(counts.get("UBLKCP", 0) > 0, f"{name}: no bulk copy")
        check(body is not None and body.get("LDS") == 24,
              f"{name}: no row loop with 24 shared loads: {body}")
        per = {k: body.get(k, 0) / K5_LOOP_PAIRS
               for k in ("instructions", "FFMA", "FMUL", "FADD", "LDS")}
        print(f"[sass] {name}: row loop per pair: " + ", ".join(
            f"{k} {v:.3f}" for k, v in per.items()), flush=True)
        got[fma] = per
    check(sorted(got) == [False, True],
          f"SASS: dots_fp32_kernel instances {sorted(got)}, expected both")
    return got


def dots_fp32_entries(xt, g, card, library_sass):
    """K5 in phase 11: both instances against the plain version (the
    plain one bit for bit, the FMA one within FMA_TOL and the element
    bound), the library product against the element bound, times, bounds,
    the SM clock under load and the SASS census. Returns the kernels
    line's dots_fp32 and dots_fp32_fma entries."""
    n_blocks = g.shape[0] // mk.BLOCK_ROWS
    hb = n_blocks // 2
    pairs = n_blocks * REFS_PER_BLOCK * TILE
    props = torch.cuda.get_device_properties(0)
    ctas = min(n_blocks, props.multi_processor_count)
    # The persistent grid's last round: blocks over CTAs x rounds.
    tail = n_blocks / (ctas * -(-n_blocks // ctas))
    per_pair = dots_fp32_census(library_sass)
    want = mk.dots_fp32_plain(xt, g)
    exact = mk.dots_fp32_exact(xt, g)
    plain_ms = cuda_ms(lambda: mk.dots_fp32_plain(xt, g), iters=1,
                       warmup=0)
    torch.cuda.synchronize()

    library = mk.dots_fp32_library(xt, g)
    sums = library()
    lib_ratio = mk.bound_ratio((sums[-1], sums.sum(1)), exact,
                               mk.LIBRARY_CHAINS)
    del sums
    print(f"[k5] dots_fp32_library (one FP32 torch.mm, TF32 off), "
          f"{n_blocks} blocks x {TILE} rays: |err| / element bound "
          f"(k = {mk.LIBRARY_CHAINS}) last block {lib_ratio[0]:.4f}, "
          f"column sums {lib_ratio[1]:.4f}", flush=True)
    check(max(lib_ratio) <= 1, "dots_fp32_library beyond its element "
          f"bound: {lib_ratio}")
    library_ms = cuda_ms(library, iters=20, warmup=2)
    # It reads g and writes every block's (128, T) sums.
    lib_b = micro_bound("dots_fp32 (library product)",
                        2 * n_blocks * mk.BLOCK_ROWS * 128 * TILE, FP32_PEAK,
                        nbytes(g, xt) + 4 * n_blocks * mk.BLOCK_ROWS * TILE)
    print(f"[k5] dots_fp32_library: {library_ms:.4f} ms, bound "
          f"{lib_b['bound_ms']:.4f} ms ({card})", flush=True)
    del library

    entries = {}
    for fma, key in ((False, "dots_fp32"), (True, "dots_fp32_fma")):
        got = mk.dots_fp32(xt, g, fma=fma)
        torch.cuda.synchronize()
        ratio = mk.bound_ratio(got, exact)
        errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
        tols = [FMA_TOL * float(w.abs().max()) for w in want]
        same = all(torch.equal(a, w) for a, w in zip(got, want))
        print(f"[k5] {key}, {n_blocks} blocks x {TILE} rays: last block's "
              f"sums and all {n_blocks} blocks' column sums equal to plain "
              f"{same}; max |err| {errs[0]:.3e}, {errs[1]:.3e} (FMA_TOL "
              f"{tols[0]:.3e}, {tols[1]:.3e}); |err| / element bound "
              f"(k = {mk.KERNEL_CHAINS}) {ratio[0]:.4f}, {ratio[1]:.4f}",
              flush=True)
        if fma:
            check(errs[0] <= tols[0] and errs[1] <= tols[1],
                  f"{key} differs from the plain version beyond {FMA_TOL} "
                  f"x max|ref|")
            check(max(ratio) <= 1, f"{key} beyond its element bound: "
                  f"{ratio}")
        else:
            check(same, f"{key} differs from its plain version")
        ms, _ = timed_pair(
            key, lambda: mk.dots_fp32(xt, g, fma=fma),
            lambda: mk.dots_fp32(xt, g[:hb * mk.BLOCK_ROWS], fma=fma), None,
            card)
        mhz, watts = sm_clock_under(lambda: mk.dots_fp32(xt, g, fma=fma))
        prof_ms = kernel_profile_ms(lambda: mk.dots_fp32(xt, g, fma=fma),
                                    "dots_fp32_kernel")
        # Operations at the FP32 peak, as for K1-K4 (an FMA counts 2);
        # beside it the FP32 instructions the function needs at the issue
        # rate, and what the row loop issues at the measured clock, over
        # the last round's share.
        b = micro_bound(key, pairs * DOTS_OPS_PER_PAIR, FP32_PEAK,
                        nbytes(xt, g, *got))
        b["bound_ms_instructions"] = micro_bound(
            f"{key}, FP32 instructions", pairs * DOTS_INSNS_PER_PAIR[fma],
            FP32_ISSUE, nbytes(xt, g, *got))["bound_ms"]
        lanes = props.multi_processor_count * 128 * mhz * 1e6
        issue_ms = pairs * per_pair[fma]["instructions"] / lanes * 1e3
        print(f"[k5] {key}: {ms:.4f} ms ({card}); SM clock under load "
              f"{mhz:.0f} MHz, {watts:.0f} W; the row loop's "
              f"{per_pair[fma]['instructions']:.3f} instructions a pair at "
              f"that clock {issue_ms:.4f} ms, over the persistent grid's "
              f"last round ({n_blocks} blocks on {ctas} CTAs: {tail:.4f}) "
              f"{issue_ms / tail:.4f} ms = {issue_ms / tail / ms:.3f} of "
              f"the time; torch.profiler: "
              + (f"{prof_ms:.4f} ms a launch" if prof_ms else "no kernel "
                 "event seen"), flush=True)
        entries[key] = dict(
            name=key, replaces="exp/r4_mxu_micro.py:68 (K5, vpu_kernel"
            + ("; the instance with explicit FMAs)" if fma else ")"),
            max_abs_err=errs[0], ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, library_bound_ms=lib_b["bound_ms"],
            library_bound_by=lib_b["bound_by"],
            element_bound_ratio=list(ratio),
            library_element_bound_ratio=list(lib_ratio),
            sass_per_pair=per_pair[fma], sm_clock_mhz=mhz,
            power_draw_w=watts, issue_ms_at_clock=issue_ms,
            profiler_ms=prof_ms,
            last_round_share=tail, **b)
        del got
    return entries


def micro_phase(card, dev):
    """Phase 11: K4-K7 against their plain versions at full shape, their
    times and bounds, then path A's two records with launch counts from
    zero. Returns the kernels' entries for the JSON line."""
    library_sass = sass.run()
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
    entries.update(dots_fp32_entries(xt, g, card, library_sass))
    flops = 2 * n_blocks * mk.BLOCK_C_ROWS * mk.DOT_DEPTH * TILE
    exact = (c[-mk.BLOCK_C_ROWS:].double().reshape(-1, mk.BLOCK_ROWS,
                                                   mk.DOT_DEPTH).sum(0)
             @ phi.double())
    # K6/K7 (two instances) must run on the tensor cores' warpgroup
    # products and keep their accumulators in registers.
    census = {name: counts for name, (counts, _) in library_sass.items()
              if "dots_bf16_kernel" in name}
    check(len(census) == 2, f"SASS: {len(census)} dots_bf16_kernel "
          f"instances, expected 2 (K6, K7): {sorted(census)}")
    for name, counts in census.items():
        print(f"[sass] {name}: " + ", ".join(
            f"{k} {v}" for k, v in counts.items()), flush=True)
        check(counts.get("HGMMA", 0) > 0, f"{name}: no HGMMA")
        check(not (counts.get("LDL") or counts.get("STL")),
              f"{name}: local memory (LDL/STL)")
    for split, key, rep in (
            (False, "dots_bf16", "exp/r4_mxu_micro.py:89 (K6, mxu1_kernel)"),
            (True, "dots_bf16x3",
             "exp/r4_mxu_micro.py:101 (K7, mxu3_kernel)")):
        want = mk.dots_bf16_plain(phi, c, split=split)
        tols = [BF16_TOL * float(w.abs().max()) for w in want]
        library = mk.dots_bf16_library(phi, c, split=split)
        runs = {"kernel": lambda: mk.dots_bf16(phi, c, split=split),
                "library": lambda: (lambda r: (r[-1], r.sum(1)))(library())}
        for what, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
            rel64 = float((got[0].double() - exact).abs().max()
                          / exact.abs().max())
            print(f"[micro] {key} ({what}), {n_blocks} blocks x {TILE} "
                  f"rays: last block's sums max |err| {errs[0]:.3e} "
                  f"(tolerance {tols[0]:.3e}), column sums of all blocks "
                  f"max |err| {errs[1]:.3e} (tolerance {tols[1]:.3e}); "
                  f"the last block against the f64 product: relative "
                  f"error {rel64:.3e}", flush=True)
            check(errs[0] <= tols[0] and errs[1] <= tols[1],
                  f"{key} ({what}) differs from its plain version beyond "
                  f"{BF16_TOL} x max|ref|")
            if what == "kernel":
                err, rel_kernel = errs[0], rel64
            del got
        check(rel_kernel < (1e-4 if split else 2e-2),
              f"{key}: relative error {rel_kernel} against f64")
        ms, plain_ms = timed_pair(
            key, runs["kernel"],
            lambda: mk.dots_bf16(phi, c[:hb * mk.BLOCK_C_ROWS], split=split),
            lambda: mk.dots_bf16_plain(phi, c, split=split), card)
        library_ms = cuda_ms(library, iters=20, warmup=2)
        print(f"[micro] {key}: library product {library_ms:.4f} ms (one "
              f"torch.mm, bf16 operands, f32 output) ({card})", flush=True)
        ops = flops * (3 if split else 1)
        b = micro_bound(key, ops, BF16_PEAK, nbytes(phi, c, *want))
        # The library call reads its bf16 layout and writes every block's
        # (128, T) sums: its own least time, beside library_ms.
        depth = mk.BLOCK_C_ROWS // mk.BLOCK_ROWS * mk.DOT_DEPTH * (
            3 if split else 1)
        lib_bytes = 2 * depth * (n_blocks * mk.BLOCK_ROWS + TILE) \
            + 4 * n_blocks * mk.BLOCK_ROWS * TILE
        lib_bound = micro_bound(f"{key} (library product)", ops, BF16_PEAK,
                                lib_bytes)["bound_ms"]
        entries[key] = dict(name=key, replaces=rep, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, rel_err_f64=rel_kernel,
                            library_ms=library_ms,
                            library_bound_ms=lib_bound, **b)
        del library
    del xt, g, phi, c, want

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
        # K5's function is one FP32 torch.mm, K6/K7's one bf16 torch.mm;
        # K4's (a planned sweep with an early out) is no library call.
        e.setdefault("library_ms", None)
        e.update(route="cuda", source=MICRO_SOURCE, launches=counts[key])
    return list(entries.values())


def march_entry(m, ref_launches, lockstep):
    """The kernels line's wavefront_march entry: the irregular primary
    frame's trace (the main path's first wave), the AO wave's, the path
    bounce's and the uniform frame's beside it, and phase 14's
    trace_irregular / trace_uniform calls (launches added to phase 12's).
    Every ray is compared bit for bit, so max_abs_err is the largest |dt|
    (0 when equal). No single PyTorch call marches a ray: library_ms is
    null."""
    prim = m["march"]["irregular primary"]
    ao = m["march"]["irregular AO wave"]
    bounce = m["march"]["irregular path bounce"]
    uni = m["march"]["uniform primary"]
    dt = max([r["max_abs_dt"] for r in m["march"].values()] + [m["row_dt"]]
             + [r["max_abs_dt"] for r in lockstep.values()])
    census = m["census"]
    return dict(
        name="wavefront_march", route="cuda", source=MARCH_SOURCE,
        replaces=MARCH_REPLACES, launches=m["launches"] + ref_launches,
        launches_reference_options=ref_launches,
        lockstep_entry_points={
            k: dict(kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                    plain_rays=r["subset"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"])
            for k, r in lockstep.items()},
        max_abs_err=dt,
        ms=prim["ms"], plain_ms=prim["plain_ms"], bound_ms=prim["bound_ms"],
        bound_by=prim["bound_by"], library_ms=None,
        bound_ops_ms=prim["bound_ops_ms"],
        bound_bytes_ms=prim["bound_bytes_ms"],
        table_bytes_ms=prim["table_bytes_ms"],
        gathered_ms=prim["gathered_ms"],
        simd_efficiency=prim["simd_efficiency"], refill=prim["refill"],
        ms_by_refill=prim["ms_by_refill"],
        ms_in_frame={k: c["march_ms"] for k, c in census.items()},
        ms_ao=ao["ms"], plain_ms_ao=ao["plain_ms"],
        bound_ms_ao=ao["bound_ms"], bound_by_ao=ao["bound_by"],
        simd_efficiency_ao=ao["simd_efficiency"],
        ms_bounce=bounce["ms"], plain_ms_bounce=bounce["plain_ms"],
        bound_ms_bounce=bounce["bound_ms"],
        bound_by_bounce=bounce["bound_by"],
        simd_efficiency_bounce=bounce["simd_efficiency"],
        ms_by_refill_bounce=bounce["ms_by_refill"],
        ms_uniform=uni["ms"], plain_ms_uniform=uni["plain_ms"],
        bound_ms_uniform=uni["bound_ms"], bound_by_uniform=uni["bound_by"],
        simd_efficiency_uniform=uni["simd_efficiency"],
        device_kernels_per_frame={k: c["device_kernels"]
                                  for k, c in census.items()},
        idle_share={k: c["idle_share"] for k, c in census.items()},
        ptxas=m["ptxas"])


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
             or "entry function" in ln or "wgmma" in ln]
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

    # 12. the paper's structures: irregular and uniform grids, wavefront
    s_irr, irr_wave, s_uni, march = structures_phase(v, tris, rays, card)

    # 13. the packet grid's options, the OBJ loader, sharding, the CLI
    opts, opt_launches = options_phase(v, f, tris, rays, hits, grid, session,
                                       ao["wave"], path["b1"], card)
    opt_err = {k: max(opts["streams"][s]["max_abs_err"] for s in names)
               for k, names in (("k2", ("primary_refine", "primary_adaptive",
                                        "path_fine")),
                                ("k3", ("ao_refine", "ao_fine")))}

    # 14. the reference's options through K2/K3, the session and K8
    _, ref_launches, ref_streams, ref_march = reference_options_phase(
        session, rays, hits, tris, ao["wave"], s_irr, irr_wave, s_uni, cam,
        card)
    k2_c = ref_streams["k2_compact_coherent"]
    k3_d = ref_streams["k3_dense_incoherent"]

    # 6. optional device-time breakdown, run last
    if profile_path is not False:
        for what, fn in (("frame", lambda: session.trace(rays, coherent=True)),
                         ("warm rebuild", lambda: session.rebuild(tris)),
                         ("AO wave", lambda: integrators.trace_sorted(
                             session, ao["wave"], any_hit=True,
                             cal_key="ao")),
                         ("render_ao", slice_runs["render_ao"]),
                         ("ambient_occlusion",
                          slice_runs["ambient_occlusion"]),
                         ("irregular primary frame",
                          lambda: s_irr.trace(rays, coherent=True)),
                         ("irregular AO wave",
                          lambda: integrators.trace_sorted(
                              s_irr, irr_wave, any_hit=True)),
                         ("uniform primary frame",
                          lambda: s_uni.trace(rays, coherent=True))):
            profile(what, fn, card, profile_path)

    # ms/plain_ms: the gather call (the main path's); *_pregathered: the
    # same kernel called K1's way in phase 3, which the main path never
    # makes. launches: the main path's count (phase 4 for closest hit,
    # phase 8 for any hit, phase 11's records for K4-K7, phase 12 for the
    # march) and phase 14's (launches_reference_options beside it); the
    # dynamic frames' sweep launches ride on the closest-hit entry, phase
    # 13's (option grids, fine bins) on both sweep entries. No single
    # PyTorch call computes the sweep: library_ms is null.
    kernels = [
        dict(name="sweep_blocks", route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES,
             launches=launches + ref_launches["sweep_blocks"],
             launches_reference_options=ref_launches["sweep_blocks"],
             max_abs_err=max(err, err1, err_r, path["err"], opt_err["k2"],
                             k2_c["max_abs_err"]),
             ms=ms,
             plain_ms=plain_ms,
             bound_ms=bound_k12["bound_ms"], bound_by=bound_k12["bound_by"],
             library_ms=None, blocks_skipped=bound_k12["blocks_skipped"],
             bound_ms_no_fma=bound_k12["bound_ms_no_fma"],
             ms_pregathered=ms1, plain_ms_pregathered=plain_ms1,
             launches_dynamic=dyn["launches"],
             launches_path=slice_launches["path_trace"],
             launches_options=opt_launches["sweep_blocks"],
             ms_incoherent=path["ms"], plain_ms_incoherent=path["plain_ms"],
             bound_ms_incoherent=path["bound"]["bound_ms"],
             blocks_skipped_incoherent=path["bound"]["blocks_skipped"],
             ms_compact_coherent=k2_c["ms"],
             plain_ms_compact_coherent=k2_c["plain_ms"],
             bound_ms_compact_coherent=k2_c["bound_ms"],
             blocks_compact_coherent=k2_c["blocks"]),
        dict(name="sweep_blocks_anyhit", route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES_ANYHIT,
             launches=(slice_launches["sweep_blocks_anyhit"]
                       + ref_launches["sweep_blocks_anyhit"]),
             launches_reference_options=ref_launches["sweep_blocks_anyhit"],
             launches_options=opt_launches["sweep_blocks_anyhit"],
             max_abs_err=max(ao["err"], opt_err["k3"], k3_d["max_abs_err"]),
             ms=ao["ms"], plain_ms=ao["plain_ms"],
             bound_ms=ao["bound"]["bound_ms"],
             bound_by=ao["bound"]["bound_by"], library_ms=None,
             blocks_skipped=ao["bound"]["blocks_skipped"],
             bound_ms_no_fma=ao["bound"]["bound_ms_no_fma"],
             ms_dense_incoherent=k3_d["ms"],
             plain_ms_dense_incoherent=k3_d["plain_ms"],
             bound_ms_dense_incoherent=k3_d["bound_ms"],
             blocks_dense_incoherent=k3_d["blocks"]),
        *micro_kernels,
        march_entry(march, ref_launches["wavefront_march"], ref_march)]
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
                    help="also time the sweep at other chunk sizes and "
                    "the wavefront march at other launch bounds")
    try:
        a = ap.parse_args()
        sys.exit(main(a.profile, a.variants))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
