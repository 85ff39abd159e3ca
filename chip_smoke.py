#!/usr/bin/env python3
"""The port's kernels timed alone (hagrid_tpu_torch on one NVIDIA GPU).

    python3 chip_smoke.py [--variants]

Each hand-written kernel that a benchmark cell runs is timed alone on
that cell's input; K4-K7, which no cell runs, on the reference scripts'
shapes. Lines, in order (any failure exits non-zero before the last):
1. the card (nvidia-smi name and power limit) and the environment;
2. the build of hagrid_tpu_torch/csrc (nvcc, sm_90a), ptxas's registers
   and spills;
3. a readable line for each kernel, then one JSON line
   {"kernels": {name: record}}:
   - K2 and K1 (csrc/sweep.cu, the gather and the pre-gathered call) on
     the round-0 stream of the Sponza-scale scene's 1024x1024 primaries
     (sponza-packet.*);
   - K3 (its any-hit instance) on the round-0 stream of AO wave 0 of
     that frame (sponza-packet.ao1);
   - K8 (csrc/wavefront.cu) on the irregular grid's primary frame, at
     the trace's refill threshold (sponza-irregular.dynamic); untimed,
     its irregular AO wave 0, path bounce 1, uniform primary frame and
     per-row mode against the plain version too;
   - S1 (csrc/scatter.cu) on the largest call of each site: the
     irregular warm rebuild (and its calls together), the packet build
     and the packet planner (the two .dynamic cells);
   - K2 on the round-0 stream of path bounce 1 of the atrium open to the
     sky at 512x512, and S2 (csrc/scan.cu) on the largest suffix min of
     that bounce's closest-hit planner (sponza-open-packet.path);
   - K4-K7 (csrc/micro.cu) at the reference scripts' full shapes, with
     their SASS checks and library products, and path A's entry points
     (hagrid_tpu_torch.exp.kernel_mt20, .mxu_micro).
   A record holds ms (the kernel alone: the median of runs between CUDA
   events, utils/profiling.py::timed), plain_ms (its plain PyTorch
   version on the same input), bound_ms / bound_by (the larger of its
   operations at the peak and its bytes read and written once at the
   HBM rate), max_abs_err (one comparison with the plain version on the
   same input; 0 where they are bit-equal; a sweep stream's launch plan
   must also equal the plan's plain version), launches (the kernel's
   launches in one call of the entry point that feeds it, counted from
   zero; a captured graph's at its replay) and ptxas (registers, stack
   frame and spills of its instances; null when the library came from
   an earlier build). With --variants, K2 and K3 are also timed at other
   chunk sizes, K8 at other refill thresholds;
4. {"ok": true, "device": {...}}.

Correctness on the card is the card tests' (python -m pytest --noconftest
-m gpu tests/test_torch_gpu.py), frame times and full-size correctness
the benchmark's (benchmark/run.py), the reference bench's workloads
bench_torch.py's. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from hagrid_tpu_torch import scenes
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.exp import kernel_mt20, mxu_micro, sass
from hagrid_tpu_torch.grid import irregular
from hagrid_tpu_torch.grid.packet import build_packet
from hagrid_tpu_torch.ops import _build, segment, sortrays, wavefront
from hagrid_tpu_torch.ops import micro_kernels as mk
from hagrid_tpu_torch.ops import sweep_kernel as sk
from hagrid_tpu_torch.ops.sweep_kernel import sweep_blocks, sweep_blocks_plain
from hagrid_tpu_torch.ops.sweep_trace import first_round_stream, trace_sweep
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.sampling import (cosine_hemisphere,
                                              hit_points_normals)
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils.config import BuildParams
from hagrid_tpu_torch.utils.profiling import timed

DEV = "cuda"
TILE = 512
PATH_SIZE = 512                  # sponza-open-packet's frame
KERNEL_SOURCE = "hagrid_tpu_torch/csrc/sweep.cu"
MICRO_SOURCE = "hagrid_tpu_torch/csrc/micro.cu"
MARCH_SOURCE = "hagrid_tpu_torch/csrc/wavefront.cu"
SCATTER_SOURCE = "hagrid_tpu_torch/csrc/scatter.cu"
SCAN_SOURCE = "hagrid_tpu_torch/csrc/scan.cu"
# One __global__ stands for both TPU schedules of the sweep: the gather
# call replaces _make_kernel_dma (K2), the pre-gathered call _make_kernel
# (K1).
REPLACES_K2 = "hagrid_tpu/ops/sweep_trace.py:248 (K2, _make_kernel_dma)"
REPLACES_K1 = "hagrid_tpu/ops/sweep_trace.py:210 (K1, _make_kernel)"
REPLACES_K3 = ("hagrid_tpu/ops/sweep_trace.py:132-133,179-180 (K3, the "
               "any_hit=True instances of K1/K2)")
MARCH_REPLACES = ("hagrid_tpu/ops/wavefront.py:290-311 (_jit_segment: an XLA "
                  "while_loop of _make_body, no Pallas kernel) and the round "
                  "loop of trace, :350-418")
SCATTER_REPLACES = ("hagrid_tpu/ops/segment.py:51 and the builds' other "
                    "integer .at[idx].add(..., mode=\"drop\") (XLA "
                    "scatters; no Pallas kernel)")
SCAN_REPLACES = ("hagrid_tpu/ops/sweep_trace.py:1093 associative_scan"
                 "(minimum) (an XLA scan; no Pallas kernel)")
# FP32 operations per ray-ref pair, counted from HitBody::test in
# csrc/sweep.cu: 5 (det) + 6 (t*det) + 11 (u*det) + 11 (v*det) + 1 (w) + 2
# (a*hi, a*lo) + 2 (us+vs, a+w) + 6 compares, for both instances (any hit
# folds tmax into hi). The exact path of the few pairs the test passes is
# not counted, so the bound stays a lower bound.
OPS_PER_PAIR = 44
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
# The wavefront march kernel. FP32 operations counted from
# csrc/wavefront.cu: per ref tested (mt_update) 9 (cross) + 5 (det) + 2
# (|det| > eps) + 1 (1/det) + 3 (o - v0) + 6 (u) + 9 (cross) + 6 (v) + 6
# (t) + 6 (the hit's compares and u + v) + 2 (t against the best); per cell
# exit 18 (the planes and their t, 6 an axis) + 2 (argmin) + 1 (isfinite)
# + 2 (terminated) + 6 (the exit point) + 6 (into voxel units) + 3 (floor)
# + 3 (to int); per ray 3 (1/d) + 24 (the slab test, 8 an axis) + 6 (its
# reductions with tmin, tmax) + 1 (enter <= exit), and per ray that starts
# alive 6 (the entry point) + 12 (its voxel) + 1 (t_cur). Integer work and
# selects are not counted.
MARCH_OPS_PER_TEST = 55
MARCH_OPS_PER_EXIT = 41
MARCH_OPS_PER_RAY = 34
MARCH_OPS_PER_START = 19
# Bytes a ray, read once (org 12, dir 12, tmin, tmax) and written once
# (t, id, u, v, steps).
MARCH_RAY_BYTES = 32 + 20
MARCH_MODES = {0: "quad rows", 1: "per row", 2: "uniform"}
MARCH_ITERS = 10               # back-to-back launches timed
MARCH_REFILLS = (32, 24, 16, 12, 8, 6, 4, 2, 1)   # --variants
# Calls of one shape captured back to back in one graph (S1, S2).
CHAIN = 10
SCAN_ROW = 1024                # the two-level plain scan's row


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


# ----------------------------------------------------------------------
# Timing, launches, ptxas, the record
# ----------------------------------------------------------------------

def kernel_ms(fn, chain=20, iters=5, warmup=2):
    """Device ms of one call of fn: the median over `iters` runs of
    `chain` back-to-back calls between CUDA events
    (utils/profiling.py::timed)."""
    return timed(fn, warmup=warmup, iters=iters, chain=chain,
                 device=DEV) * 1e3


def once_ms(fn):
    """Device ms of one call of fn, unwarmed (a plain version)."""
    return kernel_ms(fn, chain=1, iters=1, warmup=0)


def graph_ms(fn, chain=CHAIN):
    """Device ms of one call of fn from replays of `chain` calls captured
    in one CUDA graph (exp/kernel_mt20.graphed: no host time between the
    calls, each replay's launches counted)."""
    return kernel_ms(kernel_mt20.graphed(fn, chain, DEV), chain=1,
                     iters=5, warmup=1) / chain


def march_ms(call, refill=None, iters=MARCH_ITERS):
    """Device ms of one launch of the march kernel on a trace's inputs:
    the arguments packed once, then `iters` launches of the C entry point
    back to back, each between two CUDA events with the ray counter
    zeroed before its first event (the wrapper and its read stay out of
    the time; these launches bypass the wrapper's count). Returns (ms,
    (blocks an SM, blocks launched)). refill: the trace's own threshold
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


def launches_in(fn, counts, name):
    """The launches of kernel `name` (in its wrapper's dict `counts`) in
    one call of fn, after two calls that calibrate and capture."""
    fn()
    fn()
    torch.cuda.synchronize()
    before = counts[name]
    fn()
    torch.cuda.synchronize()
    return counts[name] - before


def ptxas(*symbols):
    """Registers, stack frame and spills of each entry function whose
    mangled name holds all of `symbols` (an instance: its template
    arguments as mangled, e.g. "ILb1E" for <true>), from this process's
    build log ({name: {...}}); None when the library came from an
    earlier build."""
    out, name = {}, None
    for ln in _build.last_build.get("log", "").splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
            name = fn if all(s in fn for s in symbols) else None
            if name:
                out[name] = {}
        elif name and "bytes stack frame" in ln:
            nums = [int(x) for x in ln.split() if x.isdigit()]
            out[name].update(stack=nums[0], spill_stores=nums[1],
                             spill_loads=nums[2])
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split()[0])
            name = None
    return out or None


def bound_of(ops, rate, moved):
    """The least time: the larger of `ops` at `rate` and `moved` bytes at
    the HBM rate."""
    ops_ms, bytes_ms = ops / rate * 1e3, moved / HBM_RATE * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_ops_ms=ops_ms,
                bound_bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def emit(rec, card):
    """Print one kernel's record as a readable line; main prints every
    record together in the JSON line {"kernels": {name: record}}."""
    rec["card"] = card
    print(f"[{rec['name']}] {rec['input']}: kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms by "
          f"{rec['bound_by']}; max |err| {rec['max_abs_err']:g}; launches "
          f"{rec['launches']} ({card})", flush=True)
    return rec


# ----------------------------------------------------------------------
# The sweep kernel (K1-K3)
# ----------------------------------------------------------------------

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
    print(f"[compare] {name}: {int(rays.sum())} rays in swept tiles, "
          f"{int((id_k >= 0).sum())} hits, id agreement {agree:.6f}, "
          f"max |dt| {max_err:.3e} (t rtol 1e-5: {t_ok})", flush=True)
    check(agree >= 0.9999, f"{name}: ids agree on only {agree:.6f}")
    check(t_ok, f"{name}: t differs beyond rtol 1e-5")
    return max_err


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
    print(f"[compare] {name}: {int(rays.sum())} rays in swept tiles, "
          f"{int(hit_k.sum())} kernel hits, {int(hit_p.sum())} plain hits, "
          f"hit/miss differ on {n_diff}; every kernel hit genuine at its t "
          f"inside (tmin, tmax): {genuine}; t >= plain t: {not_closer}",
          flush=True)
    check(n_diff == 0, f"{name}: hit/miss differs on {n_diff} rays")
    check(genuine, f"{name}: a kernel hit is not genuine")
    check(not_closer, f"{name}: a kernel hit is closer than the closest")
    return float(n_diff > 0)


def both_sweeps(xt, cols, gidx, tile_of, tminb, tile=TILE, any_hit=False):
    args = (xt, cols, gidx, tile_of, tminb, tile)
    got = sweep_blocks(*args, any_hit=any_hit)
    ref = sweep_blocks_plain(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    return got, ref, args


def sweep_bound(args, any_hit):
    """The least time the card could take for this stream: the larger of
    the FP32 operations of the pairs the kernel actually sweeps (live
    blocks less the blocks its early-out skips, counted by the kernel)
    over the FP32 peak, and the bytes the function must move (xt, the
    block tables and the distinct units read once, the outputs written
    once) over the HBM rate. The pairs include dead lanes (padding refs
    and dead rays) and, for any hit, rays that already hit inside a block
    that was not skipped; bound_ms_no_fma holds the operations at the
    non-FMA issue rate."""
    xt, cols, gidx, tile_of, tminb, tile = args
    nt = xt.shape[1] // tile - 1
    skipped = torch.zeros(nt, dtype=torch.int32, device=xt.device)
    sweep_blocks(*args, any_hit=any_hit, skipped=skipped)
    live_blocks = tile_of < nt
    live = int(live_blocks.sum())
    skip = int(skipped.sum())
    pairs = (live - skip) * REFS_PER_BLOCK * tile
    units = gidx.reshape(-1, 32)[live_blocks].unique().numel()
    moved = (xt.numel() * 4 + units * cols.shape[1] * 4 * 4
             + (gidx.numel() + 2 * tile_of.numel()) * 4
             + 4 * xt.shape[1] * 4)
    b = bound_of(pairs * OPS_PER_PAIR, FP32_PEAK, moved)
    return dict(b, live_blocks=live, blocks_skipped=skip, pairs=pairs,
                bytes=moved, bound_ms_no_fma=bound_of(
                    pairs * OPS_PER_PAIR, FP32_ISSUE, moved)["bound_ms"])


def variants(what, args, any_hit, card, chunks=(4, 8, 16, 32, 64, None)):
    """The kernel's time on one stream at other chunk sizes C (None: whole
    runs, one CTA a tile), between two timings of the default."""
    n_blocks = args[3].numel()
    rows = [("default", None)]
    rows += [(f"C={c or 'whole'}", c or n_blocks) for c in chunks]
    rows.append(("default again", None))
    got = [(name, kernel_ms(lambda: sk._sweep_cuda(*args, any_hit, None, c),
                            chain=5, iters=3, warmup=1))
           for name, c in rows]
    print(f"[variants] {what} ({card}): " + ", ".join(
        f"{n} {ms:.3f} ms" for n, ms in got), flush=True)


def sweep_record(name, what, replaces, args, any_hit, err, launches, card,
                 with_variants):
    """One stream's record: the kernel alone, its plain version, the
    stream's bound, ptxas's line for the instance (any_hit). The stream's
    launch plan (the plan kernel's) must equal its plain version."""
    xt, tile_of, tile = args[0], args[3], args[5]
    nt = xt.shape[1] // tile - 1
    chunk = sk.chunk_blocks(tile_of.numel())
    check(all(torch.equal(a, w) for a, w in zip(
        sk.chunk_plan(tile_of, nt, chunk),
        sk.chunk_plan_plain(tile_of, nt, chunk))),
        f"{name}: the plan kernel differs from its plain version")
    rec = dict(name=name, input=what, route="cuda", source=KERNEL_SOURCE,
               replaces=replaces, max_abs_err=err, launches=launches,
               ms=kernel_ms(lambda: sweep_blocks(*args, any_hit=any_hit)),
               plain_ms=once_ms(lambda: sweep_blocks_plain(
                   *args, any_hit=any_hit)),
               library_ms=None, **sweep_bound(args, any_hit),
               ptxas=ptxas("sweep_kernel", f"HitBodyILb{int(any_hit)}E"))
    if with_variants:
        variants(what, args, any_hit, card)
    return emit(rec, card)


def primary_records(session, rays, card, with_variants):
    """K2 and K1 on the primaries' round-0 stream; K2's launches in one
    (replayed) coherent trace of the frame."""
    grid = session.grid
    xt, gidx, tile_of, tminb, _ = first_round_stream(grid, rays, tile=TILE)
    what = (f"Sponza 1024x1024 primaries, round 0: "
            f"{int((tile_of < rays.count // TILE).sum())} blocks of "
            f"{tile_of.numel()} budgeted")
    got, ref, args = both_sweeps(xt, grid.cols, gidx, tile_of, tminb)
    err = compare_sweeps("K2, primaries round 0", got, ref, tile_of)
    launches = launches_in(lambda: session.trace(rays, coherent=True),
                           sk.launches, "sweep_blocks")
    check(not session.poll_overflow(recalibrate=False),
          "the primary frame overflowed its budget")
    k2 = sweep_record("K2", what, REPLACES_K2, args, False, err, launches,
                      card, with_variants)
    # The pre-gathered call: the gathered stream as cols, gidx = arange.
    g_round = grid.cols.reshape(-1, 4, 128)[gidx.long()].reshape(-1, 128)
    seq = torch.arange(gidx.numel(), dtype=torch.int32, device=DEV)
    got1, _, args1 = both_sweeps(xt, g_round, seq, tile_of, tminb)
    err1 = compare_sweeps("K1, primaries round 0", got1, ref, tile_of)
    check(all(torch.equal(a, b) for a, b in zip(got1, got)),
          "the pre-gathered call differs from the gather call")
    # The main path makes K2's call only.
    k1 = sweep_record("K1", what, REPLACES_K1, args1, False, err1, 0, card,
                      False)
    return [k2, k1]


def ao_record(session, rays, tris, card, with_variants):
    """K3 on AO wave 0 (1 sample a pixel, default_ao_distance) of the
    primaries' hits, at the budgets its trace_sorted calibrates; its
    launches in one (replayed) trace of the wave."""
    grid = session.grid
    hits = session.trace(rays, coherent=True)
    p, n, found = hit_points_normals(rays, hits, tris.n)
    gen = torch.Generator(device=DEV).manual_seed(0)
    wave = integrators.ao_rays(p, n, found,
                               integrators.default_ao_distance(session), gen)
    launches = launches_in(lambda: integrators.trace_sorted(
        session, wave, any_hit=True, cal_key="ao"), sk.launches,
        "sweep_blocks_anyhit")
    check(not session.poll_overflow(recalibrate=False),
          "AO wave 0 overflowed its budgets")
    bmax, rowmax = session._bmax_cal[(True, False, wave.count, "ao")]
    srt, _ = sortrays.sort_rays(wave, grid.bbox_lo, grid.bbox_hi, bits=10,
                                origin_major=True)
    xt, gidx, tile_of, tminb, tile = first_round_stream(
        grid, srt, any_hit=True, coherent=False, bmax=bmax, rowmax=rowmax)
    nt = xt.shape[1] // tile - 1
    what = (f"Sponza AO wave 0 ({wave.count} rays), round 0: "
            f"{int((tile_of < nt).sum())} blocks of {tile_of.numel()} "
            f"budgeted, tile {tile}")
    got, ref, args = both_sweeps(xt, grid.cols, gidx, tile_of, tminb, tile,
                                 any_hit=True)
    err = compare_anyhit("K3, AO wave 0 round 0", got, ref, args,
                         tri_rows(grid.cols, tris.count))
    del got, ref
    return sweep_record("K3", what, REPLACES_K3, args, True, err, launches,
                        card, with_variants)


# ----------------------------------------------------------------------
# The wavefront march (K8)
# ----------------------------------------------------------------------

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
    """One trace through the kernel as the main path runs it, once more
    through its work-counting instance, and once through trace_plain on
    the card, on the same inputs: tri ids, the bits of t/u/v and every
    ray's steps equal, no ray truncated. Returns (the kernel run's stats,
    its steps, the work counters, max |dt| over rays both hit)."""
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
    got_w = wavefront.trace(grid, lk, rays, rpi, any_hit, coherent=coherent,
                            steps=work_steps, work=work)
    work_stats = dict(wavefront.last_trace_stats)
    bad, dt = hits_bits_diff(got, want)
    bad_w, _ = hits_bits_diff(got_w, want)
    same, same_w = (torch.equal(s, want_steps) for s in (steps, work_steps))
    print(f"[compare] K8, {name} ({rays.count} rays, "
          f"{MARCH_MODES[wavefront.kernel_mode(grid, lk)]}): the kernel and "
          f"its counting instance against trace_plain on every ray: fields "
          f"not bit-equal {bad} / {bad_w}, steps equal {same} / {same_w}, "
          f"truncated {stats['truncated_rays']} / "
          f"{work_stats['truncated_rays']} / {plain_stats['truncated_rays']}"
          f", plain rounds {plain_stats['rounds']}", flush=True)
    check(not bad and same, f"{name}: the march kernel differs from "
          f"trace_plain ({bad}, steps equal: {same})")
    check(not bad_w and same_w, f"{name}: the march kernel's counting "
          f"instance differs from trace_plain ({bad_w}, steps equal: "
          f"{same_w})")
    check(stats["truncated_rays"] == work_stats["truncated_rays"]
          == plain_stats["truncated_rays"] == 0, f"{name}: rays were "
          f"truncated")
    return stats, steps, [int(x) for x in work.tolist()], dt


def main_path_call(name, fn):
    """The one call of wavefront.trace that fn makes, as (grid, lookup,
    rays, refs_per_iter, any_hit, coherent), after checking that one call
    of fn launches the march kernel once."""
    launches = launches_in(fn, wavefront.launches, "wavefront_march")
    check(launches == 1, f"{name}: {launches} march launches in one call")
    with trace_calls() as calls:
        out = fn()
    check(len(calls) == 1, f"{name}: {len(calls)} traces in one call")
    return calls[0], out


def per_row(call):
    """The same trace on the same grid with one ref row more: the
    kernel's per-row packed mode."""
    grid, lk, rays, rpi, any_hit, coherent = call
    odd = grid.replace(ref_tris=torch.cat([grid.ref_tris,
                                           grid.ref_tris[:1]]))
    check(wavefront.kernel_mode(odd, lk) == 1,
          "the padded grid is not per-row")
    return (odd, lk, rays, rpi, any_hit, coherent)


def march_record(s_irr, s_uni, rays, tris, card, with_variants):
    """K8 on the irregular primary frame's trace: against trace_plain
    (march_against_plain); its time alone at the trace's refill
    threshold; the bound from the work the trace's data needs (the
    kernel's counters: refs tested, cell exits, rays started) at the FP32
    peak, and its rays read and hits written once at the HBM rate (the
    table rows its rays visit are not counted). Untimed beside it, each
    with one launch a call and against trace_plain: the irregular AO wave
    0 (the any-hit instance) and path bounce 1 from that frame's hits,
    the uniform primary frame (the uniform mode), and the primary frame
    and the AO wave in the per-row mode."""
    call, hits = main_path_call(
        "irregular primary frame", lambda: s_irr.trace(rays, coherent=True))
    grid, lk, frame, rpi, any_hit, coherent = call
    stats, steps, work, dt = march_against_plain("irregular primary frame",
                                                 call)
    p, n, found = hit_points_normals(rays, hits, tris.n)
    gen = torch.Generator(device=DEV).manual_seed(0)
    wave = integrators.ao_rays(p, n, found,
                               integrators.default_ao_distance(s_irr), gen)
    bounce = integrators._spawn(p, n, cosine_hemisphere(n, gen), 0.0,
                                torch.where(found, float("inf"), 0.0))
    del hits, p, n, found
    calls = {"irregular primary frame, per row": per_row(call)}
    calls["irregular AO wave 0"], _ = main_path_call(
        "irregular AO wave 0", lambda: integrators.trace_sorted(
            s_irr, wave, any_hit=True))
    calls["irregular AO wave 0, per row"] = per_row(
        calls["irregular AO wave 0"])
    calls["irregular path bounce 1"], _ = main_path_call(
        "irregular path bounce 1", lambda: integrators.trace_sorted(
            s_irr, bounce, cal_key="path"))
    calls["uniform primary frame"], _ = main_path_call(
        "uniform primary frame", lambda: s_uni.trace(rays, coherent=True))
    compared = {}
    for name, c in calls.items():
        st, _, _, d = march_against_plain(name, c)
        compared[name] = dict(
            rays=c[2].count, any_hit=c[4],
            mode=MARCH_MODES[wavefront.kernel_mode(c[0], c[1])],
            mean_steps=st["mean_steps"], max_abs_dt=d)
    del calls, wave, bounce
    tests, _, exits, _, warp_iters = work
    n_rays, started = frame.count, int((steps > 0).sum())
    alive = int(steps.sum())
    ms, (per_sm, blocks) = march_ms(call)
    if with_variants:
        by = {r: round(march_ms(call, refill=r)[0], 4) for r in MARCH_REFILLS}
        print(f"[variants] K8 by refill threshold ({card}): {by}", flush=True)
    rec = dict(
        name="K8", input=(f"irregular primary frame, 1024x1024 "
                          f"({MARCH_MODES[wavefront.kernel_mode(grid, lk)]}, "
                          f"refill below {wavefront.REFILL[coherent]} live "
                          f"lanes, {blocks} blocks, {per_sm} an SM)"),
        route="cuda", source=MARCH_SOURCE, replaces=MARCH_REPLACES,
        max_abs_err=dt, launches=1, ms=ms,
        plain_ms=once_ms(lambda: wavefront.trace_plain(grid, lk, frame, rpi,
                                                       any_hit)),
        library_ms=None,
        **bound_of(tests * MARCH_OPS_PER_TEST + exits * MARCH_OPS_PER_EXIT
                   + n_rays * MARCH_OPS_PER_RAY
                   + started * MARCH_OPS_PER_START,
                   FP32_PEAK, n_rays * MARCH_RAY_BYTES),
        mean_steps=stats["mean_steps"],
        simd_efficiency=alive / max(32 * warp_iters, 1),
        compared=compared,
        ptxas=ptxas(f"march_kernelILi{wavefront.kernel_mode(grid, lk)}"
                    f"ELb{int(any_hit)}ELb0E"))
    return emit(rec, card)


# ----------------------------------------------------------------------
# The integer drop-mode scatter (S1) and the running scan (S2)
# ----------------------------------------------------------------------

@contextlib.contextmanager
def recording(name, copy):
    """Every call of segment.<name> within the block, as copy(*args) (copies
    of its inputs), then run as it is."""
    calls, real = [], getattr(segment, name)

    def rec(*args):
        calls.append(copy(*args))
        return real(*args)

    setattr(segment, name, rec)
    try:
        yield calls
    finally:
        setattr(segment, name, real)


def scatter_copy(n, idx, vals):
    """A scatter call's inputs: an expanded addend stays expanded, a
    Python fill stays a fill."""
    v = vals
    if torch.is_tensor(vals):
        v = vals.expand(idx.shape)
        v = (v[:1].clone().expand(idx.shape)
             if v.numel() and v.stride(0) == 0 else v.clone())
    return n, idx.clone(), v


def scatter_bytes(idx, vals):
    """Bytes of the indices and the addends, each read once (an expanded
    addend is one element, a fill none)."""
    b = idx.numel() * idx.element_size()
    if torch.is_tensor(vals):
        b += vals.element_size() * (vals.numel() if vals.stride(0) else 1)
    return b


def scatter_site(site, n, idx, vals):
    """One call held against add_at_drop_plain (bit-equal) and timed in
    graphs of CHAIN calls: the kernel, its plain version, and the
    library's index_add_ alone (into n + 1 zeroed slots, indices clamped
    and addends made beforehand)."""
    got = segment.add_at_drop(n, idx, vals)
    want = segment.add_at_drop_plain(n, idx, vals)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and torch.equal(got, want),
          f"{site}: the scatter kernel differs from its plain version")
    filled = (vals if torch.is_tensor(vals) else torch.full(
        idx.shape, vals, dtype=torch.int32, device=DEV))
    ci = idx.clamp(max=n).long()
    slots = torch.zeros((n + 1,), dtype=filled.dtype, device=DEV)
    b = scatter_bytes(idx, vals)
    return dict(
        site=site, rows=idx.numel(), n=n,
        idx_dtype=str(idx.dtype).replace("torch.", ""),
        vals=(str(vals.dtype).replace("torch.", "")
              + (" expanded" if vals.stride(0) == 0 else "")
              if torch.is_tensor(vals) else f"fill {vals}"),
        rows_dropped=int((idx >= n).sum()),
        ms=graph_ms(lambda: segment.add_at_drop(n, idx, vals)),
        plain_ms=graph_ms(lambda: segment.add_at_drop_plain(n, idx, vals)),
        library_ms=graph_ms(lambda: slots.zero_().index_add_(0, ci, filled)),
        bytes=b, **bound_of(0, FP32_PEAK, b))


def scatter_record(s_irr, s_pk, tris, rays, card):
    """S1 at the main path's shapes: the calls of an eager irregular warm
    rebuild (BuildParams(), the session's top dims), an eager packet warm
    rebuild and the planner of an eager packet primary frame are
    recorded; the largest call of each site is held against the plain
    version and timed (scatter_site), the irregular rebuild's calls all
    together in one graph. Launches: one replayed warm rebuild of the
    irregular session (one for each call of the eager build), and one
    replayed packet warm rebuild and primary frame."""
    def scatters(fn):
        with recording("add_at_drop_kernel", scatter_copy) as calls:
            out = fn()
            torch.cuda.synchronize()
        return calls, out

    g, recorded = s_pk.grid, {}
    recorded["irregular rebuild"], _ = scatters(
        lambda: irregular.build_irregular(tris, BuildParams(),
                                          top_dims=s_irr.grid.top_dims))
    recorded["packet build"], grid = scatters(
        lambda: build_packet(tris, bbox=s_pk.bbox, ref_capacity=g.ref_capacity,
                             dims3=g.dims3, check=False))
    recorded["packet planner"], _ = scatters(
        lambda: trace_sweep(grid, rays, coherent=True))
    del grid
    check(all(recorded.values()), "a site made no integer scatter: "
          + str({k: len(c) for k, c in recorded.items()}))
    sites = [scatter_site(what, *max(calls, key=lambda c: c[1].numel()))
             for what, calls in recorded.items()]
    irr = recorded["irregular rebuild"]

    def all_calls(fn):
        return lambda: [fn(n, idx, vals) for n, idx, vals in irr]
    build = dict(calls=len(irr),
                 ms=graph_ms(all_calls(segment.add_at_drop), 1),
                 plain_ms=graph_ms(all_calls(segment.add_at_drop_plain), 1),
                 bound_ms=sum(scatter_bytes(idx, vals) for _, idx, vals
                              in irr) / HBM_RATE * 1e3)
    counts = {what: launches_in(fn, segment.launches, "scatter_add_drop")
              for what, fn in (("irregular rebuild",
                                lambda: s_irr.rebuild(tris)),
                               ("packet rebuild", lambda: s_pk.rebuild(tris)),
                               ("packet primary frame",
                                lambda: s_pk.trace(rays, coherent=True)))}
    check(counts["irregular rebuild"] == len(irr),
          f"a replayed irregular warm rebuild launched the scatter "
          f"{counts['irregular rebuild']} times, its eager build called it "
          f"{len(irr)} times")
    check(counts["packet rebuild"] > 0 and counts["packet primary frame"] > 0,
          f"the packet session launched no scatter: {counts}")
    main = sites[0]
    for r in sites:
        print(f"[S1] {r['site']}: {r['rows']} {r['idx_dtype']} indices, n "
              f"{r['n']}, addends {r['vals']}, {r['rows_dropped']} dropped; "
              f"kernel {r['ms'] * 1e3:.1f} us, plain {r['plain_ms'] * 1e3:.1f}"
              f" us, index_add_ alone {r['library_ms'] * 1e3:.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.1f} us", flush=True)
    print(f"[S1] the irregular warm rebuild's {build['calls']} calls in one "
          f"graph: kernel {build['ms']:.4f} ms, plain {build['plain_ms']:.4f}"
          f" ms, bound {build['bound_ms']:.4f} ms", flush=True)
    rec = dict(name="S1", input=main["site"], route="cuda",
               source=SCATTER_SOURCE, replaces=SCATTER_REPLACES,
               max_abs_err=0, launches=counts,
               **{k: main[k] for k in ("rows", "n", "ms", "plain_ms",
                                       "library_ms", "bound_ms",
                                       "bound_by")},
               sites=sites, build=build,
               ptxas=ptxas("scatter_add_drop_kernel"))
    return emit(rec, card)


def two_level_scan(x, op):
    """The running max / min of 1-D x in plain torch across many blocks:
    torch.cummax / cummin along rows of SCAN_ROW values (torch spreads the
    rows over blocks), then along the rows' last values, each row
    combined with the carry of the rows before it."""
    n = x.numel()
    m = -(-n // SCAN_ROW)
    info = torch.iinfo(x.dtype)
    fill = info.min if op == "max" else info.max
    cum = torch.cummax if op == "max" else torch.cummin
    both = torch.maximum if op == "max" else torch.minimum
    rows = torch.cat([x, x.new_full((m * SCAN_ROW - n,), fill)]).view(
        m, SCAN_ROW)
    rows = cum(rows, 1).values
    carry = cum(rows[:, -1], 0).values
    carry = torch.cat([carry.new_full((1,), fill), carry[:-1]])
    return both(rows, carry[:, None]).view(-1)[:n]


def path_records(cam, card, with_variants):
    """On the atrium open to the sky at 512x512 (sponza-open-packet): path
    bounce 1 made as path_bounces makes it from the primaries' hits and
    traced through trace_sorted (the "path" budgets). K2 on its round-0
    stream; S2 on the largest running min of its closest-hit planner,
    recorded from an eager trace_sweep at those budgets, against
    torch.cummin and the two-level plain scan (bit-equal), in graphs of
    CHAIN calls, and not slower than either. Launches in one (replayed)
    trace of the bounce."""
    v, f = scenes.sponza_like(open_top=True)
    tris = Triangles.from_mesh(v, f, device=DEV)
    s = RenderSession.create(tris, structure="packet", verts=v)
    prim = primary_rays(cam, PATH_SIZE, PATH_SIZE, order="block", device=DEV)
    ph = s.trace(prim, coherent=True)
    p, nrm, found = hit_points_normals(prim, ph, tris.n)
    gen = torch.Generator(device=DEV).manual_seed(0)
    b1 = integrators._spawn(p, nrm, cosine_hemisphere(nrm, gen), 0.0,
                            torch.where(found, float("inf"), 0.0))

    def bounce():
        return integrators.trace_sorted(s, b1, cal_key="path")
    k2_launches = launches_in(bounce, sk.launches, "sweep_blocks")
    scan_launches = launches_in(bounce, segment.launches, "running_scan")
    check(not s.poll_overflow(recalibrate=False),
          "path bounce 1 overflowed its budgets")
    grid = s.grid
    bmax, rowmax = s._bmax_cal[(False, False, b1.count, "path")]
    srt, _ = sortrays.sort_rays(b1, grid.bbox_lo, grid.bbox_hi, bits=10,
                                origin_major=True)
    xt, gidx, tile_of, tminb, tile = first_round_stream(
        grid, srt, any_hit=False, coherent=False, bmax=bmax, rowmax=rowmax)
    nt = xt.shape[1] // tile - 1
    what = (f"open atrium path bounce 1 ({b1.count} rays, "
            f"{int(found.sum())} live), round 0: {int((tile_of < nt).sum())}"
            f" blocks of {tile_of.numel()} budgeted, tile {tile}")
    got, ref, args = both_sweeps(xt, grid.cols, gidx, tile_of, tminb, tile)
    err = compare_sweeps("K2, path bounce 1 round 0", got, ref, tile_of,
                         tile)
    del got, ref
    k2 = sweep_record("K2 path bounce", what, REPLACES_K2, args, False, err,
                      k2_launches, card, with_variants)

    with recording("running_min_kernel",
                   lambda x: (x.clone(),)) as calls:
        trace_sweep(grid, srt, coherent=False, bmax=bmax, rowmax=rowmax)
        torch.cuda.synchronize()
    check(calls, "the closest-hit planner made no running scan")
    x, = max(calls, key=lambda c: c[0].numel())
    got = segment.running_min(x)
    want = segment.running_min_plain(x)
    two = two_level_scan(x, "min")
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and torch.equal(got, want)
          and torch.equal(two, want),
          "the scan kernel or the two-level scan differs from torch.cummin")
    b = 2 * nbytes(x)
    rec = dict(name="S2", input=(f"path bounce 1's closest-hit planner: "
                                 f"running min of {x.numel()} "
                                 f"{str(x.dtype).replace('torch.', '')}"),
               route="cuda", source=SCAN_SOURCE, replaces=SCAN_REPLACES,
               max_abs_err=0, launches=scan_launches, n=x.numel(),
               ms=graph_ms(lambda: segment.running_min(x)),
               plain_ms=graph_ms(lambda: segment.running_min_plain(x)),
               two_level_ms=graph_ms(lambda: two_level_scan(x, "min")),
               library_ms=None, bytes=b, **bound_of(0, FP32_PEAK, b),
               ptxas=ptxas("running_scan_kernelI"
                           + {torch.int32: "i", torch.int64: "x"}[x.dtype]
                           + "Lb0E"))
    check(rec["ms"] < min(rec["plain_ms"], rec["two_level_ms"]),
          f"the scan kernel is not faster than the plain scans: {rec}")
    return [k2, emit(rec, card)]


# ----------------------------------------------------------------------
# The sweep-cost micro-kernels (K4-K7)
# ----------------------------------------------------------------------

def dots_fp32_census(library_sass):
    """K5's two instances in the built library's SASS (exp/sass.run's
    record): their row loop's instructions per pair (the loop does
    K5_LOOP_PAIRS pairs; its count includes the last block's stores, a
    few a row), checked: no local memory, FFMA in the FMA instance only,
    the ring's bulk copies, one row's 24 shared coefficient loads in the
    loop."""
    got = {}
    for name, (counts, body) in library_sass.items():
        if "dots_fp32_kernel" not in name:
            continue
        fma = any(t in name for t in ("(bool)1", "<true>", "ILb1E"))
        check(not (counts.get("LDL") or counts.get("STL")),
              f"{name}: local memory (LDL/STL)")
        check(bool(counts.get("FFMA")) == fma,
              f"{name}: FFMA {counts.get('FFMA', 0)} in the "
              f"{'FMA' if fma else 'plain'} instance")
        check(counts.get("UBLKCP", 0) > 0, f"{name}: no bulk copy")
        check(body is not None and body.get("LDS") == 24,
              f"{name}: no row loop with 24 shared loads: {body}")
        got[fma] = {k: body.get(k, 0) / K5_LOOP_PAIRS
                    for k in ("instructions", "FFMA", "FMUL", "FADD", "LDS")}
        print(f"[sass] {name}: " + ", ".join(
            f"{k} {v}" for k, v in counts.items()) + "; row loop per pair: "
            + ", ".join(f"{k} {v:.3f}" for k, v in got[fma].items()),
            flush=True)
    check(sorted(got) == [False, True],
          f"SASS: dots_fp32_kernel instances {sorted(got)}, expected both")
    return got


def micro_records(card):
    """K4-K7 against their plain versions at the reference scripts' full
    shapes, with their bounds and SASS checks; K5-K7's library products
    (one torch.mm each) checked and timed beside them; launches: path A's
    entry points (kernel_mt20.run, mxu_micro.run), counted from zero."""
    library_sass = sass.run()
    recs = []
    # K4 on the decomposition's stream: never done, always done, and a
    # threshold of +0.0 on every second block (skipped once all mins < 0).
    xt, cols, gidx, tile_of, live, dead = kernel_mt20.synthetic_stream(
        device=DEV)
    nb = tile_of.numel()
    mixed = torch.where(torch.arange(nb, device=DEV) % 2 == 1,
                        torch.zeros_like(live), live)
    for thr in (live, dead, mixed):
        args = (xt, cols, gidx, tile_of, thr, TILE)
        got, want = mk.det_sweep(*args), mk.det_sweep_plain(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              "det_sweep differs from its plain version")
    args = (xt, cols, gidx, tile_of, live, TILE)
    recs.append(dict(
        name="K4", input=f"{nb} blocks x {TILE} rays, every block swept",
        source=MICRO_SOURCE, replaces="exp/r3_kernel_mt20.py:45 (K4, "
        "make_det_kernel)", max_abs_err=0, library_ms=None,
        ms=graph_ms(lambda: mk.det_sweep(*args), chain=4),
        plain_ms=once_ms(lambda: mk.det_sweep_plain(*args)),
        **bound_of(nb * REFS_PER_BLOCK * TILE * DET_OPS_PER_PAIR, FP32_PEAK,
                   nbytes(xt, cols, gidx, tile_of, tile_of, live)
                   + 4 * xt.shape[1] * 4),
        ptxas=ptxas("sweep_kernel", "DetBody")))
    del xt, cols, gidx, tile_of, live, dead, mixed, got, want, args

    xt, g, phi, c = mxu_micro.inputs(device=DEV)
    n_blocks = g.shape[0] // mk.BLOCK_ROWS
    pairs = n_blocks * REFS_PER_BLOCK * TILE
    per_pair = dots_fp32_census(library_sass)
    want = mk.dots_fp32_plain(xt, g)
    exact = mk.dots_fp32_exact(xt, g)
    plain_ms = once_ms(lambda: mk.dots_fp32_plain(xt, g))
    library = mk.dots_fp32_library(xt, g)
    sums = library()
    lib_ratio = mk.bound_ratio((sums[-1], sums.sum(1)), exact,
                               mk.LIBRARY_CHAINS)
    del sums
    check(max(lib_ratio) <= 1, f"dots_fp32_library beyond its element "
          f"bound: {lib_ratio}")
    # It reads g and writes every block's (128, T) sums.
    lib = dict(library_ms=kernel_ms(library),
               library_bound_ms=bound_of(
                   2 * n_blocks * mk.BLOCK_ROWS * 128 * TILE, FP32_PEAK,
                   nbytes(g, xt) + 4 * n_blocks * mk.BLOCK_ROWS * TILE
               )["bound_ms"],
               library_element_bound_ratio=list(lib_ratio))
    del library
    for fma in (False, True):
        got = mk.dots_fp32(xt, g, fma=fma)
        torch.cuda.synchronize()
        ratio = mk.bound_ratio(got, exact)
        errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
        if fma:
            tols = [FMA_TOL * float(w.abs().max()) for w in want]
            check(errs[0] <= tols[0] and errs[1] <= tols[1],
                  f"dots_fp32_fma differs from the plain version beyond "
                  f"{FMA_TOL} x max|ref|")
            check(max(ratio) <= 1, f"dots_fp32_fma beyond its element "
                  f"bound: {ratio}")
        else:
            check(all(torch.equal(a, w) for a, w in zip(got, want)),
                  "dots_fp32 differs from its plain version")
        # Operations at the FP32 peak (an FMA counts 2); beside it the FP32
        # instructions the function needs at the issue rate.
        recs.append(dict(
            name="K5 FMA" if fma else "K5",
            input=f"{n_blocks} blocks x {TILE} rays",
            source=MICRO_SOURCE, replaces="exp/r4_mxu_micro.py:68 (K5, "
            "vpu_kernel" + ("; the instance with explicit FMAs)" if fma
                            else ")"),
            max_abs_err=errs[0], element_bound_ratio=list(ratio),
            ms=kernel_ms(lambda: mk.dots_fp32(xt, g, fma=fma)),
            plain_ms=plain_ms, **lib,
            **bound_of(pairs * DOTS_OPS_PER_PAIR, FP32_PEAK,
                       nbytes(xt, g, *got)),
            bound_ms_instructions=bound_of(
                pairs * DOTS_INSNS_PER_PAIR[fma], FP32_ISSUE,
                nbytes(xt, g, *got))["bound_ms"],
            sass_per_pair=per_pair[fma],
            ptxas=ptxas(f"dots_fp32_kernelILb{int(fma)}E")))
        del got
    del xt, g, want, exact

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
            (False, "K6", "exp/r4_mxu_micro.py:89 (K6, mxu1_kernel)"),
            (True, "K7", "exp/r4_mxu_micro.py:101 (K7, mxu3_kernel)")):
        want = mk.dots_bf16_plain(phi, c, split=split)
        tols = [BF16_TOL * float(w.abs().max()) for w in want]
        library = mk.dots_bf16_library(phi, c, split=split)
        runs = {"kernel": lambda: mk.dots_bf16(phi, c, split=split),
                "library": lambda: (lambda r: (r[-1], r.sum(1)))(library())}
        err = {}
        for what, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
            check(errs[0] <= tols[0] and errs[1] <= tols[1],
                  f"{key} ({what}) differs from its plain version beyond "
                  f"{BF16_TOL} x max|ref|")
            err[what] = (errs[0], float((got[0].double() - exact).abs().max()
                                        / exact.abs().max()))
            del got
        check(err["kernel"][1] < (1e-4 if split else 2e-2),
              f"{key}: relative error {err['kernel'][1]} against f64")
        ops = flops * (3 if split else 1)
        # The library call reads its bf16 layout and writes every block's
        # (128, T) sums: its own least time, beside library_ms.
        depth = mk.BLOCK_C_ROWS // mk.BLOCK_ROWS * mk.DOT_DEPTH * (
            3 if split else 1)
        lib_bytes = 2 * depth * (n_blocks * mk.BLOCK_ROWS + TILE) \
            + 4 * n_blocks * mk.BLOCK_ROWS * TILE
        recs.append(dict(
            name=key, input=f"{n_blocks} blocks x {TILE} rays",
            source=MICRO_SOURCE, replaces=rep, max_abs_err=err["kernel"][0],
            rel_err_f64=err["kernel"][1], ms=kernel_ms(runs["kernel"]),
            plain_ms=once_ms(lambda: mk.dots_bf16_plain(phi, c, split=split)),
            library_ms=kernel_ms(library),
            library_bound_ms=bound_of(ops, BF16_PEAK, lib_bytes)["bound_ms"],
            **bound_of(ops, BF16_PEAK, nbytes(phi, c, *want)),
            ptxas=ptxas(f"dots_bf16_kernelILb{int(split)}E")))
        del library, want
    del phi, c

    # Path A through its entry points: the launches of each kernel.
    before, sweeps = dict(mk.launches), sk.launches["sweep_blocks"]
    rec_a = kernel_mt20.run()
    rec_b = mxu_micro.run()
    torch.cuda.synchronize()
    counts = {k: n - before[k] for k, n in mk.launches.items()}
    print(f"[path A] kernel_mt20 ({card}):\n{kernel_mt20.report(rec_a)}\n"
          f"[path A] mxu_micro ({card}):\n{mxu_micro.report(rec_b)}\n"
          f"[path A] launches {counts}, production sweep "
          f"{sk.launches['sweep_blocks'] - sweeps}", flush=True)
    check(all(n > 0 for n in counts.values()) and
          sk.launches["sweep_blocks"] > sweeps,
          f"path A did not launch every kernel: {counts}")
    for rec in (rec_a, rec_b):
        check(all(np.isfinite(x) and x > 0 for x in rec.values()
                  if isinstance(x, float)), f"non-finite record {rec}")
    check(rec_a["skipped_ms"] < rec_a["det3_ms"] < rec_a["full_ms"],
          "the decomposition is not ordered skipped < det3 < full")
    keys = {"K4": "det_sweep", "K5": "dots_fp32", "K5 FMA": "dots_fp32_fma",
            "K6": "dots_bf16", "K7": "dots_bf16x3"}
    return [emit(dict(r, route="cuda", launches=counts[keys[r["name"]]]),
                 card) for r in recs]


def main(with_variants=False) -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    check("jax" not in sys.modules, "the port pulled in jax")

    # 1. card and environment
    card = card_line()
    print(card, flush=True)
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    lines = [ln.strip() for ln in _build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln
             or "entry function" in ln or "wgmma" in ln]
    print(f"[build] {_build.last_build['path']} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.last_build['seconds']:.1f} s); ptxas: "
          f"{' | '.join(lines)}", flush=True)

    # 3. the records, each on its cell's input
    v, f = scenes.sponza_like()
    tris = Triangles.from_mesh(v, f, device=DEV)
    cam = scenes.sponza_camera()
    rays = primary_rays(cam, 1024, 1024, order="block", device=DEV)
    session = RenderSession.create(tris, structure="packet", verts=v)
    session.rebuild(tris)                        # the warm grid
    print(f"[scene] sponza_like: {tris.count} tris, {rays.count} rays; "
          f"{session.describe()}", flush=True)
    recs = primary_records(session, rays, card, with_variants)
    recs.append(ao_record(session, rays, tris, card, with_variants))
    s_irr = RenderSession.create(tris, structure="irregular", verts=v)
    s_irr.rebuild(tris)
    s_uni = RenderSession.create(tris, structure="uniform", verts=v)
    recs.append(march_record(s_irr, s_uni, rays, tris, card, with_variants))
    del s_uni
    recs.append(scatter_record(s_irr, session, tris, rays, card))
    del s_irr, session
    recs += path_records(cam, card, with_variants)
    recs += micro_records(card)

    print(json.dumps({"kernels": {r["name"]: r for r in recs}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true",
                    help="also time K2 and K3 at other chunk sizes and K8 "
                    "at other refill thresholds")
    try:
        sys.exit(main(ap.parse_args().variants))
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
