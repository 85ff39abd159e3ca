"""Decompose the sweep kernel's per-block cost (port of
exp/r3_kernel_mt20.py).

    python3 -m hagrid_tpu_torch.exp.kernel_mt20 [--device cpu]

Three timings over one synthetic stream (tile 512, 512 tiles, 8 blocks a
tile, every block live, one gather unit per stream slot):
  full    : the production closest-hit sweep (`sweep_blocks`);
  det3    : the same shell with the body cut to det = d.n and a running
            min (`det_sweep`, K4): staging, barriers, the early-out vote
            and minimal arithmetic;
  skipped : the production kernel with every block skipped by the
            early-out (an "always done" threshold): the shell without
            staging.
So `full - det3` is the production body and `det3 - skipped` the staging.
Each is given as ms, us per block and ps per ray-ref pair. On the card
`chain` calls of each are captured once in a CUDA graph and the replays
are timed between CUDA events (the reference's host-clock timing of
blocking calls has no counterpart): the times are the device's, the
kernel and the wrapper's small torch ops (about the same for all three),
with no host time between them. The capture counts its launches in its
record (utils/profiling.capture), which each replay adds to the
wrappers' `launches`, so every launch on the card is counted. `skipped_host`
times the `skipped` calls back to back between CUDA events without a
graph, as PR 3's record timed all three: its device work is small, so it
reads the time the wrapper takes on the host to issue one call.

The stream is random normals from a seeded numpy generator, in the port's
layout: `cols` f32[4k, 128] with 6 refs x 20 coefficients and 8 zero pad
lanes a row, real tri ids (the plain sweep packs (t, id) into one key, so
ids must not be negative), `gidx` = arange, ascending `tile_of`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import device_name, resolve
from ..ops.micro_kernels import det_sweep
from ..ops.sweep_kernel import UNITS_PER_BLOCK, sweep_blocks
from ..utils import profiling
from ..utils.profiling import timed

NEVER_DONE = -2**31 + 1   # no ray's bit pattern is <= it: sweep every block
ALWAYS_DONE = 2**31 - 2   # every bit pattern is <= it: skip every block
_BLOCK_ROWS = 128
_REFS_PER_BLOCK = 768
_ID_RANGE = 1 << 20


def synthetic_stream(tile=512, nt=512, blocks_per_tile=8, seed=0,
                     device=None):
    """(xt, cols, gidx, tile_of, never_done, always_done): random rays
    (nt tiles and the dummy tile) and nt * blocks_per_tile random blocks,
    each tile owning a run of blocks_per_tile."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    n_blocks = nt * blocks_per_tile
    xt = rng.standard_normal((16, (nt + 1) * tile), dtype=np.float32)
    rows = n_blocks * _BLOCK_ROWS
    refs = rng.standard_normal((rows, 6, 20), dtype=np.float32)
    refs[:, :, 16] = (np.arange(rows * 6) % _ID_RANGE).reshape(rows, 6)
    refs[:, :, 17:] = 0.0
    cols = np.zeros((rows, 128), np.float32)
    cols[:, :120] = refs.reshape(rows, 120)
    gidx = np.arange(n_blocks * UNITS_PER_BLOCK, dtype=np.int32)
    tile_of = np.repeat(np.arange(nt, dtype=np.int32), blocks_per_tile)
    return tuple(torch.as_tensor(a, device=dev) for a in (
        xt, cols, gidx, tile_of, np.full(n_blocks, NEVER_DONE, np.int32),
        np.full(n_blocks, ALWAYS_DONE, np.int32)))


def graphed(fn, chain, device):
    """A function that replays `chain` calls of fn captured in one CUDA
    graph (fn is called once first, outside the capture, so that its
    allocations exist) and counts the launches of each replay."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with profiling.capture() as record, torch.cuda.graph(graph):
        for _ in range(chain):
            fn()

    def replay():
        graph.replay()
        profiling.replay(record)
    return replay


def run(device=None, tile=512, nt=512, blocks_per_tile=8, seed=0, warmup=2,
        iters=5, chain=4) -> dict:
    """The record: sizes, the device the times were taken on, and
    full / det3 / skipped as ms, us per block and ps per pair."""
    dev = resolve(device)
    xt, cols, gidx, tile_of, live, dead = synthetic_stream(
        tile, nt, blocks_per_tile, seed, dev)
    n_blocks = tile_of.numel()
    pairs = n_blocks * _REFS_PER_BLOCK * tile
    runs = {
        "full": lambda: sweep_blocks(xt, cols, gidx, tile_of, live, tile),
        "det3": lambda: det_sweep(xt, cols, gidx, tile_of, live, tile),
        "skipped": lambda: sweep_blocks(xt, cols, gidx, tile_of, dead, tile),
    }
    rec = dict(device=device_name(dev), tile=tile, tiles=nt,
               blocks=n_blocks, pairs=pairs)
    if dev.type == "cuda":
        runs["skipped_host"] = runs["skipped"]
    for name, fn in runs.items():
        if dev.type == "cuda" and name != "skipped_host":
            s = timed(graphed(fn, chain, dev), warmup=warmup, iters=iters,
                      device=dev) / chain
        else:
            s = timed(fn, warmup=warmup, iters=iters, chain=chain,
                      device=dev)
        rec[f"{name}_ms"] = s * 1e3
        rec[f"{name}_us_per_block"] = s * 1e6 / n_blocks
        rec[f"{name}_ps_per_pair"] = s * 1e12 / pairs
    return rec


def report(rec: dict) -> str:
    lines = [f"{name:<8}: {rec[name + '_ms']:8.3f} ms = "
             f"{rec[name + '_us_per_block']:7.3f} us/block = "
             f"{rec[name + '_ps_per_pair']:6.2f} ps/pair"
             for name in ("full", "det3", "skipped", "skipped_host")
             if name + "_ms" in rec]
    lines.append(f"({rec['blocks']} blocks, {rec['tiles']} tiles of "
                 f"{rec['tile']} rays, {rec['pairs']} pairs, on "
                 f"{rec['device']})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--tiles", type=int, default=512)
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    a = ap.parse_args(argv)
    rec = run(device=a.device, tile=a.tile, nt=a.tiles, iters=a.iters)
    print(report(rec))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
