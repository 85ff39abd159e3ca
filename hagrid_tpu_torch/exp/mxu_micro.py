"""The four linear-form dots of the sweep (det, t*det, u*det, v*det) on
the FP32 pipes against the tensor cores (port of exp/r4_mxu_micro.py).

    python3 -m hagrid_tpu_torch.exp.mxu_micro [--device cpu]

Per 768-ref block the dots are C (4*768, 16) . phi (16, 512): K = 16 is
one bf16 mma step. Three kernels over the same work (B = 2048 blocks x
512 rays):
  vpu   : the production linear forms on the FP32 pipes, dots only,
          every operation rounded as the production kernel rounds it
          (`dots_fp32`, K5);
  vpu_fma: the same with explicit fused multiply-adds
          (`dots_fp32(fma=True)`): what contraction would buy;
  vpu_lib: the same function as one FP32 library product, torch.mm(g,
          phi) with TF32 off (`dots_fp32_library`), the yardstick;
  mxu1  : one bf16 tensor-core product (`dots_bf16`, K6);
  mxu3  : bf16x3, hi/lo split of both operands, three products
          (`dots_bf16(split=True)`, K7).
Times are ms and ns per block, from CUDA events over back-to-back
launches on the card. (The reference feeds each dispatch's output back
into the next one's input to defeat a memoising dispatch layer; launches
on one CUDA stream run in order and are never elided, so that chain has
no counterpart here.) The accuracy lines give the relative error of the
bf16x1 and bf16x3 products of one block against an f64 product.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import device_name, resolve
from ..ops.micro_kernels import (BLOCK_C_ROWS, BLOCK_ROWS, DOT_DEPTH,
                                 bf16_split, dots_bf16, dots_fp32,
                                 dots_fp32_library)
from ..utils.profiling import timed


def inputs(blocks=2048, tile=512, seed=0, device=None):
    """(xt f32[16, tile], g f32[blocks*128, 128], phi f32[16, tile],
    c f32[blocks*3072, 16]), random normals from a seeded numpy
    generator."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    shapes = ((blocks * BLOCK_ROWS, 128), (16, tile),
              (blocks * BLOCK_C_ROWS, DOT_DEPTH), (16, tile))
    g, xt, c, phi = (torch.as_tensor(
        rng.standard_normal(s, dtype=np.float32), device=dev) for s in shapes)
    return xt, g, phi, c


def bf16_errors(phi, c) -> dict:
    """Relative error (max |x - ref| / max |ref|) of the first block's
    bf16x1 and bf16x3 products against the f64 product."""
    blk = c[:BLOCK_C_ROWS]
    ref = blk.double() @ phi.double()
    ch, cl = bf16_split(blk)
    ph, pl = bf16_split(phi)
    b1 = ch @ ph
    b3 = ch @ ph + ch @ pl + cl @ ph

    def rel(x):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    return dict(rel_err_bf16x1=rel(b1), rel_err_bf16x3=rel(b3))


def run(device=None, blocks=2048, tile=512, seed=0, warmup=1, iters=3,
        chain=4) -> dict:
    """The record: sizes, the device the times were taken on, vpu /
    vpu_fma / vpu_lib / mxu1 / mxu3 as ms and ns per block, and the two
    relative errors."""
    dev = resolve(device)
    xt, g, phi, c = inputs(blocks, tile, seed, dev)
    runs = {"vpu": lambda: dots_fp32(xt, g),
            "vpu_fma": lambda: dots_fp32(xt, g, fma=True),
            "vpu_lib": dots_fp32_library(xt, g),
            "mxu1": lambda: dots_bf16(phi, c),
            "mxu3": lambda: dots_bf16(phi, c, split=True)}
    rec = dict(device=device_name(dev), blocks=blocks, tile=tile)
    for name, fn in runs.items():
        s = timed(fn, warmup=warmup, iters=iters, chain=chain, device=dev)
        rec[f"{name}_ms"] = s * 1e3
        rec[f"{name}_ns_per_block"] = s * 1e9 / blocks
    rec.update(bf16_errors(phi, c))
    return rec


def report(rec: dict) -> str:
    lines = [f"{name:<7} dots: {rec[name + '_ms']:8.3f} ms total = "
             f"{rec[name + '_ns_per_block']:7.0f} ns/block"
             for name in ("vpu", "vpu_fma", "vpu_lib", "mxu1", "mxu3")]
    lines += [f"rel err bf16x1: {rec['rel_err_bf16x1']:.2e}",
              f"rel err bf16x3: {rec['rel_err_bf16x3']:.2e}",
              f"({rec['blocks']} blocks x {rec['tile']} rays, on "
              f"{rec['device']})"]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--blocks", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    rec = run(device=a.device, blocks=a.blocks, iters=a.iters)
    print(report(rec))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
