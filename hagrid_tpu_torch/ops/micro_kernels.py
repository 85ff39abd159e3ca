"""Sweep-cost micro-kernels (CUDA: csrc/micro.cu): what the planned sweep
spends on its shell, and what its four linear forms cost on the FP32 pipes
and on the tensor cores. They replace the TPU kernels of
exp/r3_kernel_mt20.py (make_det_kernel) and exp/r4_mxu_micro.py
(vpu_kernel, mxu1_kernel, mxu3_kernel); hagrid_tpu_torch/exp times them.

- `det_sweep` (K4): the production sweep's shell with the body cut to
  det = d.n per ref and a running min. Inputs as `sweep_blocks`; output
  (t, id, u, v) with t = min(seed, min over the tile's refs of det) for
  every ray of a tile that owns blocks, id = -1, u = v = 0. A block is
  skipped when every ray's running min is <= its threshold (bit patterns
  compared as int32, as in the production kernel).
- `dots_fp32` (K5): xt f32[16, T], g f32[B*128, 128] (6 refs x 20
  coefficients and 8 pad lanes a row). Per block, row and ray: det,
  f - o.n, m.b + d.c, m.d' + d.e, all four summed over the row's 6 refs;
  a block's column sums add its rows in DOT_ROW_GROUPS groups, as the
  kernel does. fma=True launches the instance whose four forms are
  chains of explicit FMAs (what contraction would buy; it rounds once
  where the plain version rounds twice). That instance, and
  `dots_fp32_library` (the same function as one FP32 torch.mm, a
  yardstick), are held to an element bound derived from their rounding
  chains: `dots_fp32_exact`, `bound_ratio`.
- `dots_bf16` (K6, and K7 with split=True): phi f32[16, T],
  c f32[B*3072, 16]. Per block, C_blk . phi with both operands rounded to
  bf16 and f32 accumulation, the 24 groups of 128 rows summed. split=True
  takes hi = bf16(x), lo = bf16(x - hi) of both operands and sums
  hi.hi + hi.lo + lo.hi. `dots_bf16_library` lays the same function out
  as one library product (a yardstick for chip_smoke.py and the tests).

The TPU kernels' sequential grid rewrites one output block, so only the
last block's (128, T) sums come back; here every block also returns its T
column sums (csum f32[B, T]), so that the work of all B blocks is
observable. K5-K7 return (out, csum).

Each wrapper runs its CUDA kernel for CUDA tensors (T = 512 there) and its
plain version for CPU tensors, and counts kernel launches in `launches`.
K4 and K5 are built without FMA contraction and equal their plain versions
bit for bit (K5's FMA instance apart); K6 and K7 accumulate on the tensor
cores in another order than a matmul followed by adds, so they agree to
about 1e-4 of the largest output.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count_launch
from . import _build
from ._build import raise_on
from .sweep_kernel import (UNIT_ROWS, UNITS_PER_BLOCK, _check, _empty_out,
                           cuda_launch_args)

BLOCK_ROWS = 128       # group rows of g per stream block
BLOCK_C_ROWS = 3072    # rows of c per stream block: 4 forms x 768 refs
DOT_DEPTH = 16         # depth of the bf16 products
CUDA_TILE = 512        # rays the K5-K7 kernels are built for
DOT_ROW_GROUPS = 4     # K5's groups of rows, summed apart into csum
_REFS_PER_ROW = 6
_COEFS = 20
_ELEMS_PER_CHUNK = 1 << 22   # elements a plain version holds per tensor

# Kernel launches, counted where each kernel is launched (a captured
# graph's at each replay: utils/profiling.count_launch).
launches = {"det_sweep": 0, "dots_fp32": 0, "dots_fp32_fma": 0,
            "dots_bf16": 0, "dots_bf16x3": 0}


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


# ---------------------------------------------------------------- K4

def _ref_coefs(units, ui):
    """Gathered units ui i64[nb, 32] -> coefficient columns of the nb
    blocks' 768 refs, each f32[nb, 768, 1]."""
    nb = ui.shape[0]
    g = units[ui].reshape(nb, BLOCK_ROWS, 128)[:, :, :_REFS_PER_ROW * _COEFS]
    return g.reshape(nb, BLOCK_ROWS * _REFS_PER_ROW, _COEFS, 1).unbind(2)


def det_sweep_plain(xt, cols, gidx, tile_of, tminb, tile):
    """Plain PyTorch version of K4, early-out included: the k-th block of
    every tile's run at once, in run order."""
    nt = _check(xt, cols, gidx, tile_of, tminb, tile)
    dev = xt.device
    out_t, out_id, out_u, out_v = _empty_out(xt.shape[1], dev)
    if nt == 0 or tile_of.numel() == 0:
        return out_t, out_id, out_u, out_v
    tiles = torch.arange(nt, dtype=torch.int32, device=dev)
    bstart = torch.searchsorted(tile_of, tiles).long()
    bend = torch.searchsorted(tile_of, tiles, right=True).long()
    units = cols.reshape(-1, UNIT_ROWS * 128)
    block_units = gidx.reshape(-1, UNITS_PER_BLOCK)
    bt = xt[14, :nt * tile].reshape(nt, tile).clone()
    chunk = max(1, 2 * _ELEMS_PER_CHUNK
                // (BLOCK_ROWS * _REFS_PER_ROW * tile))
    for k in range(int((bend - bstart).max())):
        b = bstart + k
        own = torch.nonzero(b < bend).reshape(-1)
        busy = (bt[own].view(torch.int32) > tminb[b[own]][:, None]).any(1)
        own = own[busy]
        for s in range(0, own.numel(), chunk):
            t_ids = own[s:s + chunk]
            dx, dy, dz = (xt[r, :nt * tile].reshape(nt, 1, tile)[t_ids]
                          for r in (4, 5, 6))
            n0, n1, n2 = _ref_coefs(units, block_units[b[t_ids]].long())[:3]
            det = dx * n0 + dy * n1 + dz * n2
            bt[t_ids] = torch.minimum(bt[t_ids], det.min(dim=1).values)
    swept = (bend > bstart)[:, None].expand(nt, tile).reshape(-1)
    out_t[:nt * tile] = torch.where(swept, bt.reshape(-1),
                                    out_t[:nt * tile])
    return out_t, out_id, out_u, out_v


def det_sweep(xt, cols, gidx, tile_of, tminb, tile):
    """K4: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; anything else raises."""
    if xt.device.type == "cpu":
        return det_sweep_plain(xt, cols, gidx, tile_of, tminb, tile)
    # One chunk per tile (C = the budget): the det body keeps no key to
    # merge split tiles by.
    nt, _, rows, out, plan = cuda_launch_args(
        xt, cols, gidx, tile_of, tminb, tile, chunk=tile_of.numel())
    if rows == 0:
        return out
    lib = _build.load()
    err = lib.hagrid_det_sweep(
        _ptr(xt), xt.shape[1], _ptr(cols), _ptr(gidx), _ptr(tile_of),
        tile_of.numel(), _ptr(tminb), *map(_ptr, out), nt, tile,
        _ptr(plan), _stream(xt.device))
    raise_on(lib, err, "det-only sweep")
    count_launch(launches, "det_sweep")
    return out


# ---------------------------------------------------------------- K5-K7

def _check_dots(x, table, rows_per_block, width, what):
    """Shapes and types of a (16, T) ray matrix and a block table; returns
    the block count."""
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"{what}: inputs must be float32, got {x.dtype} "
                        f"and {table.dtype}")
    if x.dim() != 2 or x.shape[0] != 16:
        raise ValueError(f"{what}: the ray matrix must be [16, T], got "
                         f"{tuple(x.shape)}")
    if (table.dim() != 2 or table.shape[1] != width
            or table.shape[0] % rows_per_block or table.shape[0] == 0):
        raise ValueError(f"{what}: the block table must be "
                         f"[B*{rows_per_block}, {width}] with B >= 1, got "
                         f"{tuple(table.shape)}")
    if x.device != table.device:
        raise ValueError(f"{what}: inputs on several devices: {x.device}, "
                         f"{table.device}")
    return table.shape[0] // rows_per_block


def _check_dots_cuda(x, table, what):
    if x.device.type != "cuda":
        raise RuntimeError(f"no {what} kernel for device {x.device}")
    if x.shape[1] != CUDA_TILE:
        raise ValueError(f"{what}: the CUDA kernel takes T = {CUDA_TILE} "
                         f"rays, got {x.shape[1]}")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if x.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError(f"{what}: inputs must be 16-byte aligned "
                         f"(vector loads)")


def _empty_dots(n_blocks, x):
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((BLOCK_ROWS, x.shape[1]), **f32),
            torch.empty((n_blocks, x.shape[1]), **f32))


def dots_fp32_plain(xt, g):
    """Plain PyTorch version of K5, op for op in the kernel's order: the
    row's accumulator takes det, tt, uu, vv of each ref in turn; a
    block's column sums add the rows of each of the DOT_ROW_GROUPS groups
    (rows w, w + 4, ..., w + 124 for group w) in order, then the groups'
    sums in group order."""
    n_blocks = _check_dots(xt, g, BLOCK_ROWS, 128, "dots_fp32")
    tile = xt.shape[1]
    ox, oy, oz, dx, dy, dz, mx, my, mz = xt[1:10].reshape(9, 1, 1, tile)
    rows = g.reshape(n_blocks, BLOCK_ROWS, 128)
    chunk = max(1, _ELEMS_PER_CHUNK // (BLOCK_ROWS * tile))
    csums = []
    for s in range(0, n_blocks, chunk):
        gg = rows[s:s + chunk, :, :_REFS_PER_ROW * _COEFS].reshape(
            -1, BLOCK_ROWS, _REFS_PER_ROW, _COEFS, 1)
        acc = torch.zeros((gg.shape[0], BLOCK_ROWS, tile),
                          dtype=torch.float32, device=xt.device)
        for ref in range(_REFS_PER_ROW):
            (n0, n1, n2, b0, b1, b2, c0, c1, c2, d0, d1, d2, e0, e1, e2,
             f) = gg[:, :, ref].unbind(2)[:16]
            det = dx * n0 + dy * n1 + dz * n2
            tt = f - (ox * n0 + oy * n1 + oz * n2)
            uu = mx * b0 + my * b1 + mz * b2 + dx * c0 + dy * c1 + dz * c2
            vv = mx * d0 + my * d1 + mz * d2 + dx * e0 + dy * e1 + dz * e2
            acc = acc + det + tt + uu + vv
        by_group = acc.reshape(-1, BLOCK_ROWS // DOT_ROW_GROUPS,
                               DOT_ROW_GROUPS, tile)
        part = torch.zeros_like(by_group[:, 0])
        for j in range(BLOCK_ROWS // DOT_ROW_GROUPS):
            part = part + by_group[:, j]
        cs = part[:, 0]
        for w in range(1, DOT_ROW_GROUPS):
            cs = cs + part[:, w]
        csums.append(cs)
    return acc[-1], torch.cat(csums)


def _dots_phi(dn, m, d):
    """The (128, T) right factor that makes K5's function one product
    g . phi: for ref slot s, rows 20s + 0..2 hold dn (d - o for the value,
    |d| + |o| for the error scale), + 3..5 m, + 6..8 d, + 9..11 m,
    + 12..14 d and + 15 ones; every other row is zero."""
    tile = dn.shape[1]
    ref = torch.cat([dn, m, d, m, d, dn.new_ones((1, tile)),
                     dn.new_zeros((_COEFS - 16, tile))])
    pad = dn.new_zeros((128 - _REFS_PER_ROW * _COEFS, tile))
    return torch.cat([ref] * _REFS_PER_ROW + [pad])


def dots_fp32_library(xt, g):
    """One library product that computes K5's function, the yardstick
    chip_smoke.py times beside the kernel; the port never calls it. Lays
    out phi (`_dots_phi` with d - o rounded to f32) and returns `call`, a
    function of no arguments that runs torch.mm(g, phi) in true FP32 (TF32
    off for the call, the setting restored after) and returns every
    block's (128, T) sums as f32[B, 128, T]. g is used as it is, no copy."""
    n_blocks = _check_dots(xt, g, BLOCK_ROWS, 128, "dots_fp32")
    o, d, m = xt[1:4], xt[4:7], xt[7:10]
    phi = _dots_phi(d - o, m, d)
    shape = (n_blocks, BLOCK_ROWS, xt.shape[1])

    def call():
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.mm(g, phi).reshape(shape)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    return call


# The FP32 unit roundoff, and the f64 reference's own error (below
# 2^-45 of the scale for the few hundred roundings of one element).
ROUND_OFF = 2.0 ** -24
_F64_MARGIN = 2.0 ** -40
# Roundings on the longest chain any term of an element passes through,
# for (out, csum); dots_fp32_exact derives them.
KERNEL_CHAINS = (28, 63)
LIBRARY_CHAINS = (129, 256)


def dots_fp32_exact(xt, g):
    """K5's function in f64 and the scale of its rounding error:
    (out, csum, out_scale, csum_scale), all f64, out and out_scale of the
    last block. The scale of an element is the sum of |term| over its
    terms: per ref |d_i n_i| and |o_i n_i| (i = x, y, z), |f|, |m_i b_i|,
    |d_i c_i|, |m_i d'_i| and |d_i e_i|, 19 a ref, 114 a row; csum's are
    its 128 rows'.

    The rule (`bound_ratio`): |got - exact| <= gamma_k * scale, with
    gamma_k = k u / (1 - k u), u = 2^-24, where k is the number of
    roundings on the longest chain that any term passes through (each
    rounding multiplies what it touches by 1 + delta, |delta| <= u; an
    FMA rounds its product and sum once). Then got = sum of t (1 +
    theta), |theta| <= gamma_k, whatever the order (Higham, Accuracy
    and Stability of Numerical Algorithms, 2nd ed., lemma 3.1).

    - K5, either instance (KERNEL_CHAINS): uu's first product is rounded
      once, then five multiply-adds (6); it enters the accumulator with
      + uu and + vv of its ref and four adds for each of the 5 later
      refs (22): out k = 28 (det's terms 27, tt's 27 or 26 with FMAs).
      csum adds the row into its group's sum, 32 rows (32, the first
      exact), then the four groups' sums in order (3): k = 63.
    - The library product (LIBRARY_CHAINS): torch.mm sums 128 products
      in an order of its own, any order of 128 terms rounds a term at
      most 128 times, and d - o is rounded once in phi: k = 129 (the
      scale counts |d n| + |o n| >= |(d - o) n|). The column sums of its
      128 rows, in any order: k = 129 + 127 = 256.

    This function's own f64 error stays below 2^-45 of the scale; the
    bound adds 2^-40 of it."""
    n_blocks = _check_dots(xt, g, BLOCK_ROWS, 128, "dots_fp32")
    tile = xt.shape[1]
    x = xt.double()
    o, d, m = x[1:4], x[4:7], x[7:10]
    phi = _dots_phi(d - o, m, d)
    phi_abs = _dots_phi(d.abs() + o.abs(), m.abs(), d.abs())
    rows = g.reshape(n_blocks, BLOCK_ROWS, 128)
    chunk = max(1, _ELEMS_PER_CHUNK // (BLOCK_ROWS * tile))
    csums, scales = [], []
    for s in range(0, n_blocks, chunk):
        gg = rows[s:s + chunk].double()
        val, mag = gg @ phi, gg.abs() @ phi_abs
        csums.append(val.sum(1))
        scales.append(mag.sum(1))
    return val[-1], torch.cat(csums), mag[-1], torch.cat(scales)


def rounding_bound(scale, k):
    """gamma_k * scale, plus the f64 reference's margin."""
    return scale * (k * ROUND_OFF / (1 - k * ROUND_OFF) + _F64_MARGIN)


def bound_ratio(got, exact, chains=KERNEL_CHAINS):
    """The largest |got - exact| / rounding_bound over out and over csum:
    (out's, csum's). got = (out, csum), exact = dots_fp32_exact(...); the
    rule holds when both are <= 1."""
    ratios = []
    for x, ref, scale, k in zip(got, exact[:2], exact[2:], chains):
        err = (x.double() - ref).abs()
        bound = rounding_bound(scale, k)
        ratios.append(float(torch.where(
            err == 0, 0.0, err / bound).max()))
    return tuple(ratios)


def dots_fp32(xt, g, fma=False):
    """K5: (out f32[128, T] of the last block, csum f32[B, T]). fma picks
    the CUDA instance with explicit FMAs (within the element bound of
    KERNEL_CHAINS, see dots_fp32_exact); the plain version, which CPU
    tensors get, rounds every operation either way."""
    if xt.device.type == "cpu":
        return dots_fp32_plain(xt, g)
    n_blocks = _check_dots(xt, g, BLOCK_ROWS, 128, "dots_fp32")
    _check_dots_cuda(xt, g, "dots_fp32")
    lib = _build.load()
    out, csum = _empty_dots(n_blocks, xt)
    err = lib.hagrid_dots_fp32(_ptr(xt), _ptr(g), _ptr(out), _ptr(csum),
                               n_blocks, int(fma), _stream(xt.device))
    raise_on(lib, err, "dots_fp32")
    count_launch(launches, "dots_fp32_fma" if fma else "dots_fp32")
    return out, csum


def bf16_round(x):
    """x rounded to bf16 (nearest even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_split(x):
    """(hi, lo) with hi = bf16(x), lo = bf16(x - hi), both as f32."""
    hi = bf16_round(x)
    return hi, bf16_round(x - hi)


def dots_bf16_plain(phi, c, split=False):
    """Plain PyTorch version of K6 (K7 with split=True): an f32 matmul of
    the bf16-rounded operands (their products are exact in f32), then the
    24 row groups summed."""
    n_blocks = _check_dots(phi, c, BLOCK_C_ROWS, DOT_DEPTH, "dots_bf16")
    tile = phi.shape[1]
    ph, pl = bf16_split(phi)
    chunk = max(1, 8 * _ELEMS_PER_CHUNK // (BLOCK_C_ROWS * tile))
    csums = []
    for s in range(0, n_blocks, chunk):
        ch, cl = bf16_split(c[s * BLOCK_C_ROWS:(s + chunk) * BLOCK_C_ROWS])
        prod = ch @ ph
        if split:
            prod = prod + ch @ pl + cl @ ph
        out = prod.reshape(-1, BLOCK_C_ROWS // BLOCK_ROWS, BLOCK_ROWS,
                           tile).sum(1)
        csums.append(out.sum(1))
    return out[-1], torch.cat(csums)


def dots_bf16(phi, c, split=False):
    """K6 (split=False) and K7 (split=True): (out f32[128, T] of the last
    block, csum f32[B, T])."""
    if phi.device.type == "cpu":
        return dots_bf16_plain(phi, c, split)
    n_blocks = _check_dots(phi, c, BLOCK_C_ROWS, DOT_DEPTH, "dots_bf16")
    _check_dots_cuda(phi, c, "dots_bf16")
    lib = _build.load()
    out, csum = _empty_dots(n_blocks, phi)
    err = lib.hagrid_dots_bf16(_ptr(phi), _ptr(c), _ptr(out), _ptr(csum),
                               n_blocks, int(split), _stream(phi.device))
    raise_on(lib, err, "dots_bf16")
    count_launch(launches, "dots_bf16x3" if split else "dots_bf16")
    return out, csum


def dots_bf16_library(phi, c, split=False):
    """One library product that computes K6's (split=True: K7's) function,
    the yardstick chip_smoke.py times beside the kernel; the port never
    calls it. Lays the operands out here and returns `call`, a function of
    no arguments that runs the one product and returns every block's
    (128, T) sums as f32[B, 128, T]: the bf16-rounded C as (B*128, 24*16),
    the groups along the depth, against bf16(phi) stacked 24 times (K7:
    depth 3 * 384, [hi | hi | lo] against [phi_hi; phi_lo; phi_hi]).

    On the card the operands are bf16 and the product is one torch.mm with
    f32 output (`out_dtype`); on the CPU they are the rounded values in
    f32 and the product an f32 matmul."""
    n_blocks = _check_dots(phi, c, BLOCK_C_ROWS, DOT_DEPTH, "dots_bf16")
    groups = BLOCK_C_ROWS // BLOCK_ROWS
    tile = phi.shape[1]

    def depth_major(x):       # (B*3072, 16) -> (B*128, 24*16)
        return (x.reshape(n_blocks, groups, BLOCK_ROWS, DOT_DEPTH)
                .transpose(1, 2).reshape(n_blocks * BLOCK_ROWS, -1))

    ch, cl = bf16_split(c)
    ph, pl = bf16_split(phi)
    a_parts, b_parts = [depth_major(ch)], [ph.repeat(groups, 1)]
    if split:
        a_parts += [depth_major(ch), depth_major(cl)]
        b_parts += [pl.repeat(groups, 1), ph.repeat(groups, 1)]
    a = torch.cat(a_parts, 1)
    b = torch.cat(b_parts, 0)
    shape = (n_blocks, BLOCK_ROWS, tile)
    if phi.device.type == "cpu":
        return lambda: (a @ b).reshape(shape)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    return lambda: torch.mm(a, b, out_dtype=torch.float32).reshape(shape)
