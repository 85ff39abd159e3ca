"""PyTorch port, sweep-cost micro-kernels K4-K7: the plain versions (what
the wrappers run on CPU tensors) against the reference's Pallas kernels in
interpret mode, on the same numpy inputs.

The reference kernels live in scripts that run TPU code when imported, so
only their function definitions are loaded (parsed out of the source and
executed in a namespace with the names they use) and called through
`pl.pallas_call(..., interpret=True)` with the scripts' own specs at a
small shape.

Tolerances: K4 and K5 atol 1e-5 on values of order 10 (XLA contracts
a*b + c into FMAs, the port rounds every operation); K5's FMA instance
and its library product are held to a bound derived from their rounding
chains (micro_kernels.dots_fp32_exact); K6 and K7
1e-4 x max|ref| (a dot followed by adds against one matmul and a sum, in
another accumulation order).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hagrid_tpu.ops import sweep_trace as j_st
from hagrid_tpu_torch.exp import kernel_mt20, mxu_micro, sass
from hagrid_tpu_torch.ops import micro_kernels as mk

ROOT = pathlib.Path(__file__).resolve().parent.parent
TILE = 128


def _reference_defs(script, names, tile=TILE):
    """The named top-level functions of exp/<script>, defined in a fresh
    namespace; nothing else of the script runs."""
    path = ROOT / "exp" / script
    tree = ast.parse(path.read_text())
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in defs) == sorted(names)
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, st=j_st, TILE=tile, G=6)
    exec(compile(ast.Module(defs, []), str(path), "exec"), ns)
    return [ns[n] for n in names]


def _ref_det_sweep(xt, g, tile_of, tminb, tile, nt):
    """exp/r3_kernel_mt20.py::run_variant's call, interpreted."""
    make_det_kernel, = _reference_defs("r3_kernel_mt20.py",
                                       ["make_det_kernel"])
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(tile_of.shape[0],),
        in_specs=[
            pl.BlockSpec((16, tile), lambda i, t, tb: (0, t[i]),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((128, 20 * j_st._G), lambda i, t, tb: (i, 0),
                         memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, tile), lambda i, t, tb: (0, t[i]),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((128, tile), jnp.float32)] * 4
        + [pltpu.VMEM((8, tile), jnp.float32)])
    f = pl.pallas_call(
        make_det_kernel(tile, nt),
        out_shape=jax.ShapeDtypeStruct((8, xt.shape[1]), jnp.float32),
        grid_spec=spec, interpret=True)
    return np.asarray(f(jnp.asarray(tile_of), jnp.asarray(tminb),
                        jnp.asarray(xt), jnp.asarray(g)))


def _ref_dots(name, x, table, rows, width, tile=TILE):
    """exp/r4_mxu_micro.py::run_vpu / run_mxu's call, interpreted: the
    output block is rewritten by every grid step, so the last block's
    sums come back."""
    kernel, = _reference_defs("r4_mxu_micro.py", [name], tile)
    n_blocks = table.shape[0] // rows
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0, grid=(n_blocks,),
        in_specs=[pl.BlockSpec((16, tile), lambda i: (0, 0)),
                  pl.BlockSpec((rows, width), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((128, tile), lambda i: (0, 0)))
    f = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((128, tile), jnp.float32),
        grid_spec=spec, interpret=True)
    return np.asarray(f(jnp.asarray(x), jnp.asarray(table)))


@pytest.fixture(scope="module")
def stream():
    """4 tiles of 128 rays, 2 blocks each, one unused block parked on the
    dummy tile, units gathered through a permutation."""
    xt, cols, gidx, tile_of, live, dead = (
        a.numpy() for a in kernel_mt20.synthetic_stream(
            tile=TILE, nt=4, blocks_per_tile=2, seed=5, device="cpu"))
    rng = np.random.default_rng(6)
    n_units = gidx.size
    cols = np.concatenate([cols, rng.standard_normal(
        (128, 128)).astype(np.float32)])          # a ninth block of rows
    cols[-128:, 120:] = 0.0
    gidx = rng.permutation(n_units + 32).astype(np.int32)
    tile_of = np.concatenate([tile_of, [4]]).astype(np.int32)
    live = np.concatenate([live, live[:1]])
    dead = np.concatenate([dead, dead[:1]])
    # What the reference's pre-gathered kernel reads: 120 lanes a row.
    g = cols.reshape(-1, 4 * 128)[gidx].reshape(-1, 128)[:, :120]
    return dict(xt=xt, cols=cols, gidx=gidx, tile_of=tile_of, live=live,
                dead=dead, g=np.ascontiguousarray(g), nt=4)


def _port_det(s, thr):
    t = torch.as_tensor
    return mk.det_sweep(t(s["xt"]), t(s["cols"]), t(s["gidx"]),
                        t(s["tile_of"]), t(thr), TILE)


@pytest.mark.parametrize("which", ["live", "dead"])
def test_det_sweep_matches_reference_kernel(stream, which):
    """K4 with the never-done threshold (every block swept) and the
    always-done one (every block skipped: the seed comes back)."""
    s = stream
    n = s["nt"] * TILE
    ref = _ref_det_sweep(s["xt"], s["g"], s["tile_of"], s[which], TILE,
                         s["nt"])
    t, tri, u, v = (x.numpy() for x in _port_det(s, s[which]))
    np.testing.assert_allclose(t[:n], ref[0, :n], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tri[:n], ref[1, :n].astype(np.int32))
    np.testing.assert_array_equal(u[:n], ref[2, :n])
    np.testing.assert_array_equal(v[:n], ref[3, :n])
    assert (tri == -1).all()
    if which == "dead":
        np.testing.assert_array_equal(t[:n], s["xt"][14, :n])
    else:
        assert (t[:n] < s["xt"][14, :n]).mean() > 0.9
    # The dummy tile owns no live block: untouched.
    assert (t[n:] == np.float32(3e38)).all()


def test_det_sweep_early_out_is_per_block(stream):
    """A threshold of +0.0 skips a block once every ray's running min is
    negative or zero, which a tile's first block achieves: the second
    block of each tile then changes nothing."""
    s = stream
    thr = s["live"].copy()
    thr[1::2] = 0
    ref = _ref_det_sweep(s["xt"], s["g"], s["tile_of"], thr, TILE, s["nt"])
    t = _port_det(s, thr)[0].numpy()
    n = s["nt"] * TILE
    np.testing.assert_allclose(t[:n], ref[0, :n], rtol=0, atol=1e-5)
    assert (t[:n] != _port_det(s, s["live"])[0].numpy()[:n]).any()


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_dots_fp32_last_block_survives(n_blocks):
    xt, g, _, _ = (a.numpy() for a in mxu_micro.inputs(
        blocks=n_blocks, tile=TILE, seed=7, device="cpu"))
    ref = _ref_dots("vpu_kernel", xt, g, 128, 128)
    out, csum = mk.dots_fp32(torch.as_tensor(xt), torch.as_tensor(g))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # On CPU tensors the FMA instance's call takes the same plain version.
    for a, b in zip(mk.dots_fp32(torch.as_tensor(xt), torch.as_tensor(g),
                                 fma=True), (out, csum)):
        assert torch.equal(a, b)
    assert csum.shape == (n_blocks, TILE)
    # Every block's column sums: block b is the last of the first b + 1.
    for b in range(n_blocks):
        ref_b = _ref_dots("vpu_kernel", xt, g[:(b + 1) * 128], 128, 128)
        np.testing.assert_allclose(csum[b].numpy(),
                                   ref_b.astype(np.float64).sum(0),
                                   rtol=0, atol=2e-4)


def test_dots_fp32_plain_column_sum_order():
    """One block: csum is the sum of the last block's rows (out) in K5's
    order, bit for bit: rows w, w + 4, ..., w + 124 of each group w in
    order, then the four groups' sums in group order."""
    xt, g, _, _ = mxu_micro.inputs(blocks=1, tile=TILE, seed=12,
                                   device="cpu")
    out, csum = mk.dots_fp32_plain(xt, g)
    rows = out.numpy()
    parts = []
    for w in range(mk.DOT_ROW_GROUPS):
        part = np.zeros(TILE, np.float32)
        for r in range(w, 128, mk.DOT_ROW_GROUPS):
            part = part + rows[r]
        parts.append(part)
    want = parts[0]
    for part in parts[1:]:
        want = want + part
    np.testing.assert_array_equal(csum[0].numpy(), want)


def _fma_model(xt, g):
    """K5's FMA instance in numpy (f64 arithmetic rounded to f32 after
    every fused step, a double rounding the kernel does not make, and
    within the same bound): per ref det, tt from f with the origin
    negated, uu and vv as chains of multiply-adds, added into the row's
    accumulator in order; csum in the kernel's group order."""
    f32 = lambda a: np.asarray(a, np.float64).astype(np.float32)  # noqa
    fma = lambda a, b, c: f32(a.astype(np.float64) * b + c)  # noqa: E731
    x = xt.numpy()[:, None, :]
    ox, oy, oz, dx, dy, dz, mx, my, mz = x[1:10]
    outs, csums = [], []
    for blk in g.numpy().reshape(-1, 128, 128):
        acc = np.zeros((128, x.shape[2]), np.float32)
        for s in range(6):
            (n0, n1, n2, b0, b1, b2, c0, c1, c2, d0, d1, d2, e0, e1, e2,
             f) = (blk[:, 20 * s + k, None] for k in range(16))
            det = fma(dz, n2, fma(dy, n1, f32(dx * n0)))
            tt = fma(-oz, n2, fma(-oy, n1, fma(-ox, n0, f)))
            uu = f32(mx * b0)
            for a, b in ((my, b1), (mz, b2), (dx, c0), (dy, c1), (dz, c2)):
                uu = fma(a, b, uu)
            vv = f32(mx * d0)
            for a, b in ((my, d1), (mz, d2), (dx, e0), (dy, e1), (dz, e2)):
                vv = fma(a, b, vv)
            acc = acc + det + tt + uu + vv
        parts = [np.zeros(x.shape[2], np.float32) for _ in range(4)]
        for r in range(128):
            parts[r % 4] = parts[r % 4] + acc[r]
        outs.append(acc)
        csums.append(((parts[0] + parts[1]) + parts[2]) + parts[3])
    return torch.as_tensor(outs[-1]), torch.as_tensor(np.stack(csums))


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_dots_fp32_rounding_bound(n_blocks):
    """The rule the FMA instance and the library are held to: the plain
    version and a model of the FMA instance lie within gamma_28 (out) and
    gamma_63 (csum) of the f64 value, scaled by the sum of |term|; one
    more rounding of g to bf16 breaks it by orders of magnitude."""
    xt, g, _, _ = mxu_micro.inputs(blocks=n_blocks, tile=TILE, seed=13,
                                   device="cpu")
    exact = mk.dots_fp32_exact(xt, g)
    assert exact[0].dtype == torch.float64
    assert exact[1].shape == exact[3].shape == (n_blocks, TILE)
    # The scale of one element: 114 terms a row.
    assert float(exact[2].min()) > 0
    for got in (mk.dots_fp32_plain(xt, g), _fma_model(xt, g)):
        r_out, r_cs = mk.bound_ratio(got, exact)
        assert r_out <= 1 and r_cs <= 1
    assert mk.bound_ratio(mk.dots_fp32_plain(xt, mk.bf16_round(g)),
                          exact)[0] > 10
    # The FMA model rounds otherwise than the plain version.
    assert not torch.equal(_fma_model(xt, g)[0],
                           mk.dots_fp32_plain(xt, g)[0])


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_dots_fp32_library_matches_plain(n_blocks):
    """The library yardstick (one product of g and the laid-out phi)
    computes K5's function: every block's (128, T) sums; the last block's
    and the column sums lie within the library's bound of the f64 value,
    and within the two bounds together of the plain version."""
    xt, g, _, _ = mxu_micro.inputs(blocks=n_blocks, tile=TILE, seed=14,
                                   device="cpu")
    sums = mk.dots_fp32_library(xt, g)()
    assert sums.shape == (n_blocks, 128, TILE)
    assert sums.dtype == torch.float32
    got = (sums[-1], sums.sum(1))
    exact = mk.dots_fp32_exact(xt, g)
    r_out, r_cs = mk.bound_ratio(got, exact, mk.LIBRARY_CHAINS)
    assert r_out <= 1 and r_cs <= 1
    plain = mk.dots_fp32_plain(xt, g)
    for lib, pl_, scale, k_lib, k in zip(got, plain, exact[2:],
                                         mk.LIBRARY_CHAINS, mk.KERNEL_CHAINS):
        slack = mk.rounding_bound(scale, k_lib) + mk.rounding_bound(scale, k)
        assert ((lib.double() - pl_.double()).abs() <= slack).all()


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
@pytest.mark.parametrize("name,split", [("mxu1_kernel", False),
                                        ("mxu3_kernel", True)])
def test_dots_bf16_last_block_survives(name, split, n_blocks):
    _, _, phi, c = (a.numpy() for a in mxu_micro.inputs(
        blocks=n_blocks, tile=TILE, seed=8, device="cpu"))
    ref = _ref_dots(name, phi, c, 3072, 16)
    out, csum = mk.dots_bf16(torch.as_tensor(phi), torch.as_tensor(c),
                             split=split)
    tol = 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    for b in range(n_blocks):
        ref_b = _ref_dots(name, phi, c[:(b + 1) * 3072], 3072, 16)
        cs = ref_b.astype(np.float64).sum(0)
        np.testing.assert_allclose(csum[b].numpy(), cs, rtol=0,
                                   atol=1e-4 * np.abs(cs).max())
    # Against the f64 product of the last block: bf16x1 keeps about three
    # digits, bf16x3 about five.
    exact = (c[-3072:].astype(np.float64).reshape(24, 128, 16).sum(0)
             @ phi.astype(np.float64))
    rel = np.abs(out.numpy() - exact).max() / np.abs(exact).max()
    assert rel < (3e-5 if split else 1e-2)
    assert split or rel > 1e-4


BF16_TOL = 1e-4   # chip_smoke.py's K6/K7 tolerance, x max|ref|


@pytest.mark.parametrize("split", [False, True])
def test_dots_bf16_library_matches_plain(split):
    """The library yardstick (one product of the depth-major layout, f32
    matmuls of the rounded operands on the CPU) computes the plain
    version's function: every block's sums, hence the last block's sums
    and all column sums, within BF16_TOL."""
    _, _, phi, c = mxu_micro.inputs(blocks=3, tile=TILE, seed=11,
                                    device="cpu")
    sums = mk.dots_bf16_library(phi, c, split=split)()
    assert sums.shape == (3, 128, TILE) and sums.dtype == torch.float32
    out, csum = mk.dots_bf16_plain(phi, c, split=split)
    assert (sums[-1] - out).abs().max() <= BF16_TOL * out.abs().max()
    assert ((sums.sum(1) - csum).abs().max()
            <= BF16_TOL * csum.abs().max())


def _kernel_order_model(phi, c, split):
    """The redesigned K6/K7's arithmetic in numpy, in its order: per block
    and warpgroup (rows 0-63, 64-127), the 24 groups' products chained
    into one f32 accumulator per row (a group's 16-deep product taken
    exactly, then rounded once into the accumulator), K7's three products
    hi.hi, hi.lo, lo.hi in that order; the column sums of each warp's 16
    rows, the four warps of a warpgroup in order, then the two
    warpgroups added last. Returns (out of the last block, csum)."""
    bf = lambda a: a.astype(jnp.bfloat16).astype(np.float32)  # noqa: E731
    ph = bf(phi)
    products = [(0, ph)]
    if split:
        pl_ = bf(phi - ph)
        products = [(0, ph), (0, pl_), (1, ph)]
    blocks = c.reshape(-1, 24, 128, 16)
    outs, csums = [], []
    for blk in blocks:
        ch = bf(blk)
        parts = (ch, bf(blk - ch))
        acc = np.zeros((128, phi.shape[1]), np.float32)
        for q in range(24):
            for a, b in products:
                prod = parts[a][q].astype(np.float64) @ b.astype(np.float64)
                acc = (acc + prod.astype(np.float32)).astype(np.float32)
        warps = acc.reshape(2, 4, 16, -1).sum(2, dtype=np.float32)
        wgs = np.zeros((2, phi.shape[1]), np.float32)
        for w in range(4):
            wgs = (wgs + warps[:, w]).astype(np.float32)
        outs.append(acc)
        csums.append((wgs[0] + wgs[1]).astype(np.float32))
    return outs[-1], np.stack(csums)


@pytest.mark.parametrize("name,split", [("mxu1_kernel", False),
                                        ("mxu3_kernel", True)])
def test_dots_bf16_kernel_order_model(name, split):
    """The kernel's accumulation order (modelled in numpy at B = 3) stays
    within BF16_TOL of the plain version and of the reference's Pallas
    kernel run interpreted: the tolerance the card check uses covers the
    order. The model's own distance is far below it."""
    _, _, phi, c = (a.numpy() for a in mxu_micro.inputs(
        blocks=3, tile=TILE, seed=12, device="cpu"))
    out, csum = _kernel_order_model(phi, c, split)
    p_out, p_cs = (x.numpy() for x in mk.dots_bf16_plain(
        torch.as_tensor(phi), torch.as_tensor(c), split=split))
    ref = _ref_dots(name, phi, c, 3072, 16)
    for got, want in ((out, p_out), (csum, p_cs), (out, ref)):
        err = np.abs(got - want).max()
        assert err <= BF16_TOL * np.abs(want).max()
        assert err <= 0.1 * BF16_TOL * np.abs(want).max()
    for b in range(3):
        ref_b = _ref_dots(name, phi, c[:(b + 1) * 3072], 3072, 16)
        cs = ref_b.astype(np.float64).sum(0)
        assert np.abs(csum[b] - cs).max() <= BF16_TOL * np.abs(cs).max()


def test_bf16_split_equals_numpy():
    x = np.random.default_rng(9).standard_normal(4096).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0, 3e38]
    hi = x.astype(jnp.bfloat16).astype(np.float32)
    lo = (x - hi).astype(jnp.bfloat16).astype(np.float32)
    got_hi, got_lo = mk.bf16_split(torch.as_tensor(x))
    np.testing.assert_array_equal(got_hi.numpy(), hi)
    np.testing.assert_array_equal(got_lo.numpy(), lo)
    np.testing.assert_array_equal(mk.bf16_round(torch.as_tensor(x)).numpy(),
                                  hi)


def test_kernel_mt20_record_on_cpu():
    rec = kernel_mt20.run(device="cpu", tile=TILE, nt=4, blocks_per_tile=2,
                          warmup=0, iters=1, chain=1)
    assert rec["device"] == "cpu" and rec["blocks"] == 8
    assert rec["pairs"] == 8 * 768 * TILE
    for name in ("full", "det3", "skipped"):
        for unit in ("ms", "us_per_block", "ps_per_pair"):
            x = rec[f"{name}_{unit}"]
            assert np.isfinite(x) and x > 0
    assert "det3" in kernel_mt20.report(rec)


def test_mxu_micro_record_on_cpu():
    """Every key finite; the accuracy lines equal the reference script's
    computation (exp/r4_mxu_micro.py:172-186) in numpy."""
    rec = mxu_micro.run(device="cpu", blocks=2, tile=TILE, warmup=0,
                        iters=1, chain=1)
    assert rec["device"] == "cpu" and rec["blocks"] == 2
    for name in ("vpu", "vpu_fma", "vpu_lib", "mxu1", "mxu3"):
        for unit in ("ms", "ns_per_block"):
            x = rec[f"{name}_{unit}"]
            assert np.isfinite(x) and x > 0
    _, _, phi, c = (a.numpy() for a in mxu_micro.inputs(
        blocks=2, tile=TILE, seed=0, device="cpu"))
    ref = c[:3072].astype(np.float64) @ phi.astype(np.float64)
    bf = lambda a: a.astype(jnp.bfloat16).astype(np.float32)  # noqa: E731
    ch, ph = bf(c[:3072]), bf(phi)
    cl, plo = bf(c[:3072] - ch), bf(phi - ph)
    b1 = ch @ ph
    b3 = ch @ ph + ch @ plo + cl @ ph
    for key, b in (("rel_err_bf16x1", b1), ("rel_err_bf16x3", b3)):
        want = np.abs(b - ref).max() / np.abs(ref).max()
        assert rec[key] == pytest.approx(want, rel=0.05)
    assert 1e-3 < rec["rel_err_bf16x1"] < 1e-2
    assert rec["rel_err_bf16x3"] < 3e-5
    assert "rel err bf16x3" in mxu_micro.report(rec)
    assert "vpu_lib" in mxu_micro.report(rec)


_SASS = """
\t\tFunction : _Z6kernelPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R2], R3 ;
        /*0020*/              @!P0 BRA 0x10 ;
        /*0030*/                   LDS.128 R4, [R5] ;
        /*0040*/                   FFMA R6, R4, R7, R6 ;
        /*0050*/                   FMUL R8, R4, R7 ;
        /*0060*/               @P1 BRA 0x30 ;
        /*0070*/                   FADD R9, R6, R8 ;
        /*0080*/               @P2 BRA 0x0 ;
        /*0090*/                   NOP ;
        /*00a0*/                   EXIT ;
"""


def test_sass_inner_loop_on_text():
    """The census reads addresses, opcodes and branch targets; the
    innermost loop holding the FP32 work is the FFMA/FMUL loop, not the
    barrier's spin loop (no FP32) nor the outer loop (longer)."""
    per = sass.instructions(_SASS)
    insns = per["_Z6kernelPf"]
    assert len(insns) == 10 and insns[-1][1] == "EXIT"
    assert sass.census(_SASS)["_Z6kernelPf"]["_total"] == 10
    body, lo, hi = sass.inner_loop(insns)
    assert (lo, hi) == (0x30, 0x60)
    assert sass.summary(body) == {"instructions": 4, "LDS": 1, "FFMA": 1,
                                  "FMUL": 1, "BRA": 1}
    assert sass.inner_loop(insns[:2]) == (None, None, None)


def _dots_args():
    xt, g, phi, c = mxu_micro.inputs(blocks=1, tile=TILE, seed=1,
                                     device="cpu")
    return xt, g, phi, c


@pytest.mark.parametrize("case", ["dtype", "shape", "table", "device"])
def test_dots_wrappers_raise(case):
    xt, g, phi, c = _dots_args()
    if case == "dtype":
        with pytest.raises(TypeError):
            mk.dots_fp32(xt.double(), g)
        with pytest.raises(TypeError):
            mk.dots_bf16(phi, c.to(torch.bfloat16))
    elif case == "shape":
        with pytest.raises(ValueError):
            mk.dots_fp32(xt[:15], g)
        with pytest.raises(ValueError):
            mk.dots_bf16(phi.reshape(-1), c)
    elif case == "table":
        with pytest.raises(ValueError):
            mk.dots_fp32(xt, g[:100])
        with pytest.raises(ValueError):
            mk.dots_bf16(phi, c[:, :8])
        with pytest.raises(ValueError):
            mk.dots_bf16(phi, c[:0])
    else:
        with pytest.raises(ValueError):
            mk.dots_fp32(xt, g.to("meta"))
        with pytest.raises(ValueError):
            mk.dots_bf16(phi, c.to("meta"))
        # A tensor that is neither on the CPU nor on a card has no kernel.
        with pytest.raises(RuntimeError):
            mk.dots_fp32(xt.to("meta"), g.to("meta"))
        with pytest.raises(RuntimeError):
            mk.dots_bf16(phi.to("meta"), c.to("meta"), split=True)


@pytest.mark.parametrize("case", ["dtype", "shape", "device"])
def test_det_sweep_wrapper_raises(stream, case):
    s = stream
    t = torch.as_tensor
    args = [t(s["xt"]), t(s["cols"]), t(s["gidx"]), t(s["tile_of"]),
            t(s["live"])]
    if case == "dtype":
        args[2] = args[2].long()
        with pytest.raises(TypeError):
            mk.det_sweep(*args, TILE)
    elif case == "shape":
        with pytest.raises(ValueError):
            mk.det_sweep(args[0][:, :-1], *args[1:], TILE)
        with pytest.raises(ValueError):
            mk.det_sweep(*args[:4], args[4][:-1], TILE)
    else:
        with pytest.raises(ValueError):
            mk.det_sweep(args[0], args[1].to("meta"), *args[2:], TILE)
        with pytest.raises(RuntimeError):
            mk.det_sweep(*(a.to("meta") for a in args), TILE)
