"""The sweep kernel's design, on the CPU: the launch plan that cuts every
tile's run of blocks into chunks (the plan kernel's plain version,
`chunk_plan` on CPU tensors) against a numpy reference, and a plain
PyTorch model of
the kernel's division-free pre-test (HitBody::test in
hagrid_tpu_torch/csrc/sweep.cu) against its exact test on adversarial
pairs: the pre-test must pass every pair that the exact test accepts, so
that the kernel's kept hits stay bit-exact.
"""

import numpy as np
import pytest
import torch

from hagrid_tpu_torch.ops import sweep_kernel as sk

F32 = torch.float32
BIG = 3e38
SLACK = 2.0 ** -16
TINY = 2.0 ** -60


# ---------------------------------------------------------------- the plan

def _runs(seed, nt, max_run, unused):
    """An ascending tile_of with random runs (many empty, a few long) and
    `unused` trailing blocks of the dummy tile nt."""
    rng = np.random.default_rng(seed)
    run = rng.integers(0, 4, nt)
    run[rng.random(nt) < 0.4] = 0
    long = rng.choice(nt, max(1, nt // 8), replace=False)
    run[long] = rng.integers(1, max_run + 1, long.size)
    tile_of = np.concatenate([np.repeat(np.arange(nt), run),
                              np.full(unused, nt)]).astype(np.int32)
    return tile_of, run


def _plan(tile_of, nt, chunk):
    t = torch.as_tensor(tile_of)
    tiles = torch.arange(nt, dtype=torch.int32)
    bstart = torch.searchsorted(t, tiles, out_int32=True)
    bend = torch.searchsorted(t, tiles, right=True, out_int32=True)
    return (bstart, bend) + sk.chunk_plan(t, nt, chunk)


@pytest.mark.parametrize("seed,nt,max_run,chunk", [
    (0, 40, 90, 16), (1, 64, 300, 24), (2, 7, 5, 16), (3, 100, 70, 8),
    (4, 33, 1, 1), (5, 50, 200, 200)])
def test_chunk_table_matches_numpy(seed, nt, max_run, chunk):
    tile_of, run = _runs(seed, nt, max_run, unused=int(seed * 3 + 2))
    bstart, bend, table, tile_first, tile_chunks = _plan(tile_of, nt, chunk)
    n_blocks = tile_of.size
    table = table.numpy()
    assert table.dtype == np.int32
    assert table.shape == (nt + -(-n_blocks // chunk), 4)
    assert table.shape[0] == sk.plan_rows(nt, n_blocks, chunk)
    tile, first, count, slot = table.T
    live = count > 0
    # Every live block in exactly one chunk, inside its tile's run.
    cover = np.zeros(n_blocks, np.int64)
    for t, f, c in zip(tile[live], first[live], count[live]):
        assert 1 <= c <= chunk
        assert bstart[t] <= f and f + c <= bend[t]
        cover[f:f + c] += 1
    np.testing.assert_array_equal(cover, (tile_of < nt).astype(np.int64))
    # Chunks first, surplus rows (0, 0, 0, -1) after; chunks by
    # decreasing size capped at top, stable in (tile, block) order.
    n_live = int(live.sum())
    assert live[:n_live].all() and not live[n_live:].any()
    assert (table[n_live:] == [0, 0, 0, -1]).all()
    top = min(chunk, sk.PLAN_BINS - 1)
    want = [(t, bstart[t] + k * chunk, min(chunk, run[t] - k * chunk))
            for t in np.flatnonzero(run) for k in range(-(-run[t] // chunk))]
    want.sort(key=lambda c: -min(c[2], top))
    np.testing.assert_array_equal(table[:n_live, :3],
                                  np.array(want).reshape(-1, 3))
    # Per tile: chunk count; a split tile's chunks, in block order, own the
    # slots tile_first + 0..n-1, the split tiles' slots numbered by tile;
    # a tile of one chunk has slot -1 and tile_first 0.
    n = -(-run // chunk)
    np.testing.assert_array_equal(tile_chunks.numpy(), n)
    split = np.where(n > 1, n, 0)
    np.testing.assert_array_equal(tile_first.numpy(),
                                  np.where(n > 1, np.cumsum(split) - split, 0))
    tile_first = tile_first.numpy()
    for t in np.flatnonzero(run):
        rows = np.flatnonzero(live & (tile == t))
        rows = rows[np.argsort(first[rows])]
        assert rows.size == n[t]
        want_slot = tile_first[t] + np.arange(n[t]) if n[t] > 1 else [-1]
        np.testing.assert_array_equal(slot[rows], want_slot)
    assert slot[live].max(initial=-1) < table.shape[0]


def test_chunk_blocks_from_shapes():
    """C from the budget alone: short coherent runs stay whole."""
    assert sk.chunk_blocks(8192) == sk.MIN_CHUNK
    assert sk.chunk_blocks(1) == sk.MIN_CHUNK
    big = 64 * sk.CHUNK_TARGET
    assert sk.chunk_blocks(big) == 64
    assert sk.chunk_blocks(big + 1) == 65


# ------------------------------------------------------- the pre-test

def _f32(x):
    return torch.as_tensor(x, dtype=F32)


def _bounds(tmin, bt, tmax, any_hit):
    """HitBody::bounds: (lo, hi) on t."""
    u = torch.fmin(bt, tmax) if any_hit else bt
    hi = u + (u.abs() * SLACK + TINY)
    lo = tmin - (tmin.abs() * SLACK + TINY)
    return lo, hi


def _flip(x, sign_bits):
    return (x.view(torch.int32) ^ sign_bits).view(F32)


def pretest(det, tt, uu, vv, lo, hi):
    """HitBody::test's division-free test, op for op in float32."""
    a = det.abs()
    sgn = det.view(torch.int32) & torch.iinfo(torch.int32).min
    ts, us, vs = _flip(tt, sgn), _flip(uu, sgn), _flip(vv, sgn)
    w = a * SLACK
    return ((us >= -w) & (vs >= -w) & (us + vs <= a + w) & (a > 1e-12)
            & (ts <= a * hi) & (ts >= a * lo))


def exact(det, tt, uu, vv, tmin, bt, tmax, any_hit):
    """HitBody::exact's acceptance, with a tie at the best counted as
    accepted (the kernel takes it when the id is smaller)."""
    inv = 1.0 / det
    t, u, v = tt * inv, uu * inv, vv * inv
    ok = ((u >= 0) & (v >= 0) & (1.0 - (u + v) >= 0) & (det.abs() > 1e-12)
          & (t > tmin) & (t <= bt))
    return ok & (t < tmax) if any_hit else ok


def _ulps(x, k):
    """x moved by k ulps (k may be negative), as float32."""
    x = _f32(x).reshape(-1)
    step = torch.full_like(x, float("inf") if k > 0 else float("-inf"))
    for _ in range(abs(k)):
        x = torch.nextafter(x, step)
    return x


def _grid(*axes):
    mesh = torch.meshgrid(*[_f32(a).reshape(-1) for a in axes],
                          indexing="ij")
    return [m.reshape(-1) for m in mesh]


def _near(x, k=2):
    return torch.cat([_ulps(x, i) for i in range(-k, k + 1)])


DENORMALS = [1e-45, 3e-42, 1.1754942e-38]
DETS = np.concatenate([s * np.array(m, np.float32) for s in (1, -1) for m in (
    [1e-12], _near(1e-12, 2).numpy(), DENORMALS, [0.0, 2e-12, 1e-6, 0.37,
                                                  1.0, 3.5, 1e4, 1e19, 3e38])])


def _family(name):
    """(det, tt, uu, vv, tmin, bt, tmax) of one adversarial family."""
    if name == "det edges":
        # det at +-1e-12 (and its neighbours), +-denormals, 0, large; the
        # solution (u, v, t) = (0.25, 0.25, 1) scaled by det.
        det, u, v, t = _grid(DETS, [0.25, 0.0, 0.5], [0.25, 0.5], [1.0])
        bt, tmax = _f32(BIG).expand_as(det), _f32(BIG).expand_as(det)
        tmin = torch.zeros_like(det)
    elif name == "u v edges":
        # uu, vv at +-0, +-tiny, and u + v one ulp either side of 1.
        edge = [0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 1e-30, -1e-30]
        halves = _near(0.5, 3)
        ends = torch.cat([_near(1.0, 3), _near(1.0 - 2 ** -24, 2)])
        det, u, v = _grid(DETS, torch.cat([_f32(edge), halves, ends]),
                          torch.cat([_f32(edge), halves, 1.0 - ends]))
        t = torch.ones_like(det)
        bt, tmax = _f32(BIG).expand_as(det), _f32(BIG).expand_as(det)
        tmin = torch.zeros_like(det)
    elif name == "t edges":
        # t one ulp either side of tmin, of the best and of tmax (a third
        # of the pairs each).
        det, base = _grid(DETS, [1e-30, 0.001, 0.5, 1.0, 7.0, 250.0])
        t = torch.cat([_ulps(base, k) for k in (-2, -1, 0, 1, 2)]).repeat(3)
        det, base = det.repeat(15), base.repeat(15)
        k = t.numel() // 3
        tmin = torch.zeros_like(t)
        tmin[:k] = base[:k]
        bt = torch.full_like(t, BIG)
        bt[k:2 * k] = base[k:2 * k]
        tmax = torch.full_like(t, BIG)
        tmax[2 * k:] = base[2 * k:]
        u = torch.full_like(t, 0.25)
        v = torch.full_like(t, 0.25)
    elif name == "seeds":
        # The seeds +-BIG (dead rays -BIG) and tmax 0 (dead any-hit rays),
        # against near, far and huge t.
        det, t, bt, tmax = _grid(DETS, [1e-3, 1.0, 1e30, 2.9e38, -1.0],
                                 [BIG, -BIG], [BIG, 0.0, 1e30])
        u = torch.full_like(det, 0.3)
        v = torch.full_like(det, 0.3)
        tmin = torch.zeros_like(det)
    else:
        raise ValueError(name)
    # The linear forms that give (u, v, t) at this det, and their
    # neighbours a few ulps away.
    uu, vv, tt = u * det, v * det, t * det
    out = []
    for k in (-2, -1, 0, 1, 2):
        out.append((det, _ulps(tt, k), _ulps(uu, -k), _ulps(vv, k)))
        out.append((det, _ulps(tt, -k), _ulps(uu, k), _ulps(vv, k)))
    det, tt, uu, vv = (torch.cat(x) for x in zip(*out))
    rep = len(out)
    return det, tt, uu, vv, tmin.repeat(rep), bt.repeat(rep), \
        tmax.repeat(rep)


def _random(seed, n=400_000):
    """Random pairs over the whole exponent range, many near the edges."""
    g = torch.Generator().manual_seed(seed)

    def mag(lo, hi):
        e = torch.empty(n).uniform_(lo, hi, generator=g)
        s = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
        return (s * torch.pow(10.0, e.double())).to(F32)

    det = mag(-46, 38.5)
    edge = lambda: torch.where(torch.rand(n, generator=g) < 0.5,  # noqa
                               torch.rand(n, generator=g) * 1e-6,
                               torch.rand(n, generator=g))
    u, v = edge(), edge()
    v = torch.where(torch.rand(n, generator=g) < 0.3, 1.0 - u, v)
    t = mag(-40, 38).abs()
    tmin = torch.where(torch.rand(n, generator=g) < 0.5, 0.0, t * 0.999999)
    bt = torch.where(torch.rand(n, generator=g) < 0.5, BIG, t * 1.000001)
    tmax = torch.where(torch.rand(n, generator=g) < 0.5, BIG, t * 1.0000001)
    uu, vv, tt = u * det, v * det, t * det
    return det, tt, uu, vv, tmin, bt, tmax


FAMILIES = ["det edges", "u v edges", "t edges", "seeds"]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("family", FAMILIES + ["random 0", "random 1"])
def test_pretest_passes_every_exact_hit(family, any_hit):
    if family.startswith("random"):
        det, tt, uu, vv, tmin, bt, tmax = _random(int(family[-1]))
    else:
        det, tt, uu, vv, tmin, bt, tmax = _family(family)
    lo, hi = _bounds(tmin, bt, tmax, any_hit)
    acc = exact(det, tt, uu, vv, tmin, bt, tmax, any_hit)
    ok = pretest(det, tt, uu, vv, lo, hi)
    missed = acc & ~ok
    assert not bool(missed.any()), (
        f"pre-test rejects {int(missed.sum())} exact hits, e.g. det "
        f"{det[missed][:3].tolist()} tt {tt[missed][:3].tolist()}")
    # The families do hold accepted pairs, and the pre-test is a filter.
    assert int(acc.sum()) > 0
    if family.startswith("random"):
        assert float(ok.float().mean()) < 0.9


def test_pretest_rejects_what_it_should():
    """Pairs clearly outside: u < 0, v < 0, u + v > 1, |det| <= 1e-12,
    t beyond the best or before tmin."""
    det = _f32([2.0, 2.0, 2.0, 1e-12, 2.0, 2.0, -2.0])
    uu = _f32([-0.2, 0.4, 1.2, 0.2e-12, 0.4, 0.4, -0.4])
    vv = _f32([0.4, -0.2, 1.0, 0.2e-12, 0.4, 0.4, -0.4])
    tt = _f32([2.0, 2.0, 2.0, 1e-12, 30.0, -2.0, 2.0])
    tmin = torch.zeros(7)
    bt = torch.full((7,), 10.0)
    lo, hi = _bounds(tmin, bt, bt, False)
    assert not bool(pretest(det, tt, uu, vv, lo, hi).any())
    # A clean hit at det < 0 passes (signs folded).
    assert bool(pretest(_f32([-2.0]), _f32([-2.0]), _f32([-0.4]),
                        _f32([-0.4]), lo[:1], hi[:1]))
