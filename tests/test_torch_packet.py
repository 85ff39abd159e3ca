"""PyTorch port, build layer: segment primitives, binning, packet build.

The integer tables of the grid must equal the reference's; float tables
(cols coefficients, slice planes) match at rtol 1e-6, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid import packet as j_packet
from hagrid_tpu.grid import uniform as j_uniform
from hagrid_tpu.ops import segment as j_segment
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.grid import packet, uniform
from hagrid_tpu_torch.ops import segment


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


def test_exclusive_scan_and_sort_pairs_stable():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 9, 500).astype(np.int32)
    np.testing.assert_array_equal(
        _np(segment.exclusive_scan(torch.as_tensor(x))),
        _np(j_segment.exclusive_scan(jnp.asarray(x))))
    keys = rng.integers(0, 7, 2000).astype(np.int32)   # many duplicates
    vals = np.arange(2000, dtype=np.int32)
    sk, sv = segment.sort_pairs(torch.as_tensor(keys), torch.as_tensor(vals))
    jk, jv = j_segment.sort_pairs(jnp.asarray(keys), jnp.asarray(vals))
    np.testing.assert_array_equal(_np(sk), _np(jk))
    np.testing.assert_array_equal(_np(sv), _np(jv))
    # Stable: equal keys keep their input order.
    for k in range(7):
        run = _np(sv)[_np(sk) == k]
        assert (np.diff(run) > 0).all()


def test_segment_starts():
    rng = np.random.default_rng(1)
    keys = np.sort(rng.integers(0, 40, 300)).astype(np.int32)  # 30+ invalid
    for nseg in (30, 40, 45):
        np.testing.assert_array_equal(
            _np(segment.segment_starts(torch.as_tensor(keys), nseg)),
            _np(j_segment.segment_starts(jnp.asarray(keys), nseg)))


def test_add_at_drop_matches_drop_mode_scatter():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 70, 200).astype(np.int32)      # some >= 50
    vals = rng.integers(-5, 5, 200).astype(np.int32)
    want = jnp.zeros((50,), jnp.int32).at[idx].add(vals, mode="drop")
    got = segment.add_at_drop(50, torch.as_tensor(idx), torch.as_tensor(vals))
    np.testing.assert_array_equal(_np(got), _np(want))
    want1 = jnp.zeros((50,), jnp.int32).at[idx].add(1, mode="drop")
    np.testing.assert_array_equal(
        _np(segment.add_at_drop(50, torch.as_tensor(idx), 1)), _np(want1))


def test_trunc_i32_saturates_like_xla():
    x = np.array([0.0, -0.7, 0.7, 5.5, -5.5, 1e9, -1e9, 3e9, -3e9, 3e38,
                  -3e38, np.inf, -np.inf, np.nan], np.float32)
    got = _np(segment.trunc_i32(torch.as_tensor(x)))
    want = _np(jnp.asarray(x).astype(jnp.int32))
    # Exact where |x| < 2^30; beyond, both saturate past any grid dim:
    # same sign and |value| >= 2^30.
    small = np.abs(np.nan_to_num(x)) < 2 ** 30
    np.testing.assert_array_equal(got[small], want[small])
    assert (np.sign(got[~small]) == np.sign(want[~small])).all()
    assert (np.abs(got[~small].astype(np.int64)) >= 2 ** 30).all()


def test_tri_box_overlap_and_voxel_ranges():
    rng = np.random.default_rng(3)
    n = 4000
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    lo = v0 - rng.uniform(0.0, 0.3, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    got = uniform.tri_box_overlap(*(torch.as_tensor(a)
                                    for a in (v0, v1, v2, lo, hi)))
    want = j_uniform.tri_box_overlap(*(jnp.asarray(a)
                                       for a in (v0, v1, v2, lo, hi)))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert 0.05 < _np(got).mean() < 0.95

    verts = np.concatenate([v0, v1, v2])
    faces = np.arange(3 * n, dtype=np.int32).reshape(3, n).T.copy()
    t, jt = Triangles.from_mesh(verts, faces), JTris.from_mesh(verts, faces)
    blo = np.array([-1.2, -1.1, -1.3], np.float32)
    bhi = np.array([1.1, 1.2, 1.0], np.float32)
    for dims in ((5, 7, 3), (16, 16, 16)):
        got = uniform.tri_voxel_ranges(t, torch.as_tensor(blo),
                                       torch.as_tensor(bhi), dims)
        want = j_uniform.tri_voxel_ranges(jt, jnp.asarray(blo),
                                          jnp.asarray(bhi), dims)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b))


def assert_grids_equal(g, jg):
    assert g.dims3 == jg.dims3
    assert g.ref_capacity == jg.ref_capacity
    for k in ("rs", "rowinfo", "total_refs", "total_pairs"):
        np.testing.assert_array_equal(_np(getattr(g, k)), _np(getattr(jg, k)),
                                      err_msg=k)
    cols, jcols = _np(g.cols), _np(jg.cols)
    assert cols.shape == jcols.shape
    np.testing.assert_array_equal(cols[:, 16::20], jcols[:, 16::20])  # ids
    np.testing.assert_allclose(cols, jcols, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(g.planes), _np(jg.planes), rtol=1e-6,
                               atol=1e-6)
    for k in ("bbox_lo", "bbox_hi"):
        np.testing.assert_array_equal(_np(getattr(g, k)), _np(getattr(jg, k)))
    assert bool(g.overflowed) == bool(jg.overflowed)


BUILDS = {
    "cornell_dims6": (lambda: j_scenes.cornell_box(), dict(dims=(6, 6, 6))),
    "soup_default": (lambda: j_scenes.random_soup(400, seed=1), {}),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_packet_cold_and_warm(name):
    mesh, kw = BUILDS[name]
    v, f = mesh()
    t, jt = Triangles.from_mesh(v, f), JTris.from_mesh(v, f)
    g, jg = packet.build_packet(t, **kw), j_packet.build_packet(jt, **kw)
    assert_grids_equal(g, jg)
    # Warm rebuild: frame-1 capacity and dims, host bbox, no check.
    bbox = (_np(jg.bbox_lo), _np(jg.bbox_hi))
    warm = dict(ref_capacity=g.ref_capacity, dims3=g.dims3, bbox=bbox,
                check=False)
    assert_grids_equal(packet.build_packet(t, **warm),
                       j_packet.build_packet(jt, **warm))


def _cell_pairs(g):
    """{(layout, row, col, tri)} of a grid's ref lists."""
    rs, cols = _np(g.rs), _np(g.cols)
    ids = cols[:, 16::20].reshape(-1).astype(np.int64)
    out, base = set(), 0
    for a, (da, db, dc) in enumerate(g.dims3):
        for r in range(da * db):
            for c in range(dc):
                lo = rs[base + r * (dc + 1) + c]
                hi = rs[base + r * (dc + 1) + c + 1]
                out.update((a, r, c, int(t)) for t in ids[lo:hi])
        base += da * db * (dc + 1)
    return out


def test_build_packet_sponza_pairs_match():
    """On the Sponza-like scene the reference's compiled build contracts
    the SAT's multiply-adds into FMAs, which the port's op-by-op rounding
    does not: a triangle lying exactly on a cell face can be kept by one
    and pruned by the other. Everything else must be equal: dims, slice
    planes (bit-exact), pair totals, and all but a handful of the
    ~30k (tri, cell) pairs."""
    v, f = j_scenes.sponza_like(4096)
    g = packet.build_packet(Triangles.from_mesh(v, f))
    jg = j_packet.build_packet(JTris.from_mesh(v, f))
    assert g.dims3 == jg.dims3 and g.ref_capacity == jg.ref_capacity
    np.testing.assert_array_equal(_np(g.planes), _np(jg.planes))
    np.testing.assert_array_equal(_np(g.rowinfo), _np(jg.rowinfo))
    assert int(g.total_pairs) == int(jg.total_pairs)
    pairs, jpairs = _cell_pairs(g), _cell_pairs(jg)
    assert len(jpairs) > 20000
    assert len(pairs ^ jpairs) <= 8, sorted(pairs ^ jpairs)


def test_warm_rebuild_overflow_flag():
    v, f = j_scenes.random_soup(400, seed=1)
    t, jt = Triangles.from_mesh(v, f), JTris.from_mesh(v, f)
    kw = dict(ref_capacity=768, dims=(8, 8, 8), check=False)
    g, jg = packet.build_packet(t, **kw), j_packet.build_packet(jt, **kw)
    assert bool(g.overflowed) and bool(jg.overflowed)
    assert int(g.total_pairs) == int(jg.total_pairs)


def test_build_packet_empty_scene():
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    g = packet.build_packet(Triangles.from_mesh(*empty))
    jg = j_packet.build_packet(JTris.from_mesh(*empty))
    assert_grids_equal(g, jg)


def test_build_packet_unported_options_raise():
    t = Triangles.from_mesh(*j_scenes.cornell_box())
    for kw in (dict(adaptive=True), dict(refine=True)):
        with pytest.raises(NotImplementedError):
            packet.build_packet(t, **kw)
