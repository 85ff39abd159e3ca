"""PyTorch port, core layer: types, camera, scenes, image helpers, oracle,
intersection tests, segment primitives, and the debugging aids around the
packet grid (invariants, planner sanitizer, checkpoints).

Inputs are made with numpy and go through hagrid_tpu and hagrid_tpu_torch
alike. Floats are compared at rtol 1e-6 (atol 1e-7 for values near 0,
where a one-ulp difference of a summand dominates).
"""

import ctypes
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core import camera as j_camera
from hagrid_tpu.core import intersect as j_intersect
from hagrid_tpu.core.types import AABB as JAABB
from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid.invariants import check_packet as j_check_packet
from hagrid_tpu.grid.packet import build_packet as j_build_packet
from hagrid_tpu.grid.packet import rays_to_x as j_rays_to_x
from hagrid_tpu.io import checkpoint as j_checkpoint
from hagrid_tpu.io import image as j_image
from hagrid_tpu.ops import segment as j_segment
from hagrid_tpu.utils.config import density_dims as j_density_dims
from hagrid_tpu.utils.sanitize import check_sweep_plan as j_check_sweep_plan
from hagrid_tpu_torch import interop, oracle, scenes
from hagrid_tpu_torch.core import camera, intersect
from hagrid_tpu_torch.core.types import AABB, Rays, Triangles
from hagrid_tpu_torch.grid.invariants import check_packet
from hagrid_tpu_torch.grid.packet import build_packet, rays_to_x
from hagrid_tpu_torch.io import checkpoint, image
from hagrid_tpu_torch.ops import segment
from hagrid_tpu_torch.ops import sweep_trace as st
from hagrid_tpu_torch.utils.config import density_dims
from hagrid_tpu_torch.utils import profiling
from hagrid_tpu_torch.utils.sanitize import check_sweep_plan


def close(got, want, rtol=1e-6, atol=1e-7):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


MESHES = {
    "cornell": lambda m: m.cornell_box(),
    "soup": lambda m: m.random_soup(300, seed=3),
    "sponza_4k": lambda m: m.sponza_like(4096),
    "san_miguel_8k": lambda m: m.san_miguel_like(8192),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_scene_generators_equal_reference(name):
    v, f = MESHES[name](scenes)
    jv, jf = MESHES[name](j_scenes)
    assert v.dtype == jv.dtype and f.dtype == jf.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


@pytest.mark.parametrize("preset", ["cornell_camera", "sponza_camera",
                                    "san_miguel_camera"])
def test_camera_presets_equal_reference(preset):
    cam, jcam = getattr(scenes, preset)(), getattr(j_scenes, preset)()
    assert (cam.eye, cam.center, cam.up, cam.fov_deg) == \
        (jcam.eye, jcam.center, jcam.up, jcam.fov_deg)
    for a, b in zip(cam.basis(), jcam.basis()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["cornell", "soup"])
def test_triangles_from_mesh_and_bounds(name):
    v, f = MESHES[name](j_scenes)
    t, jt = Triangles.from_mesh(v, f, device="cpu"), JTris.from_mesh(v, f)
    for k in ("v0", "e1", "e2", "n"):
        close(getattr(t, k), getattr(jt, k))
    for a, b in zip(t.bounds(), jt.bounds()):
        close(a, b)
    assert t.count == jt.count


def test_rays_to_x():
    rng = np.random.default_rng(1)
    org = rng.normal(size=(257, 3)).astype(np.float32) * 10
    d = rng.normal(size=(257, 3)).astype(np.float32)
    tmin = rng.uniform(0, 1, 257).astype(np.float32)
    tmax = np.where(rng.random(257) < 0.5, np.inf,
                    rng.uniform(1, 100, 257)).astype(np.float32)
    x = rays_to_x(*(torch.as_tensor(a) for a in (org, d, tmin, tmax)))
    jx = j_rays_to_x(*(jnp.asarray(a) for a in (org, d, tmin, tmax)))
    close(x, jx)


@pytest.mark.parametrize("order,w,h", [("scanline", 32, 32),
                                       ("block", 64, 32),
                                       ("block", 48, 40)])
def test_primary_rays(order, w, h):
    cam = scenes.sponza_camera()
    r = camera.primary_rays(cam, w, h, order=order, device="cpu")
    jr = j_camera.primary_rays(j_scenes.sponza_camera(), w, h, order=order)
    for k in ("org", "dir", "tmin", "tmax"):
        close(getattr(r, k), getattr(jr, k))


def test_primary_rays_jitter():
    rng = np.random.default_rng(2)
    jit = rng.random((32 * 32, 2)).astype(np.float32)
    r = camera.primary_rays(scenes.cornell_camera(), 32, 32, jitter=jit,
                            device="cpu")
    jr = j_camera.primary_rays(j_scenes.cornell_camera(), 32, 32,
                               jitter=jnp.asarray(jit))
    close(r.dir, jr.dir)


def test_block_index():
    """The host map and the on-device pixel coordinates that primary_rays
    and the integrators' reassembly use both equal the reference's map."""
    for w, h in ((32, 32), (128, 64)):
        want = j_camera.block_index(w, h)
        np.testing.assert_array_equal(camera.block_index(w, h), want)
        gx, gy = camera.block_pixels(w, h, "cpu")
        np.testing.assert_array_equal((gy * w + gx).numpy(), want)


def test_image_helpers_equal_reference():
    rng = np.random.default_rng(4)
    n = 40 * 48
    tri = rng.integers(-1, 30, n).astype(np.int32)
    nrm = rng.normal(size=(30, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    img = image.shade_eyelight(tri, None, nrm, d, 48, 40)
    np.testing.assert_array_equal(
        img, j_image.shade_eyelight(tri, None, nrm, d, 48, 40))
    assert image.dhash(img) == j_image.dhash(img)
    h2 = image.dhash(img[::-1])
    assert image.hamming(image.dhash(img), h2) == \
        j_image.hamming(j_image.dhash(img), h2)
    with pytest.raises(ValueError):
        image.hamming("00ff", "00ff00")
    with pytest.raises(ValueError):
        image.dhash(img[:4, :4])
    for ext, n_prims, dens in (((30, 15, 12), 262144, 0.4),
                               ((1, 1, 1), 36, 0.02), ((5, 0, 2), 0, 1.0)):
        assert density_dims(ext, n_prims, dens) == \
            j_density_dims(ext, n_prims, dens)


def test_oracle_matches_reference():
    v, f = j_scenes.cornell_box()
    rng = np.random.default_rng(5)
    org = (rng.uniform(0.2, 0.8, (300, 3)) * 550).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam_r = j_camera.primary_rays(j_scenes.cornell_camera(), 16, 16)
    org = np.concatenate([org, np.asarray(cam_r.org)])
    d = np.concatenate([d, np.asarray(cam_r.dir)])
    tmax = np.full(len(org), np.inf, np.float32)
    tmax[::7] = 50.0
    ref = j_oracle.closest_hit(JRays.make(org, d, tmax=tmax),
                               JTris.from_mesh(v, f))
    hits = oracle.closest_hit(Rays.make(org, d, tmax=tmax, device="cpu"),
                              Triangles.from_mesh(v, f, device="cpu"),
                              chunk=64)
    check_hits(hits, ref)
    np.testing.assert_array_equal(hits.tri_id.numpy(),
                                  np.asarray(ref.tri_id))


def test_port_imports_no_jax():
    """Every module of the port imports cleanly with jax, flax and the
    JAX package absent from sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hagrid_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'hagrid_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'hagrid_tpu')]\n"
        "new = {'hagrid_tpu_torch.' + m for m in ('device', 'ops.sortrays',"
        " 'render.sampling', 'render.integrators', 'render.dynamic',"
        " 'ops.micro_kernels', 'exp.kernel_mt20', 'exp.mxu_micro',"
        " 'core.intersect', 'grid.invariants', 'utils.sanitize',"
        " 'utils.profiling', 'io.checkpoint', 'ops.wavefront',"
        " 'grid.irregular', 'grid.traverse_ref', 'io.obj', 'native',"
        " 'native.objloader_native', 'parallel', 'parallel.mesh',"
        " 'parallel.distributed', 'cli')}\n"
        "assert len(mods) >= 45 and new <= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr


def test_aabb_matches_reference():
    v, f = j_scenes.random_soup(300, seed=3)
    t, jt = Triangles.from_mesh(v, f, device="cpu"), JTris.from_mesh(v, f)
    for box, jbox in ((AABB.of_points(v, device="cpu"), JAABB.of_points(v)),
                      (AABB.of_triangles(t), JAABB.of_triangles(jt))):
        for got, want in ((box, jbox), (box.pad(), jbox.pad()),
                          (box.pad(0.01), jbox.pad(0.01))):
            close(got.lo, want.lo)
            close(got.hi, want.hi)
            close(got.extents(), want.extents())
            close(got.half_area(), want.half_area())
    # Batched boxes: one per triangle.
    lo, hi = t.bounds()
    jlo, jhi = jt.bounds()
    close(AABB(lo, hi).half_area(), JAABB(jlo, jhi).half_area())


def _ray_batch(n, seed):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-1, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[rng.random((n, 3)) < 0.15] = 0.0          # axis-parallel rays
    d[::17, 1] = -0.0
    return org, d


def test_safe_inv_dir_and_slab_test():
    org, d = _ray_batch(600, 6)
    org[::5, 0] = 0.0       # on the box's x = 0 plane: 0 * inf on that axis
    inv = intersect.safe_inv_dir(torch.as_tensor(d))
    jinv = np.array(j_intersect.safe_inv_dir(jnp.asarray(d)))
    np.testing.assert_array_equal(inv.numpy(), jinv)
    assert np.isinf(inv.numpy()).any() and (inv.numpy() == -np.inf).any()
    lo = np.array([0.0, 0.0, 0.0], np.float32)
    hi = np.array([1.0, 1.0, 1.0], np.float32)
    tmin = np.zeros(600, np.float32)
    tmax = np.where(np.arange(600) % 3 == 0, 0.5, np.inf).astype(np.float32)
    got = intersect.slab_test(*(torch.as_tensor(a) for a in (
        org, jinv, lo, hi, tmin, tmax)))
    want = j_intersect.slab_test(*(jnp.asarray(a) for a in (
        org, jinv, lo, hi, tmin, tmax)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.1 < got[2].float().mean() < 0.9
    for a, b in zip(got[:2], want[:2]):
        close(a, b)
    # Batched boxes against one ray each.
    blo = org - 0.25
    got_b = intersect.slab_test(*(torch.as_tensor(a) for a in (
        org, jinv, blo, blo + 0.5, tmin, tmax)))
    assert bool(got_b[2][tmax > 0.5].all())      # the origin is inside


def test_moller_trumbore_matches_reference():
    v, f = j_scenes.random_soup(200, seed=7, tri_size=0.7)
    jt = JTris.from_mesh(v, f)
    org, d = _ray_batch(300, 8)
    tmin = np.zeros(300, np.float32)
    tmax = np.where(np.arange(300) % 4 == 0, 1.0, np.inf).astype(np.float32)
    want = j_intersect.moller_trumbore(
        jnp.asarray(org)[:, None], jnp.asarray(d)[:, None], jt.v0[None],
        jt.e1[None], jt.e2[None], jnp.asarray(tmin)[:, None],
        jnp.asarray(tmax)[:, None])
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    got = intersect.moller_trumbore(
        t(org)[:, None], t(d)[:, None], t(jt.v0)[None], t(jt.e1)[None],
        t(jt.e2)[None], t(tmin)[:, None], t(tmax)[:, None])
    hit, jhit = got[0].numpy(), np.asarray(want[0])
    assert jhit.sum() > 100
    assert (hit != jhit).sum() <= 2      # an edge-on pair may round apart
    both = hit & jhit
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   rtol=1e-4, atol=1e-5)
    assert oracle.moller_trumbore is intersect.moller_trumbore


def test_segment_rows_compact_unique():
    rng = np.random.default_rng(9)
    keys = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    for nseg, nrows in ((40, 300), (30, 320), (45, 200)):
        starts = j_segment.segment_starts(jnp.asarray(keys), nseg)
        np.testing.assert_array_equal(
            segment.rows_to_segments(torch.as_tensor(np.array(starts)),
                                     nrows).numpy(),
            np.asarray(j_segment.rows_to_segments(starts, nrows)))
    mask = rng.random(500) < 0.3
    idx, count = segment.compact_indices(torch.as_tensor(mask))
    jidx, jcount = j_segment.compact_indices(jnp.asarray(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(count) == int(jcount) == mask.sum()
    assert idx.dtype == torch.int32
    seg = np.sort(rng.integers(0, 12, 400)).astype(np.int32)
    val = rng.integers(0, 6, 400).astype(np.int32)
    order = np.lexsort((val, seg))
    seg, val = seg[order], val[order]
    got = segment.segmented_unique(torch.as_tensor(seg), torch.as_tensor(val),
                                   -1)
    want = j_segment.segmented_unique(jnp.asarray(seg), jnp.asarray(val), -1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(got[1].sum()) < 400


def _scatter_case(pattern):
    """(n, idx, addends) of one add_at_drop pattern at Cornell size; each
    addend a numpy array, a 1-element array (expanded) or a Python int."""
    rng = np.random.default_rng(11)
    small = lambda m: rng.integers(-3, 4, m) * (rng.random(m) < 0.6)  # noqa
    if pattern == "all_dropped":
        idx = rng.integers(40, 90, 700)
        return 40, idx, [small(700), 1]
    if pattern == "all_equal":
        return 40, np.full(3000, 17), [small(3000), rng.integers(1, 4, 3000)]
    if pattern == "sorted_runs":     # runs past a warp (32) and a block
        idx = np.repeat([0, 3, 4, 9, 39, 40], [40, 300, 1, 1100, 33, 900])
        return 40, idx, [small(idx.size), np.ones(idx.size, np.int64)]
    if pattern == "random":
        return 64, rng.integers(0, 80, 2500), [small(2500)]
    if pattern == "fill":            # the run starts of expand_by_counts
        offsets = np.cumsum(rng.integers(0, 3, 600))
        return 500, offsets, [1, 0, -2]
    if pattern == "expanded":
        return 30, rng.integers(0, 35, 1000), [np.array([5]), np.array([0])]
    if pattern == "empty":
        return 25, np.zeros(0, np.int64), [np.zeros(0, np.int64), 1]
    if pattern == "n1":
        return 1, rng.integers(0, 3, 500), [small(500), 1]
    # int64 sums past 2^31 (the sweep planner's threshold deltas)
    idx = np.sort(rng.integers(0, 20, 900))
    return 20, idx, [rng.integers(1 << 29, 1 << 30, 900).astype(np.int64)]


class _HostScatterLib:
    """csrc/scatter.cu's C entry point on host memory, by its documented
    contract: what the wrapper hands the kernel, read back through the
    pointers, strides and element sizes it passes."""

    def __init__(self):
        self.calls = []

    def hagrid_scatter_add_drop(self, idx, idx_bytes, istride, vals,
                                val_bytes, vstride, fill, m, n, out, sms,
                                stream):
        self.calls.append((idx_bytes, istride, vals is None, val_bytes,
                           vstride, fill, m, n))
        ct = {4: ctypes.c_int32, 8: ctypes.c_int64}

        def read(ptr, size, count, stride):
            a = np.ctypeslib.as_array(ctypes.cast(
                ptr, ctypes.POINTER(ct[size])), ((count - 1) * stride + 1,))
            return a[::stride] if stride else np.repeat(a, count)

        k = read(idx, idx_bytes, m, istride).astype(np.int64)
        v = (np.full(m, fill) if vals is None
             else read(vals, val_bytes, m, vstride))
        o = np.ctypeslib.as_array(ctypes.cast(
            out, ctypes.POINTER(ct[val_bytes])), (n,))
        keep = (k >= 0) & (k < n)
        np.add.at(o, k[keep], v[keep].astype(o.dtype))
        return 0


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("pattern", ["all_dropped", "all_equal",
                                     "sorted_runs", "random", "fill",
                                     "expanded", "empty", "n1", "i64_sums"])
def test_add_at_drop_contract_and_dispatch(monkeypatch, pattern, idx_dtype):
    """add_at_drop against numpy's bincount: the plain version (CPU
    tensors, float addends) and the kernel's wrapper, whose arguments a
    host copy of the kernel's contract reads back; integer addends off the
    CPU take the kernel, the rest index_add_ (a loader that raises shows
    the plain path never reaches it)."""
    from hagrid_tpu_torch.ops import _build

    def no_kernel():
        raise AssertionError("the plain path loaded the kernels")

    monkeypatch.setattr(_build, "load", no_kernel)
    n, idx_np, addends = _scatter_case(pattern)
    idx = torch.as_tensor(idx_np.astype(np.int64)).to(idx_dtype)
    for a in addends:
        a_np = np.broadcast_to(np.asarray(a), idx_np.shape)
        want = np.bincount(np.minimum(idx_np, n), weights=a_np,
                           minlength=n + 1)[:n].astype(np.int64)
        vals = (torch.as_tensor(a).expand(idx.shape) if np.ndim(a)
                else int(a))
        dtype = vals.dtype if torch.is_tensor(vals) else torch.int32
        got = segment.add_at_drop(n, idx, vals)
        assert got.dtype == dtype and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        if torch.is_tensor(vals):    # float addends: index_add_ as well
            gotf = segment.add_at_drop(n, idx, vals.double())
            np.testing.assert_array_equal(gotf.numpy(), want)

        lib = _HostScatterLib()
        monkeypatch.setattr(_build, "load", lambda: lib)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: types.SimpleNamespace(
                                cuda_stream=0))
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev=None: types.SimpleNamespace(
                                multi_processor_count=132))
        before = segment.launches["scatter_add_drop"]
        got = segment.add_at_drop_kernel(n, idx, vals)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)
        launched = segment.launches["scatter_add_drop"] - before
        assert launched == len(lib.calls) == int(idx_np.size > 0)
        if torch.is_tensor(vals) and lib.calls:  # expanded: stride 0
            assert lib.calls[0][4] == (0 if np.size(a) == 1 else 1)
        monkeypatch.setattr(_build, "load", no_kernel)

    took = []                                    # the dispatch rule
    for path in ("add_at_drop_kernel", "add_at_drop_plain"):
        monkeypatch.setattr(segment, path,
                            lambda n, i, v, path=path: took.append(path))
    for dev in ("cpu", "meta"):
        i = idx.to(dev)
        for v in (1, torch.ones(idx.shape, dtype=torch.int64, device=dev),
                  torch.ones(idx.shape, dtype=torch.int32, device=dev),
                  torch.ones(idx.shape, device=dev)):
            segment.add_at_drop(n, i, v)
    assert took == ["add_at_drop_plain"] * 4 + ["add_at_drop_kernel"] * 3 + [
        "add_at_drop_plain"]


def _scan_case(pattern, dtype):
    """One running-scan input (numpy int64, cast to `dtype` by the test);
    the long ones span two or more of the kernel's tiles (8192 int32 or
    4096 int64 values)."""
    rng = np.random.default_rng(23)
    info = np.iinfo(dtype)
    if pattern == "empty":
        return np.zeros(0, np.int64)
    if pattern == "one":
        return np.array([-7])
    if pattern == "all_equal":
        return np.full(9000, 5)
    if pattern == "ascending":
        return np.arange(-4000, 14000)
    if pattern == "descending":
        return np.arange(14000, -4000, -1)
    if pattern == "random":
        return rng.integers(-10**6, 10**6, 20_345)
    if pattern == "extremes":
        x = rng.integers(-5, 5, 8200)
        x[rng.random(8200) < 0.1] = info.min
        x[rng.random(8200) < 0.1] = info.max
        return x
    # the run starts of the packet build: slot j where a run begins, else 0
    counts = rng.integers(0, 4, 3000)
    cap = int(counts.sum()) + 50
    offsets = np.cumsum(counts) - counts
    markers = np.bincount(offsets, minlength=cap)[:cap]
    return np.where(markers > 0, np.arange(cap), 0)


class _HostScanLib:
    """csrc/scan.cu's C entry points on host memory, by their documented
    contract: the workspace size (0 for one 32 KiB tile of values or
    less), and the scan read back through the pointers the wrapper
    passes."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def hagrid_running_scan_workspace(n, val_bytes):
        tiles = -(-n // (32768 // val_bytes))
        return ((16 + 4 * tiles + 15) // 16 * 16 + 2 * tiles * val_bytes
                if tiles > 1 else 0)

    def hagrid_running_scan(self, x, y, n, val_bytes, is_max, work,
                            work_bytes, stream):
        need = self.hagrid_running_scan_workspace(n, val_bytes)
        assert work_bytes >= need and (work is not None) == (need > 0)
        self.calls.append((n, val_bytes, is_max, work_bytes))
        ct = {4: ctypes.c_int32, 8: ctypes.c_int64}[val_bytes]
        src, dst = (np.ctypeslib.as_array(ctypes.cast(p, ctypes.POINTER(ct)),
                                          (n,)) for p in (x, y))
        (np.maximum if is_max else np.minimum).accumulate(src, out=dst)
        return 0


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("pattern", ["empty", "one", "all_equal",
                                     "ascending", "descending", "random",
                                     "extremes", "run_starts"])
def test_running_scan_contract_and_dispatch(monkeypatch, pattern, dtype, op):
    """running_max / running_min against numpy's accumulate: the plain
    version (CPU tensors, other dtypes), and the kernel's wrapper, whose
    arguments a host copy of the kernel's contract reads back (one launch
    counted for a non-empty input); CPU tensors take torch.cummax / cummin
    (a loader that raises shows the plain path never reaches it), every
    tensor off the CPU the kernel, whose wrapper refuses what the kernel
    does not take (2-D, float, int16) before it loads."""
    from hagrid_tpu_torch.ops import _build

    def no_kernel():
        raise AssertionError("the plain path loaded the kernels")

    monkeypatch.setattr(_build, "load", no_kernel)
    x_np = _scan_case(pattern, dtype).astype(dtype)
    want = (np.maximum if op == "max" else np.minimum).accumulate(x_np)
    x = torch.as_tensor(x_np)
    scan = getattr(segment, f"running_{op}")
    got = scan(x)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(scan(x.double()).numpy(), want)

    lib = _HostScanLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    kernel = getattr(segment, f"running_{op}_kernel")
    before = segment.launches["running_scan"]
    for xk in (x, torch.stack([x, x], 1)[:, 0]):     # a strided view too
        got = kernel(xk)
        assert got.dtype == x.dtype and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert segment.launches["running_scan"] - before == len(lib.calls) == (
        2 * int(x_np.size > 0))
    assert all(c[1] == x.element_size() and c[2] == int(op == "max")
               for c in lib.calls)
    monkeypatch.setattr(_build, "load", no_kernel)
    with pytest.raises(ValueError):
        kernel(x.reshape(1, -1))
    for bad in (x.float(), x.to(torch.int16)):
        with pytest.raises(TypeError):
            kernel(bad)

    took = []                                    # the dispatch rule
    for path in (f"running_{op}_kernel", f"running_{op}_plain"):
        monkeypatch.setattr(segment, path,
                            lambda x, path=path: took.append(path))
    for dev in ("cpu", "meta"):
        for xd in (x, x.reshape(1, -1), x.float(), x.to(torch.int16)):
            scan(xd.to(dev))
    assert took == [f"running_{op}_plain"] * 4 + [
        f"running_{op}_kernel"] * 4


@pytest.fixture(scope="module")
def cornell_grids():
    v, f = j_scenes.cornell_box()
    jt = JTris.from_mesh(v, f)
    return dict(v=v, f=f, jt=jt, jg=j_build_packet(jt, dims=(6, 5, 4)),
                g=build_packet(Triangles.from_mesh(v, f, device="cpu"),
                               dims=(6, 5, 4)))


def test_check_packet_passes_and_catches_corruption(cornell_grids):
    import dataclasses
    g = cornell_grids["g"]
    check_packet(g, sample_tris=None)
    j_check_packet(cornell_grids["jg"], sample_tris=None)
    # The port's checker reads the reference's grid as well.
    check_packet(interop.packet_grid_from_reference(cornell_grids["jg"],
                                                    device="cpu"),
                 sample_tris=None)
    v, f = j_scenes.sponza_like(4096)
    check_packet(build_packet(Triangles.from_mesh(v, f, device="cpu")),
                 sample_tris=256)
    # A row whose ref map steps backwards.
    rs = g.rs.clone()
    row = int(torch.nonzero(rs[1:] > rs[:-1])[0])
    rs[row + 1] = rs[row] - 1
    with pytest.raises(AssertionError):
        check_packet(dataclasses.replace(g, rs=rs), sample_tris=None)
    # A live ref whose id is out of range.
    cols = g.cols.clone()
    cols[0, 16] = g.tris.count
    with pytest.raises(AssertionError):
        check_packet(dataclasses.replace(g, cols=cols), sample_tris=None)
    # A ref list that lost a triangle (ids swapped for a neighbour's).
    cols = g.cols.clone()
    cols[0, 16] = cols[0, 36]
    with pytest.raises(AssertionError):
        check_packet(dataclasses.replace(g, cols=cols), sample_tris=None)


def test_check_sweep_plan_summary_equals_reference(cornell_grids):
    c = cornell_grids
    jg = j_build_packet(c["jt"])
    g = interop.packet_grid_from_reference(jg, device="cpu")
    jr = j_camera.primary_rays(j_scenes.cornell_camera(), 64, 64)
    rays = interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                   device="cpu")
    want = j_check_sweep_plan(jg, jr, tile=128, bmax=512)
    got = check_sweep_plan(g, rays, tile=128, bmax=512)
    assert got == want
    assert got["ranges"] > 0 and got["blocks"] > 0
    assert got["units"] <= got["demand_units"]
    # Degenerate directions plan without NaN, as in the reference.
    n = 128
    d = np.zeros((n, 3), np.float32)
    d[::2, 2] = 1.0
    deg = Rays.make(np.full((n, 3), 0.5, np.float32), d,
                    tmax=np.full(n, 10.0, np.float32), device="cpu")
    assert check_sweep_plan(g, deg, tile=128, bmax=512)["demand_units"] >= 0
    # A NaN origin is caught.
    org = np.array(jr.org)
    org[5, 0] = np.nan
    bad = Rays.make(org, np.array(jr.dir), device="cpu")
    with pytest.raises(AssertionError):
        check_sweep_plan(g, bad, tile=128, bmax=512)
    # So is a ref map that points past the table.
    import dataclasses
    rs = g.rs.clone()
    rs[-1] = 1 << 24
    with pytest.raises(AssertionError):
        check_sweep_plan(dataclasses.replace(g, rs=rs), rays, tile=128,
                         bmax=512)


def test_checkpoint_loads_in_either_package(cornell_grids, tmp_path):
    c = cornell_grids
    # Written by the port, read by the reference.
    p1 = str(tmp_path / "port.npz")
    checkpoint.save_grid(p1, c["g"])
    jg2 = j_checkpoint.load_grid(p1)
    assert type(jg2) is type(c["jg"])
    # Written by the reference, read by the port.
    p2 = str(tmp_path / "ref.npz")
    j_checkpoint.save_grid(p2, c["jg"])
    g2 = checkpoint.load_grid(p2, device="cpu")
    g1 = checkpoint.load_grid(p1, device="cpu")
    for got, want in ((g2, c["jg"]), (g1, c["g"]), (c["g"], jg2)):
        assert got.dims3 == want.dims3
        assert got.ref_capacity == want.ref_capacity
        for k in ("bbox_lo", "bbox_hi", "rs", "rowinfo", "cols",
                  "total_refs", "total_pairs", "planes"):
            a, b = getattr(got, k), getattr(want, k)
            assert str(a.dtype).split(".")[-1] == str(b.dtype).split(".")[-1]
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), k)
        for k in ("v0", "e1", "e2", "n"):
            np.testing.assert_array_equal(np.asarray(getattr(got.tris, k)),
                                          np.asarray(getattr(want.tris, k)))
    # The loaded grid traces.
    rays = camera.primary_rays(scenes.cornell_camera(), 16, 16,
                               order="block", device="cpu")
    hits = st.trace_sweep(g2, rays, coherent=True, tile=128)
    check_hits(hits, oracle.closest_hit(rays, g2.tris))
    with pytest.raises(TypeError):
        checkpoint.save_grid(p1, object())


def test_profiling_helpers_on_cpu():
    """StageTimer, timed and device_trace on the host clock (on the card
    they take CUDA events; tests/test_torch_gpu.py)."""
    calls = []

    def work(n, scale=1.0):
        calls.append(n)
        return (torch.arange(n, dtype=torch.float32) * scale).sum()

    s = profiling.timed(work, 1000, warmup=2, iters=3, chain=4, scale=2.0,
                        device="cpu")
    assert len(calls) == 2 + 3 * 4 and 0 < s < 1.0
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.stage("sum"):
            work(1000)
    with timer.stage("big"):
        work(200000)
    assert set(timer.stages) == {"sum", "big"}
    assert all(v > 0 for v in timer.stages.values())
    report = timer.report().splitlines()
    assert report[0].split() == ["stage", "ms", "%"] and len(report) == 3
    with profiling.device_trace() as prof:
        work(1000)
    assert any("sum" in e.key for e in prof.key_averages())


def test_time_runs_keeps_each_run_on_both_clocks():
    """time_runs: one entry a run on each clock, per call of its chain
    (off the card both are the host clock's); timed is their median."""
    calls = []
    t = profiling.time_runs(lambda n: calls.append(n), 7, warmup=1, iters=4,
                            chain=3, device="cpu")
    assert calls == [7] * (1 + 4 * 3)
    assert len(t["seconds"]) == len(t["wall"]) == 4
    assert t["seconds"] == t["wall"] and all(x > 0 for x in t["wall"])
    s = profiling.spread([3.0, 1.0, 2.0])
    assert s == {"median": 2.0, "min": 1.0, "max": 3.0, "runs": 3}
    assert profiling.spread(None) is None
