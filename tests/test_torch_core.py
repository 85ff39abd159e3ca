"""PyTorch port, core layer: types, camera, scenes, image helpers, oracle.

Inputs are made with numpy and go through hagrid_tpu and hagrid_tpu_torch
alike. Floats are compared at rtol 1e-6 (atol 1e-7 for values near 0,
where a one-ulp difference of a summand dominates).
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core import camera as j_camera
from hagrid_tpu.core.types import Rays as JRays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.grid.packet import rays_to_x as j_rays_to_x
from hagrid_tpu.io import image as j_image
from hagrid_tpu.utils.config import density_dims as j_density_dims
from hagrid_tpu_torch import oracle, scenes
from hagrid_tpu_torch.core import camera
from hagrid_tpu_torch.core.types import Rays, Triangles
from hagrid_tpu_torch.grid.packet import rays_to_x
from hagrid_tpu_torch.io import image
from hagrid_tpu_torch.utils.config import density_dims


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
    t, jt = Triangles.from_mesh(v, f), JTris.from_mesh(v, f)
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
    r = camera.primary_rays(cam, w, h, order=order)
    jr = j_camera.primary_rays(j_scenes.sponza_camera(), w, h, order=order)
    for k in ("org", "dir", "tmin", "tmax"):
        close(getattr(r, k), getattr(jr, k))


def test_primary_rays_jitter():
    rng = np.random.default_rng(2)
    jit = rng.random((32 * 32, 2)).astype(np.float32)
    r = camera.primary_rays(scenes.cornell_camera(), 32, 32, jitter=jit)
    jr = j_camera.primary_rays(j_scenes.cornell_camera(), 32, 32,
                               jitter=jnp.asarray(jit))
    close(r.dir, jr.dir)


def test_block_index():
    for w, h in ((32, 32), (128, 64)):
        np.testing.assert_array_equal(camera.block_index(w, h),
                                      j_camera.block_index(w, h))


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
    hits = oracle.closest_hit(Rays.make(org, d, tmax=tmax),
                              Triangles.from_mesh(v, f), chunk=64)
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
        "assert len(mods) >= 13, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
