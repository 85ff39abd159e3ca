"""Procedural benchmark scenes and camera presets (port of
hagrid_tpu/scenes.py).

The mesh generators are plain numpy and produce the same arrays as
hagrid_tpu/scenes.py (tests/test_torch_core.py holds them equal); they live
here so the port runs where neither JAX nor the JAX package is
importable. The camera presets are built on the port's own Camera.

- ``cornell_box()``: the published Cornell-box geometry (36 tris).
- ``sponza_like(n_tris)``: a colonnaded two-story atrium (~262k tris at
  default), Crytek-Sponza scale and occlusion character.
- ``san_miguel_like(n_tris)``: the atrium plus dense foliage (~1M tris).
- ``random_soup(n)``: random triangle soup for property tests.

``load_scene`` also takes a path to a Wavefront OBJ (io/obj.py).
"""

from __future__ import annotations

import numpy as np

from .core.camera import Camera
from .io.obj import load_obj


def merge(meshes):
    """[(verts, faces), ...] -> (verts, faces) with offset face indices."""
    vs, fs, off = [], [], 0
    for v, f in meshes:
        vs.append(np.asarray(v, np.float32))
        fs.append(np.asarray(f, np.int64) + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs).astype(np.int32)


def grid_quad(p0, du, dv, nu, nv, flip=False):
    """Tessellated parallelogram patch: p0 + u*du + v*dv, (nu*nv*2) tris."""
    p0 = np.asarray(p0, np.float32)
    du = np.asarray(du, np.float32)
    dv = np.asarray(dv, np.float32)
    us = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    vs = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    verts = (p0[None, None] + uu[..., None] * du[None, None]
             + vv[..., None] * dv[None, None]).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b = a + (nv + 1)
    c = a + 1
    d = b + 1
    if flip:
        faces = np.stack([np.stack([a, c, b], 1), np.stack([b, c, d], 1)], 1)
    else:
        faces = np.stack([np.stack([a, b, c], 1), np.stack([b, d, c], 1)], 1)
    return verts, faces.reshape(-1, 3)


def box(lo, hi, n=1, open_top=False):
    """Axis-aligned box with each face an n x n patch (12*n^2 tris).
    open_top omits the +y face."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    d = hi - lo
    ex = [d[0], 0, 0]
    ey = [0, d[1], 0]
    ez = [0, 0, d[2]]
    faces = [
        grid_quad(lo, ey, ez, n, n, flip=True),              # -x
        grid_quad([hi[0], lo[1], lo[2]], ey, ez, n, n),      # +x
        grid_quad(lo, ex, ez, n, n),                         # -y
        grid_quad(lo, ex, ey, n, n, flip=True),              # -z
        grid_quad([lo[0], lo[1], hi[2]], ex, ey, n, n),      # +z
    ]
    if not open_top:
        faces.append(
            grid_quad([lo[0], hi[1], lo[2]], ex, ez, n, n, True))  # +y
    return merge(faces)


def cylinder(center, radius, height, nseg=16, nh=4, cap=True):
    """Vertical (y-up) cylinder."""
    cx, cy, cz = center
    ang = np.linspace(0, 2 * np.pi, nseg + 1, dtype=np.float32)
    hs = np.linspace(0, height, nh + 1, dtype=np.float32)
    aa, hh = np.meshgrid(ang, hs, indexing="ij")
    verts = np.stack([cx + radius * np.cos(aa), cy + hh,
                      cz + radius * np.sin(aa)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nseg), np.arange(nh), indexing="ij")
    a = (i * (nh + 1) + j).reshape(-1)
    b = a + (nh + 1)
    faces = np.concatenate([np.stack([a, b, a + 1], 1),
                            np.stack([b, b + 1, a + 1], 1)])
    meshes = [(verts, faces)]
    if cap:
        top = np.stack([cx + radius * np.cos(ang),
                        np.full_like(ang, cy + height),
                        cz + radius * np.sin(ang)], -1)
        centerv = np.array([[cx, cy + height, cz]], np.float32)
        cv = np.concatenate([centerv, top])
        cf = np.stack([np.zeros(nseg, np.int64), np.arange(1, nseg + 1),
                       np.arange(2, nseg + 2)], 1)
        cf[-1, 2] = 1
        meshes.append((cv, cf))
    return merge(meshes)


def uv_sphere(center, radius, nseg=12, nring=8):
    cx, cy, cz = center
    th = np.linspace(0, np.pi, nring + 1, dtype=np.float32)
    ph = np.linspace(0, 2 * np.pi, nseg + 1, dtype=np.float32)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([cx + radius * np.sin(tt) * np.cos(pp),
                      cy + radius * np.cos(tt),
                      cz + radius * np.sin(tt) * np.sin(pp)],
                     -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nring), np.arange(nseg), indexing="ij")
    a = (i * (nseg + 1) + j).reshape(-1)
    b = a + (nseg + 1)
    faces = np.concatenate([np.stack([a, b, a + 1], 1),
                            np.stack([b, b + 1, a + 1], 1)])
    return verts.astype(np.float32), faces


def cornell_box():
    """The published Cornell-box geometry (walls + two blocks), 36 tris."""
    quads = [
        # floor
        [(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)],
        # ceiling
        [(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2),
         (0, 548.8, 0)],
        # back wall
        [(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2),
         (556, 548.8, 559.2)],
        # right wall (green)
        [(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)],
        # left wall (red)
        [(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2),
         (556, 548.8, 0)],
        # short block
        [(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)],
        [(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)],
        [(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)],
        [(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)],
        [(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)],
        # tall block
        [(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)],
        [(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)],
        [(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)],
        [(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)],
        [(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)],
        # light (slightly below ceiling)
        [(343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332),
         (213, 548.7, 227)],
    ]
    vs, fs = [], []
    for q in quads:
        base = len(vs)
        vs.extend(q)
        fs.append((base, base + 1, base + 2))
        fs.append((base, base + 2, base + 3))
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


def cornell_camera() -> Camera:
    return Camera(eye=(278.0, 273.0, -800.0), center=(278.0, 273.0, 0.0),
                  up=(0.0, 1.0, 0.0), fov_deg=39.3)


def random_soup(n, seed=0, extent=1.0, tri_size=0.1):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(0, extent, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-tri_size, tri_size, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-tri_size, tri_size, (n, 3)).astype(np.float32)
    verts = np.concatenate([v0, v1, v2])
    faces = np.arange(3 * n, dtype=np.int32).reshape(3, n).T
    return verts, faces.astype(np.int32)


def sponza_like(n_tris=262144, seed=7, open_top=False):
    """Colonnaded two-story atrium at Crytek-Sponza scale (~n_tris)."""
    rng = np.random.default_rng(seed)
    # Hall: 30m x 12m x 15m high, like Sponza's atrium.
    L, W, H = 30.0, 12.0, 15.0
    # Budget: ~45% shell, ~30% columns+arches, ~15% banners, ~10% clutter.
    shell_n = max(4, int(np.sqrt(n_tris * 0.45 / 12)))
    meshes = [box([0, 0, 0], [L, H, W], n=shell_n, open_top=open_top)]

    # Column rows along +-z at two stories.
    ncols = 12
    col_budget = int(n_tris * 0.30 / (ncols * 4))
    nseg = max(8, int(np.sqrt(col_budget * 2)))
    nh = max(4, nseg // 2)
    for i in range(ncols):
        x = 2.5 + i * (L - 5.0) / (ncols - 1)
        for z in (2.5, W - 2.5):
            for (y0, h) in ((0.0, 5.5), (6.5, 5.0)):
                meshes.append(cylinder((x, y0, z), 0.45, h, nseg, nh))

    # Banners: hanging wavy cloth strips (tessellated, displaced).
    nban = 8
    ban_budget = max(8, int(n_tris * 0.15 / (nban * 2)))
    bu = max(4, int(np.sqrt(ban_budget)))
    for i in range(nban):
        x = 4.0 + i * (L - 8.0) / max(1, nban - 1)
        z = W * 0.5 + rng.uniform(-2, 2)
        v, f = grid_quad([x, 10.5, z], [1.8, 0, 0], [0, -4.0, 0.3], bu, bu)
        v = v + 0.08 * np.sin(v[:, 1:2] * 5.0 + i) * np.array([[0, 0, 1.0]])
        meshes.append((v.astype(np.float32), f))

    # Clutter: spheres/boxes on the floor (pots, debris).
    nclut = 24
    clut_budget = max(24, int(n_tris * 0.10 / nclut))
    cs = max(6, int(np.sqrt(clut_budget / 2)))
    for i in range(nclut):
        x = rng.uniform(2, L - 2)
        z = rng.uniform(1.5, W - 1.5)
        r = rng.uniform(0.2, 0.6)
        if i % 2 == 0:
            meshes.append(uv_sphere((x, r, z), r, cs, cs))
        else:
            meshes.append(box([x - r, 0, z - r], [x + r, 2 * r, z + r],
                              n=max(1, cs // 3)))
    return merge(meshes)


def sponza_camera() -> Camera:
    return Camera(eye=(2.0, 6.0, 6.0), center=(25.0, 4.0, 6.0),
                  up=(0.0, 1.0, 0.0), fov_deg=65.0)


# dhash of the 128x128 eye-light render of sponza_like(262144) from
# sponza_camera(), as the JAX package's session and its brute-force oracle
# render it (tests/test_torch_sweep.py::test_sponza_eyelight_reference_dhash).
SPONZA_EYELIGHT_DHASH = "9393927196d696aa"


def san_miguel_camera() -> Camera:
    """Courtyard-level view: ground + columns below the foliage canopy."""
    return Camera(eye=(2.0, 3.0, 6.0), center=(28.0, 5.0, 6.0),
                  up=(0.0, 1.0, 0.0), fov_deg=62.0)


def san_miguel_like(n_tris=1000000, seed=11):
    """Courtyard at San-Miguel scale: atrium + dense foliage quads."""
    rng = np.random.default_rng(seed)
    base_v, base_f = sponza_like(int(n_tris * 0.4), seed=seed,
                                 open_top=True)
    meshes = [(base_v, base_f)]
    n_leaf = int(n_tris * 0.6 / 2)
    ntrees = 6
    centers = rng.uniform([5, 6, 3], [25, 12, 9], (ntrees, 3))
    tree = rng.integers(0, ntrees, n_leaf)
    pos = centers[tree] + rng.normal(0, 1.6, (n_leaf, 3))
    s = 0.12
    du = rng.normal(0, s, (n_leaf, 3))
    dv = rng.normal(0, s, (n_leaf, 3))
    v0 = pos
    v1 = pos + du
    v2 = pos + dv
    v3 = pos + du + dv
    verts = np.concatenate([v0, v1, v2, v3]).astype(np.float32)
    idx = np.arange(n_leaf)
    f1 = np.stack([idx, idx + n_leaf, idx + 2 * n_leaf], 1)
    f2 = np.stack([idx + n_leaf, idx + 3 * n_leaf, idx + 2 * n_leaf], 1)
    meshes.append((verts, np.concatenate([f1, f2]).astype(np.int32)))
    return merge(meshes)


def load_scene(name_or_path: str):
    """Scene registry: name, or a path to a Wavefront .obj, -> (verts,
    faces, camera). An OBJ gets a camera outside its bounds looking at
    their center."""
    if name_or_path.endswith(".obj"):
        v, f = load_obj(name_or_path)
        lo, hi = v.min(0), v.max(0)
        c = (lo + hi) * 0.5
        eye = c + (hi - lo) * np.array([0.6, 0.3, 1.2])
        return v, f, Camera(eye=tuple(eye), center=tuple(c))
    if name_or_path == "cornell":
        v, f = cornell_box()
        return v, f, cornell_camera()
    if name_or_path == "sponza":
        v, f = sponza_like()
        return v, f, sponza_camera()
    if name_or_path == "san_miguel":
        v, f = san_miguel_like()
        return v, f, san_miguel_camera()
    raise ValueError(f"unknown scene {name_or_path!r}")
