"""The Sponza-scale scene, frozen: a copy of the procedural atrium
generator and its camera, so that a change to the program's own scene
module cannot move the benchmark's inputs.

`make(params, seed)` returns the mesh and the camera of one run. The
mesh is the generator's at the configuration's own seed, the same in
every run: its layout decides the sizes of the grids built on it (the
irregular build's capacities among them), so a run's seed may not change
it. The run's seed moves the camera a little, so every seed sees the
hall from nearly the same place.
"""

from __future__ import annotations

import numpy as np


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


def make(params: dict, seed: int) -> dict:
    """{"verts" f32[V, 3], "faces" i32[T, 3], "camera": {eye, center, up,
    fov_deg}} for `params` (the configuration's "scene" object: n_tris,
    seed, eye, center, fov_deg, eye_jitter, center_jitter) and the run's
    seed."""
    verts, faces = sponza_like(int(params["n_tris"]),
                               seed=int(params["seed"]))
    rng = np.random.default_rng(np.random.SeedSequence(seed % (1 << 64)))
    eye = np.asarray(params["eye"], np.float64) + rng.uniform(
        -1.0, 1.0, 3) * float(params["eye_jitter"])
    center = np.asarray(params["center"], np.float64) + rng.uniform(
        -1.0, 1.0, 3) * float(params["center_jitter"])
    camera = {"eye": tuple(float(x) for x in eye),
              "center": tuple(float(x) for x in center),
              "up": (0.0, 1.0, 0.0), "fov_deg": float(params["fov_deg"])}
    return {"verts": verts, "faces": faces, "camera": camera}
