"""The Cornell box, for the benchmark's CPU tests: the published
geometry (36 triangles) and its camera, in the scene-module form that a
configuration names (`make(params, seed)`)."""

from __future__ import annotations

import numpy as np


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


def make(params: dict, seed: int) -> dict:
    """The box scaled by params["scale"] (to the Sponza stand-in's units,
    so that the dynamic mix's wave moves it visibly) and its camera; the
    seed moves the eye by up to params["eye_jitter"] on each axis."""
    verts, faces = cornell_box()
    scale = float(params["scale"])
    rng = np.random.default_rng(seed % (1 << 64))
    eye = (np.asarray(params["eye"], np.float64) + rng.uniform(
        -1.0, 1.0, 3) * float(params["eye_jitter"])) * scale
    center = np.asarray(params["center"], np.float64) * scale
    return {"verts": (verts * np.float32(scale)).astype(np.float32),
            "faces": faces,
            "camera": {"eye": tuple(float(x) for x in eye),
                       "center": tuple(float(x) for x in center),
                       "up": (0.0, 1.0, 0.0),
                       "fov_deg": float(params["fov_deg"])}}
