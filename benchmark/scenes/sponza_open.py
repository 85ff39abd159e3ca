"""The Sponza-scale atrium open to the sky: the frozen generator of
sponza_like.py with the hall's roof left out (`open_top=True`), as the
Crytek Sponza's courtyard is, so that diffuse paths can escape and see
the sky. The frozen module is loaded from its sibling file by path, as a
private copy, and used as it is.

`make(params, seed)` is sponza_like.make with the generator called with
`open_top=True`: the mesh at the configuration's own seed in every run,
the camera moved a little by the run's seed, exactly as there.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib


def make(params: dict, seed: int) -> dict:
    """{"verts" f32[V, 3], "faces" i32[T, 3], "camera": {eye, center, up,
    fov_deg}} for `params` (the configuration's "scene" object: n_tris,
    seed, eye, center, fov_deg, eye_jitter, center_jitter) and the run's
    seed."""
    path = pathlib.Path(__file__).resolve().parent / "sponza_like.py"
    spec = importlib.util.spec_from_file_location("bench_scene_sponza_open",
                                                  path)
    frozen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(frozen)
    # The copy is this call's own: binding its generator changes nothing
    # that any other module holds.
    frozen.sponza_like = functools.partial(frozen.sponza_like, open_top=True)
    return frozen.make(params, seed)
