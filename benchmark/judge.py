"""The comparison that decides `correct`: the program's outputs of frames
kept from the measured window against the plain reference
(reference.py), on the same inputs.

For each kept frame the reference works out again what the program
derived from the inputs, and each step of the mix (steps/<name>.py)
judges its own outputs in its check(ctx, fr), in the frame's order: a
deform step moves the frame's vertices, a primary step compares the
closest hits, an AO step the occlusion decisions from them. A step's
NUMBERS say how its numbers add up over the frames: "share" (check
returns (wrong, seen), summed, then divided) or "max".

The context a check gets: `mix`, `inputs`, `seed`, `q` (None, or the
control's lower precision), `faces`, `rays` (the reference's primary
rays in block order, and `rays_q` in the control's precision), `idx`
(the frame's sample of rays, drawn from the seed), `verts` / `verts_q`
(the frame's vertices; frame_tris builds the triangles from them), and
what earlier steps of the frame left in it.

`control=q` puts the reference, computed in the lower precision q
(reference.QUANT), in the program's place: each check then judges the
reference's own answers at q, as it would the program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import frames
import reference as ref


def sample_index(n: int, m: int, seed: int, frame: int, device):
    """m distinct ray indices of n, drawn from the run's seed and the
    frame's index."""
    ss = np.random.SeedSequence([seed % (1 << 64), frame])
    rng = np.random.default_rng(ss)
    idx = np.sort(rng.choice(n, size=min(m, n), replace=False))
    return torch.from_numpy(idx).to(device)


def frame_tris(ctx: dict, control: bool = False) -> dict:
    """The frame's triangles from its vertices as they stand in `ctx`:
    the control's (in its precision) where `control`, else float32."""
    key = "tris_q" if control else "tris"
    if key not in ctx:
        ctx[key] = ref.triangles(ctx["verts_q" if control else "verts"],
                                 ctx["faces"], ctx["q"] if control else None)
    return ctx[key]


def judge(kept: list, inputs: dict, mix: dict, seed: int,
          control=None) -> dict:
    """{number: value} over the kept frames."""
    verts = inputs["verts_t"]
    dev = verts.device
    cfg = inputs["config"]
    w, h = cfg["width"], cfg["height"]
    base = {"mix": mix, "inputs": inputs, "seed": seed, "q": control,
            "faces": inputs["faces_t"],
            "rays": ref.primary_rays(inputs["camera"], w, h, dev)}
    if control is not None:
        base["rays_q"] = ref.primary_rays(inputs["camera"], w, h, dev,
                                          control)
    steps = [frames.step(name) for name in mix["steps"]]
    shares, maxima = {}, {}
    for fr in kept:
        ctx = dict(base, verts=verts, verts_q=verts,
                   idx=sample_index(w * h, int(mix["check_rays"]), seed,
                                    fr["index"], dev))
        for s in steps:
            if not hasattr(s, "check"):
                continue
            for name, v in s.check(ctx, fr).items():
                if s.NUMBERS[name] == "share":
                    a, b = shares.get(name, (0, 0))
                    shares[name] = (a + v[0], b + v[1])
                else:
                    maxima[name] = max(maxima.get(name, -math.inf), v)
    out = {k: a / max(b, 1) for k, (a, b) in shares.items()}
    out.update(maxima)
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number the mix limits is
    present, finite and at most its limit."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        rows.append((name, v, limit))
    return ok, rows
