"""deform: AnimatedScene.frame(t) with the benchmark's own deform
(frozen.wave_deform at the mix's amplitude and frequency), at the
frame's time t = phase + index * dt, the phase drawn from the seed.

Its check moves the frame's vertices in the comparison's context, as the
reference computes them, for the steps after it to judge against."""

from __future__ import annotations

import functools

import numpy as np

import frozen
import reference as ref

NUMBERS = {}


def frame_time(mix: dict, seed: int, index: int) -> float:
    """The deform's time at frame `index`: a phase drawn from the seed,
    then the mix's step dt a frame."""
    phase = np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), 1])).uniform()
    return float(phase) + index * float(mix["deform"]["dt"])


def inputs(mix, seed, index):
    return {"time": frame_time(mix, seed, index)}


def prepare(drv):
    """The animated scene; its first frame is the cold build's, and a
    margin keeps the moving geometry inside the bounds that warm packet
    rebuilds keep."""
    d = drv.mix["deform"]
    anim = drv.program("render.dynamic").AnimatedScene(
        drv.verts, drv.faces, device=drv.dev,
        deform=functools.partial(frozen.wave_deform,
                                 amplitude=d["amplitude"], freq=d["freq"]))
    drv.state["deform"] = anim
    drv.margin = d["motion_margin"] / max(float(drv.extent.min()), 1e-6)
    drv.tris = anim.frame(frame_time(drv.mix, drv.seed, 0))


def run(drv, fr, st):
    st["tris"] = drv.state["deform"].frame(fr["time"])


def check(ctx, fr):
    d = ctx["mix"]["deform"]
    moved = functools.partial(ref.deform, ctx["verts"], fr["time"],
                              d["amplitude"], d["freq"])
    ctx["verts"] = moved()
    if ctx["q"] is not None:
        ctx["verts_q"] = moved(ctx["q"])
    return {}
