"""path: integrators.path_bounces on the frame's primary hits, with a
fresh generator seeded from the run's seed and the frame's index and the
mix's max_bounces, sky and albedo: one diffuse path sample a pixel.

Its number, path_wrong_share: of the frame's sample of rays, the share of
pixels whose radiance disagrees with the reference's (reference_path.py)
by more than 1e-6. The reference bounces from its own closest hits
(ctx["primary"]) with the same uniform draws as the program takes, and
traces every wave against every triangle. Radiances are sky x albedo^k,
at least 0.1 apart at these parameters, so only a different hit or a
missing or extra term moves one."""

from __future__ import annotations

import torch

import frames
import judge
import reference_path

NUMBERS = {"path_wrong_share": "share"}


def path_seed(seed: int, index: int) -> int:
    """The path generator's seed of frame `index` (63 bits)."""
    return (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9
            + 0xD6E8FEB86659FD93) % (1 << 63)


def params(mix: dict) -> dict:
    p = mix["path"]
    return {"max_bounces": int(p["max_bounces"]), "sky": float(p["sky"]),
            "albedo": float(p["albedo"])}


def inputs(mix, seed, index):
    return {"path_seed": path_seed(seed, index)}


def prepare(drv):
    drv.state["path"] = drv.program("render.integrators").path_bounces


def traces(drv):
    """Each bounce wave counted as all n_rays. Rays that died in an
    earlier wave are still launched (at tmax 0) but skipped by the
    planner, so the count runs 5-31% a wave above the rays K2 reads on
    the open atrium: a roofline share from it reads high, and does not
    fall as paths retire."""
    return [(drv.n_rays, drv.n_tris)] * (params(drv.mix)["max_bounces"] - 1)


def run(drv, fr, st):
    gen = torch.Generator(device=drv.dev).manual_seed(fr["path_seed"])
    fr["path"] = drv.state["path"](drv.session, drv.rays, st["hits"], gen,
                                   **params(drv.mix))


def check(ctx, fr):
    p, q, idx = params(ctx["mix"]), ctx["q"], ctx["idx"]
    n = ctx["rays"]["org"].shape[0]
    # The program's draws: one torch.rand((2, n)) a wave, as AO's a sample.
    draws = [u[:, idx] for u in frames.step("ao").uniforms(
        fr["path_seed"], n, p["max_bounces"], idx.device)]
    want = reference_path.radiance(*ctx["primary"]["ref"],
                                   judge.frame_tris(ctx), draws, **p)
    if q is not None:
        got = reference_path.radiance(*ctx["primary"]["got"],
                                      judge.frame_tris(ctx, True), draws,
                                      q=q, **p)
    else:
        got = fr["path"][idx]
    return {"path_wrong_share": (int(((got - want).abs() > 1e-6).sum()),
                                 idx.numel())}
