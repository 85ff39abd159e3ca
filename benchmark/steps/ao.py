"""ao: integrators.ambient_occlusion on the frame's primary hits, with a
fresh generator seeded from the run's seed and the frame's index, the
mix's sample count, and max_dist = the mix's fraction of the scene's
largest extent.

Its number, ao_wrong_share: of the frame's sample of rays, the share of
pixels whose AO estimate disagrees with the reference's. Each sample's
ray is spawned from the reference's own closest hit (ctx["primary"])
with the same uniform draws as the program takes, and traced against
every triangle."""

from __future__ import annotations

import torch

import judge
import reference as ref

NUMBERS = {"ao_wrong_share": "share"}


def ao_seed(seed: int, index: int) -> int:
    """The AO generator's seed of frame `index` (63 bits)."""
    return (seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9
            + 0x94D049BB133111EB) % (1 << 63)


def max_dist(mix: dict, verts) -> float:
    """The occluders' reach: the mix's fraction of the largest extent of
    the scene's vertices (a host array)."""
    return (float(mix["ao"]["max_dist_frac"])
            * float((verts.max(0) - verts.min(0)).max()))


def samples(mix: dict) -> int:
    return int(mix["ao"]["samples"])


def inputs(mix, seed, index):
    return {"ao_seed": ao_seed(seed, index)}


def prepare(drv):
    drv.state["ao"] = (drv.program("render.integrators").ambient_occlusion,
                       max_dist(drv.mix, drv.verts))


def traces(drv):
    return [(drv.n_rays, drv.n_tris)] * samples(drv.mix)


def run(drv, fr, st):
    ambient_occlusion, reach = drv.state["ao"]
    gen = torch.Generator(device=drv.dev).manual_seed(fr["ao_seed"])
    fr["ao"] = ambient_occlusion(drv.session, drv.rays, st["hits"], gen,
                                 n_samples=samples(drv.mix), max_dist=reach)


def uniforms(seed: int, n: int, count: int, device) -> list:
    """The samples' draws as the program takes them from the frame's
    generator: one torch.rand of shape (2, n) on the device a sample."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand((2, n), generator=gen, device=device)
            for _ in range(count)]


def _open(o, d, tri_id, t, tris, reach, uni, q=None):
    a = ref.ao_rays(o, d, tri_id, t, tris, reach, uni, q)
    return (a["found"] & ~ref.any_hit(a["org"], a["dir"], a["tmin"],
                                      a["tmax"], tris, q)).float()


def check(ctx, fr):
    mix, q, idx = ctx["mix"], ctx["q"], ctx["idx"]
    reach = max_dist(mix, ctx["inputs"]["verts"])
    tris = judge.frame_tris(ctx)
    n = ctx["rays"]["org"].shape[0]
    draws = [u[:, idx] for u in uniforms(fr["ao_seed"], n, samples(mix),
                                         idx.device)]
    want = sum(_open(*ctx["primary"]["ref"], tris, reach, u)
               for u in draws) / len(draws)
    if q is not None:
        tris_q = judge.frame_tris(ctx, True)
        got = sum(_open(*ctx["primary"]["got"], tris_q, reach, u, q)
                  for u in draws) / len(draws)
    else:
        got = fr["ao"][idx]
    return {"ao_wrong_share": (int(((got - want).abs() > 1e-6).sum()),
                               idx.numel())}
