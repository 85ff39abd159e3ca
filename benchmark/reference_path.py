"""The plain reference of diffuse path tracing: brute-force bounces in
PyTorch, from given first-wave hits.

A path's radiance is the constant sky's, scaled by the grey albedo once
for every surface it left before escaping; a path that is still on a
surface after `max_bounces` waves contributes nothing. Each bounce's
rays are the ambient-occlusion rays of reference.py with no reach
(`max_dist` inf): the same cosine-weighted directions about the
face-forward normal, the same spawn off the surface. Each wave is
reference.closest_hit against every triangle. It imports nothing but
reference.py and calls none of the program's code.

`q` as in reference.py: None for float32, or the control's rounding of
every intermediate result.
"""

from __future__ import annotations

import math

import torch

import reference as ref


def radiance(org, dir, tri_id, t, tris: dict, uniforms, max_bounces: int,
             sky: float, albedo: float, q=None) -> torch.Tensor:
    """f32[N]: the radiance of each ray's path. org, dir f32[N, 3] and
    tri_id i32[N] / t f32[N] are the first wave's rays and closest hits;
    uniforms, the draws of each wave (f32[2, N] each, at least
    max_bounces - 1 of them), in the order the waves take them."""
    n = org.shape[0]
    out = torch.zeros(n, dtype=torch.float32, device=org.device)
    throughput = torch.ones(n, dtype=torch.float32, device=org.device)
    live = torch.ones(n, dtype=torch.bool, device=org.device)
    for bounce in range(max_bounces):
        found = tri_id >= 0
        out = ref._r(q, out + torch.where(live & ~found,
                                          ref._r(q, throughput * sky), 0.0))
        live = live & found
        throughput = ref._r(q, throughput * albedo)
        if bounce == max_bounces - 1:
            break
        a = ref.ao_rays(org, dir, tri_id, t, tris, math.inf,
                        uniforms[bounce], q)
        org, dir = a["org"], a["dir"]
        tri_id, t = ref.closest_hit(org, dir, tris, q, a["tmin"], a["tmax"])
    return out
