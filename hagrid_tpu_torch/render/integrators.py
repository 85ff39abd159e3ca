"""Integrators: ambient occlusion, shadows, path tracing (port of
hagrid_tpu/render/integrators.py).

Secondary waves are sorted origin-major (10-bit origin Morton code)
before the sweep tracer, which then bins them by (axis, sign) and keeps
the sorted order within each group: the per-tile origin spread is what
widens incoherent frusta (the reference measured a Sponza AO wave's block
demand 173.6k in caller order, 103.7k origin-sorted). Random numbers come
from a `torch.Generator`, never from a global state.
"""

from __future__ import annotations

import torch

from ..core.camera import block_pixels, primary_rays
from ..core.types import Rays
from ..ops import sortrays
from ..utils import profiling
from .sampling import cosine_hemisphere, hit_points_normals

# Self-intersection offsets, scaled by the hit point's distance from the
# origin to stay robust across scene scales (the reference's ray epsilon).
EPS_REL = 1e-3
EPS_ABS = 1e-4


def _norm(x):
    return torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def _spawn(p, n, d, t_near, t_far):
    org = p + n * (EPS_REL * _norm(p) + EPS_ABS)
    return Rays(org=org, dir=d, tmin=torch.full_like(d[:, 0], t_near),
                tmax=t_far)


def trace_sorted(session, rays: Rays, any_hit: bool = False,
                 sort: str | bool = "origin", cal_key=None):
    """Incoherent-wave entry point: a coherence sort, the trace, and the
    scatter back to the caller's order. sort="origin" (the default): the
    10-bit origin-major Morton sort; any other true value: the 7-bit
    direction-octant-major sort (measured worse on camera-derived waves;
    for waves with no origin locality); a false value: the caller's order,
    no sort and no scatter."""
    if not sort:
        return session.trace(rays, any_hit=any_hit, cal_key=cal_key)
    grid = session.grid
    om = sort == "origin"
    with profiling.span("sort"):
        sorted_rays, perm = sortrays.sort_rays(
            rays, grid.bbox_lo, grid.bbox_hi, bits=10 if om else 7,
            origin_major=om)
    hits = session.trace(sorted_rays, any_hit=any_hit, cal_key=cal_key)
    with profiling.span("unsort"):
        return sortrays.unsort(hits, perm)


def ao_rays(p, n, found, max_dist: float, generator: torch.Generator):
    """One AO sample's wave: cosine-weighted directions about the normals,
    tmax = max_dist; misses get dead rays (tmax = 0)."""
    d = cosine_hemisphere(n, generator)
    tmax = torch.where(found, max_dist, 0.0)
    return _spawn(p, n, d, 0.0, tmax)


def default_ao_distance(session) -> float:
    """0.1 x the largest extent of the grid's bounds: from the session's
    host copy where it has one (RenderSession.host_bounds), else one
    device read."""
    bounds = session.host_bounds()
    if bounds is None:
        grid = session.grid
        return float((grid.bbox_hi - grid.bbox_lo).max()) * 0.1
    lo, hi = bounds
    return float((hi - lo).max()) * 0.1


def ambient_occlusion(session, rays: Rays, hits, generator: torch.Generator,
                      n_samples: int = 4, max_dist: float | None = None):
    """AO estimate in [0, 1] per ray (1 = fully open), occluders within
    max_dist (None: default_ao_distance, 0.1 x the scene's largest
    extent). Misses get 0. Span "ao" with tracing on
    (utils/profiling.py)."""
    with profiling.span("ao"):
        p, n, found = hit_points_normals(rays, hits, session.grid.tris.n)
        if max_dist is None:
            max_dist = default_ao_distance(session)
        acc = torch.zeros((rays.count,), dtype=torch.float32,
                          device=p.device)
        for _ in range(n_samples):
            sec = ao_rays(p, n, found, max_dist, generator)
            # One calibration key for all samples: they are draws of one
            # wave shape, so budgets transfer; a sample that outgrows them
            # sets its overflow flag and poll_overflow grows the shared
            # budget.
            occ = trace_sorted(session, sec, any_hit=True,
                               cal_key="ao").tri_id >= 0
            acc = acc + torch.where(found & ~occ, 1.0, 0.0)
        return acc / n_samples


def shadow_rays(p, n, found, light_pos):
    """The shadow wave toward a point light: (rays, cos) with tmax just
    short of the light; points facing away and misses get dead rays."""
    lp = torch.as_tensor(light_pos, dtype=torch.float32, device=p.device)
    to_l = lp[None, :] - p
    dist = _norm(to_l)[:, 0]
    d = to_l / (dist[:, None] + 1e-20)
    cos = (n * d).sum(dim=-1).clamp(min=0.0)
    tmax = torch.where(found & (cos > 0), dist * (1.0 - 2.0 * EPS_REL), 0.0)
    return _spawn(p, n, d, 0.0, tmax), cos


def shadow(session, rays: Rays, hits, light_pos):
    """Hard shadow visibility toward a point light (cosine-weighted).
    Misses get 0."""
    p, n, found = hit_points_normals(rays, hits, session.grid.tris.n)
    sec, cos = shadow_rays(p, n, found, light_pos)
    blocked = trace_sorted(session, sec, any_hit=True,
                           cal_key="shadow").tri_id >= 0
    return torch.where(found & ~blocked, cos, 0.0)


def _to_scanline(flat, width: int, height: int):
    """Undo primary_rays' block ordering (no-op when it fell back); the
    pixel map is made on flat's device."""
    if width % 32 or height % 32:
        return flat
    gx, gy = block_pixels(width, height, flat.device)
    out = torch.zeros_like(flat)
    out[(gy * width + gx).long()] = flat
    return out


def render_ao(session, cam, width: int, height: int, seed: int = 0,
              n_samples: int = 4):
    """Primary rays plus AO (BASELINE config #2's AO half; like the
    reference, no shadow term). Returns (image f32[H, W, 3], primary
    hits in block order)."""
    dev = session.grid.bbox_lo.device
    rays = primary_rays(cam, width, height, order="block", device=dev)
    hits = session.trace(rays, coherent=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ao = ambient_occlusion(session, rays, hits, gen, n_samples=n_samples)
    img = _to_scanline(ao, width, height)[:, None].expand(-1, 3)
    return img.reshape(height, width, 3), hits


def _jitter(n: int, generator: torch.Generator, device):
    """A frame's pixel jitter, f32[n, 2] uniform in [0, 1) (kept apart so
    that tests can feed the reference's draws)."""
    return torch.rand((n, 2), generator=generator, device=device)


def path_bounces(session, rays: Rays, hits, generator: torch.Generator,
                 max_bounces: int = 4, sky=1.0, albedo: float = 0.7):
    """The diffuse bounces of one path sample from its first wave's hits:
    the radiance f32[n] of each of the n rays, in the caller's order.
    Rays that missed see the constant sky `sky` (a float, or a tensor
    that broadcasts to the n rays); each hit spawns a cosine-weighted
    ray, and `max_bounces - 1` incoherent waves follow through
    trace_sorted (one calibration key, "path", for all of them: later
    waves hold fewer live rays, and one that outgrows the budget sets its
    overflow flag, which poll_overflow reads and grows). Dead
    rays get tmax = 0 and land in the binning's dead group, which the
    planner skips; rays still alive after the last wave contribute
    nothing. Each wave, the last included, takes one cosine_hemisphere
    draw of all n rays from `generator`.

    With tracing on (utils/profiling.py): span "path" around the call,
    span "path.spawn" around each wave's hit points, normals, draw and
    spawn, and counter "path.waves" for each incoherent wave traced."""
    with profiling.span("path"):
        n = rays.count
        dev = rays.org.device
        tri_n = session.grid.tris.n
        radiance = torch.zeros((n,), dtype=torch.float32, device=dev)
        throughput = torch.ones((n,), dtype=torch.float32, device=dev)
        live = torch.ones((n,), dtype=torch.bool, device=dev)
        for bounce in range(max_bounces):
            if bounce:
                profiling.count("path.waves")
                hits = trace_sorted(session, rays, cal_key="path")
            found = hits.tri_id >= 0
            radiance = radiance + torch.where(live & ~found,
                                              throughput * sky, 0.0)
            live = live & found
            throughput = throughput * albedo
            with profiling.span("path.spawn"):
                p, nrm, _ = hit_points_normals(rays, hits, tri_n)
                d = cosine_hemisphere(nrm, generator)
                tmax = torch.where(live, float("inf"), 0.0)
                rays = _spawn(p, nrm, d, 0.0, tmax)
        return radiance


def path_trace(session, cam, width: int, height: int, seed: int = 0,
               spp: int = 1, max_bounces: int = 4, sky=1.0,
               albedo: float = 0.7):
    """Diffuse (Lambertian) path tracer with bounce compaction (BASELINE
    config #3): constant sky light `sky` (a float, or a tensor that
    broadcasts to the n = width x height pixels in block order on the
    session's device), grey albedo `albedo`. Each sample draws its pixel
    jitter, traces the jittered primaries (coherent) and runs
    path_bounces from their hits with the same generator."""
    dev = session.grid.bbox_lo.device
    n = width * height
    radiance = torch.zeros((n,), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(spp):
        jitter = _jitter(n, gen, dev)
        rays = primary_rays(cam, width, height, jitter=jitter,
                            order="block", device=dev)
        hits = session.trace(rays, coherent=True)
        radiance = radiance + path_bounces(session, rays, hits, gen,
                                           max_bounces=max_bounces, sky=sky,
                                           albedo=albedo)
    img = _to_scanline(radiance / spp, width, height)[:, None].expand(-1, 3)
    return img.reshape(height, width, 3)
