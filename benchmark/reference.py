"""The plain reference: brute-force ray tracing in PyTorch.

Everything the program derives from the benchmark's inputs is worked out
again here: the deformed triangles, the primary rays from the camera, the
closest hits, and the ambient-occlusion rays and their any-hit decisions.
It imports nothing of the program and calls none of its code.

Every function takes `q`, the arithmetic's precision: None for float32
as the configuration states, or a function that rounds each
intermediate result to a lower precision (`QUANT`), which makes the
control of the comparison.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MT_EPS = 1e-9            # |det| at or below it: the ray is parallel
AO_EPS_REL = 1e-3        # AO origins leave the surface by this x |p|
AO_EPS_ABS = 1e-4        # ... plus this
PAIRS_PER_BLOCK = 1 << 25   # ray-triangle pairs held at once


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest even), kept in f32."""
    b = x.contiguous().view(torch.int32)
    keep = b + 0x0FFF + ((b >> 13) & 1)
    return (keep & ~0x1FFF).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


QUANT = {"float32": None, "tf32": _tf32, "bfloat16": _bf16}


def _r(q, x):
    return x if q is None else q(x)


def _cross(q, a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (_r(q, _r(q, ay * bz) - _r(q, az * by)),
            _r(q, _r(q, az * bx) - _r(q, ax * bz)),
            _r(q, _r(q, ax * by) - _r(q, ay * bx)))


def _dot(q, a, b):
    return _r(q, _r(q, _r(q, a[0] * b[0]) + _r(q, a[1] * b[1]))
              + _r(q, a[2] * b[2]))


def deform(base: torch.Tensor, t: float, amplitude: float, freq: float,
           q=None) -> torch.Tensor:
    """The travelling sine wave in y of the dynamic mix at time t."""
    x, y, z = base.unbind(1)
    phase = _r(q, _r(q, x * freq) + _r(q, _r(q, z * 0.7) * freq))
    shift = float(np.float32(t) * np.float32(2.0) * np.float32(math.pi))
    dy = _r(q, amplitude * _r(q, torch.sin(_r(q, phase + shift))))
    return torch.stack([x, _r(q, y + dy), z], dim=1)


def triangles(verts: torch.Tensor, faces: torch.Tensor, q=None) -> dict:
    """v0 and the edges e1 = v1 - v0, e2 = v2 - v0 of each face, f32."""
    verts = _r(q, verts)
    f = faces.long()
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    return {"v0": v0, "e1": _r(q, v1 - v0), "e2": _r(q, v2 - v0)}


def block_pixels(width: int, height: int, device):
    """(x, y) of ray i when rays come in 32x32 blocks, block-major and
    Morton-ordered within a block."""
    i = torch.arange(width * height, dtype=torch.int64, device=device)
    blk, within = i // 1024, i % 1024
    x = torch.zeros_like(i)
    y = torch.zeros_like(i)
    for k in range(5):
        x |= ((within >> (2 * k)) & 1) << k
        y |= ((within >> (2 * k + 1)) & 1) << k
    per_row = width // 32
    return (blk % per_row) * 32 + x, (blk // per_row) * 32 + y


def primary_rays(camera: dict, width: int, height: int, device,
                 q=None) -> dict:
    """A pinhole camera's rays through pixel centres, in block order:
    {"org", "dir"} f32[N, 3], unit directions."""
    eye = np.asarray(camera["eye"], np.float32)
    fwd = np.asarray(camera["center"], np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(camera["up"], np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    tan_half = float(np.float32(np.tan(np.radians(camera["fov_deg"]) * 0.5)))
    aspect = float(np.float32(width / height))
    gx, gy = (c.to(torch.float32) for c in block_pixels(width, height,
                                                         device))
    sx = _r(q, _r(q, _r(q, 2.0 * _r(q, gx + 0.5)) / width - 1.0)
            * tan_half * aspect)
    sy = _r(q, _r(q, 1.0 - _r(q, 2.0 * _r(q, gy + 0.5)) / height)
            * tan_half)
    f32 = dict(dtype=torch.float32, device=device)
    d = (_r(q, sx[:, None] * torch.tensor(right, **f32))
         + _r(q, sy[:, None] * torch.tensor(up, **f32))
         + torch.tensor(fwd, **f32))
    d = _r(q, d / _r(q, torch.sqrt(_r(q, (d * d).sum(1, keepdim=True)))))
    org = torch.tensor(eye, **f32).expand(d.shape).contiguous()
    return {"org": org, "dir": d}


def _mt(q, o, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore of rays [R, 1] against triangles [1, T], two-sided:
    (hit bool[R, T], t f32[R, T])."""
    o, d, v0, e1, e2 = (x.unbind(-1) for x in (o, d, v0, e1, e2))
    p = _cross(q, d, e2)
    det = _dot(q, e1, p)
    ok = det.abs() > MT_EPS
    inv = torch.where(ok, _r(q, 1.0 / det), 0.0)
    s = tuple(_r(q, a - b) for a, b in zip(o, v0))
    u = _r(q, _dot(q, s, p) * inv)
    c = _cross(q, s, e1)
    v = _r(q, _dot(q, d, c) * inv)
    t = _r(q, _dot(q, e2, c) * inv)
    hit = (ok & (u >= 0) & (v >= 0) & (_r(q, u + v) <= 1) & (t > tmin)
           & (t < tmax))
    return hit, t


def _blocks(n_rays: int, n_tris: int):
    step = max(1, PAIRS_PER_BLOCK // max(n_tris, 1))
    for s in range(0, n_rays, step):
        yield slice(s, min(s + step, n_rays))


def closest_hit(org, dir, tris: dict, q=None, tmin=None, tmax=None):
    """Every ray against every triangle: (tri id i32[N], -1 for a miss;
    t f32[N], inf for a miss). Ties go to the smaller t, then the smaller
    id."""
    n = org.shape[0]
    dev = org.device
    tmin = torch.zeros(n, device=dev) if tmin is None else tmin
    tmax = torch.full((n,), math.inf, device=dev) if tmax is None else tmax
    tv = [tris[k][None] for k in ("v0", "e1", "e2")]
    ids, ts = [], []
    for sl in _blocks(n, tv[0].shape[1]):
        hit, t = _mt(q, org[sl, None], dir[sl, None], *tv, tmin[sl, None],
                     tmax[sl, None])
        t = torch.where(hit, t, math.inf)
        best = torch.argmin(t, dim=1)      # the first minimum: smaller id
        bt = t.gather(1, best[:, None])[:, 0]
        ids.append(torch.where(bt < math.inf, best.to(torch.int32), -1))
        ts.append(bt)
    return torch.cat(ids), torch.cat(ts)


def any_hit(org, dir, tmin, tmax, tris: dict, q=None) -> torch.Tensor:
    """bool[N]: some triangle blocks the ray within (tmin, tmax)."""
    tv = [tris[k][None] for k in ("v0", "e1", "e2")]
    return torch.cat([
        _mt(q, org[sl, None], dir[sl, None], *tv, tmin[sl, None],
            tmax[sl, None])[0].any(dim=1)
        for sl in _blocks(org.shape[0], tv[0].shape[1])])


def hit_gap(org, dir, tri_id, t, tris: dict) -> torch.Tensor:
    """For each ray that reports a hit: how far the report lies from a
    true hit of the triangle it names, recomputed in f64: the reported
    point's distance from the triangle's plane over the distance the ray
    travelled to it, or how far the ray's crossing of that plane lies
    outside the triangle in barycentric units, whichever is larger. The
    plane distance, unlike the gap of t, stays small for a ray that
    grazes its triangle. f64[hits]."""
    sel = tri_id >= 0
    k = tri_id[sel].long()
    o, d = org[sel].double(), dir[sel].double()
    tp = t[sel].double()
    v0, e1, e2 = (tris[n][k].double() for n in ("v0", "e1", "e2"))
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    plane = ((o + tp[:, None] * d - v0) * nrm).sum(1).abs() / tp.abs()
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum(1)
    s = o - v0
    u = (s * p).sum(1) / det
    v = (d * torch.linalg.cross(s, e1)).sum(1) / det
    outside = torch.stack([-u, -v, u + v - 1.0,
                           torch.zeros_like(u)]).amax(0)
    return torch.maximum(plane, outside).nan_to_num(nan=math.inf)


def ao_rays(org, dir, tri_id, t, tris: dict, max_dist: float,
            uniforms: torch.Tensor, q=None) -> dict:
    """One ambient-occlusion sample's rays from each ray's closest hit:
    cosine-weighted about the face-forward unit normal (the orthonormal
    basis of Duff et al. 2017), leaving the surface by AO_EPS_REL x |p| +
    AO_EPS_ABS, tmax = max_dist; rays that missed get tmax = 0.
    uniforms: f32[2, N], the sample's draws. {"org", "dir", "tmin",
    "tmax", "found"}."""
    found = tri_id >= 0
    k = tri_id.clamp(min=0).long()
    e1, e2 = tris["e1"][k], tris["e2"][k]
    n = torch.stack(_cross(q, e1.unbind(1), e2.unbind(1)), dim=1)
    n = _r(q, n / _r(q, torch.sqrt(_r(q, (n * n).sum(1, keepdim=True)))
                     + 1e-20))
    n = torch.where(_r(q, (n * dir).sum(1, keepdim=True)) > 0, -n, n)
    p = _r(q, org + _r(q, torch.where(found, t, 0.0)[:, None] * dir))
    u1, u2 = uniforms[0], uniforms[1]
    r = _r(q, torch.sqrt(u1))
    phi = _r(q, 2.0 * math.pi * u2)
    x, y = _r(q, r * _r(q, torch.cos(phi))), _r(q, r * _r(q, torch.sin(phi)))
    z = _r(q, torch.sqrt(torch.clamp(_r(q, 1.0 - u1), min=0.0)))
    nx, ny, nz = n.unbind(1)
    sgn = torch.where(nz >= 0.0, 1.0, -1.0)
    a = _r(q, -1.0 / _r(q, sgn + nz))
    b = _r(q, _r(q, nx * ny) * a)
    tan = torch.stack([_r(q, 1.0 + _r(q, sgn * _r(q, _r(q, nx * nx) * a))),
                       _r(q, sgn * b), -sgn * nx], dim=1)
    bit = torch.stack([b, _r(q, sgn + _r(q, _r(q, ny * ny) * a)), -ny],
                      dim=1)
    d = _r(q, _r(q, x[:, None] * tan) + _r(q, y[:, None] * bit)
           + _r(q, z[:, None] * n))
    norm_p = _r(q, torch.sqrt(_r(q, (p * p).sum(1, keepdim=True))))
    o2 = _r(q, p + _r(q, n * _r(q, AO_EPS_REL * norm_p + AO_EPS_ABS)))
    tmax = torch.where(found, max_dist, 0.0)
    return {"org": o2, "dir": d, "tmin": torch.zeros_like(tmax),
            "tmax": tmax, "found": found}
