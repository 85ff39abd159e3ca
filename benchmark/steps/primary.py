"""primary: RenderSession.trace of the camera's rays in block order,
coherent=True: the frame's closest hits.

Its numbers:
- primary_wrong_share: of the frame's sample of rays, the share whose
  reported closest hit disagrees with the brute-force one: hit against
  miss, or t apart by more than T_REL of the reference's t (a different
  triangle at the same t is a tie);
- primary_gap_max: over every hit the frame reports, the widest gap
  between the report and a true hit of the triangle it names, recomputed
  in f64 (reference.hit_gap). In the control, over the sample's hits.
It leaves both sides' hits on the sample in the context (ctx["primary"])
for the steps that spawn rays from them."""

from __future__ import annotations

import judge
import reference as ref

T_REL = 1e-4
NUMBERS = {"primary_wrong_share": "share", "primary_gap_max": "max"}


def traces(drv):
    return [(drv.n_rays, drv.n_tris)]


def run(drv, fr, st):
    hits = drv.session.trace(drv.rays, coherent=True)
    st["hits"] = hits
    fr["tri_id"], fr["t"] = hits.tri_id, hits.t


def check(ctx, fr):
    tris = judge.frame_tris(ctx)
    idx, rays = ctx["idx"], ctx["rays"]
    o, d = rays["org"][idx], rays["dir"][idx]
    rid, rt = ref.closest_hit(o, d, tris)
    if ctx["q"] is not None:
        oc, dc = ctx["rays_q"]["org"][idx], ctx["rays_q"]["dir"][idx]
        pid, pt = ref.closest_hit(oc, dc, judge.frame_tris(ctx, True),
                                  ctx["q"])
        gaps = ref.hit_gap(o, d, pid, pt, tris)
    else:
        oc, dc = o, d
        pid, pt = fr["tri_id"][idx].int(), fr["t"][idx]
        gaps = ref.hit_gap(rays["org"], rays["dir"], fr["tri_id"], fr["t"],
                           tris)
    ctx["primary"] = {"ref": (o, d, rid, rt), "got": (oc, dc, pid, pt)}
    both = (pid >= 0) & (rid >= 0)
    wrong = ((pid >= 0) != (rid >= 0)) | (
        both & ((pt - rt).abs() > T_REL * rt.abs()))
    return {"primary_wrong_share": (int(wrong.sum()), idx.numel()),
            "primary_gap_max": float(gaps.max()) if gaps.numel() else 0.0}
