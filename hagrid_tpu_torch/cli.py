"""Command-line interface (port of hagrid_tpu/cli.py), with the
reference's flags; `--device` (default: the card) takes the place of
`--platform`.

  python -m hagrid_tpu_torch.cli render --scene sponza --size 1024x1024 \
      --out out.png
  python -m hagrid_tpu_torch.cli bench --scene sponza --iters 5
  python -m hagrid_tpu_torch.cli stats --scene cornell --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _common(ap: argparse.ArgumentParser):
    ap.add_argument("--scene", default="cornell",
                    help="scene name (cornell|sponza|san_miguel) or .obj path")
    ap.add_argument("--size", default="512x512", help="WxH")
    ap.add_argument("--eye", type=float, nargs=3, default=None)
    ap.add_argument("--center", type=float, nargs=3, default=None)
    ap.add_argument("--up", type=float, nargs=3, default=(0.0, 1.0, 0.0))
    ap.add_argument("--fov", type=float, default=None)
    ap.add_argument("--top-density", type=float, default=0.12,
                    help="top-level grid density (lambda1, ref default 0.12)")
    ap.add_argument("--snd-density", type=float, default=2.4,
                    help="second-level density (lambda2, ref default 2.4)")
    ap.add_argument("--alpha", type=float, default=0.995,
                    help="SAH merge acceptance factor")
    ap.add_argument("--expansion-passes", type=int, default=3)
    ap.add_argument("--merge-passes", type=int, default=1)
    ap.add_argument("--levels", type=int, default=3, choices=range(0, 7),
                    help="max per-cell subdivision log2 (0..6)")
    ap.add_argument("--sanitize", action="store_true",
                    help="replay the sweep planning with checks (NaN, "
                         "index, divisor) before tracing (packet only)")
    ap.add_argument("--structure",
                    choices=("packet", "irregular", "uniform"),
                    default="packet")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                         "plain PyTorch versions)")


def _size(args):
    return tuple(int(x) for x in args.size.split("x"))


def _setup(args):
    from hagrid_tpu_torch import scenes
    from hagrid_tpu_torch.core.camera import Camera
    from hagrid_tpu_torch.core.types import Triangles
    from hagrid_tpu_torch.device import resolve
    from hagrid_tpu_torch.render.session import RenderSession
    from hagrid_tpu_torch.utils.config import BuildParams

    dev = resolve(args.device)
    v, f, cam = scenes.load_scene(args.scene)
    if args.eye is not None or args.center is not None or args.fov:
        cam = Camera(eye=tuple(args.eye or cam.eye),
                     center=tuple(args.center or cam.center),
                     up=tuple(args.up), fov_deg=args.fov or cam.fov_deg)
    tris = Triangles.from_mesh(v, f, device=dev)
    params = BuildParams(top_density=args.top_density,
                         snd_density=args.snd_density, alpha=args.alpha,
                         expansion_passes=args.expansion_passes,
                         merge_passes=args.merge_passes, levels=args.levels)
    session = RenderSession.create(tris, params,
                                   structure=args.structure, verts=v)
    return session, cam, tris


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_render(args):
    from hagrid_tpu_torch.core.camera import block_index, primary_rays
    from hagrid_tpu_torch.io.image import shade_eyelight, write_png, write_ppm
    session, cam, tris = _setup(args)
    dev = tris.device
    w, h = _size(args)
    rays = primary_rays(cam, w, h, order="block", device=dev)
    if args.sanitize and session.structure == "packet":
        from hagrid_tpu_torch.utils.sanitize import check_sweep_plan
        stats = check_sweep_plan(session.grid, rays)
        print(f"sanitizer: plan clean ({stats})")
    _sync(dev)
    t0 = time.perf_counter()
    hits = session.trace(rays)
    _sync(dev)
    dt = time.perf_counter() - t0
    tri_id = hits.tri_id.cpu().numpy()
    t_arr = hits.t.cpu().numpy()
    dirs = rays.dir.cpu().numpy()
    if w % 32 == 0 and h % 32 == 0:
        # Undo the packet-friendly block ordering for the image.
        idx = block_index(w, h)
        inv = np.empty_like(idx)
        inv[idx] = np.arange(idx.size)
        tri_id, t_arr, dirs = tri_id[inv], t_arr[inv], dirs[inv]
    img = shade_eyelight(tri_id, t_arr, tris.n.cpu().numpy(), dirs, w, h)
    if args.out.endswith(".ppm"):
        write_ppm(args.out, img)
    else:
        write_png(args.out, img)
    frac = float(np.mean(tri_id >= 0))
    print(f"rendered {args.out}: {w}x{h} in {dt * 1e3:.1f} ms "
          f"({w * h / dt / 1e6:.2f} Mrays/s incl. calibration), "
          f"hit fraction {frac:.3f}")
    _warn_overflow(session)


def _warn_overflow(session):
    """Surface the sweep's deferred budget overflow flag (surplus blocks
    are dropped, so geometry can be missing from the image); one read of
    the device."""
    if session.trace_overflow is not None and bool(session.trace_overflow):
        print("WARNING: sweep block budget overflowed during tracing; "
              "some far panels were dropped (geometry may be missing)",
              file=sys.stderr)


def cmd_bench(args):
    from hagrid_tpu_torch.core.camera import primary_rays
    from hagrid_tpu_torch.device import device_name
    from hagrid_tpu_torch.utils.profiling import timed
    session, cam, tris = _setup(args)
    dev = tris.device
    w, h = _size(args)
    rays = primary_rays(cam, w, h, order="block", device=dev)
    # Medians over synced calls after one untimed call: ms between CUDA
    # events on the card, by the host clock elsewhere.
    build_ms = timed(session.rebuild, tris, iters=args.iters, device=dev) * 1e3
    trace_ms = timed(session.trace, rays, iters=args.iters, device=dev) * 1e3
    print(json.dumps({
        "scene": args.scene, "tris": tris.count, "rays": w * h,
        "build_ms": round(build_ms, 2),
        "mrays_per_s": round(w * h / trace_ms / 1e3, 2),
        "structure": args.structure,
        "grid": session.describe(),
        "device": device_name(dev),
    }))
    _warn_overflow(session)


def cmd_stats(args):
    session, _, _ = _setup(args)
    print(session.describe())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hagrid_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to an image")
    _common(r)
    r.add_argument("--out", default="out.png")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="build + trace benchmark")
    _common(b)
    b.add_argument("--iters", type=int, default=5)
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("stats", help="print grid statistics")
    _common(s)
    s.set_defaults(fn=cmd_stats)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
