#!/usr/bin/env python3
"""The control of the comparison that decides `correct`: the plain
reference computed in a lower precision than the configuration states
(TF32, and bfloat16 beside it), put in the program's place and judged as
the program's frames are (judge.py). It must come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--frames 2] [--device cuda]

For each seed it prints one JSON line with the numbers of each control
precision beside the mix's limits. It runs no program code: the frames
judged are the frames a run of that seed would keep by index (frame 3,
the first after the warm-up, and one more drawn from the seed).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import frames  # noqa: E402
import judge  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402


def control_numbers(root, manifest, cell_name: str, seed: int,
                    n_frames: int, device, precision: str = "tf32") -> dict:
    """The control's numbers on `n_frames` frames of the seed's run."""
    import torch

    found = run.discover(root, manifest, cell_name, False)
    config, traffic = found["config"], found["traffic"]
    inputs = run.make_inputs(root, config, seed)
    rng = random.Random(seed)
    first = int(traffic["warmup_frames"])
    idx = [first] + [first + 1 + rng.randrange(400)
                     for _ in range(n_frames - 1)]
    kept = [frames.frame_inputs(traffic, seed, i) for i in sorted(set(idx))]
    inputs["verts_t"] = torch.from_numpy(inputs["verts"]).to(device)
    inputs["faces_t"] = torch.from_numpy(inputs["faces"]).to(device)
    return judge.judge(kept, inputs, traffic, seed,
                       control=reference.QUANT[precision])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = HERE.parent
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    found = run.discover(root, manifest, args.workload, False)
    limits = found["traffic"]["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for precision in ("tf32", "bfloat16"):
            t0 = time.perf_counter()
            nums = control_numbers(root, manifest, args.workload, seed,
                                   args.frames, args.device, precision)
            ok, rows = judge.verdict(nums, limits)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "control": precision, "correct": ok,
                "seconds": time.perf_counter() - t0,
                "checks": {n: {"value": v, "limit": lim}
                           for n, v, lim in rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
