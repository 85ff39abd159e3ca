"""A configuration, a mix with a step of a new kind, and a metric
dropped into a copy of the benchmark are found by name, with no edit to
a file that is there."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT, SEED

# A step of a kind the benchmark does not have: hard shadows toward a
# point light from the frame's primary hits, judged against brute force
# from the reference's own hits.
SHADOW_STEP = '''
"""shadow: integrators.shadow toward a point light at the mix's
fraction of the scene's bounds; shadow_wrong_share: the sample's lit
or unlit pixels against brute force."""

import torch

import judge
import reference as ref

NUMBERS = {"shadow_wrong_share": "share"}


def light(mix, verts):
    lo, hi = verts.min(0), verts.max(0)
    return [float(a + f * (b - a))
            for a, b, f in zip(lo, hi, mix["shadow"]["light_frac"])]


def prepare(drv):
    drv.state["shadow"] = (drv.program("render.integrators").shadow,
                           light(drv.mix, drv.verts))


def traces(drv):
    return [(drv.n_rays, drv.n_tris)]


def run(drv, fr, st):
    shadow, lp = drv.state["shadow"]
    fr["lit"] = shadow(drv.session, drv.rays, st["hits"], lp) > 0


def check(ctx, fr):
    o, d, tri, t = ctx["primary"]["ref"]
    tris = judge.frame_tris(ctx)
    found = tri >= 0
    k = tri.clamp(min=0).long()
    n = torch.linalg.cross(tris["e1"][k], tris["e2"][k])
    n = n / (n.norm(dim=1, keepdim=True) + 1e-20)
    n = torch.where((n * d).sum(1, keepdim=True) > 0, -n, n)
    p = o + torch.where(found, t, 0.0)[:, None] * d
    lp = torch.tensor(light(ctx["mix"], ctx["inputs"]["verts"]))
    to_l = lp.to(p.device) - p
    dist = to_l.norm(dim=1)
    dl = to_l / (dist[:, None] + 1e-20)
    live = found & ((n * dl).sum(1) > 0)
    tmax = torch.where(live, dist * (1.0 - 2e-3), 0.0)
    org = p + n * (1e-3 * p.norm(dim=1, keepdim=True) + 1e-4)
    want = live & ~ref.any_hit(org, dl, torch.zeros_like(tmax), tmax, tris)
    got = fr["lit"][ctx["idx"]]
    return {"shadow_wrong_share": (int((got != want).sum()), got.numel())}
'''


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_found(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "tests" / "cornell-irregular.json").read_text())
    cfg["name"] = "cornell-new"
    (b / "configs" / "cornell-new.json").write_text(json.dumps(cfg))
    (b / "steps" / "shadow.py").write_text(SHADOW_STEP)
    mix = {"why": "test", "steps": ["primary", "shadow"],
           "shadow": {"light_frac": [0.5, 0.9, 0.5]},
           "warmup_frames": 1, "check_frames": 2, "check_rays": 16384,
           "limits": {"primary_wrong_share": 0.002,
                      "primary_gap_max": 0.1,
                      "shadow_wrong_share": 0.002}}
    (b / "traffic" / "shadow.json").write_text(json.dumps(mix))
    (b / "metrics" / "frames_done.py").write_text(
        "def read(rec):\n    return len(rec['frames_ms'])\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "cornell-new", "source": "test",
                         "file": "benchmark/configs/cornell-new.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "cornell-new.shadow",
                           "config": "cornell-new", "traffic": "shadow",
                           "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "frames_done", "unit": "frames",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["cornell-new.shadow"]})
    code = ("import json, sys, time, pathlib; sys.path.insert(0, "
            "'benchmark'); import run; root = pathlib.Path('.'); "
            "m = json.loads(sys.argv[1]); print(json.dumps(run.run_cell("
            f"root, m, 'cornell-new.shadow', {SEED}, 0.3, False, 'cpu', "
            "time.perf_counter())))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code, json.dumps(m)],
                         capture_output=True, text=True, cwd=str(tmp_path),
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(mix["limits"])
    assert line["checks"]["shadow_wrong_share"]["value"] == 0.0
    assert line["metrics"]["frames_done"]["value"] == line["attempted"]
    assert set(line["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s",
                                    "frames_done"}
    after = _digest(tmp_path)
    assert all(after[p] == h for p, h in before.items() if p in after)
    assert set(before) <= set(after)
