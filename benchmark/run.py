#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port (hagrid_tpu_torch): one run of
one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A run sets the cell up (the scene from the seed, the session's cold build,
warm-up frames that calibrate and capture), then renders frames in a
closed loop for --seconds: each frame starts when the last one's outputs
are on the card. Then it compares frames kept from the window with the
plain reference (judge.py) and prints one JSON line on stdout:
`correct`, `attempted` and `failed` frames, `metrics`, `device`, with
--trace 1 `breakdown`, and last `checks`, each number compared beside
its limit; the same numbers are the last lines on stderr.

--trace 0 reports the cell's end-to-end metrics; --trace 1 its per-layer
metrics, from CUDA events around each step of every frame of the window
and from torch.profiler over short stretches of frames after it: one
that profiles the device alone (busy time, kernel times), one with the
host's ranges `frame.<step>` (the idle gaps' labels only).

Everything of a cell is found by name: the cell's configuration file
(BENCHMARK.json's `configs[].file`), its traffic mix
(traffic/<traffic>.json, read by frames.py), each step the mix lists
(steps/<step>.py: what it drives and how it is judged) and each metric
(metrics/<name>.py, whose read(record) returns the value or None).

Exit codes: 0 with a result; 1 a failure during the run; 2 no CUDA card,
or fewer than the cell asks for; 3 the program is not there; 4 JAX, flax
or the JAX package loaded. No result line but with 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(HERE), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0 if _p == str(HERE) else len(sys.path), _p)

import devtrace  # noqa: E402
import guard  # noqa: E402

PROFILED_FRAMES = 4     # frames under torch.profiler, a stretch
PROFILE_TRIES = 3       # stretches tried for one the profiler saw whole


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def discover(root: pathlib.Path, manifest: dict, cell_name: str,
             trace: bool) -> dict:
    """The cell, its configuration, its mix and the reader of each metric
    it reports, found by the names in the manifest."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r}; the manifest has "
                       f"{sorted(cells)}")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    e2e = [m for m in manifest["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    moved = {m["name"] for m in e2e}
    if trace:
        wanted = [m for m in manifest["per_layer"]
                  if (cell_name in m["workloads"] if "workloads" in m
                      else m["moves"] in moved)]
    else:
        wanted = e2e
    metrics = {m["name"]: (m, load_module(
        root / "benchmark" / "metrics" / f"{m['name']}.py",
        f"bench_metric_{m['name'].replace('.', '_').replace('-', '_')}"))
        for m in wanted}
    return {"cell": cell, "config": config, "traffic": traffic,
            "metrics": metrics}


def make_inputs(root: pathlib.Path, config: dict, seed: int) -> dict:
    """The scene and the camera from the seed (the configuration's scene
    module)."""
    sc = config["scene"]
    scene = load_module(root / sc["module"], "bench_scene").make(sc, seed)
    return {"verts": scene["verts"], "faces": scene["faces"],
            "camera": scene["camera"], "config": config}


class Keeper:
    """The frames the check compares: the window's slowest frame and a
    uniform sample of its frames (a reservoir), drawn from the seed."""

    def __init__(self, seed: int, n: int):
        self.rng = random.Random(seed)
        self.size = max(n - 1, 0)
        self.seen = 0
        self.sample = []
        self.slowest = None

    def offer(self, out: dict, seconds: float):
        if self.slowest is None or seconds > self.slowest[0]:
            self.slowest = (seconds, out)
        self.seen += 1
        if len(self.sample) < self.size:
            self.sample.append(out)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.sample[j] = out

    def frames(self) -> list:
        kept = {f["index"]: f for f in self.sample}
        if self.slowest is not None:
            kept[self.slowest[1]["index"]] = self.slowest[1]
        return [kept[i] for i in sorted(kept)]


class Spans:
    """The time of each step of each frame: CUDA events on the card (the
    host clock on the CPU)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.card = torch.device(device).type == "cuda"
        self.marks = {}

    @contextlib.contextmanager
    def span(self, step: str):
        if self.card:
            e0 = self.torch.cuda.Event(enable_timing=True)
            e1 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
            yield
            e1.record()
            self.marks.setdefault(step, []).append((e0, e1))
        else:
            t0 = time.perf_counter()
            yield
            self.marks.setdefault(step, []).append((t0, time.perf_counter()))

    def read(self) -> dict:
        """{step: [ms of each frame]}."""
        if self.card:
            self.torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self.marks.items()}
        return {k: [(b - a) * 1e3 for a, b in v]
                for k, v in self.marks.items()}


def _ranges(span: str):
    import torch
    return torch.profiler.record_function("frame." + span)


def _stretch(driver, index: int, host: bool) -> tuple:
    """PROFILED_FRAMES frames under torch.profiler: the device's activity
    alone, or with `host` the host's too and the benchmark's ranges
    around each frame and step. (trace, launches in the stretch, its
    length in seconds between CUDA events, next frame index)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    before = driver.launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=acts) as prof:
        e0.record()
        for _ in range(PROFILED_FRAMES):
            if host:
                with _ranges("all"):
                    driver.frame(index, span=_ranges)
            else:
                driver.frame(index)
            index += 1
        e1.record()
        torch.cuda.synchronize()
    after = driver.launches()
    launches = {k: after[k] - before[k] for k in after}
    return (devtrace.read_chrome_trace(prof), launches,
            e0.elapsed_time(e1) * 1e-3, index)


def profile_stretch(driver, index: int, metrics: dict) -> tuple:
    """The traced run's device record: (record, next frame index).

    The device's activity alone (no host profiling, whose cost would
    stretch the frames) over a few frames: its busy time, its length,
    the kernels' times. Up to PROFILE_TRIES stretches, for one in which
    the profiler saw as many of each counted kernel (a metric's COUNTED)
    as the program's launch counters say it launched; where none is
    whole, `whole` is false and no metric reads it. Then one stretch
    with the host's ranges, read only to label the idle gaps by the step
    the host was in."""
    counted = [(m.COUNTED, m.COUNTERS) for _, m in metrics.values()
               if hasattr(m, "COUNTED")]
    for attempt in range(PROFILE_TRIES):
        trace, launches, window_s, index = _stretch(driver, index, False)
        lost = devtrace.lost_events(trace, launches, counted)
        if not lost:
            break
        log(f"profiled stretch {attempt + 1}: the profiler lost kernel "
            f"events ({'; '.join(lost)})")
    rec = {"trace": trace, "launches": launches, "whole": not lost,
           "frames": PROFILED_FRAMES,
           "traces": driver.traces() * PROFILED_FRAMES,
           "busy_s": devtrace.busy_seconds(trace), "window_s": window_s,
           "device_ops": devtrace.top_ops(trace)}
    labelled, launches, _, index = _stretch(driver, index, True)
    lost = devtrace.lost_events(labelled, launches, counted)
    if lost:
        log(f"labelled stretch: the profiler lost kernel events "
            f"({'; '.join(lost)}); its gaps are labelled as seen")
    rec["idle_gaps"] = devtrace.idle_gaps(labelled)
    return rec, index


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def run_cell(root: pathlib.Path, manifest: dict, cell_name: str, seed: int,
             seconds: float, trace: bool, device, t_start: float,
             marks=None) -> dict:
    """One run of a cell on `device`: the result line's fields, before
    the import check. `marks`: (name, time) of the set-up's steps so far,
    from ("start", t_start)."""
    import torch

    import frames
    import judge

    found = discover(root, manifest, cell_name, trace)
    cell, config, traffic = found["cell"], found["config"], found["traffic"]
    card = torch.device(device).type == "cuda"
    marks = list(marks or [("start", t_start)])
    marks.append(("harness imports", time.perf_counter()))
    if card:
        torch.zeros(1, device=device)
        marks.append(("CUDA context", time.perf_counter()))
    inputs = make_inputs(root, config, seed)
    marks.append(("scene", time.perf_counter()))
    driver = frames.Driver(config, traffic, inputs, seed, device)
    marks.append(("session and cold build", time.perf_counter()))
    index = 0
    for _ in range(int(traffic["warmup_frames"])):
        driver.frame(index)
        index += 1
    marks.append(("warm-up frames", time.perf_counter()))
    rec = {"setup_s": marks[-1][1] - t_start, "log": log}
    log("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a)
        in zip(marks[1:], marks)))

    keeper = Keeper(seed, int(traffic["check_frames"]))
    spans = Spans(device) if trace else None
    frames_ms, flags = [], []
    t0 = t1 = time.perf_counter()
    while t1 - t0 < seconds:
        f0 = time.perf_counter()
        out = driver.frame(index, span=spans.span if spans else None)
        t1 = time.perf_counter()
        flags.append((out["failed"], len(driver.grid_flags) - 1))
        frames_ms.append((t1 - f0) * 1e3)
        keeper.offer(out, t1 - f0)
        index += 1
    rec.update(window_s=t1 - t0, frames_ms=frames_ms)
    grid_bad = driver.grid_failed()
    failed = sum(1 for f, g in flags if f or grid_bad[g])
    if trace:
        rec["spans_ms"] = spans.read()
        if card:
            rec["profile"], index = profile_stretch(driver, index,
                                                    found["metrics"])
    peak = torch.cuda.max_memory_allocated() if card else 0
    kept = keeper.frames()
    rays_per_frame = sum(r for r, _ in driver.traces())
    driver.close()
    del driver

    values = {}
    for name, (meta, mod) in found["metrics"].items():
        v = mod.read(rec)
        if v is None:
            log(f"metric {name}: nothing to read in this run")
        else:
            values[name] = {"value": float(v), "unit": meta["unit"]}
    n = len(frames_ms)
    log(f"{cell_name}: {n} frames in {rec['window_s']:.3f} s, {failed} "
        f"failed; {rays_per_frame} rays a frame = "
        f"{rays_per_frame * n / rec['window_s'] / 1e6:.3f} Mrays/s; "
        f"setup {rec['setup_s']:.3f} s; frames min/median/max "
        f"{min(frames_ms):.3f}/{sorted(frames_ms)[n // 2]:.3f}/"
        f"{max(frames_ms):.3f} ms")

    t_check = time.perf_counter()
    inputs["verts_t"] = torch.from_numpy(inputs["verts"]).to(device)
    inputs["faces_t"] = torch.from_numpy(inputs["faces"]).to(device)
    numbers = judge.judge(kept, inputs, traffic, seed)
    correct, rows = judge.verdict(numbers, traffic["limits"])
    log(f"check: {len(kept)} frames (indices "
        f"{[f['index'] for f in kept]}) against the reference in "
        f"{time.perf_counter() - t_check:.2f} s")

    dev_info = {"platform": "gpu" if card else "cpu",
                "kind": (torch.cuda.get_device_name(torch.device(device))
                         if card else "cpu"),
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": n, "failed": failed,
            "metrics": values, "device": dev_info}
    prof = rec.get("profile")
    if prof:
        dev_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}
    return line


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    manifest_path = ROOT / "BENCHMARK.json"
    manifest = json.loads(manifest_path.read_text())
    chips = {w["name"]: w["chips"] for w in manifest["workloads"]}
    if args.workload not in chips:
        log(f"no workload {args.workload!r} in {manifest_path}")
        return 1
    marks = [("start", T_START)]
    import torch
    marks.append(("torch import", time.perf_counter()))
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        log(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    marks.append(("CUDA check", time.perf_counter()))
    try:
        import hagrid_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not importable: {e}")
        return 3
    bad = guard.loaded_forbidden()
    if bad:
        log(f"loaded at start-up, and not allowed: {bad}")
        return 4
    marks.append(("program import", time.perf_counter()))
    try:
        line = run_cell(ROOT, manifest, args.workload, args.seed,
                        args.seconds, bool(args.trace), "cuda", T_START,
                        marks)
    except Exception:  # noqa: BLE001: a failed run prints no result
        traceback.print_exc(file=sys.stderr)
        return 1
    bad = guard.loaded_forbidden()
    if bad:
        log(f"loaded by the end of the window, and not allowed: {bad}")
        return 4
    log(f"card: {card_line()}")
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
