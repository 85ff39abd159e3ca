"""The port's bench (bench_torch.py, the counterpart of bench.py) on the
CPU at Cornell size: one JSON line with bench.py's keys for every
structure and workload, overflow recorded on the wavefront structures
too, a failed run's line and exit code, no JAX in the process, and the
line's scene numbers against the JAX package's RenderSession.

The `gpu` cases are the counterpart of tests/test_bench_regression.py:
the bench on the card at its defaults, held to bench_torch_thresholds.json
(skipped without a card).
"""

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--scene", "cornell", "--size", "32x32", "--iters", "1",
         "--device", "cpu"]
STRUCTURES = ("packet", "irregular", "uniform")
WORKLOADS = ("primary", "ao", "path", "dynamic")
# bench.py's keys (bench.py:285-291, 91-94, 328, 360-366) and the
# workloads' keys of extra["workloads"].
KEYS = ("metric", "value", "unit", "vs_baseline", "extra")
EXTRA = ("rebuild_ms", "tris", "device", "structure", "grid", "workloads",
         "workload_overflow", "trace_overflow", "timing", "card",
         "launches")
PRIMARY_EXTRA = ("rays", "hit_fraction", "latency_ms",
                 "primary_mrays_pipelined")
OUT = {"primary": "primary_mrays", "ao": "ao_mrays",
       "path": "path_mrays_upper", "dynamic": "dynamic_fps"}


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(ROOT, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    """The bench's small CPU runs are many small torch ops: one intra-op
    thread keeps them from contending for the cores with the suite's
    other workers (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _run(*argv):
    """(exit code, the parsed line, stdout's lines) of bench_torch.main."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _load_bench().main(list(argv))
    lines = out.getvalue().splitlines()
    return rc, json.loads(lines[-1]), lines


def _bench(structure, workload):
    return _run(*SMALL, "--structure", structure, "--workload", workload)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_line_has_bench_keys(structure, workload):
    """One JSON line with bench.py's keys and non-null values, exit code
    0, the workload run (and only it) with an overflow entry, no
    overflow. (The value is rounded as bench.py rounds it, so a slow CPU
    may print 0.0; the unrounded times are checked positive.)"""
    rc, line, lines = _bench(structure, workload)
    assert rc == 0 and len(lines) == 1, line.get("error")
    assert set(KEYS) <= set(line) and "error" not in line
    assert line["vs_baseline"] is None
    assert line["value"] is not None
    extra = line["extra"]
    assert extra["workloads"] == {OUT[workload]: line["value"]}
    assert list(extra["workload_overflow"]) == [workload]
    assert not any(extra["workload_overflow"].values())
    assert extra["trace_overflow"] is False
    assert extra["grid_overflow"] is False
    keys = EXTRA + (PRIMARY_EXTRA if workload == "primary" else ())
    if structure == "irregular" and workload == "primary":
        keys += ("mean_steps_per_ray",)
    for k in keys:
        assert extra.get(k) is not None, k
    assert extra["structure"] == structure and extra["device"] == "cpu"
    assert extra["card"] == "cpu" and extra["max_memory_reserved"] is None
    assert extra["tris"] == 32
    metric = {"primary": "primary_mrays", "dynamic": "dynamic_fps"}.get(
        workload, f"{workload}_mrays")
    assert line["metric"] == f"{metric}_cornell"
    for t in extra["timing"].values():
        w = t["wall_ms"]
        assert 0 < w["min"] <= w["median"] <= w["max"] and t["cuda_ms"] is None
    # On the CPU every wrapper takes its plain version: no kernel launch.
    assert not any(extra["launches"].values())


def test_dynamic_reports_each_window():
    """The dynamic workload runs bench.py's window (3 frames, one sync)
    `iters` times: the value is the median of the windows' frames/s, and
    the spread has one entry a window."""
    rc, line, _ = _run("--scene", "cornell", "--size", "16x16", "--iters",
                       "2", "--device", "cpu", "--structure", "uniform",
                       "--workload", "dynamic")
    assert rc == 0, line.get("error")
    t = line["extra"]["timing"]["dynamic"]
    fps, wall = t["fps"], t["wall_ms"]
    assert fps["runs"] == wall["runs"] == 2
    assert 0 < fps["min"] <= fps["median"] <= fps["max"]
    assert line["value"] == round(fps["median"], 3)
    # wall_ms is per frame: a window's fps is 1000 / its wall_ms.
    assert fps["max"] == pytest.approx(1e3 / wall["min"], rel=1e-9)
    assert fps["min"] == pytest.approx(1e3 / wall["max"], rel=1e-9)


@pytest.mark.parametrize("structure", ["irregular", "uniform"])
def test_wavefront_structures_record_every_overflow(structure):
    """bench.py records no overflow for the wavefront structures
    (bench.py:107); the port's bench records every workload's, from the
    march's truncated rays and the build's own overflow (the runs of
    test_line_has_bench_keys, or new ones)."""
    got = {}
    for w in WORKLOADS:
        got.update(_bench(structure, w)[1]["extra"]["workload_overflow"])
    assert got == {w: False for w in OUT}


def test_missing_scene_fails_with_a_line(capsys):
    rc, line, lines = _run(*SMALL, "--scene", "/nonexistent.obj")
    assert rc != 0 and len(lines) == 1
    assert line["value"] is None
    assert "FileNotFoundError" in line["error"]


def test_spent_budget_stops_with_a_line():
    rc, line, lines = _run(*SMALL, "--budget-s", "0")
    assert rc != 0 and len(lines) == 1
    assert line["value"] is None and line["error"].startswith("budget")
    assert line["extra"]["rebuild_ms"] > 0          # what it has
    assert "workloads" not in line["extra"]


def test_bad_flag_fails_with_a_line():
    rc, line, _ = _run("--workload", "bogus")
    assert rc != 0 and line["value"] is None and "error" in line


def test_bench_imports_no_jax():
    """A process that runs bench_torch imports neither jax nor any module
    of the JAX package."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('bench_torch', "
        f"{os.path.join(ROOT, 'bench_torch.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "rc = m.main(['--quick', '--device', 'cpu', '--workload', 'primary',"
        " '--size', '32x32'])\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'hagrid_tpu' or "
        "k.startswith('hagrid_tpu.'))\n"
        "print('MODULES', bad, rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "MODULES [] 0", lines
    assert json.loads(lines[-2])["value"] is not None


def _stat(grid, key):
    return int(re.search(rf"\b{key}=(\d+)", grid).group(1))


@pytest.mark.parametrize("structure", ["packet", "irregular"])
def test_scene_numbers_match_reference_session(structure):
    """tris, rays, hit_fraction and describe() of the port's bench against
    the JAX package's RenderSession on the same Cornell scene, warm
    rebuilt and traced at 32x32 in block order: hit fraction exactly (at
    bench.py's rounding); describe() equal (irregular: refs and cells)."""
    from hagrid_tpu import scenes as j_scenes
    from hagrid_tpu.core.camera import primary_rays as j_primary_rays
    from hagrid_tpu.core.types import Triangles as JTris
    from hagrid_tpu.render.session import RenderSession as JRenderSession

    _, line, _ = _bench(structure, "primary")
    extra = line["extra"]
    v, f = j_scenes.cornell_box()
    tris = JTris.from_mesh(v, f)
    js = JRenderSession.create(tris, structure=structure, verts=v)
    js.rebuild(tris)
    rays = j_primary_rays(j_scenes.cornell_camera(), 32, 32, order="block")
    key = (False, True, rays.count, None)
    if structure == "packet":
        # The port's calibrated budget: the reference's kernel runs in
        # interpret mode here, and its probes would take most of a minute.
        js._bmax_cal[key] = (128, None)
    hits = js.trace(rays, coherent=True)
    if structure == "packet":
        assert not js.poll_overflow(recalibrate=False)
    assert extra["tris"] == len(f)
    assert extra["rays"] == rays.count == 32 * 32
    frac = float(np.mean(np.asarray(hits.tri_id) >= 0))
    assert extra["hit_fraction"] == round(frac, 4)
    want = js.describe()
    if structure == "packet":
        assert extra["grid"] == want
    else:
        for k in ("refs", "cells"):
            assert _stat(extra["grid"], k) == _stat(want, k), k


# ---------------------------------------------------------------- the card

THRESHOLDS = os.path.join(ROOT, "bench_torch_thresholds.json")


@pytest.fixture(scope="module")
def card_run():
    """bench_torch.py's default run on the card: Sponza-scale scene,
    1024x1024, all workloads, the packet grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the bench's kernels have no CPU "
                    "mode)")
    out = subprocess.run([sys.executable, os.path.join(ROOT,
                                                       "bench_torch.py")],
                         capture_output=True, text=True, timeout=1500,
                         cwd=ROOT)
    line = json.loads(out.stdout.splitlines()[-1])
    assert out.returncode == 0, line.get("error")
    return line


def _thresholds():
    with open(THRESHOLDS) as fh:
        return json.load(fh)


@pytest.mark.gpu
def test_card_bench_is_complete(card_run):
    """The default run: no overflow, K2 and K3 launched, the card named."""
    extra = card_run["extra"]
    assert not any(extra["workload_overflow"].values())
    assert extra["trace_overflow"] is False
    assert extra["launches"]["sweep_blocks"] > 0
    assert extra["launches"]["sweep_blocks_anyhit"] > 0
    assert extra["device"] == torch.cuda.get_device_name(0)


@pytest.mark.gpu
def test_card_bench_primary_regression(card_run):
    th = _thresholds()
    assert card_run["value"] >= th["primary_mrays_min"]
    assert card_run["extra"]["rebuild_ms"] <= th["rebuild_ms_max"]


@pytest.mark.gpu
@pytest.mark.parametrize("key", ["ao_mrays", "path_mrays_upper",
                                 "dynamic_fps"])
def test_card_bench_workload_regression(card_run, key):
    assert card_run["extra"]["workloads"][key] >= _thresholds()[f"{key}_min"]
