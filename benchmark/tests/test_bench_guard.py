"""The import guards: nothing of JAX or the JAX package in a run, and
nothing of the program in the reference."""

import os
import shutil
import subprocess
import sys

import guard
from conftest import BENCH, ROOT


def test_top_level_names_compare_whole():
    mods = {"hagrid_tpu_torch": 1, "hagrid_tpu_torch.ops": 1,
            "jaxtyping": 1, "jax": 1, "jax.numpy": 1, "hagrid_tpu.grid": 1,
            "flaxen": 1, "jaxlib.xla": 1}
    assert guard.loaded_forbidden(mods) == ["hagrid_tpu.grid", "jax",
                                            "jax.numpy", "jaxlib.xla"]


def test_the_reference_and_the_comparison_import_nothing_of_the_program():
    sources = [BENCH / "reference.py", BENCH / "judge.py",
               *sorted((BENCH / "steps").glob("*.py"))]
    for path in sources:
        names = guard.imports_of(path)
        assert not names & (guard.FORBIDDEN | {guard.PROGRAM}), (path, names)
    code = ("import sys, pathlib; sys.path.insert(0, sys.argv[1]); "
            "import frames, judge, reference; "
            "[frames.step(p.stem) for p in "
            "pathlib.Path(sys.argv[1], 'steps').glob('*.py')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'hagrid_tpu_torch', 'hagrid_tpu', 'jax', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)],
                         capture_output=True, text=True, check=True,
                         cwd=str(ROOT))
    assert out.stdout.strip() == "[]"


def test_the_harness_imports_nothing_of_jax():
    for path in sorted(BENCH.rglob("*.py")):
        assert not guard.imports_of(path) & guard.FORBIDDEN, path


def test_a_run_without_a_card_or_without_the_program_prints_nothing(
        tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = ["benchmark/run.py", "--workload", "sponza-packet.dynamic",
            "--seed", "1", "--seconds", "1", "--trace", "0"]
    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, *args], capture_output=True,
                             text=True, cwd=str(cwd), env=env, timeout=300)
        assert out.returncode != 0 and out.stdout == ""
