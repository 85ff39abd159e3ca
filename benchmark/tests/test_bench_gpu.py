"""On the card: a short run of every cell, traced and not, correct."""

import json
import time

import pytest

import run
from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("trace", (False, True))
def test_every_cell_runs_correct_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in m["workloads"]:
        line = run.run_cell(ROOT, m, w["name"], 2**31 + 3, 2.0, trace,
                            "cuda", time.perf_counter())
        assert line["correct"] and line["failed"] == 0, (w["name"], line)
