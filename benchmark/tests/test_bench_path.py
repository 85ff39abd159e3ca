"""The path cell on the CPU at the Cornell box's size: the program's
bounces judged correct against the plain reference (reference_path.py),
traced and not; the control in TF32 and bfloat16, and three faults
planted in the program's bounces, judged not correct by the path's own
number; the reference imports nothing of the program."""

import time

import pytest
import torch

import control
import guard
import run
from conftest import BENCH, ROOT, SEED

CELL = "sponza-open-packet.path"


def _run(manifest, trace=False):
    return run.run_cell(ROOT, manifest, CELL, SEED, 0.3, trace, "cpu",
                        time.perf_counter())


def test_the_path_reference_imports_nothing_of_the_program():
    names = guard.imports_of(BENCH / "reference_path.py")
    assert names <= {"__future__", "math", "torch", "reference"}, names


def test_the_path_cell_is_correct_and_traced(manifest):
    line = _run(manifest, trace=True)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["checks"]["path_wrong_share"]["value"] == 0.0
    # On the CPU only the steps' own times: the spans' device times, the
    # roofline and the idle share come from the card's profiled stretch.
    assert set(line["metrics"]) == {"primary_ms", "path_ms"}


@pytest.mark.parametrize("precision", ("tf32", "bfloat16"))
def test_the_path_control_is_not_correct(manifest, precision):
    nums = control.control_numbers(ROOT, manifest, CELL, SEED, 2, "cpu",
                                   precision)
    limits = run.discover(ROOT, manifest, CELL, False)["traffic"]["limits"]
    assert nums["path_wrong_share"] > limits["path_wrong_share"], nums


def _dropped(fn):
    """One bounce fewer than asked for."""
    def bounces(*a, max_bounces=4, **kw):
        return fn(*a, max_bounces=max_bounces - 1, **kw)
    return bounces


def _albedo(fn):
    """Albedo 0.5 in place of the mix's."""
    def bounces(*a, **kw):
        return fn(*a, **dict(kw, albedo=0.5))
    return bounces


def _sky_on_hit(fn):
    """The sky's radiance added where the primary ray hit a surface."""
    def bounces(session, rays, hits, *a, sky=1.0, **kw):
        out = fn(session, rays, hits, *a, sky=sky, **kw)
        return out + torch.where(hits.tri_id >= 0, sky, 0.0)
    return bounces


@pytest.mark.parametrize("fault", (_dropped, _albedo, _sky_on_hit))
def test_a_planted_path_fault_is_not_correct(manifest, fault, monkeypatch):
    from hagrid_tpu_torch.render import integrators
    monkeypatch.setattr(integrators, "path_bounces",
                        fault(integrators.path_bounces))
    line = _run(manifest)
    assert not line["correct"]
    c = line["checks"]["path_wrong_share"]
    assert c["value"] > c["limit"], line["checks"]
    assert line["checks"]["primary_wrong_share"]["value"] == 0.0
