"""BENCHMARK.json against the contract the harness is built to: names,
units, keys, files found by name, and which cells report what."""

import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|per_tok)")


@pytest.fixture(scope="module")
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command(m):
    assert set(m) == TOP
    assert m["paths"] == ["benchmark"]
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries(m):
    names = {}
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in m[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]), e["name"]
            assert _line(e["why"])
            names.setdefault(group, set()).add(e["name"])
        assert len(names[group]) == len(m[group])
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]), e
        assert e["better"] in ("lower", "higher")
    metric_names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_configs_are_files_of_their_own(m):
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert _line(c["source"]) and body["source"] == c["source"]
        assert not any(WIDTH.search(k) for k in c["reduced"])


def test_cells_find_their_files(m):
    pairs = set()
    for w in m["workloads"]:
        assert w["chips"] in (1, 4)
        mix = BENCH / "traffic" / f"{w['traffic']}.json"
        for step in json.loads(mix.read_text())["steps"]:
            assert (BENCH / "steps" / f"{step}.py").is_file(), step
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(m["workloads"]) // 4)
    for e in m["end_to_end"] + m["per_layer"]:
        assert (BENCH / "metrics" / f"{e['name']}.py").is_file()


def test_bounds_and_sources(m):
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(e["layer"])


def test_every_metric_s_cells_report_what_it_moves(m):
    cells = {w["name"] for w in m["workloads"]}
    reports = {e["name"]: set(e.get("workloads", cells))
               for e in m["end_to_end"]}
    for cell in cells:
        assert "setup_s" in [n for n, c in reports.items() if cell in c]
        assert len([n for n, c in reports.items() if cell in c]) >= 2
        assert any(cell in e["workloads"] for e in m["per_layer"])
    for e in m["per_layer"]:
        assert e["moves"] == "frame_ms"
        assert set(e["workloads"]) <= reports[e["moves"]]


def test_roofline_and_mfu_names(m):
    for e in m["per_layer"]:
        if e["name"].endswith("_roofline") or "mfu" in e["name"]:
            assert e["unit"] == "%" and e["better"] == "higher"
