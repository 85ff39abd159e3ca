"""The benchmark's CPU tests: its harness, its reference and its
comparison, driven on the Cornell box at 64x64 through the program's
plain (CPU) paths. They are not part of the repository's test suite:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import copy
import json
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2**31 + 11


def cornell_manifest() -> dict:
    """BENCHMARK.json with each configuration's file swapped for its
    Cornell-sized stand-in under benchmark/tests/."""
    m = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for c in m["configs"]:
        c["file"] = ("benchmark/tests/cornell-"
                     f"{c['name'].split('-', 1)[1]}.json")
    return m


@pytest.fixture
def manifest():
    return cornell_manifest()
