"""The control fails each cell's check, on the card, at the cell's own
widths, depth, slots and rate: the reference computed from float8 operands,
put in the program's place, is judged by the same ``check.verdict`` and the
cell's own limits as the served tokens of the same requests, and reads not
correct where they read correct.  The window is short (four seconds of
arrivals, each request served to its end), so that a test run holds it;
the limits were set from the cells' own runs (PERF.md)."""
import json
import time

import pytest

from conftest import ROOT
from perfbench import harness
from perfbench.spec import load_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_not_correct(name, gpu):
    cell = load_cell(name, ROOT)
    r = harness.run(cell, seed=2 ** 31 + 101, seconds=4.0, trace=False,
                    t0=time.perf_counter(), lower=["fp8"])
    print(name, json.dumps(r["readings"]))
    assert r["correct"] and r["control"] == {"fp8": False}
