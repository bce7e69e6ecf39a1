"""Simulation twins, first half: each prints what the reference example
prints, byte for byte but the masked wall clock, and what
``examples_torch/expected/`` holds for the card to compare against."""
import pytest

from test_torch_examples import EXPECTED_DIR, REF_DIR, TWIN_DIR, stdout_of

NAMES = ("quickstart", "fault_tolerance_study", "fleet_capacity_study",
         "heterogeneous_cost_study", "heterogeneous_topology")


@pytest.mark.parametrize("name", NAMES)
def test_twin_prints_what_the_reference_prints(name, tmp_path, monkeypatch):
    (tmp_path / "ref").mkdir()
    (tmp_path / "twin").mkdir()
    want = stdout_of(REF_DIR / f"{name}.py", [], tmp_path / "ref", monkeypatch)
    got = stdout_of(TWIN_DIR / f"{name}.py", [], tmp_path / "twin", monkeypatch)
    assert want == (EXPECTED_DIR / f"{name}.txt").read_text()
    assert got == want
