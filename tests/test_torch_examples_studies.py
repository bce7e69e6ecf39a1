"""Simulation twins, second half, and ``calibration_study --smoke`` (the
kernelsim oracle on the CPU): each prints what the reference prints, byte
for byte but the masked wall clock, and what ``examples_torch/expected/``
holds.  Together with test_torch_examples_stdout.py this covers every name
in ``chip_smoke.EXAMPLES_SIM``."""
import pytest

from test_torch_examples import (EXPECTED_DIR, REF_DIR, TWIN_DIR, chip_smoke,
                                 stdout_of)
from test_torch_examples_stdout import NAMES as FIRST_HALF

NAMES = ("memory_pressure_study", "moe_af_simulation", "pareto_sweep",
         "pipelining_study", "trace_study")


def test_the_two_halves_are_the_card_s_list():
    assert sorted(FIRST_HALF + NAMES) == sorted(chip_smoke().EXAMPLES_SIM)


@pytest.mark.parametrize("name", NAMES + ("calibration_study",))
def test_twin_prints_what_the_reference_prints(name, tmp_path, monkeypatch):
    (tmp_path / "ref").mkdir()
    (tmp_path / "twin").mkdir()
    argv = ["--smoke", "--out", "calib"] if name == "calibration_study" else []
    want = stdout_of(REF_DIR / f"{name}.py", argv, tmp_path / "ref", monkeypatch)
    twin_argv = argv + ["--device", "cpu"] if argv else []
    got = stdout_of(TWIN_DIR / f"{name}.py", twin_argv, tmp_path / "twin",
                    monkeypatch)
    assert want == (EXPECTED_DIR / f"{name}.txt").read_text()
    assert got == want


def test_trace_study_writes_its_artifacts_where_told(tmp_path, monkeypatch):
    stdout_of(TWIN_DIR / "trace_study.py", [], tmp_path, monkeypatch)
    written = sorted(p.name for p in (tmp_path / "artifacts").iterdir())
    assert written == ["trace-study-pd.spans.jsonl",
                       "trace-study-pd.summary.txt",
                       "trace-study-pd.trace.json"]
