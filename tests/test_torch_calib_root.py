"""The port fits into, lists and reads from its own artifact root,
``artifacts/calib_torch``, so a port fit never prices the reference's runs
(the reference reads ``artifacts/calib`` and checks hardware and geometry,
not the oracle).  Every default that names the root is held here: the
CLI's ``calibrate --out`` and its listing, ``calibrate``'s ``out_root``,
``discover_artifacts``, the ``calibration_study`` twin's ``--out`` and the
calibrated JSON spec."""
import inspect
import json
import os
from pathlib import Path

import pytest

import repro.calib.artifacts as ref_artifacts
from repro_torch.api import cli
from repro_torch.calib import calibrate, discover_artifacts
from test_torch_examples import TWIN_DIR, load

ROOT = os.path.join("artifacts", "calib_torch")


def test_every_default_names_the_port_root():
    assert inspect.signature(calibrate).parameters["out_root"].default == ROOT
    assert inspect.signature(discover_artifacts).parameters["root"].default == ROOT
    with open(TWIN_DIR / "specs" / "calibration.json") as f:
        assert json.load(f)["opmodel"]["calibration"] == ROOT


def test_study_twin_fits_into_the_port_root(monkeypatch):
    """The twin's ``--out`` default reaches ``calibrate`` as its root."""
    study = load(TWIN_DIR / "calibration_study.py")
    seen = {}

    class Stop(Exception):
        pass

    def fake_calibrate(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(study, "calibrate", fake_calibrate)
    with pytest.raises(Stop):
        study.main(["--smoke", "--device", "cpu"])
    assert seen["out_root"] == ROOT


def test_cli_fit_is_seen_by_the_port_and_not_the_reference(tmp_path, monkeypatch,
                                                           capsys):
    """``python -m repro_torch calibrate`` with its defaults, in a working
    directory of its own: the fit lands under ``artifacts/calib_torch``,
    the port's listing shows it, and the reference's discovery, pointed at
    its own default root, finds nothing."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["calibrate", "--device", "cpu", "--oracle", "kernelsim",
                     "--model", "qwen2-7b", "--smoke", "--no-fidelity",
                     "--train-samples", "40", "--eval-samples", "12"]) == 0
    fitted = sorted(p.name for p in (Path(ROOT)).rglob("*.json"))
    assert fitted and not os.path.exists(os.path.join("artifacts", "calib"))
    found = discover_artifacts()
    assert sorted(f"{a['operator']}.json" for a in found) == fitted
    assert ref_artifacts.discover_artifacts() == []
    capsys.readouterr()
    assert cli.main(["list", "calibration"]) == 0
    text = capsys.readouterr().out
    assert "calibration artifacts (artifacts/calib_torch):" in text
    assert all(a["operator"] in text for a in found)
