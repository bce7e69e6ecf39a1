"""The specs as JSON (``examples_torch/specs/``): each is the reference's
YAML as ``yaml.safe_load`` reads it, and each that needs no artifacts runs
through the port to the reference's report (``stable_view``, the hash that
``examples_torch/expected/specs.json`` holds for the card)."""
import hashlib
import json

import pytest
import yaml

from repro.api import SimSpec as RefSimSpec
from repro.api import run as ref_run
from repro_torch.api import SimSpec, run
from test_torch_examples import EXPECTED_DIR, REF_DIR, SPECS, TWIN_DIR, chip_smoke


def stable_view(report) -> str:
    """``chip_smoke.stable_view`` of the report as the CLI saves it."""
    return chip_smoke().stable_view(json.loads(report.to_json()))


# The one value a JSON spec changes: the port fits into its own root, so a
# port fit never prices the reference's runs.
PORT_VALUES = {"calibration": {("opmodel", "calibration"): "artifacts/calib_torch"}}


@pytest.mark.parametrize("name", SPECS)
def test_json_spec_is_the_yaml_spec(name):
    with open(REF_DIR / "specs" / f"{name}.yaml") as f:
        want = yaml.safe_load(f)
    for (section, key), value in PORT_VALUES.get(name, {}).items():
        assert want[section][key] != value
        want[section][key] = value
    with open(TWIN_DIR / "specs" / f"{name}.json") as f:
        assert json.load(f) == want


def test_the_card_runs_every_spec_but_calibration():
    assert sorted(chip_smoke().EXAMPLE_SPECS) == [s for s in SPECS
                                                  if s != "calibration"]
    with open(EXPECTED_DIR / "specs.json") as f:
        assert sorted(json.load(f)) == sorted(chip_smoke().EXAMPLE_SPECS)


@pytest.mark.parametrize("name", [s for s in SPECS if s != "calibration"])
def test_spec_runs_to_the_reference_report(name):
    want = stable_view(ref_run(RefSimSpec.load(str(REF_DIR / "specs" / f"{name}.yaml"))))
    got = stable_view(run(SimSpec.load(str(TWIN_DIR / "specs" / f"{name}.json")),
                          device="cpu"))
    assert got == want
    with open(EXPECTED_DIR / "specs.json") as f:
        expected = json.load(f)[name]
    assert hashlib.sha256(want.encode()).hexdigest() == expected["stable_view_sha256"]
