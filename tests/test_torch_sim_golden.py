"""The port's ``run`` against the reference's golden reports: the specs of
``tests/test_golden.py`` that need neither the fleet nor the observability
layer, held to ``tests/golden/*.json`` with that file's comparison (exact
``spec_hash``, every float to 1e-6 relative)."""
import json

import pytest

from repro_torch.api import SimSpec, run
from test_golden import GOLDEN_DIR, SPECS, _diff

PORTED = ("colocated", "pd_disagg", "af_moe", "memory_pd", "fabric_af")


def _report(preset):
    return run(SimSpec.from_dict(SPECS[preset]), device="cpu")


@pytest.mark.parametrize("preset", PORTED)
def test_port_summary_matches_golden(preset):
    rep = _report(preset)
    golden = json.loads((GOLDEN_DIR / f"{preset}.json").read_text())
    assert rep.spec_hash == golden["spec_hash"]
    drift = _diff(golden["summary"], rep.summary)
    assert not drift, f"port drifted from golden '{preset}':\n" + "\n".join(drift)
    assert rep.all_complete


def test_port_fabric_run_shows_contention():
    """As ``test_fabric_golden_shows_contention``, on the port's own report:
    oversubscription costs simulated time, so the fabric is wired in."""
    s = _report("fabric_af").summary
    assert s["fabric_transfers"] > 0
    assert s["fabric_exposed_comm_s"] > s["fabric_uncontended_comm_s"]
    assert s["fabric_contention_delay_s"] > 0


def test_goldens_left_to_the_fleet_and_obs_layers_raise():
    """``fleet_pd`` (and any obs-enabled spec) waits for ROADMAP item 7: the
    port refuses it rather than run it with the section dropped."""
    from repro_torch.api import SpecError
    left = sorted(set(SPECS) - set(PORTED))
    assert left == ["fleet_pd"]
    spec = SimSpec.from_dict(SPECS["fleet_pd"])
    assert spec.spec_hash() == json.loads(
        (GOLDEN_DIR / "fleet_pd.json").read_text())["spec_hash"]
    with pytest.raises(SpecError, match="item 7"):
        run(spec, device="cpu")
