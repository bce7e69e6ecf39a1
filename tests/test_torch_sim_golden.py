"""The port's ``run`` against the reference's golden reports: every spec
of ``tests/test_golden.py``, the fleet spec included, held to
``tests/golden/*.json`` with that file's comparison (exact ``spec_hash``,
every float to 1e-6 relative)."""
import json

import pytest

from repro_torch.api import SimSpec, run
from test_golden import GOLDEN_DIR, SPECS, _diff

PORTED = ("colocated", "pd_disagg", "af_moe", "memory_pd", "fabric_af",
          "fleet_pd")


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
    """No golden is left to the fleet and observability layers any more:
    every spec of ``tests/test_golden.py`` runs through the port, and the
    fleet golden's whole report (its instances, tenants and scale events,
    not only the summary the golden pins) equals the reference's report of
    the same spec, byte for byte but for the moment of the run."""
    import repro.api as R
    left = sorted(set(SPECS) - set(PORTED))
    assert left == []
    spec = SimSpec.from_dict(SPECS["fleet_pd"])
    assert spec.spec_hash() == json.loads(
        (GOLDEN_DIR / "fleet_pd.json").read_text())["spec_hash"]
    blobs = []
    for rep in (run(spec, device="cpu"),
                R.run(R.SimSpec.from_dict(SPECS["fleet_pd"]))):
        d = json.loads(rep.to_json())
        d.pop("wall_clock_s")
        d.pop("created_at")
        blobs.append(json.dumps(d, sort_keys=True))
    assert blobs[0] == blobs[1]
    assert len(json.loads(blobs[0])["instances"]) == 3   # colo x2, pd x1
