"""The port's shared network fabric against the reference's, and the
``analytic_roofline_hw`` repair that lands with it: pure-delegating
``FabricOps`` layers are unwrapped before deciding whether grouped GEMMs
price by the base roofline, as in the reference, so an AF deployment on a
shared fabric takes the same vectorised expert-pricing path in both."""
import pytest

import repro.api as R
import repro.core.engine as R_engine
import repro.core.events as R_events
import repro.core.fabric as R_fabric
from repro.core.opmodels.batch import analytic_roofline_hw as r_roofline_hw
import repro_torch.api as T
import repro_torch.core.engine as T_engine
import repro_torch.core.events as T_events
import repro_torch.core.fabric as T_fabric
from repro_torch.core.opmodels.batch import analytic_roofline_hw

AF_FABRIC = {
    "model": {"name": "mixtral-8x7b", "smoke": True},
    "topology": {"preset": "af", "n_prefill": 1, "n_decode": 1, "m": 4,
                 "ffn_ep": 4, "fabric": {"mode": "shared",
                                         "oversubscription": 2.0,
                                         "latency_s": 5e-6}},
    "workload": {"n_requests": 10, "rate": 20.0, "prompt_mean": 256,
                 "output_mean": 16, "seed": 13},
    "pipeline": {"preset": "two_batch", "ep_overlap": 0.5},
    "seed": 16,
}


def _decode_ops(pkg, body, **kw):
    handle = pkg.build(pkg.SimSpec.from_dict(body), **kw)
    return handle.clusters["decode"].replicas[0].predictor.ops


@pytest.mark.parametrize("opmodel", ["analytical", "refined"])
def test_roofline_hw_unwraps_fabric_ops(opmodel):
    body = dict(AF_FABRIC, opmodel={"name": opmodel})
    ops = _decode_ops(T, body, device="cpu")
    assert isinstance(ops, T_fabric.FabricOps)
    ref = r_roofline_hw(_decode_ops(R, body))
    got = analytic_roofline_hw(ops)
    assert got == ref
    if opmodel == "analytical":
        hw = ops.inner.hw
        assert got == (hw.peak_flops, hw.hbm_bw, hw.op_overhead)
        # nested pure-delegating layers unwrap too
        twice = T_fabric.FabricOps(ops, ops.config)
        assert analytic_roofline_hw(twice) == got
    else:        # refined models override grouped_gemm: priced per rank
        assert got is None


def _run_fabric(mod_engine, mod_events, mod_fabric, uplinks, transfers,
                oversubscription=1.0, latency_s=0.0):
    """tests/test_fabric.py::run_fabric, against either package."""
    eng = mod_engine.SimEngine()
    fab = mod_fabric.Fabric(eng, mod_fabric.FabricConfig(
        mode="shared", oversubscription=oversubscription,
        latency_s=latency_s))
    for name, bw in uplinks.items():
        fab.attach(name, bw)
    done = {}
    for i, (t0, src, dst, nb) in enumerate(transfers):
        def submit(ev, i=i, src=src, dst=dst, nb=nb):
            fab.start_transfer(src, dst, nb,
                               done=lambda i=i: done.__setitem__(i, eng.now))
        eng.at(t0, mod_events.EV.KV_TRANSFER_START, submit)
    eng.run()
    return fab, done


@pytest.mark.parametrize("oversub,latency", [(1.0, 0.0), (2.0, 0.0),
                                             (3.0, 1e-3)])
def test_contention_completions_equal_the_reference(oversub, latency):
    uplinks = {"a": 1e9, "b": 2e9, "c": 5e8}
    transfers = [(0.0, "a", "c", 4e8), (0.1, "b", "c", 3e8),
                 (0.15, "a", "b", 1e8), (0.5, "c", "a", 2e8)]
    r_fab, r_done = _run_fabric(R_engine, R_events, R_fabric, uplinks,
                                transfers, oversub, latency)
    t_fab, t_done = _run_fabric(T_engine, T_events, T_fabric, uplinks,
                                transfers, oversub, latency)
    assert t_done == r_done and len(t_done) == len(transfers)
    assert t_fab.stats == r_fab.stats
    assert t_fab.exposed_comm_s() == r_fab.exposed_comm_s()
    assert t_fab.uncontended_comm_s() == r_fab.uncontended_comm_s()


def test_hand_computed_contention_fixture():
    """tests/test_fabric.py's hand-worked case on the port: 600 B A->C at
    t=0 and 300 B B->C at t=2 over 100 B/s uplinks share C's rx side and
    finish at 9 s and 8 s (exposed 15 s against 9 s uncontended)."""
    fab, done = _run_fabric(T_engine, T_events, T_fabric,
                            {"A": 100.0, "B": 100.0, "C": 100.0},
                            [(0.0, "A", "C", 600.0), (2.0, "B", "C", 300.0)])
    assert done[0] == pytest.approx(9.0, abs=1e-9)
    assert done[1] == pytest.approx(8.0, abs=1e-9)
    assert fab.stats["transfers"] == 2
    assert fab.exposed_comm_s() == pytest.approx(15.0, abs=1e-9)
    assert fab.uncontended_comm_s() == pytest.approx(9.0, abs=1e-9)
    assert fab.in_flight() == 0
