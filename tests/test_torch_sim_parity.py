"""The port's simulator against the reference's, spec by spec: the same spec
through both packages' ``run`` gives the same stable view (summary, spec
hash, per-cluster breakdown, conservation, event count) to the byte.  The
specs are taken from the reference's own tests; they cover an inline
StageGraph with cross-cluster expert parallelism, a chunked-prefill mix,
fault injection under memory pressure, the ``numpy`` predictor backend,
refined operator models and fitted calibration artifacts.  The ``jit``
backend is held step by step at the reference's float32 tolerance."""
import json

import numpy as np
import pytest

import repro.api as R
import repro.calib as R_calib
import repro_torch.api as T
import repro_torch.calib as T_calib
from test_determinism import _stable_view

SMALL = {"model": {"name": "qwen2-7b"},
         "topology": {"preset": "colocated", "n_replicas": 2},
         "workload": {"n_requests": 30, "rate": 20.0}, "seed": 0}

PRESSURE = {  # tests/test_memory.py::_PRESSURE
    "model": {"name": "qwen2-7b", "smoke": True},
    "topology": {"preset": "pd", "n_prefill": 1, "n_decode": 2},
    "workload": {"n_requests": 40, "arrival": "burst", "burst_size": 40,
                 "burst_period": 1.0, "prompt": "fixed", "prompt_mean": 64,
                 "output": "fixed", "output_mean": 2048, "seed": 7},
    "seed": 7,
}

SPECS = {
    # examples/heterogeneous_topology.py::pd_af_cross_cluster, as a spec
    "stagegraph_cross_cluster_ep": {
        "model": {"name": "mixtral-8x7b", "smoke": True},
        "topology": {"preset": None, "clusters": [
            {"name": "prefill", "role": "prefill", "n_replicas": 2, "tp": 2},
            {"name": "decode", "role": "decode", "step": "af", "m": 2,
             "hardware": "H100-SXM", "tp": 2, "attn_tp": 2, "ffn_tp": 1,
             "ffn_ep": 8, "remote_expert_ranks": [6, 7],
             "expert_cluster_hw": "A800-SXM4-80G", "expert_link_bw": 25e9,
             "expert_link_latency": 5e-6, "seed_offset": 50,
             "pipeline": {"name": "two_batch", "ep_overlap": 0.5}},
        ], "links": [
            {"src": "prefill", "dst": "decode", "bandwidth": 50e9},
            {"src": "decode", "dst": "prefill", "bandwidth": 25e9},
        ]},
        "policy": {"router": "zipf"},
        "workload": {"n_requests": 20, "rate": 15.0, "prompt_mean": 256,
                     "output_mean": 24, "seed": 3},
        "seed": 3,
    },
    # tests/test_pipelining.py::test_chunked_prefill_piggybacks_decode_end_to_end
    "chunked_prefill_mix": {
        "model": {"name": "qwen2-7b", "smoke": True},
        "topology": {"preset": "colocated", "n_replicas": 1},
        "workload": {"n_requests": 40, "rate": 30.0, "prompt_mean": 1024,
                     "output_mean": 64, "seed": 2},
        "pipeline": {"chunked_prefill": True, "prefill_chunk": 256},
    },
    # tests/test_memory.py::test_replica_failure_during_swap_pressure_conserves
    "failure_under_swap_pressure": dict(
        PRESSURE,
        memory={"manager": "paged", "capacity_frac": 0.0002,
                "preemption": "swap"},
        faults=[{"kind": "failure", "cluster": "decode", "replica": 0,
                 "at": 2.0, "downtime": 5.0}]),
    # tests/test_api.py::test_faults_via_spec
    "failure_and_straggler": dict(SMALL, faults=[
        {"kind": "failure", "cluster": "colocated", "replica": 0,
         "at": 0.2, "downtime": 1.0},
        {"kind": "straggler", "cluster": "colocated", "replica": 1,
         "slowdown": 2.0}]),
    # the numpy predictor backend, on a dense and an AF MoE deployment
    "numpy_backend_colocated": dict(SMALL, opmodel={"backend": "numpy"}),
    "numpy_backend_af": {
        "model": {"name": "mixtral-8x7b", "smoke": True},
        "topology": {"preset": "af", "m": 4, "ffn_ep": 4},
        "workload": {"n_requests": 20, "rate": 20.0, "prompt_mean": 256,
                     "output_mean": 24, "seed": 5},
        "pipeline": {"preset": "full_overlap"},
        "opmodel": {"backend": "numpy"}, "seed": 5,
    },
    # tests/test_api.py::test_af_report_carries_ep_fields (full width)
    "af_zipf_remote_ranks": {
        "model": {"name": "mixtral-8x7b"},
        "topology": {"preset": "af", "attn_tp": 2, "ffn_ep": 8,
                     "remote_expert_ranks": [7], "expert_link_bw": 25e9},
        "policy": {"router": "zipf"},
        "workload": {"n_requests": 8, "rate": 20.0}, "seed": 1,
    },
    # refined operator models (virtual kernels), PD, shared fabric
    "refined_pd_fabric": {
        "model": {"name": "qwen2-7b", "smoke": True},
        "topology": {"preset": "pd", "n_prefill": 2, "n_decode": 1,
                     "fabric": {"mode": "shared", "oversubscription": 2.0,
                                "uplink_bw": 2e7}},
        "workload": {"n_requests": 30, "arrival": "burst", "burst_size": 15,
                     "burst_period": 2.0, "prompt_mean": 512,
                     "output_mean": 32, "seed": 7},
        "opmodel": {"name": "refined"}, "seed": 7,
    },
}


def _both(spec_dict):
    ref = R.run(R.SimSpec.from_dict(spec_dict))
    port = T.run(T.SimSpec.from_dict(spec_dict), device="cpu")
    return ref, port


@pytest.mark.parametrize("name", sorted(SPECS))
def test_port_run_equals_reference(name):
    ref, port = _both(SPECS[name])
    assert port.all_complete and ref.all_complete
    assert port.spec == ref.spec
    assert _stable_view(port) == _stable_view(ref)


def test_refined_run_on_fitted_artifacts(tmp_path):
    """The ``simulate`` path on the card in small: fit refined models with
    the port's calibrate, then price one AF deployment from those artifacts
    in both packages."""
    T_calib.calibrate(model="mixtral-8x7b", hardware="H100-SXM",
                      oracle="kernelsim", smoke=True, n_train=40, n_eval=12,
                      seed=0, out_root=str(tmp_path), device="cpu")
    spec = {"model": {"name": "mixtral-8x7b", "smoke": True},
            "topology": {"preset": "af", "hardware": "H100-SXM",
                         "n_prefill": 1, "prefill_tp": 2, "n_decode": 1,
                         "m": 4, "ffn_ep": 4},
            "pipeline": {"preset": "two_batch", "ep_overlap": 0.5},
            "workload": {"n_requests": 20, "rate": 10.0, "prompt_mean": 256,
                         "output_mean": 24, "seed": 1},
            "opmodel": {"name": "refined", "calibration": str(tmp_path)},
            "seed": 1}
    ref, port = _both(spec)
    assert port.all_complete
    assert _stable_view(port) == _stable_view(ref)
    # the fitted models priced the run, not the analytical fallback
    analytical = T.run(T.SimSpec.from_dict(
        dict(spec, opmodel={"name": "analytical"})), device="cpu")
    assert port.summary["tpot_p50_s"] != analytical.summary["tpot_p50_s"]


def _colocated_predictor(pkg, **spec_kw):
    spec = pkg.SimSpec.from_dict(dict(SMALL, **spec_kw))
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.build(spec, **kw).clusters["colocated"].replicas[0].predictor


def test_jit_backend_steps_match_numpy_on_cpu():
    """``backend: jit`` is a float32 torch evaluation on the device ``build``
    was given; it must agree with the float64 numpy path within the
    reference's own float32 gate (tests/test_predictor_batch.py, 1e-5)."""
    pred = _colocated_predictor(T, opmodel={"backend": "jit"})
    assert pred.device == "cpu" and pred.backend == "jit"
    assert pred._vectorized_ok()
    rng = np.random.default_rng(0)
    steps = []
    for _ in range(32):
        n = int(rng.integers(1, 12))
        q = [int(rng.integers(1, 2048)) for _ in range(n)]
        steps.append((q, [qi + int(rng.integers(0, 4096)) for qi in q]))
    for decode in (False, True):
        s = [([1] * len(q), kv) for q, kv in steps] if decode else steps
        jit = pred.step_time_batch(s, decode=decode, backend="jit")
        ref = pred.step_time_batch(s, decode=decode, backend="numpy")
        assert np.all(ref > 0)
        assert np.max(np.abs(jit - ref) / ref) <= 1e-5
    # and numpy is the reference's numpy, bit for bit
    r_pred = _colocated_predictor(R)
    np.testing.assert_array_equal(
        r_pred.step_time_batch(steps, decode=False, backend="numpy"),
        pred.step_time_batch(steps, decode=False, backend="numpy"))


def test_jit_backend_run_on_cpu_close_to_numpy():
    """A whole run on the jit backend: same requests, every latency within
    float32 rounding of the numpy run's."""
    jit = T.run(T.SimSpec.from_dict(dict(SMALL, opmodel={"backend": "jit"})),
                device="cpu")
    num = T.run(T.SimSpec.from_dict(dict(SMALL, opmodel={"backend": "numpy"})),
                device="cpu")
    assert jit.all_complete and num.all_complete
    for key in ("ttft_p50_s", "tpot_p50_s", "e2e_p99_s", "duration_s"):
        assert jit.summary[key] == pytest.approx(num.summary[key], rel=1e-4)


def test_jit_backend_on_cuda_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the jit backend runs there")
    spec = T.SimSpec.from_dict(dict(SMALL, opmodel={"backend": "jit"}))
    with pytest.raises((RuntimeError, AssertionError)):
        T.run(spec)                      # device defaults to "cuda"


def test_reports_serialize_alike():
    ref, port = _both(SPECS["numpy_backend_colocated"])
    r, p = json.loads(ref.to_json()), json.loads(port.to_json())
    for d in (r, p):
        d.pop("wall_clock_s"), d.pop("created_at")
    assert r == p
    assert T.Report.from_dict(json.loads(port.to_json())).summary == port.summary
