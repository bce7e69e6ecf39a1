"""Determinism of the port's simulator, as ``tests/test_determinism.py``
holds the reference's: identical SimSpec + seed gives byte-identical
reports in process and across ``sweep`` workers, forked (``device="cpu"``)
and spawned (``device="cuda"``, which the python backend never reads, so
no card is needed), and the seed matters."""
from repro_torch.api import (
    ModelRef, PipelineSpec, SimSpec, TopologySpec, WorkloadSpec, run, sweep,
)
from test_determinism import _stable_view


def _specs():
    yield SimSpec(
        name="det-colocated",
        model=ModelRef("qwen2-7b", smoke=True),
        topology=TopologySpec(preset="colocated", n_replicas=2),
        workload=WorkloadSpec(n_requests=30, rate=25.0, seed=5), seed=5)
    yield SimSpec(
        name="det-af-pipelined",
        model=ModelRef("mixtral-8x7b", smoke=True),
        topology=TopologySpec(preset="af", m=4, ffn_ep=4),
        workload=WorkloadSpec(n_requests=20, rate=20.0, prompt_mean=256,
                              output_mean=24, seed=5),
        pipeline=PipelineSpec(preset="full_overlap"), seed=5)


def test_same_spec_same_seed_is_byte_identical_in_process():
    for spec in _specs():
        a, b = run(spec, device="cpu"), run(spec, device="cpu")
        assert _stable_view(a) == _stable_view(b)


def test_reports_identical_across_process_pool_workers():
    base = next(_specs())
    axes = {"workload.rate": [15.0, 25.0], "seed": [1, 2]}
    serial = sweep(base, axes, jobs=1, device="cpu")
    forked = sweep(base, axes, jobs=2, device="cpu")
    spawned = sweep(base, axes, jobs=2, device="cuda")
    assert len(serial) == len(forked) == len(spawned) == 4
    for a, b, c in zip(serial, forked, spawned):
        assert a.point == b.point == c.point
        assert _stable_view(a) == _stable_view(b) == _stable_view(c)


def test_seed_actually_matters():
    spec = next(_specs())
    a = run(spec, device="cpu")
    b = run(spec.with_(**{"workload.seed": 99, "seed": 99}), device="cpu")
    assert a.summary["ttft_p50_s"] != b.summary["ttft_p50_s"]
