"""The port's declarative API and command line against the reference's:
the same bad spec raises the same ``SpecError`` text in both; ``python -m
repro_torch`` runs, sweeps, traces and lists on the CPU; a spec with a
``fleet`` or an enabled ``obs`` section runs as the reference runs it."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.api as R
import repro_torch.api as T
from repro_torch.api import cli

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"name": "cli-test", "model": {"name": "qwen2-7b", "smoke": True},
         "topology": {"preset": "colocated", "n_replicas": 2},
         "workload": {"n_requests": 10, "rate": 10.0}, "seed": 0}

BAD = {
    "unknown_model": {"model": {"name": "gpt-17"}},
    "unknown_link_endpoint": {"topology": {
        "preset": None, "clusters": [{"name": "a", "role": "colocated"}],
        "links": [{"src": "a", "dst": "nowhere", "bandwidth": 1e9}]}},
    "closed_loop_without_concurrency": {"workload": {"arrival": "closed"}},
    "unknown_router": {"policy": {"router": "nope"}},
    "unknown_batching": {"policy": {"batching": "nope"}},
    "unknown_preset": {"topology": {"preset": "hybrid"}},
    "unknown_fault_kind": {"faults": [{"kind": "meteor",
                                       "cluster": "colocated"}]},
    "unknown_fault_cluster": {"faults": [{"cluster": "decode"}]},
    "role_key_typo": {"policy": {"batching": {"decod": "static"}}},
    "remote_rank_out_of_range": {"topology": {
        "preset": "af", "ffn_ep": 4, "remote_expert_ranks": [3, 9]}},
    "unknown_backend": {"opmodel": {"backend": "xla"}},
    "calibration_without_refined": {"opmodel": {"calibration": "calib/"}},
    "memory_overlap_too_large": {"memory": {"transfer_overlap": 1.5}},
    "fabric_with_streamed_transfer": {
        "topology": {"preset": "pd", "fabric": {"mode": "shared"}},
        "memory": {"transfer_overlap": 0.5}},
    "unknown_field": {"modle": {"name": "qwen2-7b"}},
    "unknown_workload_field": {"workload": {"ratee": 4.0}},
    "nonpositive_until": {"until": -1.0},
}


def _error(pkg, body):
    with pytest.raises(pkg.SpecError) as e:
        pkg.SimSpec.from_dict(body).validate()
    return str(e.value)


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_spec_raises_the_reference_text(case):
    assert _error(T, BAD[case]) == _error(R, BAD[case])


def _blob(rep):
    d = json.loads(rep.to_json())
    d.pop("wall_clock_s")
    d.pop("created_at")
    return json.dumps(d, sort_keys=True)


@pytest.mark.parametrize("section,body", [
    ("fleet", {"fleet": {"instances": [{"name": "a", "count": 2}]}}),
    ("obs", {"obs": {}}),
    ("obs", {"obs": True}),
])
def test_fleet_and_obs_specs_raise_naming_item_7(section, body, tmp_path,
                                                 capsys):
    """Once refused (ROADMAP item 7), a ``fleet`` or enabled ``obs``
    section now parses, hashes, validates and runs as in the reference:
    ``run`` and the CLI give the reference's report, and ``build`` refuses
    a fleet spec with the reference's text, as the reference does."""
    spec = T.SimSpec.from_dict(dict(SMALL, **body))
    ref_spec = R.SimSpec.from_dict(dict(SMALL, **body))
    assert spec.to_dict() == ref_spec.to_dict()
    assert spec.spec_hash() == ref_spec.spec_hash()
    spec.validate()
    want = R.run(ref_spec)
    assert _blob(T.run(spec, device="cpu")) == _blob(want)
    assert any(k.startswith(section) for k in want.summary)
    if section == "fleet":
        with pytest.raises(T.SpecError) as port_err:
            T.build(spec, device="cpu")
        with pytest.raises(R.SpecError) as ref_err:
            R.build(ref_spec)
        assert str(port_err.value) == str(ref_err.value).replace(
            "repro.", "repro_torch.")
    p = tmp_path / "s.json"
    p.write_text(json.dumps(dict(SMALL, **body)))
    assert cli.main(["run", str(p), "--device", "cpu",
                     "-o", str(tmp_path)]) == 0
    assert "item 7" not in capsys.readouterr().err
    got = json.loads((tmp_path / "cli-test.report.json").read_text())
    assert got["summary"] == json.loads(want.to_json())["summary"]


def test_disabled_obs_runs_as_the_reference():
    body = dict(SMALL, obs={"enabled": False})
    port = T.run(T.SimSpec.from_dict(body), device="cpu")
    ref = R.run(R.SimSpec.from_dict(body))
    assert port.spec_hash == ref.spec_hash
    assert port.summary == ref.summary


def test_chrome_export_waits_for_the_obs_layer(tmp_path):
    """``EventTrace.to_chrome_trace`` no longer waits: the observability
    layer's sink writes it, and the raw ring of a real run exports to the
    same file as the reference's."""
    from repro.core.engine import SimEngine as RSimEngine
    from repro.core.trace import EventTrace as RTrace
    from repro_torch.core.engine import SimEngine
    from repro_torch.core.trace import EventTrace
    out = {}
    for name, pkg, trace, engine in (("port", T, EventTrace(), SimEngine),
                                     ("ref", R, RTrace(), RSimEngine)):
        kw = {"device": "cpu"} if pkg is T else {}
        spec = pkg.SimSpec.from_dict(SMALL)
        handle = pkg.build(spec, engine=engine(trace=trace), **kw)
        handle.run(spec.workload.build_requests(spec.seed))
        path = tmp_path / f"{name}.json"
        trace.to_chrome_trace(str(path))
        out[name] = path.read_bytes()
    events = json.loads(out["port"])["traceEvents"]
    assert events and all(e["ts"] >= 0 for e in events)
    assert out["port"] == out["ref"]


def test_cli_run_sweep_and_list_on_cpu(tmp_path, capsys):
    spec_path = tmp_path / "s.json"
    spec_path.write_text(json.dumps(SMALL))
    out = str(tmp_path / "artifacts")
    assert cli.main(["run", str(spec_path), "-o", out, "--device", "cpu",
                     "--set", "workload.rate=20"]) == 0
    rep = json.load(open(os.path.join(out, "cli-test.report.json")))
    assert rep["summary"]["n_completed"] == 10
    assert rep["spec"]["workload"]["rate"] == 20
    want = R.run(R.SimSpec.from_dict(
        dict(SMALL, workload={"n_requests": 10, "rate": 20})))
    assert rep["spec_hash"] == want.spec_hash
    assert rep["summary"] == json.loads(want.to_json())["summary"]
    assert cli.main(["sweep", str(spec_path), "--axis",
                     "topology.n_replicas=1,2", "--jobs", "2",
                     "--device", "cpu", "-o", out]) == 0
    lines = [json.loads(line) for line in
             open(os.path.join(out, "cli-test.sweep.jsonl"))]
    assert len(lines) == 2
    assert cli.main(["list"]) == 0
    text = capsys.readouterr().out
    assert "models" in text and "mixtral-8x7b" in text
    assert ("fleet routers:\n  least_outstanding\n  power_of_two\n"
            "  prefix_affinity\n  round_robin\n") in text
    assert cli.main(["run", str(tmp_path / "missing.json"),
                     "--device", "cpu"]) == 2
    assert cli.main(["trace", str(spec_path), "--device", "cpu",
                     "-o", out]) == 0
    trace = json.load(open(os.path.join(out, "cli-test.trace.json")))
    body = [e["ts"] for e in trace["traceEvents"] if e["ph"] != "M"]
    assert body and body == sorted(body) and body[0] >= 0
    for ext in ("spans.jsonl", "summary.txt", "report.json"):
        assert os.path.isfile(os.path.join(out, f"cli-test.{ext}"))


def test_cli_rejects_bad_spec(tmp_path, capsys):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"model": {"name": "not-a-model"}}))
    assert cli.main(["run", str(p), "--device", "cpu"]) == 2
    assert "unknown model" in capsys.readouterr().err


def test_python_m_repro_torch_run(tmp_path):
    """The module entry point, in a process of its own that has never
    imported the reference."""
    spec_path = tmp_path / "s.json"
    spec_path.write_text(json.dumps(SMALL))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = "\n".join([
        "import runpy, sys",
        "sys.argv = ['repro_torch'] + sys.argv[1:]",
        "try:",
        "    runpy.run_module('repro_torch', run_name='__main__')",
        "except SystemExit as e:",
        "    rc = e.code",
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules",
        "sys.exit(rc)"])
    done = subprocess.run(
        [sys.executable, "-c", code, "run", str(spec_path), "--device", "cpu",
         "-o", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "n_completed" in done.stdout
    assert (tmp_path / "cli-test.report.json").is_file()
