"""The port's declarative API and command line against the reference's:
the same bad spec raises the same ``SpecError`` text in both; ``python -m
repro_torch`` runs, sweeps and lists on the CPU; a spec that needs the fleet
or observability layer (ROADMAP Queue A item 7) is refused, never run with
the section dropped."""
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


@pytest.mark.parametrize("section,body", [
    ("fleet", {"fleet": {"instances": [{"name": "a", "count": 2}]}}),
    ("obs", {"obs": {}}),
    ("obs", {"obs": True}),
])
def test_fleet_and_obs_specs_raise_naming_item_7(section, body, tmp_path,
                                                 capsys):
    spec = T.SimSpec.from_dict(dict(SMALL, **body))
    # parsed and hashed as the reference does
    assert spec.to_dict() == R.SimSpec.from_dict(dict(SMALL, **body)).to_dict()
    assert spec.spec_hash() == R.SimSpec.from_dict(dict(SMALL, **body)).spec_hash()
    for call in (spec.validate, lambda: T.run(spec, device="cpu"),
                 lambda: T.build(spec, device="cpu")):
        with pytest.raises(T.SpecError, match=rf"^{section}: .*item 7"):
            call()
    p = tmp_path / "s.json"
    p.write_text(json.dumps(dict(SMALL, **body)))
    assert cli.main(["run", str(p), "--device", "cpu",
                     "-o", str(tmp_path)]) == 2
    assert "item 7" in capsys.readouterr().err
    assert not list(tmp_path.glob("*.report.json"))


def test_disabled_obs_runs_as_the_reference():
    body = dict(SMALL, obs={"enabled": False})
    port = T.run(T.SimSpec.from_dict(body), device="cpu")
    ref = R.run(R.SimSpec.from_dict(body))
    assert port.spec_hash == ref.spec_hash
    assert port.summary == ref.summary


def test_chrome_export_waits_for_the_obs_layer(tmp_path):
    from repro_torch.core.trace import EventTrace
    with pytest.raises(NotImplementedError, match="item 7"):
        EventTrace().to_chrome_trace(str(tmp_path / "t.json"))


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
    assert "fleet routers:\n  (not yet ported: ROADMAP Queue A item 7)" in text
    assert cli.main(["run", str(tmp_path / "missing.json"),
                     "--device", "cpu"]) == 2
    with pytest.raises(SystemExit):
        cli.main(["trace", str(spec_path)])        # waits for item 7


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
