"""What the benchmark may import and read, how it finds its pieces, that its
traffic repeats per seed, and that ``BENCHMARK.json`` agrees with its files
and with the contract's shape."""
import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from conftest import ROOT, smoke_config
from perfbench import harness, traffic
from perfbench.spec import HERE, load_cell, load_metric

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports, whole."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert "benchmarks" + "/" not in path.read_text()     # the JAX package's benchmarks


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path
    # nor through the benchmark's own module it imports
    assert "repro_torch" not in _imports(HERE / "weights.py")


def test_the_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(HERE))
    import run
    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        assert run.loaded_forbidden() == []
        sys.modules["jaxlib.xla"] = sys
        assert run.loaded_forbidden() == ["jaxlib"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def _mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_traffic_repeats_per_seed_and_keeps_its_work(name):
    """A seed gives the same requests again; another seed the same arrival
    times and lengths, other token ids; a longer window extends a shorter
    one's schedule; lengths stay in the mix's ranges."""
    mix = _mix(name)
    a = traffic.requests(mix, 2 ** 32 + 9, 20.0, 32000)
    b = traffic.requests(mix, 2 ** 32 + 9, 20.0, 32000)
    c = traffic.requests(mix, 12, 20.0, 32000)
    assert len(a) > 5
    assert all(t == u and (p == q).all() and n == k for (t, p, n), (u, q, k) in zip(a, b))
    assert [(t, len(p), n) for t, p, n in a] == [(t, len(p), n) for t, p, n in c]
    assert any((p != q).any() for (_, p, _), (_, q, _) in zip(a, c))
    assert traffic.schedule(mix, 2000.0)[:len(a)] == traffic.schedule(mix, 20.0)
    assert all(t < 20.0 for t, _, _ in a) and len(traffic.schedule(mix, 2000.0)) > len(a)
    lens = np.array([len(p) for _, p, _ in a])
    assert lens.min() >= mix["prompt"]["min"] and lens.max() <= mix["prompt"]["max"]
    assert all(mix["output"]["min"] <= n <= mix["output"]["max"] for _, _, n in a)
    assert mix["judge"] in ("tails", "throughput") and len(mix["source"]) <= 300


@pytest.mark.parametrize("name", MIXES)
def test_warm_lengths_reach_every_bucket(name):
    mix = _mix(name)
    lo, hi, ms = mix["prompt"]["min"], mix["prompt"]["max"], mix["max_seq"]
    want = {traffic.prefill_bucket(n, ms) for n in range(lo, hi + 1)}
    assert {traffic.prefill_bucket(n, ms) for n in traffic.warm_lengths(mix)} == want


def test_a_mix_that_passes_the_slot_or_the_context_is_refused():
    cfg, _ = smoke_config("yi-9b")
    mix = {"max_seq": 4096, "prompt": {"max": 3968}, "output": {"max": 127}}
    harness.check_fits(dict(cfg, max_position_embeddings=4096), mix)
    with pytest.raises(ValueError, match="slot"):
        harness.check_fits(cfg, dict(mix, output={"max": 128}))
    with pytest.raises(ValueError, match="context"):
        harness.check_fits(dict(cfg, max_position_embeddings=4000), mix)


def test_benchmark_json_agrees_with_its_files_and_the_contract():
    index = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(index) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert index["paths"] == ["perfbench"] and 1 <= index["run_seconds"] <= 51
    assert len(json.dumps(index)) < 64 * 1024
    configs = {c["name"]: c for c in index["configs"]}
    for c in index["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        own = json.loads((ROOT / c["file"]).read_text())
        assert own["name"] == c["name"] and own["source"] == c["source"]
        assert sorted(own["reduced"]) == sorted(c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["source"]) <= 200
    e2e = {m["name"] for m in index["end_to_end"]}
    assert "setup_s" in e2e
    for m in index["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in index["per_layer"]:
        reader = load_metric(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
        layers.setdefault(m["layer"], set()).add(m["name"])
    pairs = set()
    for w in index["workloads"]:
        own = json.loads((HERE / "cells" / f"{w['name']}.json").read_text())
        assert (own["config"], own["traffic"], own["why"]) == (w["config"], w["traffic"], w["why"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = load_cell(w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        judged = ({"out_tok_s"} if cell.traffic["judge"] == "throughput"
                  else {"ttft_p95_ms", "tpot_p95_ms"})
        assert reported == judged | {"setup_s"}
        assert cell.per_layer and all(m["moves"] in reported for m in cell.per_layer)
        harness.check_fits(cell.config, cell.traffic)
    for m in index["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in index["workloads"]}


def test_a_new_cell_mix_config_and_metric_are_found_by_name(tmp_path):
    """Files dropped in, nothing edited: the new cell runs (on the CPU, at
    the smoke geometry) on its new mix and configuration, and its result
    line carries the new metric."""
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    index = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp_path / "perfbench"
    cfg, _ = smoke_config("yi-9b")
    cfg["name"] = "tiny-dense"
    (base / "configs" / "tiny-dense.json").write_text(json.dumps(cfg))
    mix = {"source": "a drop-in mix", "slots": 2, "max_seq": 48, "rate": 100.0,
           "judge": "tails", "prompt": {"dist": "uniform", "min": 5, "max": 20},
           "output": {"dist": "uniform", "min": 3, "max": 6}, "sizes_seed": 4,
           "check": {"requests": 2}, "trace": {"warm_s": 0.02, "profile_s": 0.02}}
    (base / "traffic" / "tiny.json").write_text(json.dumps(mix))
    why = "a drop-in cell"
    (base / "cells" / "tiny-dense.tiny.json").write_text(json.dumps(
        {"config": "tiny-dense", "traffic": "tiny", "why": why,
         "limits": {"max_logit_gap": 1e-4}}))
    (base / "metrics" / "prefill_count.py").write_text(
        'LAYER = "engine scheduler (serving/engine.py)"\nUNIT = "count"\n'
        'MOVES = "ttft_p95_ms"\n\n\ndef read(w):\n'
        '    return float(sum(s["kind"] == "prefill" for s in w.steps))\n')
    index["workloads"].append({"name": "tiny-dense.tiny", "config": "tiny-dense",
                               "traffic": "tiny", "chips": 1, "why": why})
    index["per_layer"].append({"name": "prefill_count", "unit": "count", "better": "lower",
                               "source": "program_counter",
                               "layer": "engine scheduler (serving/engine.py)",
                               "moves": "ttft_p95_ms", "workloads": ["tiny-dense.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(index))
    cell = load_cell("tiny-dense.tiny", tmp_path)
    assert cell.traffic == mix and cell.config["name"] == "tiny-dense"
    r = harness.run(cell, seed=3, seconds=0.1, trace=True, t0=time.perf_counter(),
                    device="cpu")
    assert r["correct"] and r["attempted"] == len(traffic.schedule(mix, 0.1)) > 2
    assert r["metrics"]["prefill_count"]["value"] == float(r["attempted"])
    assert "decode_step_ms" not in r["metrics"]     # listed for other cells only


def _first_cell() -> str:
    return json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]


def _cli(cwd: Path):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", _first_cell(), "--seed",
         str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_result_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
