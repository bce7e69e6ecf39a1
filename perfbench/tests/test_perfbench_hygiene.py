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
from perfbench.spec import (HERE, INTERFACE, family, load_arch, load_cell, load_metric,
                            model_shapes)

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


PROGRAM = {"repro_torch", "jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")) + [
    HERE / "weights.py", HERE / "spec.py"], ids=lambda p: str(p.relative_to(HERE)))
def test_the_reference_imports_nothing_of_the_program(path):
    """Every family's reference, and the benchmark's own modules it imports."""
    assert not _imports(path) & PROGRAM


def test_the_reference_runs_without_the_program():
    """In a fresh interpreter, each configuration's family (which imports
    the program only inside ``port_config``) and its reference, run at a
    tiny size, leave no module of the program or of JAX loaded."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
from perfbench.spec import HERE, family, load_config, model_shapes
for f in sorted((HERE / "configs").glob("*.json")):
    cfg = dict(load_config(f.stem), hidden_size=32, intermediate_size=48, head_dim=8,
               num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=1,
               vocab_size=64)
    m = model_shapes(cfg)
    seq = {{"tokens": torch.arange(6), "prompt_len": 3, "bucket": 8}}
    family(m).served_logits(m, 1, [seq], dtype=torch.float32, device="cpu")
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}} & set({sorted(PROGRAM)!r}))))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted((HERE / "arch").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_family_defines_the_whole_interface(path):
    fam = load_arch(path.stem)
    for name in INTERFACE:
        fn = getattr(fam, name)
        assert callable(fn) and (fn.__doc__ or "").strip(), name


@pytest.mark.parametrize("path", sorted((HERE / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_configuration_names_its_family(path):
    cfg = json.loads(path.read_text())
    assert (HERE / "arch" / f"{cfg['arch']}.py").is_file()
    assert model_shapes(cfg)["arch"] == cfg["arch"]


def test_a_configuration_without_a_known_family_is_refused(tmp_path):
    """No ``arch``, an ``arch`` with no file, or a family file that lacks a
    function of the interface: refused when the cell is loaded, with no
    default family."""
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    base = tmp_path / "perfbench"
    name = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    config = json.loads((base / "cells" / f"{name}.json").read_text())["config"]
    path = base / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    load_cell(name, tmp_path)
    src = (base / "arch" / "llama_style.py").read_text()
    (base / "arch" / "partial.py").write_text(src.replace("def served_logits(", "def _gone("))
    for arch, match in ((None, "names no architecture"), ("", "names no architecture"),
                        ("no_such_family", "no architecture family"),
                        ("../configs/yi-9b", "no architecture family"),
                        ("partial", "does not define served_logits")):
        bad = {k: v for k, v in cfg.items() if k != "arch"}
        if arch is not None:
            bad["arch"] = arch
        path.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=match):
            load_cell(name, tmp_path)
        with pytest.raises(ValueError, match=match):
            model_shapes(bad, base)


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


QK_FAMILY = '''"""The qk-norm decoder family: ``llama_style``'s layers with a zero-centred
RMSNorm over each head of q and of k before RoPE, as Qwen3 has them."""
from pathlib import Path

from perfbench.spec import load_module
from perfbench.weights import NORM_STD

HERE = Path(__file__).resolve().parent
base = load_module(HERE / "llama_style.py", "qknorm_decoder_base")
REFERENCE = load_module(HERE.parent / "reference" / "qknorm_decoder.py",
                        "qknorm_decoder_reference")
shapes, outer_leaves = base.shapes, base.outer_leaves
prefill_flops, decode_token_flops = base.prefill_flops, base.decode_token_flops
decode_kv_bytes, kv_bytes_per_position = base.decode_kv_bytes, base.kv_bytes_per_position


def layer_leaves(m, i):
    """``llama_style``'s, then the two norms of (hd,)."""
    return base.layer_leaves(m, i) + [("attn.q_norm", (m["hd"],), NORM_STD),
                                      ("attn.k_norm", (m["hd"],), NORM_STD)]


def port_config(cfg, m):
    """The engine's config, which has to have the q/k norms."""
    pc = base.engine_config(cfg, m)
    if not pc.qk_norm or pc.tie_embeddings:
        raise ValueError("the engine has no q/k norms")
    return pc


def served_logits(m, seed, seqs, *, dtype, device, precision="f32"):
    """The family's plain reference."""
    return REFERENCE.served_logits(m, seed, seqs, dtype=dtype, device=device,
                                   precision=precision)


def weight_params(m):
    """``llama_style``'s and the norms."""
    return base.weight_params(m) + 2 * m["L"] * m["hd"]


def decode_step_weight_bytes(m, batch):
    """``llama_style``'s and the norms."""
    return base.decode_step_weight_bytes(m, batch) + 2 * m["L"] * m["hd"] * m["dtype_bytes"]
'''

QK_REFERENCE = '''"""The qk-norm decoder family's plain reference: ``llama_style``'s, with
the zero-centred per-head RMSNorm on q and k before RoPE."""
from pathlib import Path

from perfbench.spec import load_module

ls = load_module(Path(__file__).with_name("llama_style.py"), "qknorm_reference_base")


def layer_weights(raw, m, prec):
    w = ls.layer_weights(raw, m, prec)
    w["q_norm"], w["k_norm"] = raw["attn"]["q_norm"].float(), raw["attn"]["k_norm"].float()
    return w


def attention(m, w, h, prec):
    T, H, K, hd = h.shape[0], m["H"], m["K"], m["hd"]
    q = ls.mm(h, w["wq"], prec).reshape(T, H, hd)
    k = ls.mm(h, w["wk"], prec).reshape(T, K, hd)
    v = ls.mm(h, w["wv"], prec).reshape(T, K, hd)
    q = ls.rope(ls.rms_norm(q, w["q_norm"], m["eps"]), m["theta"])
    k = ls.rope(ls.rms_norm(k, w["k_norm"], m["eps"]), m["theta"])
    return ls.mm(ls.attend(m, q, k, v), w["wo"], prec)


def block(m, w, x, s, prec):
    rnd = ls.rounding(prec)
    x = rnd(x + attention(m, w, rnd(ls.rms_norm(x, w["ln1"], m["eps"])), prec))
    h = rnd(ls.rms_norm(x, w["ln2"], m["eps"]))
    return rnd(x + ls.ffn(m, w, h, s, prec))


def served_logits(m, seed, seqs, *, dtype, device, precision="f32"):
    return ls.forward(m, seed, seqs, dtype=dtype, device=device, precision=precision,
                      layer_weights=layer_weights, block=block)
'''

NO_QK_NORM = {  # the toy reference: q and k straight to RoPE
    'ls.rope(ls.rms_norm(q, w["q_norm"], m["eps"]), m["theta"])': 'ls.rope(q, m["theta"])',
    'ls.rope(ls.rms_norm(k, w["k_norm"], m["eps"]), m["theta"])': 'ls.rope(k, m["theta"])'}


def _qk_checkout(root: Path, reference: str):
    """A copy of the benchmark with the qk-norm family, its reference, a
    configuration (qwen3-8b at the smoke geometry), a mix and a cell added:
    new files only, and the cell in the index."""
    shutil.copytree(HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    base = root / "perfbench"
    (base / "arch" / "qknorm_decoder.py").write_text(QK_FAMILY)
    (base / "reference" / "qknorm_decoder.py").write_text(reference)
    cfg, pc = smoke_config("qwen3-8b")
    assert pc.qk_norm
    cfg.update(name="tiny-qknorm", arch="qknorm_decoder")
    (base / "configs" / "tiny-qknorm.json").write_text(json.dumps(cfg))
    mix = {"source": "a drop-in mix", "slots": 3, "max_seq": 48, "rate": 100.0,
           "judge": "tails", "prompt": {"dist": "uniform", "min": 5, "max": 30},
           "output": {"dist": "uniform", "min": 3, "max": 8}, "sizes_seed": 5,
           "check": {"requests": 8}, "trace": {"warm_s": 0.02, "profile_s": 0.02}}
    (base / "traffic" / "tiny-qk.json").write_text(json.dumps(mix))
    why = "a drop-in architecture"
    (base / "cells" / "tiny-qknorm.tiny-qk.json").write_text(json.dumps(
        {"config": "tiny-qknorm", "traffic": "tiny-qk", "why": why,
         "limits": {"max_logit_gap": 1e-4}}))
    index = json.loads((ROOT / "BENCHMARK.json").read_text())
    index["workloads"].append({"name": "tiny-qknorm.tiny-qk", "config": "tiny-qknorm",
                               "traffic": "tiny-qk", "chips": 1, "why": why})
    (root / "BENCHMARK.json").write_text(json.dumps(index))
    assert all(p.read_bytes() == b for p, b in before.items())      # nothing edited
    return load_cell("tiny-qknorm.tiny-qk", root)


def test_a_new_architecture_is_files_only(tmp_path):
    """A family, its reference, a configuration, a mix and a cell dropped in
    and nothing edited: the qk-norm engine (qwen3-8b at the smoke geometry)
    serves, on the CPU, tokens that its family's reference puts first, to
    1e-4.  The same cell judged by a reference that leaves the q/k norms
    out reads not correct, so the family's own reference decides.  The
    first family refuses this engine."""
    cell = _qk_checkout(tmp_path / "qk", QK_REFERENCE)
    m = model_shapes(cell.config, cell.base)
    assert m["arch"] == "qknorm_decoder"
    assert [n for n, _, _ in family(m).layer_leaves(m, 0)][-2:] == ["attn.q_norm",
                                                                  "attn.k_norm"]
    r = harness.run(cell, seed=2 ** 31 + 41, seconds=0.1, trace=False, t0=time.perf_counter(),
                    device="cpu")
    assert r["attempted"] > 3 and r["failed"] == 0
    assert r["correct"] and r["checks"]["max_logit_gap"]["value"] <= 1e-4

    toy = QK_REFERENCE
    for a, b in NO_QK_NORM.items():
        assert a in toy
        toy = toy.replace(a, b)
    cell = _qk_checkout(tmp_path / "toy", toy)
    r = harness.run(cell, seed=2 ** 31 + 41, seconds=0.1, trace=False, t0=time.perf_counter(),
                    device="cpu")
    assert r["attempted"] > 3 and r["failed"] == 0
    assert not r["correct"] and r["checks"]["max_logit_gap"]["value"] > 1e-4

    with pytest.raises(ValueError, match="q/k norms"):
        harness.port_config(dict(cell.config, arch="llama_style"))


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
