"""The port's Table-2 launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), on the CPU.

The predicted side is host code: given the same hardware profile, the same
decode floor and the same operator models (``calibrate`` off: analytical;
on: forests fitted against the virtual kernels), the port's ``predict``
must return the report that the reference's ``build_colocated`` +
``fixed_batch`` + ``sim.run`` returns, byte for byte.  The measured side is
held in kind: every request completes with its tokens (the tokens
themselves are held to the reference engine's by
``tests/test_torch_serving.py``)."""
import dataclasses
import json

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.hardware import HardwareSpec as RefHardwareSpec
from repro.core.hardware import ParallelismConfig as RefParallelismConfig
from repro.core.opmodels.refined import calibrate_refined as ref_calibrate_refined
from repro.core.workflows.colocated import build_colocated as ref_build_colocated
from repro.workload.generator import fixed_batch as ref_fixed_batch
from repro_torch.configs import get_config
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.opmodels.refined import calibrate_refined
from repro_torch.launch import serve

# a host-like profile, as ``measure_hardware`` returns one, fixed so both
# packages are handed the same numbers
HW = dict(name="cpu-host", peak_flops=3.1e11, hbm_bw=1.7e10,
          hbm_capacity=8e9, intra_node_bw=1.7e10, inter_node_bw=1.7e10,
          devices_per_node=1, n_cores=1, op_overhead=3e-5)
CELLS = [  # (arch, layers or None for the smoke depth, batch, prompt, output)
    ("qwen2-7b", None, 4, 32, 32),
    ("qwen2-7b", None, 2, 64, 12),
    ("mixtral-8x7b", 1, 3, 32, 16),
]


def _configs(arch, layers):
    cfg, rcfg = get_config(arch, smoke=True), ref_get_config(arch, smoke=True)
    if layers is not None:                 # a layer-cut config, as served
        cfg = dataclasses.replace(cfg, num_layers=layers)
        rcfg = dataclasses.replace(rcfg, num_layers=layers)
    return cfg, rcfg


def _ops(cfg, hw, fit, calibrate):
    if not calibrate:
        return None
    return fit(hw, n_heads=cfg.num_heads, n_kv_heads=cfg.num_kv_heads,
               head_dim=cfg.resolved_head_dim, n_samples=60)


@pytest.mark.parametrize("calibrate", [False, True], ids=["analytical", "refined"])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}x{c[3]}x{c[4]}")
def test_predict_equals_the_reference(cell, calibrate):
    arch, layers, batch, prompt, output = cell
    cfg, rcfg = _configs(arch, layers)
    hw, rhw = HardwareSpec(**HW), RefHardwareSpec(**HW)
    floor = 0.0123
    got = serve.predict(cfg, hw, floor, _ops(cfg, hw, calibrate_refined, calibrate),
                        batch=batch, prompt_len=prompt, output_len=output)
    sim = ref_build_colocated(rcfg, rhw, n_replicas=1,
                              par=RefParallelismConfig(tp=1),
                              ops=_ops(rcfg, rhw, ref_calibrate_refined, calibrate))
    for rep_w in sim.clusters["colocated"].replicas:
        rep_w.predictor.engine_overhead = floor
    want = sim.run(ref_fixed_batch(batch, prompt, output))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["n_completed"] == batch


def test_predict_without_a_floor_keeps_the_default_overhead():
    cfg, rcfg = _configs("qwen2-7b", None)
    got = serve.predict(cfg, HardwareSpec(**HW), None, None, batch=2,
                        prompt_len=32, output_len=8)
    sim = ref_build_colocated(rcfg, RefHardwareSpec(**HW), n_replicas=1,
                              par=RefParallelismConfig(tp=1))
    assert sim.clusters["colocated"].replicas[0].predictor.engine_overhead == 2e-3
    want = sim.run(ref_fixed_batch(2, 32, 8))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("arch,layers", [("qwen2-7b", None), ("mixtral-8x7b", 1)])
def test_measure_completes_every_request(arch, layers):
    cfg, _ = _configs(arch, layers)
    measured, floor, reqs, steps = serve.measure(cfg, batch=3, prompt_len=16,
                                                 output_len=5, max_seq=64,
                                                 device="cpu")
    assert [len(r.tokens) for r in reqs] == [5, 5, 5]
    assert measured["n_requests"] == 3 and measured["output_tokens"] == 15
    assert measured["decode_steps"] == 4
    # the measured pass's own entries: three prefills, four decodes
    assert [s["kind"] for s in steps].count("prefill") == 3
    assert [s["kind"] for s in steps].count("decode") == 4
    assert 0 < floor <= measured["duration_s"]


def test_run_on_the_cpu_completes_every_request():
    out = serve.run(batch=2, prompt_len=16, output_len=6, max_seq=64,
                    calibrate=False, device="cpu")
    m, p = out["measured"], out["predicted"]
    assert m["n_requests"] == 2 and m["output_tokens"] == 12
    assert p["n_completed"] == 2
    assert p["throughput_tok_s"] > 0 and m["throughput_tok_s"] > 0


def test_run_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this case needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(batch=1, prompt_len=16, output_len=2, max_seq=32)


def test_main_prints_the_reference_lines(capsys):
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "16",
                "--output-len", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("measured  : ") and out[1].startswith("predicted : ")
    assert out[2].startswith("relative error: ")
