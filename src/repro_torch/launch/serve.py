"""End-to-end serving: the real MiniEngine on a model, its measured
throughput against the Frontier simulator's prediction (the paper's
Table-2 protocol).

    python -m repro_torch.launch.serve                  # on the card
    python -m repro_torch.launch.serve --device cpu     # smoke model, CPU

``run`` is the reference's ``run`` with its defaults (the smoke geometry,
f32, ``calibrate`` fitting virtual-kernel forests); ``device``, ``smoke``,
``dtype`` and ``eager`` are the port's.  The engine replays its steps from
CUDA graphs on the card, as the reference's runs jitted steps; ``eager=True``
runs them uncaptured, for a comparison.  Its two halves are public, so a
caller can measure a full-width or layer-cut config and price it from other
operator models: :func:`measure` serves a warm pass and a measured pass,
and :func:`predict` simulates the same fixed batch on a colocated tp=1
deployment built from the config itself (``build_colocated``, so a config
with fewer layers is priced as it is served).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import HardwareSpec, ParallelismConfig
from repro_torch.core.opmodels.calibration import measure_hardware
from repro_torch.core.opmodels.refined import calibrate_refined
from repro_torch.core.workflows.colocated import build_colocated
from repro_torch.serving.engine import MiniEngine, ServeRequest
from repro_torch.workload.generator import fixed_batch


def measure(cfg: ModelConfig, *, batch: int, prompt_len: int,
            output_len: int, max_seq: int, seed: int = 0,
            device="cuda", dtype=torch.float32, options=None, eager=False
            ) -> Tuple[Dict[str, float], float, List[ServeRequest], List[Dict]]:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens twice on one
    ``MiniEngine`` (random weights from ``seed``): a warm pass, which
    captures the steps' graphs on the card, then the measured pass.  Returns
    the measured pass's report, its decode floor (the fastest decode step,
    in seconds), its requests and its ``step_log`` entries."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len) for _ in range(batch)]

    engine = MiniEngine(cfg, max_slots=batch, max_seq=max_seq, seed=seed,
                        dtype=dtype, device=device, options=options,
                        eager=eager)
    engine.submit(list(prompts), output_len)
    engine.run()                      # warm pass
    engine.step_log.clear()
    requests = engine.submit(list(prompts), output_len)
    measured = engine.run()           # steady-state measurement
    step_floor = min(s["dur"] for s in engine.step_log
                     if s["kind"] == "decode")
    return measured, step_floor, requests, engine.step_log


def predict(cfg: ModelConfig, hw: HardwareSpec, step_floor: Optional[float],
            ops, *, batch: int, prompt_len: int,
            output_len: int) -> Dict[str, Any]:
    """The simulator's report for the measured batch on one tp=1 replica of
    ``cfg`` on ``hw``, priced by ``ops`` (``None``: the analytical models).
    ``step_floor`` becomes every replica's ``engine_overhead`` (the
    reference's calibration of the per-step floor); ``None`` keeps the
    predictor's default."""
    sim = build_colocated(cfg, hw, n_replicas=1,
                          par=ParallelismConfig(tp=1), ops=ops)
    if step_floor is not None:
        for rep_w in sim.clusters["colocated"].replicas:
            rep_w.predictor.engine_overhead = step_floor
    return sim.run(fixed_batch(batch, prompt_len, output_len))


def run(arch: str = "qwen2-7b", *, batch: int = 4, prompt_len: int = 32,
        output_len: int = 32, max_seq: int = 256, seed: int = 0,
        calibrate: bool = True, device="cuda", smoke: bool = True,
        dtype=torch.float32, eager=False):
    cfg = get_config(arch, smoke=smoke)
    measured, step_floor, _, _ = measure(
        cfg, batch=batch, prompt_len=prompt_len, output_len=output_len,
        max_seq=max_seq, seed=seed, device=device, dtype=dtype, eager=eager)
    hw = measure_hardware(device)
    ops = (calibrate_refined(hw, n_heads=cfg.num_heads,
                             n_kv_heads=cfg.num_kv_heads,
                             head_dim=cfg.resolved_head_dim,
                             n_samples=200)
           if calibrate else None)
    # calibration (paper flow): the engine's steady-state per-step floor on
    # THIS hardware feeds the predictor; at smoke scale the step is
    # dispatch/framework dominated, which operator models must carry.
    predicted = predict(cfg, hw, step_floor, ops, batch=batch,
                        prompt_len=prompt_len, output_len=output_len)
    return {"measured": measured, "predicted": predicted}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--output-len", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; nothing steps down")
    a = ap.parse_args(argv)
    out = run(a.arch, batch=a.batch, prompt_len=a.prompt_len,
              output_len=a.output_len, device=a.device)
    m, p = out["measured"], out["predicted"]
    print(f"measured  : {m['throughput_tok_s']:.1f} tok/s "
          f"(ttft {m['ttft_mean_s']*1e3:.1f} ms)")
    print(f"predicted : {p['throughput_tok_s']:.1f} tok/s "
          f"(ttft {p['ttft_p50_s']*1e3:.1f} ms)")
    err = abs(p["throughput_tok_s"] - m["throughput_tok_s"]) / m["throughput_tok_s"]
    print(f"relative error: {err:.1%}")


if __name__ == "__main__":
    main()
