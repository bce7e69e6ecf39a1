"""Shared pieces of the benchmark's own tests (``python -m pytest
perfbench/tests``): import paths, and a cell at the engine's smoke geometry
for runs on the CPU."""
import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def smoke_config(port_name: str, **changes) -> dict:
    """A ``llama_style`` configuration file's dict for the engine's smoke
    geometry of ``port_name``, with ``changes`` to the port's ModelConfig
    applied.  A sliding window is set to the smoke mix's slot length, as
    every cell's window is at least its slots' (no cell wraps the window's
    ring)."""
    import dataclasses
    from repro_torch.configs import get_config
    pc = get_config(port_name, smoke=True)
    if pc.sliding_window:
        changes.setdefault("sliding_window", 64)
    moe = changes.pop("moe", {})
    if pc.moe is not None and moe:
        changes["moe"] = dataclasses.replace(pc.moe, **moe)
    pc = dataclasses.replace(pc, **changes)
    cfg = {"name": pc.name, "arch": "llama_style", "port": {"name": port_name, "smoke": True},
           "dtype": "float32", "hidden_size": pc.d_model,
           "num_attention_heads": pc.num_heads, "num_key_value_heads": pc.num_kv_heads,
           "head_dim": pc.resolved_head_dim, "num_hidden_layers": pc.num_layers,
           "vocab_size": pc.vocab_size, "rope_theta": pc.rope_theta,
           "rms_norm_eps": pc.rms_eps, "max_position_embeddings": 4096,
           "intermediate_size": pc.moe.expert_d_ff if pc.moe else pc.d_ff,
           "serving": {"attention_window": pc.sliding_window}}
    if pc.moe is not None:
        cfg.update(num_local_experts=pc.moe.num_experts, num_experts_per_tok=pc.moe.top_k)
        cfg["serving"]["moe_capacity_factor"] = pc.moe.capacity_factor_eval
    return cfg, pc


def smoke_mix(**changes) -> dict:
    """An open loop of about six requests in a window of ``SMOKE_SECONDS``,
    more than the slots hold at once."""
    mix = {"source": "the smoke geometry", "slots": 4, "max_seq": 64, "rate": 20.0,
           "judge": "tails",
           "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.6, "min": 3, "max": 40},
           "output": {"dist": "uniform", "min": 4, "max": 12},
           "sizes_seed": 0, "check": {"requests": 4},
           "trace": {"warm_s": 0.05, "profile_s": 0.05}}
    mix.update(changes)
    return mix


SMOKE_SECONDS = 0.3


def smoke_cell(port_name: str, limit: float = 1e-3, **mix_changes):
    from perfbench.spec import Cell
    cfg, _ = smoke_config(port_name)
    with open(ROOT / "BENCHMARK.json") as f:
        index = json.load(f)
    return Cell(name=f"{port_name}.smoke", config=cfg, traffic=smoke_mix(**mix_changes),
                limits={"max_logit_gap": limit}, chips=1,
                end_to_end=index["end_to_end"], per_layer=index["per_layer"])


@pytest.fixture
def gpu():
    """Skips a test where there is no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
