"""Dense FFN: gated (SwiGLU/GeGLU) or plain two-layer, megatron TP over d_ff.
Port of ``repro/models/mlp.py``."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import PD, AxisRules, activation


def mlp_pds(cfg: ModelConfig, d_ff: int | None = None) -> Dict[str, PD]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p = {
        "w_in": PD((d, ff), ("embed", "mlp")),
        "w_out": PD((ff, d), ("mlp", "embed")),
    }
    if cfg.gated_mlp:
        p["w_gate"] = PD((d, ff), ("embed", "mlp"))
    return p


def mlp_apply(cfg: ModelConfig, p, x: torch.Tensor, ax: AxisRules) -> torch.Tensor:
    act = activation(cfg.mlp_act)
    h = x @ p["w_in"]
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    h = ax.constrain(h, "batch", None, "mlp")
    return ax.constrain(h @ p["w_out"], "batch", None, "embed")
