"""RG-LRU recurrent block (Griffin / recurrentgemma, arXiv:2402.19427).

Port of ``repro/models/rglru.py``:
    y = W_out( GeLU(W_gate x)  *  RG-LRU( conv1d( W_x x ) ) )
with the per-channel f32 recurrence
    a_t = exp(-c * softplus(lam) * r_t),
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t).
The temporal conv1d keeps a (width-1)-token tail as decode state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import PD, AxisRules, activation

_gelu = activation("gelu")


def rglru_pds(cfg: ModelConfig) -> Dict[str, PD]:
    d = cfg.d_model
    w = cfg.conv1d_width
    return {
        "w_x": PD((d, d), ("embed", "mlp")),
        "w_gate": PD((d, d), ("embed", "mlp")),
        "conv_w": PD((w, d), (None, "mlp"), 0.02),
        "conv_b": PD((d,), ("mlp",), "zeros"),
        "w_r": PD((d, d), ("mlp", "mlp")),
        "b_r": PD((d,), ("mlp",), "zeros"),
        "w_i": PD((d, d), ("mlp", "mlp")),
        "b_i": PD((d,), ("mlp",), "zeros"),
        "lam": PD((d,), ("mlp",), 0.5),      # lambda (softplus'd)
        "w_out": PD((d, d), ("mlp", "embed")),
    }


def _conv1d(u, w, b, tail):
    """Causal depthwise conv.  u (B,T,D); tail (B,W-1,D) from previous chunk."""
    W = w.shape[0]
    T = u.shape[1]
    ext = torch.cat([tail, u], dim=1)                  # (B, T+W-1, D)
    out = torch.zeros_like(u)
    for i in range(W):
        out = out + ext[:, i:i + T, :] * w[W - 1 - i]
    new_tail = ext[:, -(W - 1):, :] if W > 1 else tail
    return out + b, new_tail


def _gates(p, u):
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_r"].float() + p["b_r"].float())
    i = torch.sigmoid(uf @ p["w_i"].float() + p["b_i"].float())
    c = 8.0
    a = torch.exp(-c * F.softplus(p["lam"].float()) * r)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12)) * (i * uf)
    return a, gated_in


def rglru_apply(cfg: ModelConfig, p, x, ax: AxisRules, *,
                conv_tail, h0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence recurrent block.  Returns (y, new_conv_tail, h_last)."""
    gate = _gelu(x @ p["w_gate"])
    u = ax.constrain(x @ p["w_x"], "batch", None, "mlp")
    u, new_tail = _conv1d(u, p["conv_w"], p["conv_b"], conv_tail)
    a, gin = _gates(p, u)                               # (B,T,D) f32
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + gin[:, t]
        hs.append(h)
    hseq = ax.constrain(torch.stack(hs, dim=1).to(x.dtype), "batch", None, "mlp")
    return ax.constrain((gate * hseq) @ p["w_out"], "batch", None, "embed"), \
        new_tail, h


def rglru_decode(cfg: ModelConfig, p, x, ax: AxisRules, *,
                 conv_tail, h0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token step.  x (B,1,D); conv_tail (B,W-1,D); h0 (B,D)."""
    gate = _gelu(x @ p["w_gate"])
    u = x @ p["w_x"]
    ext = torch.cat([conv_tail, u], dim=1)              # (B,W,D)
    # ext[:, -1] is the current token and pairs with conv_w[0] (the
    # full-sequence path pairs w[j] with u_{t-j}), hence the flip
    conv = torch.einsum("bwd,wd->bd", ext, torch.flip(p["conv_w"], [0])) + p["conv_b"]
    a, gin = _gates(p, conv[:, None, :])
    h = a[:, 0] * h0.float() + gin[:, 0]
    y = ((gate[:, 0] * h.to(x.dtype)) @ p["w_out"])[:, None]
    return ax.constrain(y, "batch", None, "embed"), ext[:, 1:, :], h
