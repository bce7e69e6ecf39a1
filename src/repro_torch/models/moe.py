"""Mixture-of-Experts layer on one device.

Port of ``repro/models/moe.py``'s single-device branch: a softmax router with
top-k gates, a capacity-padded dispatch (stable sort of the assignments by
expert, each expert's first ``C_e`` kept, the rest dropped GShard-style),
batched expert GEMMs, a gate-weighted combine, and the router's aux metrics.
Empty capacity slots point at a dump row past the real tokens, as in the
reference, so the scatters are ``index_put_`` and the combine ``index_add_``.
The expert-parallel branches (``shard_map``, all-to-all) wait for the
multi-device slice.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import PD, AxisRules, activation


def moe_pds(cfg: ModelConfig) -> Dict[str, PD]:
    moe = cfg.moe
    d, ff, E = cfg.d_model, moe.expert_d_ff, moe.num_experts
    p = {
        "router": PD((d, E), ("embed", None), 0.02),
        "w_in": PD((E, d, ff), ("expert", "embed", "mlp")),
        "w_out": PD((E, ff, d), ("expert", "mlp", "embed")),
    }
    if cfg.gated_mlp:
        p["w_gate"] = PD((E, d, ff), ("expert", "embed", "mlp"))
    return p


def _capacity(T_l: int, k: int, E: int, cf: float, *, train: bool) -> int:
    A = T_l * k
    if train:
        return max(1, math.ceil(cf * A / E))
    return min(A, max(16, math.ceil(cf * A / E)))


def _expert_ffn(cfg: ModelConfig, xb, w_in, w_gate, w_out):
    """xb (E,C,D) -> (E,C,D) via batched expert GEMMs."""
    act = activation(cfg.mlp_act)
    h = torch.bmm(xb, w_in)
    if cfg.gated_mlp:
        h = act(torch.bmm(xb, w_gate)) * h
    else:
        h = act(h)
    return torch.bmm(h, w_out)


def _dispatch_compute_combine(cfg: ModelConfig, x_flat, ids, gates,
                              w_in, w_gate, w_out, *, E: int, C_e: int):
    """Capacity dispatch -> expert FFN -> combine.

    x_flat (T, D); ids/gates (T, k).  Returns (y (T, D), kept scalar)."""
    T, D = x_flat.shape
    k = ids.shape[-1]
    A = T * k
    dev = x_flat.device
    le = ids.reshape(A)
    tok = torch.arange(A, device=dev) // k

    order = torch.sort(le, stable=True).indices          # by expert, stable
    s_le = le[order]
    s_tok = tok[order]
    s_gate = gates.reshape(A)[order]

    counts = torch.bincount(le, minlength=E)[:E]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(A, device=dev) - starts[s_le]
    valid = pos < C_e
    dump = E * C_e
    dst = torch.where(valid, s_le * C_e + pos, dump)

    # slot -> source token (T is the dump row of zeros) and slot -> gate;
    # every dropped assignment lands on the dump slot, cut off after
    slot_src = torch.full((dump + 1,), T, dtype=torch.long, device=dev)
    slot_src = slot_src.index_put_((dst,), s_tok)[:-1]
    slot_gate = torch.zeros((dump + 1,), dtype=gates.dtype, device=dev)
    slot_gate = slot_gate.index_put_((dst,), s_gate)[:-1]

    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, D))], dim=0)
    xb = x_pad[slot_src].reshape(E, C_e, D)
    yb = _expert_ffn(cfg, xb, w_in, w_gate, w_out).reshape(dump, D)
    yb = yb * slot_gate[:, None].to(yb.dtype)

    y = x_flat.new_zeros((T + 1, D)).index_add_(0, slot_src, yb)[:T]
    return y, valid.float().sum()


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor, ax: AxisRules, *,
              train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,S,D) -> (y (B,S,D), aux metrics incl. load-balance loss)."""
    moe = cfg.moe
    B, S, D = x.shape
    E, k = moe.num_experts, moe.top_k
    cf = moe.capacity_factor_train if train else moe.capacity_factor_eval

    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    gates = gates.to(x.dtype)

    # load-balance aux (switch-style) + router z-loss
    count_e = torch.zeros((E,), dtype=torch.float32, device=x.device)
    count_e = count_e.index_add_(0, ids.reshape(-1),
                                 torch.ones(ids.numel(), device=x.device))
    f_e = count_e / torch.clamp_min(count_e.sum(), 1.0)
    P_e = probs.reshape(-1, E).mean(dim=0)
    lb_loss = E * torch.sum(f_e * P_e)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    C_e = _capacity(B * S, k, E, cf, train=train)
    y, kept = _dispatch_compute_combine(
        cfg, x.reshape(B * S, D), ids.reshape(B * S, k), gates.reshape(B * S, k),
        p["w_in"], p.get("w_gate"), p["w_out"], E=E, C_e=C_e)
    aux = {
        "moe_lb_loss": lb_loss,
        "moe_z_loss": z_loss,
        "moe_drop_frac": 1.0 - kept / float(B * S * k),
        "moe_load_cv": torch.std(count_e, correction=0)
        / torch.clamp_min(torch.mean(count_e), 1e-9),
    }
    return y.reshape(B, S, D), aux
