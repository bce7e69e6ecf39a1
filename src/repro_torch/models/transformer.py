"""Block descriptors, decode caches and the train / prefill / decode forms of
every block kind.  Port of ``repro/models/transformer.py``.

Block kinds: "global"/"local" (attention + dense-or-MoE FFN), "rwkv"
(time-mix + channel-mix), "recurrent" (RG-LRU + MLP).  The reference scans
over stacked groups of layers; the port keeps one parameter module per layer
(``models/model.py``) and calls these functions layer by layer.

An attention block hands its layer's K/V wholly to ``models/attention.py``:
the projections, the decode cache entry (``cache_pds``) and its ring rule,
and the prefill that fills it (``attention_prefill``); this module calls only
attention's public functions.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV, ModelConfig,
)
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import PD, AxisRules, rms_norm

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac", "moe_load_cv")


def _zeros_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


# ---------------------------------------------------------------------------
# Param descriptors
# ---------------------------------------------------------------------------
def block_pds(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {
        "ln1": PD((d,), ("embed",), "zeros"),
        "ln2": PD((d,), ("embed",), "zeros"),
    }
    if cfg.post_block_norm:
        p["ln1_post"] = PD((d,), ("embed",), "zeros")
        p["ln2_post"] = PD((d,), ("embed",), "zeros")
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        p["attn"] = attn.attn_pds(cfg)
        if cfg.cross_attention:
            p["xattn"] = attn.attn_pds(cfg, cross=True)
            p["ln_x"] = PD((d,), ("embed",), "zeros")
        if cfg.moe is not None:
            p["moe"] = moe_mod.moe_pds(cfg)
            if cfg.moe.num_shared_experts:
                p["shared_mlp"] = mlp_mod.mlp_pds(
                    cfg, cfg.moe.expert_d_ff * cfg.moe.num_shared_experts)
        else:
            p["mlp"] = mlp_mod.mlp_pds(cfg)
    elif kind == RWKV:
        p["tm"] = rwkv_mod.timemix_pds(cfg)
        p["cm"] = rwkv_mod.channelmix_pds(cfg)
    elif kind == RECURRENT:
        p["rec"] = rglru_mod.rglru_pds(cfg)
        p["mlp"] = mlp_mod.mlp_pds(cfg)
    else:
        raise ValueError(kind)
    return p


def block_cache_pds(cfg: ModelConfig, kind: str, batch: int, seq: int,
                    memory_len: int = 0) -> Dict[str, Any]:
    d = cfg.d_model
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        return attn.cache_pds(cfg, batch, cfg.kv_cache_len(seq, kind),
                              memory_len if cfg.cross_attention else 0)
    if kind == RWKV:
        H, hs = d // cfg.rwkv_head_size, cfg.rwkv_head_size
        return {
            "tm_shift": PD((batch, d), ("batch", "embed"), "zeros"),
            "cm_shift": PD((batch, d), ("batch", "embed"), "zeros"),
            "state": PD((batch, H, hs, hs), ("batch", "heads", None, None),
                        "zeros", torch.float32),
        }
    if kind == RECURRENT:
        W = cfg.conv1d_width
        return {
            "conv_tail": PD((batch, W - 1, d), ("batch", None, "mlp"), "zeros"),
            "h": PD((batch, d), ("batch", "mlp"), "zeros", torch.float32),
        }
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _ffn_train(cfg, p, h, ax, *, train: bool):
    if cfg.moe is not None:
        y, aux = moe_mod.moe_apply(cfg, p["moe"], h, ax, train=train)
        if cfg.moe.num_shared_experts:
            y = y + mlp_mod.mlp_apply(cfg, p["shared_mlp"], h, ax)
        return y, aux
    return mlp_mod.mlp_apply(cfg, p["mlp"], h, ax), _zeros_aux(h.device)


def _post(cfg, p, name, y):
    if cfg.post_block_norm:
        return rms_norm(y, p[name], cfg.rms_eps, zero_centered=True)
    return y


def _norm(cfg, p, name, x):
    return rms_norm(x, p[name], cfg.rms_eps, zero_centered=True)


def _rwkv_full(cfg, p, x, ax):
    """Time-mix + channel-mix over a whole sequence from a zero state (and
    zero token shifts).  Returns (x_out, decode cache entry)."""
    B, _, d = x.shape
    H, hs = d // cfg.rwkv_head_size, cfg.rwkv_head_size
    zeros = ax.replicated(torch.zeros((B, d), dtype=x.dtype, device=x.device))
    y, tm_shift, state = rwkv_mod.timemix_apply(
        cfg, p["tm"], _norm(cfg, p, "ln1", x), ax, prev_shift=zeros,
        prev_state=ax.replicated(torch.zeros((B, H, hs, hs), dtype=torch.float32,
                                             device=x.device)))
    x = x + y
    y, cm_shift = rwkv_mod.channelmix_apply(
        cfg, p["cm"], _norm(cfg, p, "ln2", x), ax, prev_shift=zeros)
    return x + y, {"tm_shift": tm_shift, "cm_shift": cm_shift, "state": state}


def _recurrent_full(cfg, p, x, ax):
    B, _, d = x.shape
    y, tail, hlast = rglru_mod.rglru_apply(
        cfg, p["rec"], _norm(cfg, p, "ln1", x), ax,
        conv_tail=ax.replicated(torch.zeros((B, cfg.conv1d_width - 1, d),
                                            dtype=x.dtype, device=x.device)),
        h0=ax.replicated(torch.zeros((B, d), dtype=torch.float32, device=x.device)))
    x = x + y
    x = x + mlp_mod.mlp_apply(cfg, p["mlp"], _norm(cfg, p, "ln2", x), ax)
    return x, {"conv_tail": tail, "h": hlast}


def block_train(cfg: ModelConfig, kind: str, p, x, ax: AxisRules, *,
                causal: bool = True, train: bool = True,
                memory: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence block forward (no cache)."""
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        a = attn.attention_train(cfg, p["attn"], _norm(cfg, p, "ln1", x), ax,
                                 window=window, causal=causal)
        x = x + _post(cfg, p, "ln1_post", a)
        if memory is not None:
            x = x + attn.attention_train(cfg, p["xattn"], _norm(cfg, p, "ln_x", x),
                                         ax, memory=memory)
        f, aux = _ffn_train(cfg, p, _norm(cfg, p, "ln2", x), ax, train=train)
        return x + _post(cfg, p, "ln2_post", f), aux
    if kind == RWKV:
        return _rwkv_full(cfg, p, x, ax)[0], _zeros_aux(x.device)
    if kind == RECURRENT:
        return _recurrent_full(cfg, p, x, ax)[0], _zeros_aux(x.device)
    raise ValueError(kind)


def block_prefill(cfg: ModelConfig, kind: str, p, x, ax: AxisRules, *,
                  memory: Optional[torch.Tensor] = None, cache_len: int = 0,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward that also produces the decode cache entry for this block
    (attention's from ``attention.attention_prefill``)."""
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        a, cache = attn.attention_prefill(cfg, p["attn"], _norm(cfg, p, "ln1", x),
                                          ax, window=window, cache_len=cache_len)
        x = x + _post(cfg, p, "ln1_post", a)
        if memory is not None:
            a, xcache = attn.attention_prefill(
                cfg, p["xattn"], _norm(cfg, p, "ln_x", x), ax, memory=memory)
            x = x + a
            cache.update(xcache)
        f, _ = _ffn_train(cfg, p, _norm(cfg, p, "ln2", x), ax, train=False)
        return x + _post(cfg, p, "ln2_post", f), cache
    if kind == RWKV:
        return _rwkv_full(cfg, p, x, ax)
    if kind == RECURRENT:
        return _recurrent_full(cfg, p, x, ax)
    raise ValueError(kind)


def block_decode(cfg: ModelConfig, kind: str, p, x, cache, pos, ax: AxisRules,
                 donate: bool = False,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step.  x (B,1,D); pos an int or (B,) positions.
    ``donate``: the caller hands its cache over, and self-attention may write
    its entry in place (``attention.attention_decode``)."""
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        a, kv_cache = attn.attention_decode(
            cfg, p["attn"], _norm(cfg, p, "ln1", x),
            {"k": cache["k"], "v": cache["v"]}, pos, ax, window=window,
            donate=donate)
        x = x + _post(cfg, p, "ln1_post", a)
        new_cache = dict(cache)
        new_cache.update(kv_cache)
        if cfg.cross_attention and "xk" in cache:
            a, _ = attn.attention_decode(cfg, p["xattn"], _norm(cfg, p, "ln_x", x),
                                         {}, pos, ax,
                                         memory_kv=(cache["xk"], cache["xv"]))
            x = x + a
        f, _ = _ffn_train(cfg, p, _norm(cfg, p, "ln2", x), ax, train=False)
        return x + _post(cfg, p, "ln2_post", f), new_cache
    if kind == RWKV:
        y, tm_shift, state = rwkv_mod.timemix_decode(
            cfg, p["tm"], _norm(cfg, p, "ln1", x), ax,
            prev_shift=cache["tm_shift"], prev_state=cache["state"])
        x = x + y
        y, cm_shift = rwkv_mod.channelmix_apply(
            cfg, p["cm"], _norm(cfg, p, "ln2", x), ax,
            prev_shift=cache["cm_shift"])
        return x + y, {"tm_shift": tm_shift, "cm_shift": cm_shift, "state": state}
    if kind == RECURRENT:
        y, tail, hlast = rglru_mod.rglru_decode(
            cfg, p["rec"], _norm(cfg, p, "ln1", x), ax,
            conv_tail=cache["conv_tail"], h0=cache["h"])
        x = x + y
        x = x + mlp_mod.mlp_apply(cfg, p["mlp"], _norm(cfg, p, "ln2", x), ax)
        return x, {"conv_tail": tail, "h": hlast}
    raise ValueError(kind)
