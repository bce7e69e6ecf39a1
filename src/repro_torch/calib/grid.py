"""Shape-grid sampling for calibration: deterministic heterogeneous-batch
grids derived from a model config's operator geometry and clamped to the
oracle's measurable domain.

Reuses the regime samplers in ``core/opmodels/calibration.py`` (uniform /
lognormal / skewed / bimodal length mixes, Zipf-like expert loads) — the
batch shapes the paper shows proxy models mis-price.  Train and eval
grids are drawn from disjoint seeds so the fidelity numbers are held-out
by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.opmodels.calibration import (
    sample_attention_batch, sample_grouped_gemm,
)


@dataclass
class AttentionSample:
    q_lens: List[int]
    kv_lens: List[int]
    decode: bool          # decode batches price via attention_decode

    @property
    def causal(self) -> bool:
        return not self.decode


@dataclass
class GroupedGemmSample:
    tokens_per_expert: List[int]


@dataclass
class CalibGrid:
    """The full sampling plan for one (model, hardware, oracle) triple."""
    geometry: Dict[str, int]                 # attention geometry
    moe_geometry: Optional[Dict[str, int]]   # None for dense models
    attn_train: List[AttentionSample] = field(default_factory=list)
    attn_eval: List[AttentionSample] = field(default_factory=list)
    gg_train: List[GroupedGemmSample] = field(default_factory=list)
    gg_eval: List[GroupedGemmSample] = field(default_factory=list)


def attention_grid(n: int, *, seed: int, max_len: int, max_batch: int,
                   decode_frac: float = 0.5) -> List[AttentionSample]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        decode = bool(rng.random() < decode_frac)
        q, kv = sample_attention_batch(rng, decode=decode, max_len=max_len,
                                       max_batch=max_batch)
        out.append(AttentionSample(q, kv, decode))
    return out


def grouped_gemm_grid(n: int, *, seed: int, n_experts: int, top_k: int,
                      d_in: int, d_out: int, max_tokens: int
                      ) -> List[GroupedGemmSample]:
    rng = np.random.default_rng(seed)
    return [GroupedGemmSample(sample_grouped_gemm(
        rng, n_experts=n_experts, top_k=top_k, d_in=d_in, d_out=d_out,
        max_tokens=max_tokens)) for _ in range(n)]


def geometry_of(cfg) -> Dict[str, int]:
    """The attention geometry the predictor prices with (tp=1 base)."""
    return {"n_heads": cfg.num_heads, "n_kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim}


def moe_geometry_of(cfg) -> Optional[Dict[str, int]]:
    if cfg.moe is None:
        return None
    return {"n_experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
            "d_in": cfg.d_model, "d_out": cfg.moe.expert_d_ff}


def build_grid(cfg, *, n_train: int, n_eval: int, seed: int,
               limits: Dict[str, int],
               max_len: Optional[int] = None,
               max_batch: Optional[int] = None) -> CalibGrid:
    """Train + held-out eval grids for one model config, clamped to the
    oracle's limits.  Eval seeds are offset so no sample is shared."""
    max_len = min(max_len or limits["max_len"], limits["max_len"])
    max_batch = min(max_batch or limits["max_batch"], limits["max_batch"])
    max_len = max(32, max_len)
    max_batch = max(1, max_batch)
    grid = CalibGrid(geometry=geometry_of(cfg),
                     moe_geometry=moe_geometry_of(cfg))
    grid.attn_train = attention_grid(n_train, seed=seed, max_len=max_len,
                                     max_batch=max_batch)
    grid.attn_eval = attention_grid(n_eval, seed=seed + 10_007,
                                    max_len=max_len, max_batch=max_batch)
    if grid.moe_geometry is not None:
        max_tokens = min(limits["max_tokens"],
                         max(128, max_batch * max_len))
        grid.gg_train = grouped_gemm_grid(
            n_train, seed=seed + 1, max_tokens=max_tokens,
            **grid.moe_geometry)
        grid.gg_eval = grouped_gemm_grid(
            n_eval, seed=seed + 10_009, max_tokens=max_tokens,
            **grid.moe_geometry)
    return grid
