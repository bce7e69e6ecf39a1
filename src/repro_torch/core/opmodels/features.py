"""Feature extraction for the refined operator models (paper §3.2).

Attention: aggregate AND distributional statistics of batch sequence
lengths (Vidur collapses these to a single sqrt proxy — exactly what loses
the heterogeneity information).  GroupedGEMM: token counts, expert counts,
model dims, selection ratio, and load-balance metrics (max/mean, CV,
entropy) per the paper.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

ATTN_FEATURE_NAMES = [
    "batch", "sum_len", "sum_len_sq", "max_len", "min_len", "mean_len",
    "std_len", "p50", "p90", "p99", "cv", "heads", "kv_heads", "head_dim",
    "causal", "window",
]


def attention_features(q_lens: Sequence[int], kv_lens: Sequence[int],
                       n_heads: int, n_kv_heads: int, head_dim: int, *,
                       causal: bool, window: int) -> np.ndarray:
    kv = np.asarray(kv_lens, np.float64)
    if window:
        kv = np.minimum(kv, window)
    q = np.asarray(q_lens, np.float64)
    work = q * kv  # per-request attention work proxy
    return np.array([
        len(kv),
        q.sum(),
        float((work).sum()),
        kv.max(initial=0.0),
        kv.min(initial=0.0),
        kv.mean() if len(kv) else 0.0,
        kv.std() if len(kv) else 0.0,
        float(np.percentile(kv, 50)) if len(kv) else 0.0,
        float(np.percentile(kv, 90)) if len(kv) else 0.0,
        float(np.percentile(kv, 99)) if len(kv) else 0.0,
        float(kv.std() / kv.mean()) if len(kv) and kv.mean() > 0 else 0.0,
        n_heads, n_kv_heads, head_dim,
        1.0 if causal else 0.0,
        float(window),
    ])


GG_FEATURE_NAMES = [
    "total_tokens", "n_experts", "n_active", "d_in", "d_out",
    "selection_ratio", "max_load", "mean_load", "load_cv", "load_entropy",
    "max_over_mean",
]


def grouped_gemm_features(tokens_per_expert: Sequence[int], d_in: int,
                          d_out: int) -> np.ndarray:
    c = np.asarray(tokens_per_expert, np.float64)
    total = c.sum()
    active = (c > 0).sum()
    mean = c.mean() if len(c) else 0.0
    p = c / total if total > 0 else np.full_like(c, 1.0 / max(len(c), 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = float(-(p[p > 0] * np.log(p[p > 0])).sum())
    return np.array([
        total, len(c), active, d_in, d_out,
        active / max(len(c), 1),
        c.max(initial=0.0), mean,
        float(c.std() / mean) if mean > 0 else 0.0,
        ent,
        float(c.max(initial=0.0) / mean) if mean > 0 else 0.0,
    ])
