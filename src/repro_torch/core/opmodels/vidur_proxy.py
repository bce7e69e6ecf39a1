"""Vidur-style sqrt-proxy operator model (the paper's comparison baseline).

Vidur collapses a heterogeneous batch of sequence lengths into a single
proxy length (the square root of the summed squared lengths spread over the
batch) and predicts runtime for the *homogenized* batch.  This is accurate
for uniform batches but loses tail/imbalance structure — the paper measures
>55% error on skewed FlashAttention batches (Fig. 2).

We give the proxy model the SAME ground-truth oracle (the virtual-kernel
simulator) the RF model is trained on, so the comparison isolates the
*workload representation*, exactly as in the paper.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from repro_torch.core.opmodels.kernelsim import VirtualKernels


class VidurProxyModel:
    def __init__(self, kernels: VirtualKernels):
        self.kernels = kernels

    def attention_prefill(self, q_lens: Sequence[int], kv_lens: Sequence[int],
                          n_heads: int, n_kv_heads: int, head_dim: int, *,
                          causal: bool = True, window: int = 0) -> float:
        kv = np.minimum(kv_lens, window) if window else np.asarray(kv_lens)
        q = np.asarray(q_lens, np.float64)
        # proxy: one homogenized batch at sqrt of mean squared length
        proxy = float(np.sqrt(np.mean(np.asarray(kv, np.float64) ** 2)))
        proxy = max(int(round(proxy)), 1)
        b = max(int(round(q.sum() / proxy)), 1)
        return self.kernels.attention_prefill(
            [proxy] * b, [proxy] * b, n_heads, n_kv_heads, head_dim,
            causal=causal, window=window)

    def attention_decode(self, context_lens: Sequence[int], n_heads: int,
                         n_kv_heads: int, head_dim: int, *,
                         window: int = 0) -> float:
        kv = np.minimum(context_lens, window) if window \
            else np.asarray(context_lens)
        proxy = float(np.sqrt(np.mean(np.asarray(kv, np.float64) ** 2)))
        proxy = max(int(round(proxy)), 1)
        return self.kernels.attention_decode(
            [proxy] * len(context_lens), n_heads, n_kv_heads, head_dim,
            window=window)

    def grouped_gemm(self, tokens_per_expert: Sequence[int], d_in: int,
                     d_out: int) -> float:
        """Vidur has no GroupedGEMM model (Table 1) — homogenized fallback."""
        c = np.asarray(tokens_per_expert, np.float64)
        mean = max(int(round(c.mean())), 1) if len(c) else 1
        return self.kernels.grouped_gemm([mean] * len(c), d_in, d_out)
