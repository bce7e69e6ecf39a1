"""Analytical (roofline) operator models + the OperatorModelSet interface.

This closed-form model is the "simplified roofline" baseline the paper
criticizes intra-framework simulators for (§2.2) — kept both as a fallback
and as the comparison point for the refined RF models.  Every operator time
is ``max(flops/peak, bytes/hbm_bw) + op_overhead``.

The refined models (attention_model.py / grouped_gemm_model.py) subclass
OperatorModelSet and override the two operators the paper targets.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.hardware import HardwareSpec


@dataclass
class GemmShape:
    m: int
    n: int
    k: int
    dtype_bytes: int = 2


class OperatorModelSet:
    """Interface queried by the ExecutionPredictor."""

    def __init__(self, hw: HardwareSpec):
        self.hw = hw

    # ---- dense algebra ----------------------------------------------------
    def gemm(self, m: int, n: int, k: int, dtype_bytes: int = 2) -> float:
        flops = 2.0 * m * n * k
        bytes_ = dtype_bytes * (m * k + k * n + m * n)
        return self._roof(flops, bytes_)

    # ---- attention ----------------------------------------------------------
    def attention_prefill(self, q_lens: Sequence[int], kv_lens: Sequence[int],
                          n_heads: int, n_kv_heads: int, head_dim: int,
                          causal: bool = True, window: int = 0) -> float:
        flops = 0.0
        bytes_ = 0.0
        for q, kv in zip(q_lens, kv_lens):
            eff_kv = min(kv, window) if window else kv
            pairs = q * eff_kv * (0.5 if causal and q == kv and not window else 1.0)
            flops += 4.0 * n_heads * head_dim * pairs
            bytes_ += 2.0 * (q * n_heads + 2 * eff_kv * n_kv_heads) * head_dim
        return self._roof(flops, bytes_)

    def attention_decode(self, context_lens: Sequence[int], n_heads: int,
                         n_kv_heads: int, head_dim: int,
                         window: int = 0) -> float:
        flops = 0.0
        bytes_ = 0.0
        for kv in context_lens:
            eff = min(kv, window) if window else kv
            flops += 4.0 * n_heads * head_dim * eff
            bytes_ += 2.0 * 2 * eff * n_kv_heads * head_dim  # KV read
        return self._roof(flops, bytes_)

    # ---- MoE ---------------------------------------------------------------
    def grouped_gemm(self, tokens_per_group: Sequence[int], d_in: int,
                     d_out: int, dtype_bytes: int = 2) -> float:
        """One grouped GEMM over expert groups on a single device."""
        flops = sum(2.0 * t * d_in * d_out for t in tokens_per_group)
        bytes_ = sum(dtype_bytes * (t * d_in + t * d_out)
                     for t in tokens_per_group)
        bytes_ += dtype_bytes * d_in * d_out * len(tokens_per_group)  # weights
        return self._roof(flops, bytes_)

    # ---- collectives ---------------------------------------------------------
    def all_reduce(self, nbytes: float, n: int, *, inter_node: bool = False) -> float:
        if n <= 1:
            return 0.0
        bw = self.hw.inter_node_bw if inter_node else self.hw.intra_node_bw
        return 2.0 * nbytes * (n - 1) / n / bw + self.hw.op_overhead

    def all_gather(self, nbytes: float, n: int, *, inter_node: bool = False) -> float:
        if n <= 1:
            return 0.0
        bw = self.hw.inter_node_bw if inter_node else self.hw.intra_node_bw
        return nbytes * (n - 1) / n / bw + self.hw.op_overhead

    def all_to_all(self, nbytes_per_device: float, n: int, *,
                   inter_node: bool = False) -> float:
        if n <= 1:
            return 0.0
        bw = self.hw.inter_node_bw if inter_node else self.hw.intra_node_bw
        return nbytes_per_device * (n - 1) / n / bw + self.hw.op_overhead

    def p2p(self, nbytes: float, *, inter_node: bool = True) -> float:
        bw = self.hw.inter_node_bw if inter_node else self.hw.intra_node_bw
        return nbytes / bw + self.hw.op_overhead

    def m2n(self, nbytes: float, m: int, n: int, *,
            inter_node: bool = True) -> float:
        """M2N dispatch/combine (m senders fan nbytes into n receivers).
        The flat baseline ignores the fan shape — exactly p2p — so callers
        switching from p2p to m2n stay bit-identical without a fabric;
        FabricOps overrides this with the NIC-lane-aware model."""
        return self.p2p(nbytes, inter_node=inter_node)

    # ---- helpers -------------------------------------------------------------
    def membound(self, nbytes: float) -> float:
        return nbytes / self.hw.hbm_bw + self.hw.op_overhead

    def _roof(self, flops: float, bytes_: float) -> float:
        return max(flops / self.hw.peak_flops, bytes_ / self.hw.hbm_bw) \
            + self.hw.op_overhead


class AnalyticalModels(OperatorModelSet):
    """Alias for clarity at call sites."""
