"""Refined operator model set: RF-backed Attention + GroupedGEMM, wired
into the OperatorModelSet interface the ExecutionPredictor consumes.

This is Frontier's §3.2 model: fine-grained, feature-rich, per-(operator,
model, hardware) fitted predictors, with the analytical roofline as the
fallback for operators outside the fitted domain.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.opmodels.analytical import OperatorModelSet
from repro_torch.core.opmodels.calibration import (
    FittedAttention, FittedGroupedGemm, fit_attention_model,
    fit_grouped_gemm_model,
)
from repro_torch.core.opmodels.kernelsim import VirtualKernels


class RefinedModels(OperatorModelSet):
    def __init__(self, hw: HardwareSpec, *,
                 attention: Optional[FittedAttention] = None,
                 grouped: Optional[FittedGroupedGemm] = None,
                 kernels: Optional[VirtualKernels] = None):
        super().__init__(hw)
        self.attention = attention
        self.grouped = grouped
        self.kernels = kernels or VirtualKernels(hw)

    # GEMM: virtual-kernel model (tile/wave-aware) instead of pure roofline
    def gemm(self, m, n, k, dtype_bytes: int = 2) -> float:
        return self.kernels.gemm(m, n, k, dtype_bytes)

    def attention_prefill(self, q_lens, kv_lens, n_heads, n_kv_heads,
                          head_dim, causal=True, window=0) -> float:
        if self.attention is not None and \
                (n_heads, n_kv_heads, head_dim) == (self.attention.n_heads,
                                                    self.attention.n_kv_heads,
                                                    self.attention.head_dim):
            return self.attention.predict(q_lens, kv_lens, causal=causal,
                                          window=window)
        return self.kernels.attention_prefill(q_lens, kv_lens, n_heads,
                                              n_kv_heads, head_dim,
                                              causal=causal, window=window)

    def attention_decode(self, context_lens, n_heads, n_kv_heads, head_dim,
                         window=0) -> float:
        if self.attention is not None and \
                (n_heads, n_kv_heads, head_dim) == (self.attention.n_heads,
                                                    self.attention.n_kv_heads,
                                                    self.attention.head_dim):
            return self.attention.predict([1] * len(context_lens),
                                          context_lens, causal=False,
                                          window=window)
        return self.kernels.attention_decode(context_lens, n_heads,
                                             n_kv_heads, head_dim,
                                             window=window)

    def grouped_gemm(self, tokens_per_group, d_in, d_out,
                     dtype_bytes: int = 2) -> float:
        if self.grouped is not None and (d_in, d_out) == (self.grouped.d_in,
                                                          self.grouped.d_out):
            return self.grouped.predict(tokens_per_group)
        return self.kernels.grouped_gemm(tokens_per_group, d_in, d_out,
                                         dtype_bytes)


def calibrate_refined(hw: HardwareSpec, *, n_heads: int, n_kv_heads: int,
                      head_dim: int, moe_dims=None, n_samples: int = 500,
                      seed: int = 0) -> RefinedModels:
    """Fit RF models against the virtual-kernel ground truth for one model
    config on one hardware profile (the paper's per-model profiling flow)."""
    vk = VirtualKernels(hw)
    attn, _ = fit_attention_model(
        lambda q, kv, H, K, hd, causal, window: (
            vk.attention_prefill(q, kv, H, K, hd, causal=causal, window=window)
            if any(x > 1 for x in q) else
            vk.attention_decode(kv, H, K, hd, window=window)),
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        n_samples=n_samples, seed=seed)
    grouped = None
    if moe_dims is not None:
        n_experts, top_k, d_in, d_out = moe_dims
        grouped, _ = fit_grouped_gemm_model(
            lambda c, di, do: vk.grouped_gemm(c, di, do),
            n_experts=n_experts, top_k=top_k, d_in=d_in, d_out=d_out,
            n_samples=n_samples, seed=seed)
    return RefinedModels(hw, attention=attn, grouped=grouped, kernels=vk)
