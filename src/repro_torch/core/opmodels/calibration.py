"""Calibration: sample operator workloads, fit RF models against a ground
truth (virtual kernels, or measured wall-clock of the plain PyTorch ops), and
evaluate relative-error CDFs — the paper's Fig. 2 protocol.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.opmodels.features import (
    attention_features, grouped_gemm_features,
)
from repro_torch.core.opmodels.forest import RandomForest
from repro_torch.core.opmodels.kernelsim import VirtualKernels


# ---------------------------------------------------------------------------
# Workload samplers (heterogeneous batches, incl. the skewed regimes that
# break proxy models)
# ---------------------------------------------------------------------------
def sample_attention_batch(rng: np.random.Generator, *, decode: bool,
                           max_len: int = 8192, max_batch: int = 128,
                           ) -> Tuple[List[int], List[int]]:
    b = int(rng.integers(1, max_batch + 1))
    regime = rng.choice(["uniform", "lognormal", "skewed", "bimodal"])
    if regime == "uniform":
        lens = rng.integers(16, max_len, b)
    elif regime == "lognormal":
        lens = np.clip(rng.lognormal(np.log(512), 1.0, b).astype(int), 16, max_len)
    elif regime == "bimodal":
        lens = np.where(rng.random(b) < 0.8,
                        rng.integers(16, 256, b),
                        rng.integers(max_len // 2, max_len, b))
    else:  # skewed: one giant + many small (the paper's 72-request example)
        lens = rng.integers(16, 128, b)
        lens[0] = int(rng.integers(max_len // 2, max_len))
    # clamp covers the skewed regime's fixed 16..128 draws when an oracle
    # caps max_len below 128 (CPU timing of the plain versions)
    lens = [min(int(x), max_len) for x in lens]
    if decode:
        return [1] * b, lens
    return lens, lens


def sample_grouped_gemm(rng: np.random.Generator, *, n_experts: int,
                        top_k: int, d_in: int, d_out: int,
                        max_tokens: int = 16384) -> List[int]:
    toks = int(rng.integers(min(64, max_tokens), max_tokens))
    alpha = float(rng.uniform(0.0, 2.0))
    ranks = np.arange(1, n_experts + 1, dtype=np.float64)
    p = ranks ** -alpha
    rng.shuffle(p)
    p /= p.sum()
    return [int(x) for x in rng.multinomial(toks * top_k, p)]


# ---------------------------------------------------------------------------
# Fitted models
# ---------------------------------------------------------------------------
@dataclass
class FittedAttention:
    forest: RandomForest
    n_heads: int
    n_kv_heads: int
    head_dim: int

    def predict(self, q_lens, kv_lens, *, causal: bool, window: int) -> float:
        x = attention_features(q_lens, kv_lens, self.n_heads,
                               self.n_kv_heads, self.head_dim,
                               causal=causal, window=window)
        return float(np.exp(self.forest.predict(x[None])[0]))


@dataclass
class FittedGroupedGemm:
    forest: RandomForest
    d_in: int
    d_out: int

    def predict(self, tokens_per_expert) -> float:
        x = grouped_gemm_features(tokens_per_expert, self.d_in, self.d_out)
        return float(np.exp(self.forest.predict(x[None])[0]))


def fit_attention_model(oracle: Callable, *, n_heads: int, n_kv_heads: int,
                        head_dim: int, n_samples: int = 600,
                        decode_frac: float = 0.5, max_len: int = 8192,
                        seed: int = 0, window: int = 0,
                        ) -> Tuple[FittedAttention, Dict[str, np.ndarray]]:
    """oracle(q_lens, kv_lens, heads, kv, hd, causal, window) -> seconds."""
    rng = np.random.default_rng(seed)
    X, y, held = [], [], []
    for i in range(n_samples):
        decode = rng.random() < decode_frac
        q, kv = sample_attention_batch(rng, decode=decode, max_len=max_len)
        t = oracle(q, kv, n_heads, n_kv_heads, head_dim,
                   causal=not decode, window=window)
        X.append(attention_features(q, kv, n_heads, n_kv_heads, head_dim,
                                    causal=not decode, window=window))
        y.append(math.log(max(t, 1e-9)))
        held.append((q, kv, decode, t))
    X, y = np.asarray(X), np.asarray(y)
    n_tr = int(0.8 * len(y))
    forest = RandomForest(seed=seed).fit(X[:n_tr], y[:n_tr])
    model = FittedAttention(forest, n_heads, n_kv_heads, head_dim)
    # held-out eval
    rel = []
    for (q, kv, decode, t) in held[n_tr:]:
        p = model.predict(q, kv, causal=not decode, window=window)
        rel.append(abs(p - t) / max(t, 1e-12))
    return model, {"rel_err": np.asarray(rel)}


def fit_grouped_gemm_model(oracle: Callable, *, n_experts: int, top_k: int,
                           d_in: int, d_out: int, n_samples: int = 500,
                           seed: int = 0,
                           ) -> Tuple[FittedGroupedGemm, Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    X, y, held = [], [], []
    for _ in range(n_samples):
        counts = sample_grouped_gemm(rng, n_experts=n_experts, top_k=top_k,
                                     d_in=d_in, d_out=d_out)
        t = oracle(counts, d_in, d_out)
        X.append(grouped_gemm_features(counts, d_in, d_out))
        y.append(math.log(max(t, 1e-9)))
        held.append((counts, t))
    X, y = np.asarray(X), np.asarray(y)
    n_tr = int(0.8 * len(y))
    forest = RandomForest(seed=seed).fit(X[:n_tr], y[:n_tr])
    model = FittedGroupedGemm(forest, d_in, d_out)
    rel = []
    for counts, t in held[n_tr:]:
        p = model.predict(counts)
        rel.append(abs(p - t) / max(t, 1e-12))
    return model, {"rel_err": np.asarray(rel)}


# ---------------------------------------------------------------------------
# Measured hardware profile and measured attention oracle (wall-clock of the
# plain PyTorch ops on an explicit device) -- used for the end-to-end
# validation against the real mini serving engine (Table 2 protocol).
# ---------------------------------------------------------------------------
def _time_op(fn: Callable, device, reps: int) -> float:
    """Mean seconds per call after one warm-up: CUDA events on the card,
    ``perf_counter`` on the CPU."""
    import torch
    device = torch.device(device)
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) * 1e-3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def measure_hardware(device="cuda", seed: int = 0) -> HardwareSpec:
    """Micro-benchmarked profile of ``device``: a 1024^2 f32 matmul for the
    peak rate and a 64 MiB scaled copy for the memory rate."""
    import torch
    device = torch.device(device)
    n = 1024
    a = torch.ones((n, n), dtype=torch.float32, device=device)
    peak = 2 * n ** 3 / _time_op(lambda: a @ a, device, 6)
    big = torch.ones((64 * 1024 * 1024 // 4,), dtype=torch.float32,
                     device=device)
    bw = 2 * big.numel() * 4 / _time_op(lambda: big * 1.0001, device, 6)
    cuda = device.type == "cuda"
    return HardwareSpec(
        name=torch.cuda.get_device_name(device) if cuda else "cpu-host",
        peak_flops=peak, hbm_bw=bw,
        hbm_capacity=(float(torch.cuda.get_device_properties(device)
                            .total_memory) if cuda else 8e9),
        intra_node_bw=bw, inter_node_bw=bw, devices_per_node=1, n_cores=1,
        op_overhead=3e-5)


def measure_cpu_hardware(seed: int = 0) -> HardwareSpec:
    return measure_hardware("cpu", seed)


def cpu_attention_oracle(reps: int = 3, device="cuda") -> Callable:
    """Wall-clock oracle running the plain attention on ``device`` (the name
    is the reference's; the card is the default here as everywhere)."""
    import torch
    from repro_torch.kernels import ref

    def oracle(q_lens, kv_lens, H, K, hd, causal=True, window=0):
        # one call per request (shapes kept small by the caller)
        total = 0.0
        for q_len, kv_len in zip(q_lens, kv_lens):
            q = torch.ones((1, int(q_len), H, hd), dtype=torch.float32,
                           device=device)
            k = torch.ones((1, int(kv_len), K, hd), dtype=torch.float32,
                           device=device)
            total += _time_op(
                lambda: ref.flash_attention_ref(q, k, k, causal=causal,
                                                window=window),
                device, reps)
        return total
    return oracle
