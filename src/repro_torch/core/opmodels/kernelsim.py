"""Tile-level virtual-kernel simulator — the profiling ground truth.

The paper profiles CUDA kernels on A800s.  Without GPUs, we model kernel
execution at tile granularity and use it as ground truth for fitting and
evaluating the operator models (plus real CPU wall-clock measurements, see
calibration.py).  The model captures the phenomena the paper calls out:

- partitioning/tiling: a kernel is a grid of tiles (CTAs); each tile's time
  depends on its own work (per-request kv length, per-expert token count);
- wave quantization: tiles are list-scheduled onto n_cores; heterogeneous
  tile times create ragged tail waves;
- memory-vs-compute regimes per tile (decode attention and small-m expert
  GEMMs are bandwidth-bound).

GPU-profile (many SMs, wave effects) and TPU-profile (few sequential cores,
MXU-tile granularity) instances share the same machinery.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core.hardware import HardwareSpec


def _list_schedule(durs: Sequence[float], n_cores: int) -> float:
    """Greedy list scheduling (in submission order, like a HW dispatcher)."""
    if not len(durs):
        return 0.0
    cores = np.zeros(n_cores)
    for d in durs:
        i = int(np.argmin(cores))
        cores[i] += d
    return float(cores.max())


@dataclass
class VirtualKernels:
    hw: HardwareSpec
    bq: int = 128                 # query-block tile rows
    bk: int = 128                 # kv-block tile cols
    tile_n: int = 128             # GEMM tile N
    tile_m: int = 128             # GEMM tile M
    launch_overhead: float = 4e-6
    tile_overhead: float = 1.5e-7  # per-tile scheduling cost

    # ---- core tile timings -------------------------------------------------
    def _core_flops(self) -> float:
        return self.hw.peak_flops / self.hw.n_cores

    def _core_bw(self) -> float:
        return self.hw.hbm_bw / self.hw.n_cores

    # ---- FlashAttention (prefill) ------------------------------------------
    def attention_prefill(self, q_lens: Sequence[int], kv_lens: Sequence[int],
                          n_heads: int, n_kv_heads: int, head_dim: int, *,
                          causal: bool = True, window: int = 0) -> float:
        tiles: List[float] = []
        for q, kv in zip(q_lens, kv_lens):
            eff_kv = min(kv, window) if window else kv
            n_qblocks = math.ceil(q / self.bq)
            for qb in range(n_qblocks):
                # causal: q-block qb attends ~ (qb+1)*bq keys (+ window clip)
                span = min(eff_kv, (qb + 1) * self.bq) if causal else eff_kv
                n_kblocks = max(1, math.ceil(span / self.bk))
                flops = 4.0 * self.bq * self.bk * head_dim * n_kblocks
                byts = 2.0 * (self.bq * head_dim
                              + 2 * n_kblocks * self.bk * head_dim)
                t_tile = max(flops / self._core_flops(),
                             byts / self._core_bw()) + self.tile_overhead
                tiles.extend([t_tile] * n_heads)
        return self.launch_overhead + _list_schedule(tiles, self.hw.n_cores)

    # ---- FlashDecode ----------------------------------------------------------
    def attention_decode(self, context_lens: Sequence[int], n_heads: int,
                         n_kv_heads: int, head_dim: int, *,
                         window: int = 0, kv_split: int = 4) -> float:
        tiles: List[float] = []
        for kv in context_lens:
            eff = min(kv, window) if window else kv
            per_split = math.ceil(eff / kv_split)
            n_kblocks = max(1, math.ceil(per_split / self.bk))
            flops = 4.0 * self.bk * head_dim * n_kblocks
            # decode is KV-read bound: each split streams its KV slice
            t_tile = max(flops / self._core_flops(),
                         2.0 * 2 * per_split * head_dim / self._core_bw())
            t_tile += self.tile_overhead
            tiles.extend([t_tile] * (n_kv_heads * kv_split))
        return self.launch_overhead + _list_schedule(tiles, self.hw.n_cores)

    # ---- GroupedGEMM (MoE experts) -------------------------------------------
    def grouped_gemm(self, tokens_per_expert: Sequence[int], d_in: int,
                     d_out: int, dtype_bytes: int = 2) -> float:
        tiles: List[float] = []
        n_tiles_n = max(1, math.ceil(d_out / self.tile_n))
        for m_e in tokens_per_expert:
            if m_e <= 0:
                continue
            n_tiles_m = max(1, math.ceil(m_e / self.tile_m))
            # each (m,n) tile runs the full k-loop
            flops = 2.0 * self.tile_m * self.tile_n * d_in
            byts = dtype_bytes * (self.tile_m * d_in + self.tile_n * d_in
                                  + self.tile_m * self.tile_n)
            t_tile = max(flops / self._core_flops(),
                         byts / self._core_bw()) + self.tile_overhead
            tiles.extend([t_tile] * (n_tiles_m * n_tiles_n))
        return self.launch_overhead + _list_schedule(tiles, self.hw.n_cores)

    # ---- plain GEMM -------------------------------------------------------------
    def gemm(self, m: int, n: int, k: int, dtype_bytes: int = 2) -> float:
        return self.grouped_gemm([m], k, n, dtype_bytes)
