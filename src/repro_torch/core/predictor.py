"""ExecutionPredictor: decomposes a model step into a data-dependent
micro-workflow of operator events and predicts its runtime.

Key paper features implemented here:
- per-operator decomposition (qkv/attn/wo/ffn/gate/collectives) instead of a
  monolithic batch model;
- the MoE micro-workflow: gate GEMM -> pluggable routing module ->
  token-to-expert assignment map -> heterogeneous per-expert GroupedGEMM
  tasks per EP rank -> implicit synchronization barrier modeled as
  max[T_rank_1..T_rank_ep] (straggler effect);
- TP collectives (2 all-reduces per layer), EP all-to-alls, PP micro-batch
  pipelining at the replica level.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import (
    ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV, ModelConfig,
)
from repro_torch.core.hardware import HardwareSpec, ParallelismConfig
from repro_torch.core.opmodels.analytical import OperatorModelSet
from repro_torch.core.routing import BalancedRouting, RoutingModule, split_by_rank


@dataclass
class StepBreakdown:
    total: float = 0.0
    parts: Dict[str, float] = field(default_factory=dict)
    moe_straggler_excess: float = 0.0   # time lost to the max() barrier
    dropped_token_frac: float = 0.0

    def add(self, name: str, t: float) -> None:
        self.parts[name] = self.parts.get(name, 0.0) + t
        self.total += t


_CACHE_QUANTUM = 1.05   # geometric bucket ratio for memo-cache shape keys


_LOG_QUANTUM = math.log(_CACHE_QUANTUM)
_QTZ_MEMO: Dict[int, int] = {}


def _qtz(x: float) -> int:
    """Quantize a positive magnitude into ~5% geometric buckets.

    Memoized on the exact argument: cache-key construction is on the
    per-event hot path and token totals recur heavily, so the log()
    usually collapses to one dict probe.
    """
    v = _QTZ_MEMO.get(x)
    if v is None:
        v = int(x) if x <= 1 else int(round(math.log(x) / _LOG_QUANTUM))
        _QTZ_MEMO[x] = v
    return v


class ExecutionPredictor:
    def __init__(self, cfg: ModelConfig, par: ParallelismConfig,
                 hw: HardwareSpec, ops: OperatorModelSet, *,
                 routing: Optional[RoutingModule] = None,
                 engine_overhead: float = 2e-3,
                 seed: int = 0,
                 memoize: bool = True,
                 cache_size: int = 4096,
                 backend: str = "python",
                 device="cuda"):
        self.cfg = cfg
        self.par = par
        self.hw = hw
        self.ops = ops
        self.routing = routing or BalancedRouting()
        self.engine_overhead = engine_overhead
        if backend not in ("python", "numpy", "jit"):
            raise ValueError(f"predictor backend must be 'python', 'numpy' "
                             f"or 'jit', got {backend!r}")
        # cost-evaluation backend: "python" walks the operator graph per
        # call (exact parts breakdown, the default); "numpy"/"jit" price
        # cache-miss steps through the vectorized fused roofline kernel
        # (total only; falls back to python when the model/ops don't
        # vectorize — subclassed operator models or step walks.  MoE
        # models vectorize for every routing module: the batch path
        # consumes routing draws in the scalar call order)
        self.backend = backend
        # where backend="jit" evaluates its fused float32 roofline; read by
        # nothing else (the python and numpy backends are host arithmetic)
        self.device = device
        self._vec_supported: Optional[bool] = None
        self.rng = np.random.default_rng(seed)
        # step-time memoization: event-graph decode steps are expensive, and
        # serving batches recur in (quantized) shape — cache on the shape key
        # so finer-grained simulation does not regress simulator throughput.
        # Stochastic routers cycle over several cached draws per bucket so
        # the straggler distribution isn't collapsed to one sample.
        self._cache: Optional[OrderedDict] = OrderedDict() if memoize else None
        self._cache_size = cache_size
        self._cache_variants = 8 if self.routing.stochastic else 1
        # rotation counters live in an LRU-bounded map: million-request
        # runs see unboundedly many distinct shape buckets, and the
        # counter must not leak one entry per bucket forever
        self._bucket_calls: "OrderedDict[Tuple, int]" = OrderedDict()
        self._bucket_calls_cap = max(8 * cache_size, 64)
        # per-(counts, ep) grouped-GEMM rank pricing memo (MoE hot path)
        self._gg_cache: OrderedDict = OrderedDict()
        self._gg_cache_size = max(cache_size // 4, 64)
        self.cache_hits = 0
        self.cache_misses = 0

    # -------------------------------------------------------------- caching --
    def _cache_key(self, q_lens: Sequence[int], kv_lens: Sequence[int],
                   decode: bool, n_prefill: Optional[int] = None) -> Tuple:
        sq, skv = int(sum(q_lens)), int(sum(kv_lens))
        mkv = int(max(kv_lens, default=0))
        base = (decode, len(q_lens), _qtz(sq), _qtz(skv), _qtz(mkv))
        if n_prefill is not None:
            # mixed chunked-prefill step: keyed apart from pure steps (the
            # tuple is longer, so mixed keys can never alias pure ones)
            base = base + ("mix", n_prefill)
        if self._cache_variants == 1:
            # deterministic routing: no rotation, no counter to maintain
            return base + (0,)
        # rotate stochastic-routing draws per bucket (not per call, which
        # would alias with periodic prefill/decode interleavings); evict
        # cold buckets alongside the step cache so the counter stays
        # bounded (a restarted bucket merely re-enters rotation at 0)
        calls = self._bucket_calls
        n = calls.get(base, 0)
        calls[base] = n + 1
        calls.move_to_end(base)
        if len(calls) > self._bucket_calls_cap:
            calls.popitem(last=False)
        return base + (n % self._cache_variants,)

    def _on_cache_hit(self, bd: "StepBreakdown") -> None:
        """Subclass hook: restore side-band state for a cached step."""

    # ------------------------------------------------------------ weights --
    def weight_bytes_per_device(self, dtype_bytes: int = 2) -> float:
        n = self.cfg.param_count()
        return dtype_bytes * n / max(self.par.tp * self.par.pp, 1)

    def kv_bytes_per_token(self) -> float:
        return self.kv_bytes_per_token_per_layer() * self.kv_layer_count()

    def kv_layer_count(self) -> int:
        """Attention layers holding KV — the chunk count for layer-wise
        streamed KV transfer (recurrent layers carry no paged KV)."""
        return sum(1 for k in self.cfg.pattern
                   if k in (ATTN_GLOBAL, ATTN_LOCAL))

    def kv_bytes_per_token_per_layer(self) -> float:
        cfg = self.cfg
        return 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2  # bf16 k+v

    # ------------------------------------------------------------- layers --
    def _attn_layer(self, kind: str, q_lens: Sequence[int],
                    kv_lens: Sequence[int], decode: bool,
                    bd: StepBreakdown,
                    n_prefill: Optional[int] = None) -> None:
        cfg, par, ops = self.cfg, self.par, self.ops
        tp = max(par.tp, 1)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, K = cfg.num_heads, cfg.num_kv_heads
        toks = sum(q_lens)
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0

        # projections (TP-sharded over heads)
        bd.add("qkv_gemm", ops.gemm(toks, (H + 2 * K) * hd // tp, d))
        if n_prefill is not None:
            # mixed chunked-prefill step: prefill-chunk rows run the prefill
            # attention kernel, piggybacked decode rows the decode kernel —
            # the fused batch shares every GEMM but not the attention math
            if n_prefill:
                bd.add("attn", ops.attention_prefill(
                    q_lens[:n_prefill], kv_lens[:n_prefill], H // tp,
                    max(K // tp, 1), hd, causal=True, window=window))
            if len(q_lens) > n_prefill:
                bd.add("attn", ops.attention_decode(
                    kv_lens[n_prefill:], H // tp, max(K // tp, 1), hd,
                    window=window))
        elif decode:
            bd.add("attn", ops.attention_decode(
                kv_lens, H // tp, max(K // tp, 1), hd, window=window))
        else:
            bd.add("attn", ops.attention_prefill(
                q_lens, kv_lens, H // tp, max(K // tp, 1), hd,
                causal=True, window=window))
        bd.add("o_gemm", ops.gemm(toks, d, H * hd // tp))
        bd.add("tp_coll", ops.all_reduce(2.0 * toks * d, tp))

    def _dense_ffn(self, toks: int, bd: StepBreakdown) -> None:
        cfg, tp, ops = self.cfg, max(self.par.tp, 1), self.ops
        n_mats = 3 if cfg.gated_mlp else 2
        bd.add("ffn_gemm", n_mats * ops.gemm(toks, cfg.d_ff // tp, cfg.d_model))
        bd.add("tp_coll", ops.all_reduce(2.0 * toks * cfg.d_model, tp))

    def _moe_ffn(self, toks: int, bd: StepBreakdown) -> None:
        """The MoE micro-workflow with straggler barrier."""
        cfg, ops = self.cfg, self.ops
        moe = cfg.moe
        ep = max(self.par.ep, 1)
        tp_in_expert = max(self.par.tp // ep, 1)
        E, k = moe.num_experts, moe.top_k

        # (1) gate GEMM
        bd.add("moe_gate", ops.gemm(toks, E, cfg.d_model))
        # (2) routing module -> assignment map
        counts = self.routing.assign(toks, E, k, self.rng)
        # capacity drops (same policy as models/moe.py)
        cap = math.ceil(moe.capacity_factor_eval * toks * k / E)
        kept = np.minimum(counts, cap)
        bd.dropped_token_frac = 1.0 - kept.sum() / max(counts.sum(), 1)
        # (3) dispatch all-to-all over EP group
        a2a_bytes = 2.0 * toks * k * cfg.d_model / ep
        bd.add("moe_a2a", ops.all_to_all(a2a_bytes, ep))
        # (4) heterogeneous per-rank GroupedGEMM tasks -> max() barrier
        n_mats = 3 if cfg.gated_mlp else 2
        t_max, t_mean = self._grouped_gemm_rank_stats(
            kept, ep, n_mats, cfg.d_model,
            moe.expert_d_ff // tp_in_expert)
        bd.add("moe_expert_gemm", t_max)
        bd.moe_straggler_excess += t_max - t_mean
        # (5) combine all-to-all + shared experts + TP reduce
        bd.add("moe_a2a", ops.all_to_all(a2a_bytes, ep))
        if moe.num_shared_experts:
            ff = moe.expert_d_ff * moe.num_shared_experts
            bd.add("ffn_gemm", n_mats * ops.gemm(
                toks, ff // max(self.par.tp, 1), cfg.d_model))
        if tp_in_expert > 1:
            bd.add("tp_coll", ops.all_reduce(2.0 * toks * cfg.d_model, tp_in_expert))

    def _grouped_gemm_rank_stats(self, kept: np.ndarray, ep: int,
                                 n_mats: int, d_in: int,
                                 d_out: int) -> Tuple[float, float]:
        """(straggler max, mean) of per-EP-rank GroupedGEMM times.

        Memoized on the exact kept-count histogram — routing draws recur
        heavily under capacity clipping, and replaying the per-rank walk
        per miss dominated MoE stepping.  Exact counts in the key keep
        every cached value bit-identical to an uncached evaluation (the
        variant-rotation scheme upstream already diversifies the draws
        feeding this cache).  For the base analytical model the per-rank
        loop itself collapses to one array expression; overridden
        grouped_gemm/_roof models keep the scalar loop.
        """
        key = (kept.tobytes(), ep, n_mats, d_in, d_out)
        hit = self._gg_cache.get(key)
        if hit is not None:
            self._gg_cache.move_to_end(key)
            return hit
        ops = self.ops
        from repro_torch.core.opmodels.batch import (analytic_roofline_hw,
                                               expert_rank_map,
                                               grouped_gemm_rank_times)
        hw3 = analytic_roofline_hw(ops)
        if hw3 is not None:
            rank_of = expert_rank_map(len(kept), ep)
            sums = np.bincount(rank_of, weights=kept, minlength=ep)
            groups = np.bincount(rank_of, minlength=ep)
            times = grouped_gemm_rank_times(
                hw3, sums, groups, d_in, d_out, n_mats).tolist()
        else:
            times = [n_mats * ops.grouped_gemm(list(rc), d_in, d_out)
                     for rc in split_by_rank(kept, ep)]
        # python-ordered mean: bit-identical to the historical walk
        out = (max(times), sum(times) / len(times))
        self._gg_cache[key] = out
        if len(self._gg_cache) > self._gg_cache_size:
            self._gg_cache.popitem(last=False)
        return out

    def _recurrent_layer(self, kind: str, toks: int, bd: StepBreakdown) -> None:
        cfg, ops, tp = self.cfg, self.ops, max(self.par.tp, 1)
        d = cfg.d_model
        if kind == RWKV:
            bd.add("rwkv_proj", 5 * ops.gemm(toks, d // tp, d))
            # sequential state update: memory-bound state traffic
            H, hs = d // cfg.rwkv_head_size, cfg.rwkv_head_size
            state_bytes = 4.0 * toks * H * hs * hs / tp
            bd.add("rwkv_scan", ops.membound(state_bytes))
            bd.add("rwkv_out", ops.gemm(toks, d, d // tp))
        else:  # RG-LRU
            bd.add("rglru_proj", 2 * ops.gemm(toks, d // tp, d))
            bd.add("rglru_gates", 2 * ops.gemm(toks, d // tp, d // tp))
            bd.add("rglru_scan", ops.membound(4.0 * toks * d / tp))
            bd.add("rglru_out", ops.gemm(toks, d, d // tp))
        bd.add("tp_coll", ops.all_reduce(2.0 * toks * d, tp))

    # -------------------------------------------------------------- steps --
    def step_time(self, q_lens: Sequence[int], kv_lens: Sequence[int], *,
                  decode: bool,
                  n_prefill: Optional[int] = None) -> StepBreakdown:
        """One full model step for a (micro-)batch on one PP stage set.

        q_lens: new tokens per request (1s for decode; prompt lens/chunks for
        prefill).  kv_lens: context lengths (== q_lens for fresh prefill).
        ``n_prefill`` marks a *mixed* chunked-prefill step: the first
        ``n_prefill`` rows are prefill chunks, the rest piggybacked decode
        tokens — attention is priced per class, GEMMs over the fused batch.

        Results are memoized on a quantized batch-shape key (~5% geometric
        buckets on token totals): two batches in the same bucket replay the
        cached breakdown instead of re-walking the operator graph.  With a
        stochastic router the cache holds 8 rotating draws per bucket, so
        straggler variance is subsampled, not collapsed; pass
        ``memoize=False`` for exact per-step sampling.
        """
        if self._cache is None:
            return self._price_step(q_lens, kv_lens, decode=decode,
                                    n_prefill=n_prefill)
        key = self._cache_key(q_lens, kv_lens, decode, n_prefill)
        bd = self._cache.get(key)
        if bd is not None:
            self._cache.move_to_end(key)
            self.cache_hits += 1
            self._on_cache_hit(bd)
            return bd
        self.cache_misses += 1
        bd = self._price_step(q_lens, kv_lens, decode=decode,
                              n_prefill=n_prefill)
        self._cache[key] = bd
        if len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return bd

    def _price_step(self, q_lens, kv_lens, *, decode: bool,
                    n_prefill: Optional[int]) -> StepBreakdown:
        """Cache-miss pricing: the configured backend when it can
        reproduce the scalar walk, else the exact python path."""
        if (self.backend != "python" and n_prefill is None
                and self._vectorized_ok()):
            from repro_torch.core.opmodels.batch import batch_step_totals
            total = float(batch_step_totals(
                self, [(q_lens, kv_lens)], decode=decode,
                backend=self.backend)[0])
            bd = StepBreakdown()
            if total:
                bd.add("step", total)   # coarse: no per-operator parts
            return bd
        return self._step_time_impl(q_lens, kv_lens, decode=decode,
                                    n_prefill=n_prefill)

    def _vectorized_ok(self) -> bool:
        if self._vec_supported is None:
            from repro_torch.core.opmodels.batch import supports_vectorized
            self._vec_supported = supports_vectorized(self)
        return self._vec_supported

    def step_time_batch(self, steps: Sequence[Tuple[Sequence[int],
                                                    Sequence[int]]],
                        *, decode: bool,
                        backend: Optional[str] = None) -> np.ndarray:
        """Per-step totals (seconds) for many batch shapes at once.

        ``steps`` is a sequence of ``(q_lens, kv_lens)`` pairs; the result
        is ``np.array([self.step_time(q, kv, decode=decode).total ...])``
        evaluated exactly (no memo-cache quantization).  With the
        ``numpy``/``jit`` backends the whole grid — MoE included, with
        routing draws consumed from ``self.rng`` in the scalar call
        order — prices through the fused roofline kernel in one shot;
        the ``python`` backend, and any model the kernel can't reproduce
        (subclassed operator models or step walks), walks the scalar
        path per step.
        """
        backend = backend or self.backend
        if backend != "python" and self._vectorized_ok():
            from repro_torch.core.opmodels.batch import batch_step_totals
            return batch_step_totals(self, steps, decode=decode,
                                     backend=backend)
        return np.array([self._step_time_impl(list(q), list(kv),
                                              decode=decode).total
                         for q, kv in steps])

    def _step_time_impl(self, q_lens: Sequence[int], kv_lens: Sequence[int],
                        *, decode: bool,
                        n_prefill: Optional[int] = None) -> StepBreakdown:
        cfg = self.cfg
        bd = StepBreakdown()
        toks = int(sum(q_lens))
        if toks == 0:
            return bd
        layers_per_stage = [len(cfg.pattern) // max(self.par.pp, 1)] * max(self.par.pp, 1)
        # embed + head (memory-bound lookups + final GEMM)
        bd.add("embed", self.ops.membound(2.0 * toks * cfg.d_model))
        for kind in cfg.pattern:
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                self._attn_layer(kind, q_lens, kv_lens, decode, bd,
                                 n_prefill=n_prefill)
                if cfg.moe is not None:
                    self._moe_ffn(toks, bd)
                else:
                    self._dense_ffn(toks, bd)
            else:
                self._recurrent_layer(kind, toks, bd)
                if kind == RECURRENT:
                    self._dense_ffn(toks, bd)
                # RWKV channel-mix counted inside rwkv ops via d_ff GEMMs:
                if kind == RWKV:
                    tp = max(self.par.tp, 1)
                    bd.add("ffn_gemm", 2 * self.ops.gemm(
                        toks, cfg.d_ff // tp, cfg.d_model))
        n_logits = len(q_lens) if not decode else toks
        bd.add("head", self.ops.gemm(n_logits, cfg.padded_vocab // max(self.par.tp, 1),
                                     cfg.d_model))
        # PP pipeline: with m microbatches the critical path is
        # (pp + m - 1)/m x the per-stage time; callers pass microbatches via
        # replica-level pipelining, here we fold the bubble factor.
        pp = max(self.par.pp, 1)
        if pp > 1:
            m = max(len(q_lens), 1)
            bd.total = bd.total * (pp + m - 1) / (m * pp) * pp
            bd.add("pp_p2p", self.ops.p2p(2.0 * toks * cfg.d_model,
                                          inter_node=True) * (pp - 1))
        bd.add("engine_overhead", self.engine_overhead)
        return bd

    # convenience wrappers -------------------------------------------------
    def prefill_time(self, prompt_lens: Sequence[int],
                     context_lens: Optional[Sequence[int]] = None) -> StepBreakdown:
        kv = list(context_lens) if context_lens is not None else list(prompt_lens)
        return self.step_time(list(prompt_lens), kv, decode=False)

    def decode_time(self, context_lens: Sequence[int]) -> StepBreakdown:
        return self.step_time([1] * len(context_lens), list(context_lens),
                              decode=True)
