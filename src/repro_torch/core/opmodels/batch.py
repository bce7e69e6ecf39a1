"""Vectorized batch evaluation of the analytical step-time model.

The scalar :meth:`ExecutionPredictor.step_time` walks the layer pattern
per call, looping over per-request shapes in Python — fine for one step,
ruinous for thousands of candidate batches (sweeps, router cache probes,
bench cells).  This module evaluates the SAME closed-form roofline math
over whole arrays of ``(q_lens, kv_lens)`` batch shapes at once:

- every roofline operator (GEMM / attention / grouped-GEMM / membound)
  contributes one ``(flops, bytes)`` row per layer term, vectorized
  across the B steps;
- per-request attention reductions use one concatenation plus
  ``np.add.reduceat`` instead of B Python loops;
- MoE layers are first-class: routing draws are made through
  ``routing.assign`` per ``(step, layer)`` in the *identical call order*
  as the scalar walk (same ``pred.rng`` sequence), capacity clipping and
  the per-EP-rank GroupedGEMM straggler ``max()`` are array reductions,
  and the dispatch/combine all-to-alls are linear terms;
- the ``numpy`` backend replays the scalar walk's exact term-by-term
  accumulation order, so per-step totals are **bit-identical** to the
  Python path (every flop/byte tally is an exact small integer in
  float64); the ``jit`` backend stacks the roof rows — grouped-GEMM and
  dense alike — into one fused torch evaluation of
  ``sum_t mult_t * max(F_t/peak, B_t/bw)`` in float32 on the predictor's
  ``device`` (looser tolerance).

Only base analytical operator models vectorize: refined/subclassed model
sets may override arbitrary operators, and predictor subclasses (the AF
event graph) replace the step walk entirely.  :func:`supports_vectorized`
gates those cases; the predictor falls back to the scalar walk per step.
Any :class:`~repro_torch.core.routing.RoutingModule` is supported — stochastic
routers vectorize via pre-drawn count arrays with the draw sequence
preserved.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, RWKV
from repro_torch.core.opmodels.analytical import OperatorModelSet

#: methods whose analytical closed form the vectorizer replicates; any
#: override on the installed OperatorModelSet disables vectorization
_ANALYTICAL_METHODS = ("gemm", "attention_prefill", "attention_decode",
                       "grouped_gemm", "all_reduce", "all_to_all", "p2p",
                       "membound", "_roof")


def supports_vectorized(pred) -> bool:
    """True when ``batch_step_totals`` reproduces ``pred.step_time``.

    MoE models vectorize for every routing module: the batch path draws
    ``routing.assign`` per ``(step, layer)`` in the scalar call order, so
    the ``pred.rng`` sequence — and therefore every count array — is
    identical to the per-step walk.
    """
    from repro_torch.core.predictor import ExecutionPredictor
    if type(pred)._step_time_impl is not ExecutionPredictor._step_time_impl:
        return False                      # subclassed step walk (AF events)
    ops_t = type(pred.ops)
    return all(getattr(ops_t, m, None) is getattr(OperatorModelSet, m)
               for m in _ANALYTICAL_METHODS)


def expert_rank_map(n_experts: int, ep: int) -> np.ndarray:
    """Expert-index -> EP-rank map matching ``routing.split_by_rank``
    (contiguous shards; remainder experts spread over the first ranks)."""
    ep = max(int(ep), 1)
    base, rem = divmod(int(n_experts), ep)
    sizes = np.full(ep, base, np.int64)
    sizes[:rem] += 1
    return np.repeat(np.arange(ep), sizes)


def grouped_gemm_rank_times(ops, rank_sums, rank_groups, d_in: int,
                            d_out: int, n_mats: int,
                            dtype_bytes: int = 2) -> np.ndarray:
    """``[n_mats * ops.grouped_gemm(counts_r, d_in, d_out) for r]`` as one
    array expression over EP ranks.

    ``rank_sums[r]`` is the token total routed to rank ``r`` and
    ``rank_groups[r]`` its expert-group count.  Bit-identical to the
    scalar loop for the base analytical model because every flop/byte
    tally is an exact integer in float64 (products and sums below 2^53
    round nowhere).  ``ops`` may also be an array-like of per-rank
    ``(peak_flops, hbm_bw, op_overhead)`` triples via
    :func:`rank_hw_arrays` for heterogeneous expert clusters.
    """
    s = np.asarray(rank_sums, float)
    g = np.asarray(rank_groups, float)
    if isinstance(ops, tuple):
        peak, hbm, oh = ops
    else:
        hw = ops.hw
        peak, hbm, oh = hw.peak_flops, hw.hbm_bw, hw.op_overhead
    flops = 2.0 * d_in * d_out * s
    bytes_ = dtype_bytes * (d_in + d_out) * s + dtype_bytes * d_in * d_out * g
    return n_mats * (np.maximum(flops / peak, bytes_ / hbm) + oh)


def analytic_roofline_hw(ops) -> Optional[Tuple[float, float, float]]:
    """``(peak_flops, hbm_bw, op_overhead)`` when ``ops`` prices
    grouped-GEMMs with the base analytical roofline — unwrapping
    pure-delegating :class:`FabricOps` layers — else None (an overridden
    grouped_gemm/_roof must be called per rank)."""
    from repro_torch.core.fabric import FabricOps
    o = ops
    while isinstance(o, FabricOps):
        o = o.inner
    t = type(o)
    if (t.grouped_gemm is OperatorModelSet.grouped_gemm
            and t._roof is OperatorModelSet._roof):
        return o.hw.peak_flops, o.hw.hbm_bw, o.hw.op_overhead
    return None


class _Terms:
    """Ordered term accumulator translating the scalar ``bd.add`` sequence
    into vectorized rows.

    The ``numpy`` evaluation replays the terms in emission order —
    ``total += mult * (max(F/peak, B/bw) + oh)`` per roof row, linear
    terms verbatim — which reproduces the scalar walk's accumulation
    order exactly.  The ``jit`` evaluation stacks the roof rows into one
    fused float32 torch expression (order-free sum; float32 tolerance).
    """

    def __init__(self, B: int, hw):
        self._seq: List[tuple] = []       # ("roof", F, Bt, mult) | ("lin", a)
        self.hw = hw
        self._b = B

    def roof(self, flops, bytes_, mult: float = 1.0) -> None:
        self._seq.append((
            "roof",
            np.broadcast_to(np.asarray(flops, float), (self._b,)),
            np.broadcast_to(np.asarray(bytes_, float), (self._b,)),
            mult))

    def lin(self, arr) -> None:
        self._seq.append(("lin",
                          np.broadcast_to(np.asarray(arr, float),
                                          (self._b,))))

    def gemm(self, m, n: int, k: int, mult: float = 1.0,
             dtype_bytes: int = 2) -> None:
        m = np.asarray(m, float)
        self.roof(2.0 * m * n * k,
                  dtype_bytes * (m * k + k * n + m * n), mult)

    def membound(self, nbytes, mult: float = 1.0) -> None:
        # max(0/peak, b/hbm) + oh == b/hbm + oh: bitwise the scalar path
        self.roof(0.0, nbytes, mult)

    def all_reduce(self, nbytes, n: int) -> None:
        if n <= 1:
            return
        bw = self.hw.intra_node_bw
        self.lin(2.0 * np.asarray(nbytes, float) * (n - 1) / n / bw
                 + self.hw.op_overhead)

    def all_to_all(self, nbytes, n: int) -> None:
        if n <= 1:
            return
        bw = self.hw.intra_node_bw
        self.lin(np.asarray(nbytes, float) * (n - 1) / n / bw
                 + self.hw.op_overhead)

    def evaluate(self, backend: str, device="cuda") -> np.ndarray:
        hw = self.hw
        if backend == "jit":
            F = [t[1] for t in self._seq if t[0] == "roof"]
            if F:
                Bt = np.stack([t[2] for t in self._seq if t[0] == "roof"])
                mult = np.asarray([t[3] for t in self._seq
                                   if t[0] == "roof"], float)
                out = _fused_roofline(np.stack(F), Bt, mult, hw.peak_flops,
                                      hw.hbm_bw, device)
                out = out + mult.sum() * hw.op_overhead
                for t in self._seq:
                    if t[0] == "lin":
                        out = out + t[1]
                return out
        total = np.zeros(self._b)
        for t in self._seq:
            if t[0] == "roof":
                _, F, Bt, mult = t
                row = np.maximum(F / hw.peak_flops, Bt / hw.hbm_bw) \
                    + hw.op_overhead
                total = total + (row if mult == 1.0 else mult * row)
            else:
                total = total + t[1]
        return total


def _fused_roofline(F: np.ndarray, Bt: np.ndarray, mult: np.ndarray,
                    peak: float, hbm: float, device) -> np.ndarray:
    """``(mult[:, None] * maximum(F / peak, Bt / hbm)).sum(0)`` in float32 on
    ``device``; rows are roofline terms, columns are steps."""
    import torch
    f = torch.as_tensor(F, dtype=torch.float32, device=device)
    b = torch.as_tensor(Bt, dtype=torch.float32, device=device)
    m = torch.as_tensor(mult, dtype=torch.float32, device=device)
    out = (m[:, None] * torch.maximum(f / peak, b / hbm)).sum(dim=0)
    return out.cpu().numpy().astype(float)


def _predraw_moe_rows(pred, toks_int: List[int], n_moe_layers: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(layer, step) straggler-rank (max flops, max bytes) rows for the
    MoE GroupedGEMM barrier, with routing draws consumed from ``pred.rng``
    in the exact scalar order: step-major, layer-minor.

    The reduction exploits ``max_r max(F_r/p, B_r/b) ==
    max(max_r F_r / p, max_r B_r / b)`` (p, b positive constants), so the
    per-layer term stays one roofline row.
    """
    cfg, par = pred.cfg, pred.par
    moe = cfg.moe
    E, top_k = moe.num_experts, moe.top_k
    ep = max(par.ep, 1)
    tp_in_expert = max(par.tp // ep, 1)
    d_in, d_out = cfg.d_model, moe.expert_d_ff // tp_in_expert
    rank_of = expert_rank_map(E, ep)
    groups = np.bincount(rank_of, minlength=ep).astype(float)
    B = len(toks_int)
    maxF = np.empty((n_moe_layers, B))
    maxB = np.empty((n_moe_layers, B))
    stochastic = pred.routing.stochastic

    def rank_rows(toks: int) -> Tuple[float, float]:
        counts = pred.routing.assign(toks, E, top_k, pred.rng)
        cap = math.ceil(moe.capacity_factor_eval * toks * top_k / E)
        kept = np.minimum(counts, cap)
        s = np.bincount(rank_of, weights=kept, minlength=ep)
        flops = 2.0 * d_in * d_out * s
        bytes_ = 2 * (d_in + d_out) * s + 2 * d_in * d_out * groups
        return float(flops.max()), float(bytes_.max())

    for bi, toks in enumerate(toks_int):
        if stochastic:
            for li in range(n_moe_layers):
                maxF[li, bi], maxB[li, bi] = rank_rows(toks)
        else:
            # deterministic routing consumes no draws and depends only on
            # the token total: one evaluation covers every layer
            f, b = rank_rows(toks)
            maxF[:, bi] = f
            maxB[:, bi] = b
    return maxF, maxB


def batch_step_totals(pred, steps: Sequence[Tuple[Sequence[int],
                                                  Sequence[int]]],
                      *, decode: bool,
                      backend: str = "numpy") -> np.ndarray:
    """Vectorized ``[pred.step_time(q, kv, decode=...).total for q, kv in
    steps]`` for analytical-model predictors (see module doc).

    ``steps`` is a sequence of ``(q_lens, kv_lens)`` pairs; returns a
    float64 array of per-step totals in seconds.  Requires
    ``supports_vectorized(pred)``.  MoE predictors consume routing draws
    from ``pred.rng`` exactly as the scalar walk would (one ``assign``
    per attention layer per non-empty step, step-major order).
    """
    cfg, par, hw = pred.cfg, pred.par, pred.ops.hw
    B = len(steps)
    if B == 0:
        return np.zeros(0)
    tp = max(par.tp, 1)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    moe = cfg.moe

    lens = np.array([len(q) for q, _ in steps])
    live = lens > 0                       # zero-token steps price to 0.0
    idx = np.flatnonzero(live)
    if len(idx) == 0:
        return np.zeros(B)
    Q = np.concatenate([np.asarray(steps[i][0], float) for i in idx])
    KV = np.concatenate([np.asarray(steps[i][1], float) for i in idx])
    offs = np.concatenate(([0], np.cumsum(lens[idx])))[:-1]
    n_req = lens[idx].astype(float)
    toks = np.add.reduceat(Q, offs)

    if moe is not None:
        n_moe_layers = sum(1 for kind in cfg.pattern
                           if kind in (ATTN_GLOBAL, ATTN_LOCAL))
        toks_int = [int(sum(steps[i][0])) for i in idx]
        gg_maxF, gg_maxB = _predraw_moe_rows(pred, toks_int, n_moe_layers)
        ep = max(par.ep, 1)
        tp_in_expert = max(par.tp // ep, 1)
        moe_n_mats = 3 if cfg.gated_mlp else 2
        a2a_bytes = 2.0 * toks * moe.top_k * d / ep

    # per-window attention reductions, computed once and reused per layer
    attn_cache = {}

    def attn_sums(window: int):
        if window in attn_cache:
            return attn_cache[window]
        eff = np.minimum(KV, window) if window else KV
        if decode:
            pairs_sum = None
        else:
            factor = (np.where(Q == KV, 0.5, 1.0)
                      if not window else np.ones_like(Q))
            pairs_sum = np.add.reduceat(Q * eff * factor, offs)
        sums = (pairs_sum, np.add.reduceat(eff, offs),
                np.add.reduceat(Q, offs))
        attn_cache[window] = sums
        return sums

    t = _Terms(len(idx), hw)
    t.membound(2.0 * toks * d)                                    # embed
    moe_li = 0
    for kind in cfg.pattern:
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            window = cfg.sliding_window if kind == ATTN_LOCAL else 0
            t.gemm(toks, (H + 2 * K) * hd // tp, d)               # qkv
            pairs_sum, eff_sum, q_sum = attn_sums(window)
            if decode:
                t.roof(4.0 * (H // tp) * hd * eff_sum,
                       4.0 * eff_sum * max(K // tp, 1) * hd)
            else:
                t.roof(4.0 * (H // tp) * hd * pairs_sum,
                       2.0 * (q_sum * (H // tp)
                              + 2.0 * eff_sum * max(K // tp, 1)) * hd)
            t.gemm(toks, d, H * hd // tp)                         # o_gemm
            t.all_reduce(2.0 * toks * d, tp)
            if moe is not None:                                   # MoE ffn
                t.gemm(toks, moe.num_experts, d)                  # gate
                t.all_to_all(a2a_bytes, ep)                       # dispatch
                t.roof(gg_maxF[moe_li], gg_maxB[moe_li],
                       mult=moe_n_mats)                           # straggler
                t.all_to_all(a2a_bytes, ep)                       # combine
                if moe.num_shared_experts:
                    ff = moe.expert_d_ff * moe.num_shared_experts
                    t.gemm(toks, ff // tp, d, mult=moe_n_mats)
                if tp_in_expert > 1:
                    t.all_reduce(2.0 * toks * d, tp_in_expert)
                moe_li += 1
            else:
                n_mats = 3 if cfg.gated_mlp else 2                # dense ffn
                t.gemm(toks, cfg.d_ff // tp, d, mult=n_mats)
                t.all_reduce(2.0 * toks * d, tp)
        elif kind == RWKV:
            t.gemm(toks, d // tp, d, mult=5)
            Hh, hs = d // cfg.rwkv_head_size, cfg.rwkv_head_size
            t.membound(4.0 * toks * Hh * hs * hs / tp)
            t.gemm(toks, d, d // tp)
            t.all_reduce(2.0 * toks * d, tp)
            t.gemm(toks, cfg.d_ff // tp, d, mult=2)               # chan-mix
        else:                                                     # RG-LRU
            t.gemm(toks, d // tp, d, mult=2)
            t.gemm(toks, d // tp, d // tp, mult=2)
            t.membound(4.0 * toks * d / tp)
            t.gemm(toks, d, d // tp)
            t.all_reduce(2.0 * toks * d, tp)
            if kind == RECURRENT:
                n_mats = 3 if cfg.gated_mlp else 2
                t.gemm(toks, cfg.d_ff // tp, d, mult=n_mats)
                t.all_reduce(2.0 * toks * d, tp)
    n_logits = toks if decode else n_req
    t.gemm(n_logits, cfg.padded_vocab // tp, d)                   # head

    totals = t.evaluate(backend, pred.device)
    pp = max(par.pp, 1)
    if pp > 1:
        m = np.maximum(n_req, 1.0)
        totals = totals * (pp + m - 1) / (m * pp) * pp
        totals = totals + ((2.0 * toks * d) / hw.inter_node_bw
                           + hw.op_overhead) * (pp - 1)
    totals = totals + pred.engine_overhead

    out = np.zeros(B)
    out[idx] = totals
    return out
