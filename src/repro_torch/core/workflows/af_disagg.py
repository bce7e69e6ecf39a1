"""AF (Attention/FFN) disaggregation — MegaScale-Infer / Step-3 style.

One decode step is simulated as an *event dependency graph*: the global
batch is partitioned into m micro-batches; ATTN_COMPUTE(i,k) runs on the
attention cluster, A2F_TRANSFER(i,k) ships activations, the FFN stage runs
on the FFN cluster, F2A_TRANSFER(i,k) returns.  The event engine schedules
each node as soon as its dependencies are met, capturing the ping-pong
latency hiding: while A2F(i,k) is in flight the attention cluster computes
ATTN(i+1,k).  The step time is the timestamp of the final event — the
critical path.

Expert parallelism is first-class: an MoE FFN stage is not a scalar max()
but an explicit per-EP-rank sub-graph per micro-batch —

    gate -> EXPERT_DISPATCH(r) [all-to-all, per rank]
         -> EXPERT_RANK(r)     [heterogeneous GroupedGEMM per rank]
         -> barrier            [straggler: last rank gates the combine]
         -> EXPERT_COMBINE     [all-to-all + shared experts]

Ranks listed in ``remote_ranks`` host their expert shards on a *different
cluster*: their dispatch/combine legs traverse an inter-cluster LinkSpec
(lower bandwidth, extra latency) and their GroupedGEMM runs on that
cluster's operator models (heterogeneous hardware) — the cross-cluster
expert-routing regime.  Because dispatch and combine are collectives, the
EP group advances in lockstep: micro-batch i+1's experts start only after
micro-batch i's combine has completed on every rank.

The *resource model* of one step is selected by a
:class:`repro_torch.core.pipeline.PipelineConfig` (see that module):
``af_overlap="none"`` keeps the legacy lanes (attention compute + FFN
lockstep, un-contended transfers), ``"serial"`` chains every task on one
resource (the no-latency-hiding baseline; step time = sum of durations),
and ``"two_batch"`` adds per-direction NIC lanes so transfers contend but
hide behind the other micro-batch's attention.  ``ep_overlap`` hides the
per-rank dispatch/combine legs behind GroupedGEMM compute at a configured
efficiency.  Every step also books its serial (no-overlap) makespan, so
``overlap_efficiency = 1 - makespan/serial_makespan`` and the exposed-comm
fractions are first-class observables.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.core.engine import SimEngine
from repro_torch.core.events import EV
from repro_torch.core.hardware import HardwareSpec, LinkSpec, ParallelismConfig
from repro_torch.core.opmodels.analytical import OperatorModelSet
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.predictor import ExecutionPredictor, StepBreakdown
from repro_torch.core.routing import RoutingModule, split_by_rank


@dataclass
class AFStepStats:
    makespan: float = 0.0
    attn_busy: float = 0.0
    ffn_busy: float = 0.0
    transfer_bytes: float = 0.0
    attn_bubble_frac: float = 0.0
    ffn_bubble_frac: float = 0.0
    events: int = 0
    # latency-hiding observability (pipelining layer)
    serial_makespan: float = 0.0      # sum of all task durations (no overlap)
    bubble_time: float = 0.0          # attention-lane idle within makespan
    overlap_efficiency: float = 0.0   # 1 - makespan / serial_makespan
    attn_exposed_comm: float = 0.0    # F2A time that stalled the attn lane
    ffn_exposed_comm: float = 0.0     # A2F time that stalled the FFN group
    ep_overlap_hidden: float = 0.0    # EP a2a time hidden behind GEMMs
    # expert-parallel observability (per-EP-rank event graph)
    ep_dispatch_time: float = 0.0     # sum over stages of the dispatch leg
    ep_combine_time: float = 0.0      # sum over stages of the combine leg
    ep_straggler_excess: float = 0.0  # sum of (last rank - mean rank) waits
    rank_busy: List[float] = field(default_factory=list)  # GEMM time per rank
    cross_cluster_bytes: float = 0.0  # dispatch+combine bytes on remote link


def simulate_af_decode_step(cfg: ModelConfig, hw: HardwareSpec,
                            ops: OperatorModelSet,
                            context_lens: Sequence[int], *,
                            m: int, attn_par: ParallelismConfig,
                            ffn_par: ParallelismConfig,
                            routing: Optional[RoutingModule] = None,
                            rng: Optional[np.random.Generator] = None,
                            remote_ranks: Sequence[int] = (),
                            remote_link: Optional[LinkSpec] = None,
                            remote_ops: Optional[OperatorModelSet] = None,
                            pipeline: Optional[PipelineConfig] = None,
                            trace: Optional[Callable] = None,
                            ) -> AFStepStats:
    """Event-dependency-graph simulation of ONE decode step (one token).

    By default the per-EP-rank EXPERT_DISPATCH_DONE / EXPERT_RANK_DONE
    markers are *virtual*: their timestamps and stats are computed exactly
    but no Event objects enter the engine (they carry no callbacks, and
    materializing 2·ep of them per stage dominated MoE stepping).
    ``stats.events`` still counts them.  Pass ``trace`` (an event callback,
    as for :class:`SimEngine`) to emit them as real events at identical
    timestamps in identical per-rank order — they then drain through the
    engine's same-timestamp batch dispatch instead of one callback per
    marker.
    """
    rng = rng or np.random.default_rng(0)
    virtual_markers = 0
    mode = pipeline.af_overlap if pipeline is not None else "none"
    eta = pipeline.ep_overlap if pipeline is not None else 0.0
    nic_lanes = pipeline.nic_lanes if pipeline is not None else 1
    L = cfg.num_layers
    # np.array_split semantics by hand (first n % m chunks get one extra
    # element) — the values are identical, without the per-call numpy cost
    lens_list = list(context_lens)
    n_req = len(lens_list)
    q_sz, r_sz = divmod(n_req, max(m, 1))
    micro = []
    off = 0
    for j in range(max(m, 1)):
        sz = q_sz + (1 if j < r_sz else 0)
        if sz:
            micro.append(lens_list[off:off + sz])
        off += sz
    m_eff = len(micro)
    d = cfg.d_model
    ep = max(ffn_par.ep, ffn_par.tp, 1) if cfg.moe is not None else 1
    remote = frozenset(int(r) for r in remote_ranks)
    if remote and not all(0 <= r < ep for r in remote):
        raise ValueError(f"remote_ranks {sorted(remote)} out of range for "
                         f"ep={ep}")
    if remote and remote_link is None:
        raise ValueError("remote_ranks given without a remote_link — the "
                         "cross-cluster legs would not be modeled")
    r_ops = remote_ops or ops

    # ---- per-step pricing precompute -------------------------------------
    # The same micro-batch shapes are re-priced once per layer per stage;
    # compute operators and intra-node collectives are pure for every
    # model set (FabricOps delegates them verbatim), so their
    # per-(micro, kind) results are computed once up front.  Inter-node
    # transfer pricing (m2n/p2p) may account per call into a fabric, so it
    # is pre-priced only for the base analytical methods and stays a
    # per-event call otherwise.
    ops_t = type(ops)
    xfer_cacheable = (ops_t.m2n is OperatorModelSet.m2n
                      and ops_t.p2p is OperatorModelSet.p2p)

    # ---- per-(microbatch, layer) task durations --------------------------
    def t_attn(lens: List[int], kind: str) -> float:
        tp = max(attn_par.tp, 1)
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        t = ops.gemm(len(lens), (H + 2 * K) * hd // tp, d)
        t += ops.attention_decode(lens, H // tp, max(K // tp, 1), hd,
                                  window=window)
        t += ops.gemm(len(lens), d, H * hd // tp)
        t += ops.all_reduce(2.0 * len(lens) * d, tp)
        return t

    def t_ffn_dense(n_tok: int) -> float:
        n_mats = 3 if cfg.gated_mlp else 2
        tp = max(ffn_par.tp, 1)
        return (n_mats * ops.gemm(n_tok, cfg.d_ff // tp, d)
                + ops.all_reduce(2.0 * n_tok * d, tp))

    # A2F/F2A is MegaScale's M2N fan: attention ranks to FFN ranks (EP
    # group for MoE, TP group for dense).  The flat model prices it exactly
    # as p2p; FabricOps spreads the payload over the narrow side's NICs.
    n_attn = max(attn_par.devices, 1)
    n_ffn = max(ep, ffn_par.devices, 1)

    tb = [2.0 * len(c) * d for c in micro]   # A2F/F2A payload per micro
    xfer_dur = ([ops.m2n(tbi, n_attn, n_ffn) for tbi in tb]
                if xfer_cacheable else None)

    attn_kinds = [k for k in cfg.pattern]
    stats = AFStepStats()
    stats.rank_busy = [0.0] * ep
    moe = cfg.moe
    n_mats_moe = 3 if cfg.gated_mlp else 2

    # attention duration per (micro, layer) — pure pricing, computed once
    attn_dur: List[List[float]] = []
    for c in micro:
        per_kind: dict = {}
        row = []
        for kind in attn_kinds:
            v = per_kind.get(kind)
            if v is None:
                if kind not in (ATTN_GLOBAL, ATTN_LOCAL):
                    # recurrent block: runs on the attention cluster too
                    v = ops.gemm(len(c), d, d) * 3
                else:
                    v = t_attn(c, kind)
                per_kind[kind] = v
            row.append(v)
        attn_dur.append(row)
    ffn_dense_dur = ([t_ffn_dense(len(c)) for c in micro]
                     if moe is None else None)
    # MoE fixed stage pricing per micro: (gate, a2a leg, shared tail,
    # gate + a2a leg)
    moe_fixed: List[tuple] = []
    if moe is not None:
        for c in micro:
            n_tok = len(c)
            t_gate = ops.gemm(n_tok, moe.num_experts, d)
            a2a_base = ops.all_to_all(2.0 * n_tok * moe.top_k * d / ep, ep)
            t_shared = (n_mats_moe * ops.gemm(
                n_tok, moe.expert_d_ff * moe.num_shared_experts, d)
                if moe.num_shared_experts else 0.0)
            moe_fixed.append((t_gate, a2a_base, t_shared, t_gate + a2a_base))

    # ---- fused per-EP-rank GroupedGEMM pricing ---------------------------
    # With base-analytical (or pure-delegating fabric) models the per-rank
    # straggler pricing collapses to scalar roofline arithmetic inside the
    # stage loop: the flop/byte tallies are exact integers, so
    # coefficient-times-token-sum is bit-identical to the scalar
    # grouped_gemm walk.  Heterogeneous remote expert clusters contribute
    # per-rank (peak, hbm, overhead) triples.
    if cfg.moe is not None:
        from repro_torch.core.opmodels.batch import analytic_roofline_hw
        E = cfg.moe.num_experts
        base_sz, rem_sz = divmod(E, ep)
        rank_bounds = []
        off = 0
        for r in range(ep):
            n = base_sz + (1 if r < rem_sz else 0)
            rank_bounds.append((off, off + n))
            off += n
        rank_groups = [b - a for a, b in rank_bounds]
        local_hw = analytic_roofline_hw(ops)
        rem_hw = analytic_roofline_hw(r_ops)
        if local_hw is not None and rem_hw is not None:
            gg_hw = [rem_hw if r in remote else local_hw for r in range(ep)]
        else:
            gg_hw = None
        gg_cf = 2.0 * d * cfg.moe.expert_d_ff   # flops per routed token
        gg_cb1 = 2 * (d + cfg.moe.expert_d_ff)  # activation bytes per token
        gg_cb2 = 2 * d * cfg.moe.expert_d_ff    # weight bytes per group
        # hot-loop specialization: analytic roofline, one expert shard per
        # rank, all ranks on the local cluster (no per-rank legs/hw)
        gg_fast = gg_hw is not None and not remote and E == ep
        if gg_fast:
            gg_peak, gg_hbm, gg_oh = gg_hw[0]
        is_rem = [r in remote for r in range(ep)]
        if remote:
            # remote_link is guaranteed non-None here (validated above);
            # its pricing is latency + nbytes/bandwidth, inlined in the
            # stage loop (surface the canonical bandwidth error up front)
            link_lat = remote_link.latency
            link_bw = remote_link.bandwidth
            if link_bw <= 0:
                remote_link.transfer_time(0.0)

    # ---- resources & dependency-driven scheduling -------------------------
    # "none":      attention lane + FFN lockstep lane; transfers free.
    # "serial":    ONE chain shared by everything (no-latency-hiding
    #              baseline — makespan == sum of task durations).
    # "two_batch": attention lane + FFN lane + per-direction NIC lanes
    #              (transfers contend but overlap compute — ping-pong).
    if mode == "serial":
        chain = [0.0]
        attn_free = ffn_free = chain
    else:
        attn_free = [0.0]    # attention cluster: single pipeline
        ffn_free = [0.0]     # FFN/EP group: lockstep (collectives barrier it)
    a2f_nic = [0.0] * nic_lanes
    f2a_nic = [0.0] * nic_lanes

    not_serial = mode != "serial"
    serial_mode = not not_serial
    nic_free = mode == "none"
    two_batch = mode == "two_batch"

    if trace is not None:
        # ---- traced path: real marker events drain through SimEngine ------
        eng = SimEngine(trace=trace)
        # markers are observational: batch-drain contiguous runs (the
        # replay order and per-event trace callbacks are unchanged)
        eng.register_batch_handler(EV.EXPERT_DISPATCH_DONE, lambda evs: None)
        eng.register_batch_handler(EV.EXPERT_RANK_DONE, lambda evs: None)
        done_f2a = {i: 0.0 for i in range(m_eff)}  # F2A(i, k-1) completion
        f2a_dur = {i: 0.0 for i in range(m_eff)}   # its transfer duration

        def xfer_start(lanes: List[float], dur: float) -> float:
            """Transfer start time under the mode's NIC resource model."""
            if serial_mode:
                start = max(eng.now, attn_free[0])   # the one shared chain
                attn_free[0] = start + dur
                return start
            if two_batch:
                j = min(range(len(lanes)), key=lambda n: lanes[n])
                start = max(eng.now, lanes[j])
                lanes[j] = start + dur
                return start
            return eng.now                           # legacy: un-contended

        def schedule_attn(i: int, k: int, ev=None):
            dur = attn_dur[i][k]
            if k > 0 and not_serial:
                # F2A return time that the attention lane could not hide
                stats.attn_exposed_comm += max(
                    0.0, min(done_f2a[i] - attn_free[0], f2a_dur[i]))
            start = max(eng.now, attn_free[0], done_f2a[i])
            attn_free[0] = start + dur
            stats.attn_busy += dur
            stats.serial_makespan += dur
            eng.at(start + dur, EV.ATTN_COMPUTE_DONE,
                   lambda ev: schedule_a2f(i, k), i=i, k=k)

        def schedule_a2f(i: int, k: int):
            dur = (xfer_dur[i] if xfer_dur is not None
                   else ops.m2n(tb[i], n_attn, n_ffn))
            stats.transfer_bytes += tb[i]
            stats.serial_makespan += dur
            if serial_mode:
                stats.ffn_exposed_comm += dur  # nothing hides on one chain
            start = eng.now if nic_free else xfer_start(a2f_nic, dur)
            eng.at(start + dur, EV.A2F_TRANSFER_DONE,
                   lambda ev: schedule_ffn(i, k, dur), i=i, k=k)

        def schedule_ffn(i: int, k: int, xfer: float = 0.0):
            if not_serial:
                # A2F delivery time that stalled the (idle) FFN group
                stats.ffn_exposed_comm += max(
                    0.0, min(eng.now - ffn_free[0], xfer))
            if moe is None:
                dur = ffn_dense_dur[i]
                start = max(eng.now, ffn_free[0])
                ffn_free[0] = start + dur
                stats.ffn_busy += dur
                stats.serial_makespan += dur
                eng.at(start + dur, EV.FFN_COMPUTE_DONE,
                       lambda ev: schedule_f2a(i, k), i=i, k=k)
            else:
                schedule_experts(i, k)

        # ---- the per-EP-rank expert sub-graph -----------------------------

        def schedule_experts(i: int, k: int):
            t0 = max(eng.now, ffn_free[0])
            t_gate, a2a_base, t_shared, tgb = moe_fixed[i]
            # the routing draw stays at event-execution time: stage order
            # is dynamic, so pre-drawing would reorder the rng sequence
            counts = (routing.assign(len(micro[i]), moe.num_experts,
                                     moe.top_k, rng)
                      if routing is not None else
                      np.full(moe.num_experts,
                              len(micro[i]) * moe.top_k // moe.num_experts))
            counts_l = counts.tolist()

            # dispatch and combine are collectives: the group advances in
            # lockstep, so the whole stage timeline is fixed once the
            # dispatch starts — compute it, reserve the group through the
            # combine, and book the per-rank events at their true
            # timestamps.  With ep_overlap=eta the a2a legs hide behind
            # GroupedGEMM compute (chunked dispatch): comm+compute pairs
            # cost (1-eta)*(comm+compute) + eta*max(comm, compute).
            rank_busy = stats.rank_busy
            eh = stats.ep_overlap_hidden
            t0g = t0 + t_gate
            serial_finish = 0.0
            barrier = 0.0
            fin_sum = 0.0
            max_leg = a2a_base
            if gg_fast:
                # one expert shard per rank, uniform local hardware,
                # constant dispatch leg — scalar roofline per rank
                cf, cb1, cb2 = gg_cf, gg_cb1, gg_cb2
                peak, hbm, oh = gg_peak, gg_hbm, gg_oh
                nm = n_mats_moe
                for r, s_r in enumerate(counts_l):
                    rf = cf * s_r / peak
                    rb = (cb1 * s_r + cb2) / hbm
                    dur = nm * ((rf if rf > rb else rb) + oh)
                    rank_busy[r] += dur
                    sf = tgb + dur
                    if sf > serial_finish:
                        serial_finish = sf
                    if eta != 0.0:
                        hidden = eta * (a2a_base if a2a_base < dur else dur)
                        eh += hidden
                        t_ready = t0g + (a2a_base - hidden)
                    else:
                        t_ready = t0g + a2a_base
                    fin = t_ready + dur
                    fin_sum += fin
                    if fin > barrier:
                        barrier = fin
                    eng.at(t_ready, EV.EXPERT_DISPATCH_DONE, None,
                           i=i, k=k, r=r)
                    eng.at(fin, EV.EXPERT_RANK_DONE, None, i=i, k=k, r=r)
            else:
                # general path: remote per-rank legs (cross-cluster link),
                # multi-expert shards, heterogeneous hw, non-analytic models
                per_rank = None if gg_hw is not None else \
                    split_by_rank(np.asarray(counts), ep)
                for r in range(ep):
                    a, b = rank_bounds[r]
                    s_r = counts_l[a] if b - a == 1 else sum(counts_l[a:b])
                    if gg_hw is not None:
                        peak, hbm, oh = gg_hw[r]
                        rf = gg_cf * s_r / peak
                        rb = (gg_cb1 * s_r + gg_cb2 * rank_groups[r]) / hbm
                        dur = n_mats_moe * ((rf if rf > rb else rb) + oh)
                    else:
                        dur = n_mats_moe * (
                            r_ops if r in remote else ops).grouped_gemm(
                                list(per_rank[r]), d, moe.expert_d_ff)
                    rank_busy[r] += dur
                    if is_rem[r]:
                        nbytes = 2.0 * float(s_r) * d
                        # dispatch + combine each traverse the link once
                        stats.cross_cluster_bytes += 2.0 * nbytes
                        leg = a2a_base + (link_lat + nbytes / link_bw)
                        t_gl = t_gate + leg
                        if leg > max_leg:
                            max_leg = leg
                    else:
                        leg = a2a_base
                        t_gl = tgb
                    sf = t_gl + dur
                    if sf > serial_finish:
                        serial_finish = sf
                    hidden = eta * (leg if leg < dur else dur)
                    eh += hidden
                    t_ready = t0g + (leg - hidden)
                    fin = t_ready + dur
                    fin_sum += fin
                    if fin > barrier:
                        barrier = fin
                    eng.at(t_ready, EV.EXPERT_DISPATCH_DONE, None,
                           i=i, k=k, r=r)
                    eng.at(fin, EV.EXPERT_RANK_DONE, None, i=i, k=k, r=r)
            stats.ep_overlap_hidden = eh
            stats.ep_straggler_excess += barrier - fin_sum / ep
            stats.ep_dispatch_time += max_leg
            t_comb = max_leg
            if eta > 0.0:
                # combine a2a overlaps the shared-expert GEMM tail at eta
                tail = ((1.0 - eta) * (t_comb + t_shared)
                        + eta * max(t_comb, t_shared))
                stats.ep_overlap_hidden += (t_comb + t_shared) - tail
            else:
                tail = t_comb + t_shared
            end = barrier + tail
            # combine leg + the serial shared-expert tail (dispatch_time
            # covers only the inbound collective, so the fields stay
            # distinct)
            stats.ep_combine_time += t_comb + t_shared
            # the no-overlap baseline runs EP ranks in parallel but
            # overlaps nothing else: gate + slowest (dispatch + GEMM) +
            # combine + shared
            stats.serial_makespan += serial_finish + t_comb + t_shared
            ffn_free[0] = end
            stats.ffn_busy += end - t0
            eng.at(end, EV.EXPERT_COMBINE_DONE,
                   lambda ev: schedule_f2a(i, k), i=i, k=k)

        def schedule_f2a(i: int, k: int):
            dur = (xfer_dur[i] if xfer_dur is not None
                   else ops.m2n(tb[i], n_attn, n_ffn))
            stats.transfer_bytes += tb[i]
            stats.serial_makespan += dur
            if serial_mode:
                stats.attn_exposed_comm += dur
            start = eng.now if nic_free else xfer_start(f2a_nic, dur)

            def done(ev):
                done_f2a[i] = eng.now
                f2a_dur[i] = dur
                if k + 1 < L:
                    schedule_attn(i, k + 1)
            eng.at(start + dur, EV.F2A_TRANSFER_DONE, done, i=i, k=k)

        for i in range(m_eff):
            schedule_attn(i, 0)
        eng.run()
        makespan_now = eng.now
        processed = eng.processed
    else:
        # ---- untraced fast path: inline stage state machine ---------------
        # The AF graph keeps exactly one pending event per live micro-batch
        # chain (every dispatch schedules at most one successor), so the
        # engine collapses to picking the earliest (time, creation-seq)
        # continuation among the chains and running its handler inline.
        # Events are clamped below `now` at scheduling time exactly like
        # SimEngine.at, so the dynamic stage order (and therefore the
        # routing rng draw order) is bit-for-bit the traced engine's; every
        # float expression below mirrors the traced closures verbatim, so
        # all stats agree bit-for-bit too (asserted by
        # test_virtual_markers_bit_identical_to_traced_event_path).
        now = 0.0
        seq = 0
        processed = 0
        live = 0
        # per-chain continuation: 1=A2F transfer, 2=FFN/expert stage,
        # 3=F2A transfer, 4=next-stage attention; 0=chain complete
        c_time = [0.0] * m_eff
        c_seq = [0] * m_eff
        c_phase = [0] * m_eff
        c_k = [0] * m_eff
        c_x = [0.0] * m_eff          # carried A2F/F2A transfer duration
        rank_busy = stats.rank_busy
        attn_busy = 0.0
        ffn_busy = 0.0
        transfer_bytes = 0.0
        serial_mk = 0.0
        attn_exposed = 0.0
        ffn_exposed = 0.0
        eh = 0.0
        ep_disp = 0.0
        ep_comb = 0.0
        straggler = 0.0
        cross_bytes = 0.0
        if moe is not None:
            micro_n = [len(c) for c in micro]
            assign = routing.assign if routing is not None else None
            n_experts = moe.num_experts
            top_k = moe.top_k
            d_ff_moe = moe.expert_d_ff
            if assign is None:
                fb_counts = [np.full(n_experts, n * top_k // n_experts)
                             for n in micro_n]
                fb_counts_l = [c.tolist() for c in fb_counts]
            gg_tab = None
            gg_tabs = None
            smax = max(micro_n) * top_k

            def _gg_table(peak, hbm, oh):
                # dur is a pure function of the per-rank token sum, which
                # is bounded by n_tok * top_k — tabulate the roofline once
                # per step (identical expression, identical bits; valid
                # for one expert shard per rank, where the weight-bytes
                # term gg_cb2 * rank_groups[r] is exactly gg_cb2)
                tab = []
                for s in range(smax + 1):
                    rf = gg_cf * s / peak
                    rb = (gg_cb1 * s + gg_cb2) / hbm
                    tab.append(n_mats_moe * ((rf if rf > rb else rb) + oh))
                return tab

            if gg_fast:
                gg_tab = _gg_table(gg_peak, gg_hbm, gg_oh)
            elif gg_hw is not None and moe.num_experts == ep:
                # analytic per-rank hw with one shard per rank but remote
                # ranks / heterogeneous clusters: one table per distinct
                # (peak, hbm, overhead), plus tabulated link legs
                by_hw = {}
                gg_tabs = []
                for t in gg_hw:
                    tab = by_hw.get(t)
                    if tab is None:
                        tab = by_hw[t] = _gg_table(*t)
                    gg_tabs.append(tab)
                if remote:
                    lk_tab = []
                    cross_tab = []
                    for s in range(smax + 1):
                        nbytes = 2.0 * float(s) * d
                        cross_tab.append(2.0 * nbytes)
                        lk_tab.append(link_lat + nbytes / link_bw)

        def xfer_start_u(lanes: List[float], dur: float,
                         now_: float) -> float:
            """Transfer start time under the mode's NIC resource model."""
            if serial_mode:
                start = max(now_, attn_free[0])      # the one shared chain
                attn_free[0] = start + dur
                return start
            if two_batch:
                j = min(range(len(lanes)), key=lambda n: lanes[n])
                start = max(now_, lanes[j])
                lanes[j] = start + dur
                return start
            return now_                              # legacy: un-contended

        # kick off stage 0 on every chain, in chain order (matches the
        # traced path's schedule_attn(i, 0) loop; done_f2a is 0.0 == now)
        for i in range(m_eff):
            dur = attn_dur[i][0]
            start = attn_free[0]
            if start < now:
                start = now
            attn_free[0] = start + dur
            attn_busy += dur
            serial_mk += dur
            seq += 1
            t = start + dur
            c_time[i] = t if t > now else now
            c_seq[i] = seq
            c_phase[i] = 1
            live += 1

        two_chains = m_eff == 2
        while live:
            # earliest (time, creation-seq) continuation — SimEngine order
            if two_chains:
                if c_phase[0]:
                    if c_phase[1]:
                        t0_ = c_time[0]
                        t1_ = c_time[1]
                        if t0_ < t1_ or (t0_ == t1_
                                         and c_seq[0] < c_seq[1]):
                            i = 0
                            now = t0_
                        else:
                            i = 1
                            now = t1_
                    else:
                        i = 0
                        now = c_time[0]
                else:
                    i = 1
                    now = c_time[1]
            else:
                bi = 0
                bt = None
                bs = 0
                for j in range(m_eff):
                    if c_phase[j]:
                        tj = c_time[j]
                        if (bt is None or tj < bt
                                or (tj == bt and c_seq[j] < bs)):
                            bt = tj
                            bs = c_seq[j]
                            bi = j
                i = bi
                now = bt
            processed += 1
            P = c_phase[i]
            if P == 2:
                # FFN/expert stage (A2F_TRANSFER_DONE handler)
                if not_serial:
                    # A2F delivery time that stalled the (idle) FFN group
                    v = now - ffn_free[0]
                    x_ = c_x[i]
                    if x_ < v:
                        v = x_
                    if v > 0.0:
                        ffn_exposed += v
                if moe is None:
                    dur = ffn_dense_dur[i]
                    start = ffn_free[0]
                    if start < now:
                        start = now
                    ffn_free[0] = start + dur
                    ffn_busy += dur
                    serial_mk += dur
                    end = start + dur
                else:
                    t0 = ffn_free[0]
                    if t0 < now:
                        t0 = now
                    mf = moe_fixed[i]
                    t_gate = mf[0]
                    a2a_base = mf[1]
                    t_shared = mf[2]
                    tgb = mf[3]
                    # the routing draw stays at event-execution time:
                    # stage order is dynamic, so pre-drawing would
                    # reorder the rng sequence
                    if assign is not None:
                        counts = assign(micro_n[i], n_experts, top_k, rng)
                        counts_l = counts.tolist()
                    else:
                        counts = fb_counts[i]
                        counts_l = fb_counts_l[i]
                    t0g = t0 + t_gate
                    fin_sum = 0.0
                    max_leg = a2a_base
                    if gg_fast:
                        tab = gg_tab
                        if eta == 0.0:
                            # max()/+const commute bit-wise (rounding is
                            # monotone), so only the max dur is tracked
                            t_ready = t0g + a2a_base
                            max_dur = 0.0
                            r = 0
                            for s_r in counts_l:
                                dur = tab[s_r]
                                rank_busy[r] += dur
                                r += 1
                                if dur > max_dur:
                                    max_dur = dur
                                fin_sum += t_ready + dur
                            serial_finish = tgb + max_dur
                            barrier = t_ready + max_dur
                        else:
                            serial_finish = 0.0
                            barrier = 0.0
                            r = 0
                            for s_r in counts_l:
                                dur = tab[s_r]
                                rank_busy[r] += dur
                                r += 1
                                sf = tgb + dur
                                if sf > serial_finish:
                                    serial_finish = sf
                                hidden = eta * (a2a_base
                                                if a2a_base < dur else dur)
                                eh += hidden
                                t_ready = t0g + (a2a_base - hidden)
                                fin = t_ready + dur
                                fin_sum += fin
                                if fin > barrier:
                                    barrier = fin
                    elif gg_tabs is not None:
                        # one expert shard per rank with tabulated per-rank
                        # rooflines and link legs (remote / heterogeneous)
                        serial_finish = 0.0
                        barrier = 0.0
                        r = 0
                        if eta == 0.0:
                            # hidden = eta*(...) == +0.0 and leg - 0.0 ==
                            # leg for the non-negative legs, so the eta
                            # terms drop out bit-exactly
                            for s_r in counts_l:
                                dur = gg_tabs[r][s_r]
                                rank_busy[r] += dur
                                if is_rem[r]:
                                    cross_bytes += cross_tab[s_r]
                                    leg = a2a_base + lk_tab[s_r]
                                    t_gl = t_gate + leg
                                    if leg > max_leg:
                                        max_leg = leg
                                else:
                                    leg = a2a_base
                                    t_gl = tgb
                                r += 1
                                sf = t_gl + dur
                                if sf > serial_finish:
                                    serial_finish = sf
                                fin = t0g + leg + dur
                                fin_sum += fin
                                if fin > barrier:
                                    barrier = fin
                        else:
                            for s_r in counts_l:
                                dur = gg_tabs[r][s_r]
                                rank_busy[r] += dur
                                if is_rem[r]:
                                    cross_bytes += cross_tab[s_r]
                                    leg = a2a_base + lk_tab[s_r]
                                    t_gl = t_gate + leg
                                    if leg > max_leg:
                                        max_leg = leg
                                else:
                                    leg = a2a_base
                                    t_gl = tgb
                                r += 1
                                sf = t_gl + dur
                                if sf > serial_finish:
                                    serial_finish = sf
                                hidden = eta * (leg if leg < dur else dur)
                                eh += hidden
                                t_ready = t0g + (leg - hidden)
                                fin = t_ready + dur
                                fin_sum += fin
                                if fin > barrier:
                                    barrier = fin
                    else:
                        per_rank = None if gg_hw is not None else \
                            split_by_rank(np.asarray(counts), ep)
                        serial_finish = 0.0
                        barrier = 0.0
                        for r in range(ep):
                            a, b = rank_bounds[r]
                            s_r = (counts_l[a] if b - a == 1
                                   else sum(counts_l[a:b]))
                            if gg_hw is not None:
                                peak, hbm, oh = gg_hw[r]
                                rf = gg_cf * s_r / peak
                                rb = (gg_cb1 * s_r
                                      + gg_cb2 * rank_groups[r]) / hbm
                                dur = n_mats_moe * (
                                    (rf if rf > rb else rb) + oh)
                            else:
                                dur = n_mats_moe * (
                                    r_ops if r in remote
                                    else ops).grouped_gemm(
                                        list(per_rank[r]), d, d_ff_moe)
                            rank_busy[r] += dur
                            if is_rem[r]:
                                nbytes = 2.0 * float(s_r) * d
                                # dispatch + combine each traverse the link
                                cross_bytes += 2.0 * nbytes
                                leg = a2a_base + (link_lat
                                                  + nbytes / link_bw)
                                t_gl = t_gate + leg
                                if leg > max_leg:
                                    max_leg = leg
                            else:
                                leg = a2a_base
                                t_gl = tgb
                            sf = t_gl + dur
                            if sf > serial_finish:
                                serial_finish = sf
                            hidden = eta * (leg if leg < dur else dur)
                            eh += hidden
                            t_ready = t0g + (leg - hidden)
                            fin = t_ready + dur
                            fin_sum += fin
                            if fin > barrier:
                                barrier = fin
                    virtual_markers += 2 * ep
                    straggler += barrier - fin_sum / ep
                    ep_disp += max_leg
                    t_comb = max_leg
                    if eta > 0.0:
                        # combine a2a overlaps the shared-expert GEMM tail
                        tail = ((1.0 - eta) * (t_comb + t_shared)
                                + eta * max(t_comb, t_shared))
                        eh += (t_comb + t_shared) - tail
                    else:
                        tail = t_comb + t_shared
                    end = barrier + tail
                    ep_comb += t_comb + t_shared
                    serial_mk += serial_finish + t_comb + t_shared
                    ffn_free[0] = end
                    ffn_busy += end - t0
                seq += 1
                c_time[i] = end if end > now else now
                c_seq[i] = seq
                c_phase[i] = 3
            elif P == 1:
                # A2F transfer (ATTN_COMPUTE_DONE handler)
                dur = (xfer_dur[i] if xfer_dur is not None
                       else ops.m2n(tb[i], n_attn, n_ffn))
                transfer_bytes += tb[i]
                serial_mk += dur
                if serial_mode:
                    ffn_exposed += dur  # nothing hides on one chain
                start = now if nic_free else xfer_start_u(a2f_nic, dur, now)
                c_x[i] = dur
                seq += 1
                t = start + dur
                c_time[i] = t if t > now else now
                c_seq[i] = seq
                c_phase[i] = 2
            elif P == 3:
                # F2A transfer (FFN/EXPERT_COMBINE_DONE handler)
                dur = (xfer_dur[i] if xfer_dur is not None
                       else ops.m2n(tb[i], n_attn, n_ffn))
                transfer_bytes += tb[i]
                serial_mk += dur
                if serial_mode:
                    attn_exposed += dur
                start = now if nic_free else xfer_start_u(f2a_nic, dur, now)
                c_x[i] = dur
                seq += 1
                t = start + dur
                c_time[i] = t if t > now else now
                c_seq[i] = seq
                c_phase[i] = 4
            else:
                # F2A delivered (done_f2a == now); next layer's attention
                k = c_k[i] + 1
                if k < L:
                    c_k[i] = k
                    dur = attn_dur[i][k]
                    if not_serial:
                        # F2A return time the attention lane could not hide
                        v = now - attn_free[0]
                        x_ = c_x[i]
                        if x_ < v:
                            v = x_
                        if v > 0.0:
                            attn_exposed += v
                    # max(now, attn_free, done_f2a): done_f2a == now here
                    start = attn_free[0]
                    if start < now:
                        start = now
                    attn_free[0] = start + dur
                    attn_busy += dur
                    serial_mk += dur
                    seq += 1
                    t = start + dur
                    c_time[i] = t if t > now else now
                    c_seq[i] = seq
                    c_phase[i] = 1
                else:
                    c_phase[i] = 0
                    live -= 1

        stats.attn_busy = attn_busy
        stats.ffn_busy = ffn_busy
        stats.transfer_bytes = transfer_bytes
        stats.serial_makespan = serial_mk
        stats.attn_exposed_comm = attn_exposed
        stats.ffn_exposed_comm = ffn_exposed
        stats.ep_overlap_hidden = eh
        stats.ep_dispatch_time = ep_disp
        stats.ep_combine_time = ep_comb
        stats.ep_straggler_excess = straggler
        stats.cross_cluster_bytes = cross_bytes
        makespan_now = now

    stats.makespan = makespan_now
    # virtual markers are still *counted* events — the step's event-graph
    # size is an observable and must not depend on trace mode
    stats.events = processed + virtual_markers
    if stats.makespan > 0:
        stats.attn_bubble_frac = 1.0 - stats.attn_busy / stats.makespan
        stats.ffn_bubble_frac = 1.0 - stats.ffn_busy / stats.makespan
    stats.bubble_time = max(stats.makespan - stats.attn_busy, 0.0)
    if stats.serial_makespan > 0:
        stats.overlap_efficiency = max(
            1.0 - stats.makespan / stats.serial_makespan, 0.0)
    return stats


class AFPipelinePredictor(ExecutionPredictor):
    """ExecutionPredictor whose decode step runs the AF event graph."""

    def __init__(self, *args, m: int = 2,
                 attn_par: Optional[ParallelismConfig] = None,
                 ffn_par: Optional[ParallelismConfig] = None,
                 remote_ranks: Sequence[int] = (),
                 remote_link: Optional[LinkSpec] = None,
                 remote_ops: Optional[OperatorModelSet] = None,
                 pipeline: Optional[PipelineConfig] = None, **kw):
        super().__init__(*args, **kw)
        self.m = m
        self.attn_par = attn_par or self.par
        self.ffn_par = ffn_par or self.par
        self.remote_ranks = tuple(remote_ranks)
        self.remote_link = remote_link
        self.remote_ops = remote_ops
        self.pipeline = pipeline
        # set to a callable to emit the per-rank marker events for real
        # (inner-engine event tracing); None keeps the fast virtual path
        self.af_trace: Optional[Callable] = None
        self.last_stats: Optional[AFStepStats] = None
        # run-level EP observability totals (cache hits replay the cached
        # step's stats, so totals stay consistent with simulated time)
        self.af_totals = {
            "decode_steps": 0, "makespan_s": 0.0, "ep_dispatch_time_s": 0.0,
            "ep_combine_time_s": 0.0, "ep_straggler_excess_s": 0.0,
            "cross_cluster_bytes": 0.0, "transfer_bytes": 0.0,
            # latency-hiding observability (pipelining layer)
            "serial_makespan_s": 0.0, "bubble_time_s": 0.0,
            "attn_exposed_comm_s": 0.0, "ffn_exposed_comm_s": 0.0,
            "ep_overlap_hidden_s": 0.0,
        }

    def _accumulate(self, stats: AFStepStats) -> None:
        t = self.af_totals
        t["decode_steps"] += 1
        t["makespan_s"] += float(stats.makespan)
        t["ep_dispatch_time_s"] += float(stats.ep_dispatch_time)
        t["ep_combine_time_s"] += float(stats.ep_combine_time)
        t["ep_straggler_excess_s"] += float(stats.ep_straggler_excess)
        t["cross_cluster_bytes"] += float(stats.cross_cluster_bytes)
        t["transfer_bytes"] += float(stats.transfer_bytes)
        t["serial_makespan_s"] += float(stats.serial_makespan)
        t["bubble_time_s"] += float(stats.bubble_time)
        t["attn_exposed_comm_s"] += float(stats.attn_exposed_comm)
        t["ffn_exposed_comm_s"] += float(stats.ffn_exposed_comm)
        t["ep_overlap_hidden_s"] += float(stats.ep_overlap_hidden)

    def _on_cache_hit(self, bd: StepBreakdown) -> None:
        # cached prefill steps carry no AF stats; keep the last decode stats
        if hasattr(bd, "af_stats"):
            self.last_stats = bd.af_stats
            self._accumulate(bd.af_stats)

    def _step_time_impl(self, q_lens, kv_lens, *, decode: bool,
                        n_prefill=None) -> StepBreakdown:
        if not decode:
            return super()._step_time_impl(q_lens, kv_lens, decode=False,
                                           n_prefill=n_prefill)
        stats = simulate_af_decode_step(
            self.cfg, self.hw, self.ops, list(kv_lens), m=self.m,
            attn_par=self.attn_par, ffn_par=self.ffn_par,
            routing=self.routing, rng=self.rng,
            remote_ranks=self.remote_ranks, remote_link=self.remote_link,
            remote_ops=self.remote_ops, pipeline=self.pipeline,
            trace=self.af_trace)
        self.last_stats = stats
        self._accumulate(stats)
        bd = StepBreakdown()
        bd.add("af_pipeline", stats.makespan)
        bd.add("engine_overhead", self.engine_overhead)
        bd.parts["attn_bubble_frac"] = stats.attn_bubble_frac
        bd.parts["ffn_bubble_frac"] = stats.ffn_bubble_frac
        bd.parts["ep_straggler_excess"] = stats.ep_straggler_excess
        bd.af_stats = stats
        return bd


def build_af(cfg: ModelConfig, hw: HardwareSpec, *,
             n_prefill: int = 1, n_decode: int = 1, m: int = 2,
             attn_par: Optional[ParallelismConfig] = None,
             ffn_par: Optional[ParallelismConfig] = None,
             prefill_par: Optional[ParallelismConfig] = None,
             ops: Optional[OperatorModelSet] = None,
             engine=None,
             routing=None, seed: int = 0,
             expert_cluster_hw: Optional[HardwareSpec] = None,
             remote_expert_ranks: Sequence[int] = (),
             expert_link: Optional[LinkSpec] = None,
             memory=None, queue_policy=None,
             memoize: bool = True,
             pipeline=None, transfer_overlap: float = 0.0,
             kv_frac: float = 0.9, fabric=None):
    """PD front + AF-disaggregated decode (as deployed by MegaScale-Infer).

    .. deprecated::
        ``build_af`` is kept as a thin shim over the declarative experiment
        API; prefer ``repro_torch.api.SimSpec`` with
        ``TopologySpec(preset="af", ...)`` and ``repro_torch.api.run`` — specs
        serialize, validate, and sweep.

    Preset over :func:`repro_torch.core.topology.build_system`.  Pass
    ``remote_expert_ranks`` (+ optionally ``expert_cluster_hw`` /
    ``expert_link``) to place some EP ranks on a separate expert cluster
    reached over an inter-cluster link (cross-cluster expert routing).
    """
    from repro_torch.core.topology import ClusterSpec, StageGraph, build_system
    attn_par = attn_par or ParallelismConfig(tp=1)
    ffn_par = ffn_par or ParallelismConfig(tp=1, ep=1)
    prefill_par = prefill_par or ParallelismConfig(tp=1)
    graph = StageGraph(clusters=[
        ClusterSpec("prefill", "prefill", n_replicas=n_prefill,
                    par=prefill_par, seed_offset=0, memoize=memoize),
        ClusterSpec("decode", "decode", n_replicas=n_decode,
                    par=attn_par, step="af", m=m,
                    attn_par=attn_par, ffn_par=ffn_par, seed_offset=50,
                    expert_cluster_hw=expert_cluster_hw,
                    remote_expert_ranks=tuple(remote_expert_ranks),
                    expert_link=expert_link, memoize=memoize),
    ], fabric=fabric)
    return build_system(cfg, hw, graph, ops=ops, routing=routing,
                        engine=engine,
                        memory=memory, queue_policy=queue_policy, seed=seed,
                        pipeline=pipeline, transfer_overlap=transfer_overlap,
                        kv_frac=kv_frac)
