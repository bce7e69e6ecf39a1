"""GQA attention: training/prefill (full-sequence) and decode (KV cache).

Port of ``repro/models/attention.py``: GQA with any (H, K), qk_norm,
attention-logit softcap, sliding-window attention with ring caches,
cross-attention, bidirectional encoders.  These are the reference's plain
paths (``_sdpa`` and the blockwise online softmax); the reference models never
call the Pallas attention kernels.  The port calls two.  A decode step whose
caller hands its cache over (``donate``) writes its entry into that cache in
place and attends with the decode attention kernel over each row's live
prefix (``attention_decode``).  A full-sequence self-attention core on a CUDA
tensor that autograd would not record, with no mesh, no logit softcap and
its own positions, runs the flash attention kernel (``attention_train``):
the served prefill, without the S x S bias or f32 scores ``_sdpa`` builds.

This module owns a layer's K/V.  Its decode cache entry (``cache_pds``) is
"k"/"v" of ``cache_len`` slots, a ring where the window is shorter than the
sequence: absolute position p sits at slot ``p % cache_len``, stored so by
``_kv_to_cache`` and written and read so by ``attention_decode``; a
cross-attention layer adds its memory's "xk"/"xv".  ``attention_prefill``
runs a prompt's attention and returns that entry, built on one device from
the k/v its core attended over (one q/k/v projection); under tensor
parallelism the core's k/v are laid out otherwise, and the cache projects
its own.

TP mapping (megatron-style over the "model" mesh axis), as the reference's:
train/prefill replicate KV heads ``rep = tp/gcd(K, tp)`` times so the q-head
axis shards evenly (replicated attention when H itself does not divide), each
rank projecting only the heads it holds; decode shards the KV cache over
(batch -> data, seq -> model) and each rank attends over its own slots.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels._build import grad_would_record
from repro_torch.models.common import (
    PD, AxisRules, apply_rope, rms_norm, rope_freqs, softcap,
)

NEG_INF = -2.0e38


def attn_pds(cfg: ModelConfig, cross: bool = False) -> Dict[str, PD]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": PD((d, H, hd), ("embed", "heads", None)),
        "wk": PD((d, K, hd), ("embed", "kv", None)),
        "wv": PD((d, K, hd), ("embed", "kv", None)),
        "wo": PD((H, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = PD((hd,), (None,), "zeros")
        p["k_norm"] = PD((hd,), (None,), "zeros")
    return p


def _per_head(ax: AxisRules, fn, q, k, v, rows=None, *, q_axes, kv_axes):
    """``fn(q, k, v[, rows])`` on each rank's batch rows and KV heads.

    Attention mixes neither rows nor heads, so on a mesh the core runs under
    ``local_map`` (as GSPMD partitions it): q/k/v on (batch -> data, KV heads
    -> model when they divide), ``rows`` (a per-row (B, T) bias) on the batch
    axes, the output as q.  DTensor propagation through the core's batched
    products would flatten a batch and a head dim both sharded, which not
    every torch version can do."""
    args = (q, k, v) + (() if rows is None else (rows,))
    if ax.mesh is None:
        return fn(*args)

    def pl(t, axes):
        return ax.placements(ax.resolve(axes, t.shape))
    q_pl = pl(q, q_axes)
    in_pl = (q_pl, pl(k, kv_axes), pl(v, kv_axes))
    if rows is not None:
        in_pl += (pl(rows, ("batch",) + (None,) * (rows.ndim - 1)),)
    return local_map(fn, out_placements=(q_pl,), in_placements=in_pl,
                     redistribute_inputs=True)(*(ax.replicated(t) for t in args))


def kv_replication(cfg: ModelConfig, ax: AxisRules) -> int:
    """How many times KV heads are replicated for TP train/prefill."""
    tp = ax.model_size()
    H, K = cfg.num_heads, cfg.num_kv_heads
    if tp <= 1 or H % tp != 0:
        return 1
    rep = tp // math.gcd(K, tp)
    return rep if (H // K) % rep == 0 else 1


def _proj(x, w):
    """x (B,S,D) @ w (D,H,hd) -> (B,S,H,hd)."""
    return torch.einsum("bsd,dhk->bshk", x, w)


def _proj_kv(x, p, ax: AxisRules, rep: int):
    """x (B,S,D) -> k/v (B,S,K*rep,hd): each KV head repeated ``rep`` times
    (``kv_replication``); when it is, split over "model" as
    ``AxisRules.shared_product`` projects them."""
    if rep == 1:
        return _proj(x, p["wk"]), _proj(x, p["wv"])
    return tuple(ax.shared_product("bsd,dhk->bshk", x, p[w], rep) for w in ("wk", "wv"))


def _project_qkv(cfg: ModelConfig, p, x, positions, ax: AxisRules,
                 rope: bool = True, rep: int = 1):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,K*rep,hd) with qk_norm + RoPE
    (``_proj_kv``)."""
    q = _proj(x, p["wq"])
    k, v = _proj_kv(x, p, ax, rep)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps, zero_centered=True)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps, zero_centered=True)
    if rope:
        cos, sin = rope_freqs(positions, cfg.resolved_head_dim, cfg.rope_theta)
        cos = ax.replicated(cos[:, :, None, :])
        sin = ax.replicated(sin[:, :, None, :])
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return ax.constrain(q, "batch", None, "heads", None), k, v


def _valid(q_pos, k_pos, *, causal: bool, window: int) -> torch.Tensor:
    """(S, T) bool: True where q may attend k."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return ok


def _bias(ok: torch.Tensor) -> torch.Tensor:
    """Additive f32 bias: 0 where attendable, NEG_INF elsewhere."""
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill(~ok, NEG_INF)


def _sdpa(cfg: ModelConfig, q, k, v, bias) -> torch.Tensor:
    """Grouped-head attention.  q (B,S,K,G,hd); k,v (B,T,K,hd)."""
    scale = cfg.resolved_head_dim ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    if cfg.attn_logit_softcap:
        scores = softcap(scores, cfg.attn_logit_softcap)
    scores = scores + bias[None, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _flash_core(cfg: ModelConfig, ax: AxisRules, q, k, v) -> bool:
    """Whether a self-attention core over its own positions may run as the
    flash attention kernel: real CUDA tensors (not a dry run's fake ones) that
    autograd would not record (the kernel has no backward), no mesh and no
    logit softcap.  The kernel's index mask is then ``_valid`` of the
    positions, and it computes the core as ``_sdpa`` does: bf16 products
    accumulated in f32, an f32 online softmax, P in bf16 for PV."""
    return (q.device.type == "cuda" and not is_fake(q) and ax.mesh is None
            and not cfg.attn_logit_softcap and not grad_would_record(q, k, v))


def _sdpa_blockwise(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, causal: bool,
                    window: int, block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block`` keys: only a
    (B,K,G,S,block) score tile exists at a time.  When grad is enabled each
    block's body runs under ``torch.utils.checkpoint``, so backward recomputes
    its scores instead of keeping every tile (the reference's
    ``jax.checkpoint(body, policy=nothing_saveable)``)."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = hd ** -0.5
    nb = (T + block - 1) // block
    qf = q.float()

    def body(m, l, acc, kblk, vblk, pblk):
        s = torch.einsum("bskgd,btkd->bkgst", qf, kblk.float()) * scale
        if cfg.attn_logit_softcap:
            s = softcap(s, cfg.attn_logit_softcap)
        ok = _valid(q_pos, pblk, causal=causal, window=window)
        s = s.masked_fill(~ok[None, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = p.masked_fill((m_new == NEG_INF)[..., None], 0.0)
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, vblk.float())
        return m_new, l, acc

    step = body
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, body, use_reentrant=False)

    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, hd), dtype=torch.float32, device=q.device)
    for ib in range(nb):
        sl = slice(ib * block, min((ib + 1) * block, T))
        m, l, acc = step(m, l, acc, k[:, sl], v[:, sl], k_pos[sl])
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)          # (B,S,K,G,hd)


def _attend(cfg: ModelConfig, p, x, ax: AxisRules, *, window: int,
            causal: bool, positions: Optional[torch.Tensor],
            memory: Optional[torch.Tensor],
            memory_positions: Optional[torch.Tensor],
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``attention_train``'s attention, returning ``(y, k, v)``: the output
    and the k/v its core attended over (B, T, K * ``kv_replication``, hd),
    RoPE'd at their positions for self-attention, the memory's for
    cross-attention."""
    B, S, _ = x.shape
    own_positions = positions is None
    if own_positions:
        positions = torch.arange(S, device=x.device).expand(B, S)
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rep = kv_replication(cfg, ax)   # KV heads replicated across TP ranks
    if memory is None:
        q, k, v = _project_qkv(cfg, p, x, positions, ax, rep=rep)
        k_pos = positions
    else:
        # cross-attention: q from x, k/v from encoder memory; no RoPE on q/k
        q = ax.constrain(_proj(x, p["wq"]), "batch", None, "heads", None)
        k, v = _proj_kv(memory, p, ax, rep)
        Tm = memory.shape[1]
        k_pos = (memory_positions if memory_positions is not None
                 else torch.arange(Tm, device=x.device).expand(B, Tm))
        causal, window = False, 0
    Kr = K * rep
    kv_axis = "heads" if Kr % ax.model_size() == 0 else None
    k = ax.constrain(k, "batch", None, kv_axis, None)
    v = ax.constrain(v, "batch", None, kv_axis, None)
    if Kr % ax.model_size():
        # DTensor cannot split a head-sharded dim into (Kr, G) unless Kr
        # divides over "model" (GSPMD reshards there on its own)
        q = ax.constrain(q, "batch", None, None, None)
    blockwise = ax.opt("attn_impl", "naive") == "blockwise"
    if (not blockwise and memory is None and own_positions
            and _flash_core(cfg, ax, q, k, v)):
        # head h reads KV head h // (H // Kr), the (Kr, G) grouping below
        out = kernel_ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        q = q.reshape(B, S, Kr, H // Kr, hd)
        if blockwise:
            block = int(ax.opt("attn_block", 1024))

            def core(q, k, v):
                return _sdpa_blockwise(cfg, q, k, v, positions[0], k_pos[0],
                                       causal=causal, window=window, block=block)
        else:
            bias = _bias(_valid(positions[0], k_pos[0], causal=causal, window=window))

            def core(q, k, v):
                return _sdpa(cfg, q, k, v, bias)
        out = _per_head(ax, core, q, k, v,
                        q_axes=("batch", None, "heads", None, None),
                        kv_axes=("batch", None, "heads", None))
        out = out.reshape(B, S, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return ax.constrain(y, "batch", None, "embed"), k, v


def attention_train(cfg: ModelConfig, p, x, ax: AxisRules, *,
                    window: int = 0, causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    memory: Optional[torch.Tensor] = None,
                    memory_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention.  memory != None => cross-attention.

    Self-attention over its own positions takes the flash attention kernel
    where ``_flash_core`` holds and ``attn_impl`` is not "blockwise"; every
    other call (training, a mesh, softcap, cross-attention, explicit
    positions, blockwise, the CPU) takes ``_sdpa`` or the blockwise core."""
    return _attend(cfg, p, x, ax, window=window, causal=causal,
                   positions=positions, memory=memory,
                   memory_positions=memory_positions)[0]


def attention_prefill(cfg: ModelConfig, p, x, ax: AxisRules, *,
                      window: int = 0, cache_len: int = 0,
                      memory: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``attention_train`` of a prompt (causal self-attention over its own
    positions, by the same core) and the layer's decode cache entry: "k" and
    "v" in a cache of ``cache_len`` slots (``S`` where 0, ``_kv_to_cache``).
    With ``memory``, cross-attention over it and the entry "xk" and "xv",
    the memory's k/v that decode attends over.

    On one device, or under data parallelism alone, the entry is the core's
    own k/v: one projection.  Under tensor parallelism the core holds
    ``kv_replication`` copies of each KV head split on heads, while the
    cache holds the K heads split on its slots ("kv_seq"), so the cache
    projects its own k/v, as the reference's compiled step does on a mesh."""
    B, S, _ = x.shape
    y, k, v = _attend(cfg, p, x, ax, window=window, causal=True, positions=None,
                      memory=memory, memory_positions=None)
    if ax.model_size() > 1:
        if memory is None:
            pos = torch.arange(S, device=x.device).expand(B, S)
            _, k, v = _project_qkv(cfg, p, x, pos, ax)
        else:
            k, v = _proj(memory, p["wk"]), _proj(memory, p["wv"])
    if memory is not None:
        return y, {"xk": k, "xv": v}
    return y, _kv_to_cache(k, v, cache_len or S, window, ax)


# ---------------------------------------------------------------------------
# Decode path (single new token against a KV cache)
# ---------------------------------------------------------------------------
def cache_pds(cfg: ModelConfig, batch: int, cache_len: int,
              memory_len: int = 0) -> Dict[str, PD]:
    """A layer's decode cache entry: "k"/"v" of ``cache_len`` slots split
    on them ("kv_seq"), and with ``memory_len`` the cross-attention's
    memory k/v "xk"/"xv"."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    c = {
        "k": PD((batch, cache_len, K, hd), ("batch", "kv_seq", None, None), "zeros"),
        "v": PD((batch, cache_len, K, hd), ("batch", "kv_seq", None, None), "zeros"),
    }
    if memory_len:
        c["xk"] = PD((batch, memory_len, K, hd), ("batch", None, None, None), "zeros")
        c["xv"] = PD((batch, memory_len, K, hd), ("batch", None, None, None), "zeros")
    return c


def _kv_to_cache(k, v, cache_len: int, window: int, ax: AxisRules):
    """Store prefill K/V into a (possibly ring) cache of length cache_len."""
    S = k.shape[1]
    eff = min(window, cache_len) if window else cache_len

    def pad(x, n):      # zeros after the sequence axis (dim 1)
        return F.pad(x, (0, 0, 0, 0, 0, n)) if n else x

    if S >= eff:
        ck, cv = k[:, S - eff:], v[:, S - eff:]
        shift = S % cache_len
        if window and eff == cache_len and shift:
            # ring semantics: absolute position p lives at slot p % cache_len
            # (decode writes at pos % cache_len), so rotate the stored window
            # (``torch.roll`` by two slices: DTensor has no rule for roll in
            # every torch version)
            ck = torch.cat([ck[:, -shift:], ck[:, :-shift]], dim=1)
            cv = torch.cat([cv[:, -shift:], cv[:, :-shift]], dim=1)
        ck, cv = pad(ck, cache_len - eff), pad(cv, cache_len - eff)
    else:
        ck, cv = pad(k, cache_len - S), pad(v, cache_len - S)
    return {"k": ax.constrain(ck, "batch", "kv_seq", None, None),
            "v": ax.constrain(cv, "batch", "kv_seq", None, None)}


def attention_decode(cfg: ModelConfig, p, x, cache: Dict[str, torch.Tensor],
                     pos, ax: AxisRules, *, window: int = 0,
                     memory_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     donate: bool = False,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x (B,1,D); cache k/v (B,Sc,K,hd); pos an int (one
    position for the batch) or a (B,) tensor (one per row, as the serving
    engine's continuous batching gives).

    Sliding-window caches are ring buffers of length ``min(window, S)``;
    entries carry RoPE at their absolute positions.  Cross-attention passes
    precomputed ``memory_kv``.

    By default the cache is not written: a new one is returned, as the
    reference does.  With ``donate`` the caller hands its cache over (the
    analogue of donating a buffer to a compiled step): where ``pos`` is per
    row and there is no mesh, no logit softcap and no ``memory_kv``, row
    ``b``'s entry is written in place at slot ``pos[b] % Sc`` and
    ``kernels.ops.decode_attention`` attends over the first
    ``min(pos[b] + 1, Sc)`` slots (the same positions the functional path
    leaves valid); the input's own k/v tensors are returned.  On the card
    that is the kernel at every shape: a head dim that is not a multiple of
    128 (the smoke configs' 16) is zero-padded there, a copy of the cache
    per layer that no full-size configuration pays, and a shape or dtype the
    kernel refuses raises.  Anything else takes the functional path."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    scale = hd ** -0.5

    def attend(q, ck, cv, bias):
        # q (B,H,hd); ck/cv (B,T,K,hd); bias (T,) or per-row (B,T), f32
        if K % ax.model_size():     # as in attention_train: heads whole
            q = ax.constrain(q, "batch", None, None)

        def core(qg, ck, cv, *rows):
            s = torch.einsum("bkgd,btkd->bkgt", qg, ck).float() * scale
            if cfg.attn_logit_softcap:
                s = softcap(s, cfg.attn_logit_softcap)
            s = s + (rows[0][:, None, None, :] if rows else bias[None, None, None, :])
            pr = torch.softmax(s, dim=-1).to(cv.dtype)
            return torch.einsum("bkgt,btkd->bkgd", pr, cv)

        o = _per_head(ax, core, q.reshape(B, K, H // K, hd), ck, cv,
                      bias if bias.ndim == 2 else None,
                      q_axes=("batch", "heads", None, None),
                      kv_axes=("batch", None, "heads", None))
        return o.reshape(B, H, hd)

    def attend_split(q, ck, cv, bias):
        # the cache split over "model" on its slots (the reference's
        # "kv_seq"), as GSPMD partitions attend: each rank scores its slots
        # for every head, and the softmax's max and sums, and the output,
        # are reduced over "model"; the cache never moves
        group = ax.mesh.get_group(ax.model_axis)

        def core(qg, ck, cv, bias):
            s = torch.einsum("bkgd,btkd->bkgt", qg, ck).float() * scale
            if cfg.attn_logit_softcap:
                s = softcap(s, cfg.attn_logit_softcap)
            s = s + (bias[:, None, None, :] if bias.ndim == 2 else bias[None, None, None, :])
            m = s.amax(dim=-1, keepdim=True).detach()
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
            e = torch.exp(s - m)
            pr = (e / ax.sum_over(e.sum(dim=-1, keepdim=True), ax.model_axis)).to(cv.dtype)
            o = torch.einsum("bkgt,btkd->bkgd", pr, cv)
            return ax.sum_over(o.float(), ax.model_axis).to(cv.dtype)

        def pl(t, *axes):
            return ax.placements(ax.resolve(axes, t.shape))
        qg = ax.constrain(q, "batch", None, None).reshape(B, K, H // K, hd)
        q_pl = pl(qg, "batch", None, None, None)
        b_pl = pl(bias, *(("batch",) if bias.ndim == 2 else ()), "kv_seq")
        kv_pl = pl(ck, "batch", "kv_seq", None, None)
        o = local_map(core, out_placements=(q_pl,),
                      in_placements=(q_pl, kv_pl, kv_pl, b_pl),
                      redistribute_inputs=True)(qg, ck, cv, ax.replicated(bias))
        return o.reshape(B, H, hd)

    if memory_kv is not None:  # cross-attention: cache is static memory KV
        q = _proj(x, p["wq"])[:, 0]
        ck, cv = memory_kv
        o = attend(q, ck, cv, torch.zeros((ck.shape[1],), dtype=torch.float32,
                                          device=x.device))
        y = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :]
        return ax.constrain(y, "batch", None, "embed"), cache

    per_row = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if per_row:
        pos = pos.to(x.device).long()
        pos_b = pos[:, None]
    else:
        pos = int(pos)
        pos_b = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos_b, ax)
    q = q[:, 0]  # (B,H,hd)

    ck, cv = cache["k"], cache["v"]
    Sc = ck.shape[1]
    if donate and per_row and ax.mesh is None and not cfg.attn_logit_softcap:
        rows = torch.arange(B, device=x.device)
        slot = pos % Sc
        ck.index_put_((rows, slot), k_new[:, 0].to(ck.dtype))
        cv.index_put_((rows, slot), v_new[:, 0].to(cv.dtype))
        o = kernel_ops.decode_attention(q, ck, cv, torch.clamp(pos + 1, max=Sc))
        y = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :]
        return y, {"k": ck, "v": cv}
    t = torch.arange(Sc, device=x.device)
    if per_row:
        slot = pos % Sc                                   # (B,)
        hit = (t[None, :] == slot[:, None])[..., None, None]
        valid = (t[None, :] <= pos[:, None]) | (pos[:, None] + 1 >= Sc)
    else:
        slot = pos % Sc  # ring semantics; Sc == full length when window == 0
        hit = (t == slot)[None, :, None, None]
        # the ring is fully valid once pos+1 >= Sc; before that only the
        # first pos+1 slots hold real entries
        valid = (t <= pos) | (pos + 1 >= Sc)
    # a select, not a write into the cache: the cache may be sharded on its
    # sequence axis, and a new one is returned either way
    hit = ax.replicated(hit)
    ck = ax.constrain(torch.where(hit, k_new, ck), "batch", "kv_seq", None, None)
    cv = ax.constrain(torch.where(hit, v_new, cv), "batch", "kv_seq", None, None)
    split = ax.model_size() > 1 and ax.resolve(("batch", "kv_seq"), ck.shape[:2])[1]
    o = (attend_split if split else attend)(q, ck, cv, _bias(valid))
    y = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :]
    return ax.constrain(y, "batch", None, "embed"), {"k": ck, "v": cv}
