"""GQA attention: training/prefill (full-sequence) and decode (KV cache).

Port of ``repro/models/attention.py`` on one device: GQA with any (H, K),
qk_norm, attention-logit softcap, sliding-window attention with ring caches,
cross-attention, bidirectional encoders.  These are the reference's plain
paths (``_sdpa`` and the blockwise online softmax); the reference models never
call the Pallas attention kernels, and neither does the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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


def _proj(x, w):
    """x (B,S,D) @ w (D,H,hd) -> (B,S,H,hd)."""
    return torch.einsum("bsd,dhk->bshk", x, w)


def _project_qkv(cfg: ModelConfig, p, x, positions, rope: bool = True):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,K,hd) with qk_norm + RoPE."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps, zero_centered=True)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps, zero_centered=True)
    if rope:
        cos, sin = rope_freqs(positions, cfg.resolved_head_dim, cfg.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


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


def _sdpa_blockwise(cfg: ModelConfig, q, k, v, q_pos, k_pos, *, causal: bool,
                    window: int, block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block`` keys: only a
    (B,K,G,S,block) score tile exists at a time."""
    B, S, K, G, hd = q.shape
    T = k.shape[1]
    scale = hd ** -0.5
    nb = (T + block - 1) // block
    qf = q.float()
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, hd), dtype=torch.float32, device=q.device)
    for ib in range(nb):
        sl = slice(ib * block, min((ib + 1) * block, T))
        s = torch.einsum("bskgd,btkd->bkgst", qf, k[:, sl].float()) * scale
        if cfg.attn_logit_softcap:
            s = softcap(s, cfg.attn_logit_softcap)
        ok = _valid(q_pos, k_pos[sl], causal=causal, window=window)
        s = s.masked_fill(~ok[None, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = p.masked_fill((m_new == NEG_INF)[..., None], 0.0)
        alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p, v[:, sl].float())
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)          # (B,S,K,G,hd)


def attention_train(cfg: ModelConfig, p, x, ax: AxisRules, *,
                    window: int = 0, causal: bool = True,
                    positions: Optional[torch.Tensor] = None,
                    memory: Optional[torch.Tensor] = None,
                    memory_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention.  memory != None => cross-attention."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if memory is None:
        q, k, v = _project_qkv(cfg, p, x, positions)
        k_pos = positions
    else:
        # cross-attention: q from x, k/v from encoder memory; no RoPE on q/k
        q = _proj(x, p["wq"])
        k, v = _proj(memory, p["wk"]), _proj(memory, p["wv"])
        Tm = memory.shape[1]
        k_pos = (memory_positions if memory_positions is not None
                 else torch.arange(Tm, device=x.device).expand(B, Tm))
        causal, window = False, 0

    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = q.reshape(B, S, K, H // K, hd)
    if ax.opt("attn_impl", "naive") == "blockwise":
        out = _sdpa_blockwise(cfg, q, k, v, positions[0], k_pos[0],
                              causal=causal, window=window,
                              block=int(ax.opt("attn_block", 1024)))
    else:
        ok = _valid(positions[0], k_pos[0], causal=causal, window=window)
        out = _sdpa(cfg, q, k, v, _bias(ok))
    out = out.reshape(B, S, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ---------------------------------------------------------------------------
# Decode path (single new token against a KV cache)
# ---------------------------------------------------------------------------
def cache_pds(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, PD]:
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": PD((batch, cache_len, K, hd), ("batch", "kv_seq", None, None), "zeros"),
        "v": PD((batch, cache_len, K, hd), ("batch", "kv_seq", None, None), "zeros"),
    }


def attention_decode(cfg: ModelConfig, p, x, cache: Dict[str, torch.Tensor],
                     pos, ax: AxisRules, *, window: int = 0,
                     memory_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x (B,1,D); cache k/v (B,Sc,K,hd); pos an int (one
    position for the batch) or a (B,) tensor (one per row, as the serving
    engine's continuous batching gives).

    Sliding-window caches are ring buffers of length ``min(window, S)``;
    entries carry RoPE at their absolute positions.  Cross-attention passes
    precomputed ``memory_kv``.  The cache is not written in place: a new one
    is returned, as the reference does."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    scale = hd ** -0.5

    def attend(q, ck, cv, bias):
        # q (B,H,hd); ck/cv (B,T,K,hd); bias (T,) or per-row (B,T), f32
        qg = q.reshape(B, K, H // K, hd)
        s = torch.einsum("bkgd,btkd->bkgt", qg, ck).float() * scale
        if cfg.attn_logit_softcap:
            s = softcap(s, cfg.attn_logit_softcap)
        s = s + (bias[:, None, None, :] if bias.ndim == 2
                 else bias[None, None, None, :])
        pr = torch.softmax(s, dim=-1).to(cv.dtype)
        return torch.einsum("bkgt,btkd->bkgd", pr, cv).reshape(B, H, hd)

    if memory_kv is not None:  # cross-attention: cache is static memory KV
        q = _proj(x, p["wq"])[:, 0]
        ck, cv = memory_kv
        o = attend(q, ck, cv, torch.zeros((ck.shape[1],), dtype=torch.float32,
                                          device=x.device))
        return torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :], cache

    per_row = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if per_row:
        pos = pos.to(x.device).long()
        pos_b = pos[:, None]
    else:
        pos = int(pos)
        pos_b = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(cfg, p, x, pos_b)
    q = q[:, 0]  # (B,H,hd)

    ck, cv = cache["k"], cache["v"]
    Sc = ck.shape[1]
    t = torch.arange(Sc, device=x.device)
    if per_row:
        slot = pos % Sc                                   # (B,)
        hit = (t[None, :] == slot[:, None])[..., None, None]
        ck = torch.where(hit, k_new, ck)
        cv = torch.where(hit, v_new, cv)
        valid = (t[None, :] <= pos[:, None]) | (pos[:, None] + 1 >= Sc)
    else:
        slot = pos % Sc  # ring semantics; Sc == full length when window == 0
        ck, cv = ck.clone(), cv.clone()
        ck[:, slot] = k_new[:, 0]
        cv[:, slot] = v_new[:, 0]
        # the ring is fully valid once pos+1 >= Sc; before that only the
        # first pos+1 slots hold real entries
        valid = (t <= pos) | (pos + 1 >= Sc)
    o = attend(q, ck, cv, _bias(valid))
    y = torch.einsum("bhk,hkd->bd", o, p["wo"])[:, None, :]
    return y, {"k": ck, "v": cv}
