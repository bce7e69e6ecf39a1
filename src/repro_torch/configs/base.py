"""Configuration system for the repro framework.

Every assigned architecture is a :class:`ModelConfig` instance; input shapes
are :class:`ShapeConfig` instances.  Configs are plain frozen dataclasses so
they hash, compare, and serialize trivially (the launcher round-trips them to
JSON in checkpoint metadata).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds (the per-layer pattern a model cycles through)
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "global"      # full (causal) attention
ATTN_LOCAL = "local"        # sliding-window attention
RECURRENT = "recurrent"     # RG-LRU recurrent block (recurrentgemma)
RWKV = "rwkv"               # RWKV6 time-mix + channel-mix block

FAMILIES = ("dense", "moe", "ssm", "vlm", "audio", "hybrid")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    capacity_factor_train: float = 1.25
    capacity_factor_eval: float = 2.0
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None    # default: d_model // num_heads
    # Per-layer pattern, cycled to num_layers.  ("global",) means uniform.
    block_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    sliding_window: int = 0           # window for ATTN_LOCAL blocks
    rope_theta: float = 10_000.0
    qk_norm: bool = False             # qwen3-style per-head q/k RMSNorm
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    post_block_norm: bool = False     # gemma2 sandwich norms
    gated_mlp: bool = True            # SwiGLU/GeGLU vs plain 2-layer FFN
    mlp_act: str = "silu"             # "silu" | "gelu" | "relu"
    tie_embeddings: bool = False
    rms_eps: float = 1e-6

    moe: Optional[MoEConfig] = None

    # Encoder-decoder (seamless): num_layers == decoder layers.
    encoder_layers: int = 0
    cross_attention: bool = False

    # Modality frontend stubs. "none" | "patch" (vlm) | "frames" (audio).
    frontend: str = "none"
    frontend_dim: int = 0             # embedding dim produced by the stub
    frontend_fraction: float = 0.25   # fraction of seq taken by stub embeds

    # RWKV6 / RG-LRU specifics
    rwkv_head_size: int = 64
    conv1d_width: int = 4             # recurrentgemma temporal conv width
    rglru_c: float = 8.0              # RG-LRU decay sharpness constant

    # --------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Full per-layer block-kind tuple of length num_layers."""
        p = self.block_pattern
        reps = (self.num_layers + len(p) - 1) // len(p)
        return (p * reps)[: self.num_layers]

    @property
    def is_attention_free(self) -> bool:
        return all(k in (RWKV, RECURRENT) for k in self.pattern)

    @property
    def is_sub_quadratic(self) -> bool:
        """True if decode memory/compute does not grow unboundedly with ctx."""
        return all(
            k in (RWKV, RECURRENT) or (k == ATTN_LOCAL and self.sliding_window > 0)
            for k in self.pattern
        )

    def kv_cache_len(self, seq_len: int, kind: str) -> int:
        """Per-layer KV length a decode cache must hold for `seq_len` context."""
        if kind in (RWKV, RECURRENT):
            return 0
        if kind == ATTN_LOCAL and self.sliding_window > 0:
            return min(self.sliding_window, seq_len)
        return seq_len

    # Parameter counting (used for MODEL_FLOPS=6ND and memory budgeting).
    def param_count(self, *, active_only: bool = False) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.padded_vocab * d
        total = emb if self.tie_embeddings else 2 * emb
        def attn_params() -> int:
            qkv = d * (self.q_dim + 2 * self.kv_dim)
            out = self.q_dim * d
            qknorm = 2 * hd if self.qk_norm else 0
            return qkv + out + qknorm
        def dense_mlp(ff: int) -> int:
            return d * ff * (3 if self.gated_mlp else 2)
        def rwkv_block() -> int:
            # time-mix: r,k,v,g,o projections + decay lora (d->64->d) + mixes
            tm = 5 * d * d + 2 * d * 64 + 64 * d + 6 * d
            cm = 2 * d * self.d_ff // 2 if False else d * self.d_ff + self.d_ff * d
            return tm + cm
        def rglru_block() -> int:
            # in/out proj (d->dr x2 gates) + conv1d + lru params
            dr = self.d_model  # recurrent width == d_model
            return 2 * d * dr + dr * d + self.conv1d_width * dr + 2 * dr
        per_layer = 0
        for kind in self.pattern:
            norms = 2 * d * (2 if self.post_block_norm else 1)
            if kind == RWKV:
                per_layer += rwkv_block() + norms
                continue
            if kind == RECURRENT:
                per_layer += rglru_block() + dense_mlp(self.d_ff) + norms
                continue
            blk = attn_params()
            if self.moe is not None:
                e = self.moe
                n_e = (e.top_k + e.num_shared_experts) if active_only else (
                    e.num_experts + e.num_shared_experts)
                blk += d * e.num_experts  # router
                blk += n_e * d * e.expert_d_ff * (3 if self.gated_mlp else 2)
            else:
                blk += dense_mlp(self.d_ff)
            per_layer += blk + norms
        total += per_layer
        if self.encoder_layers:
            enc = self.encoder_layers * (attn_params() + dense_mlp(self.d_ff) + 2 * d)
            xattn = self.num_layers * (attn_params() + d)  # cross-attn per dec layer
            total += enc + xattn
        total += d  # final norm
        return total

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM pool)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason-if-not).  See DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k" and not cfg.is_sub_quadratic:
        return False, "pure full-attention arch: 500k decode KV is unbounded-quadratic territory; skipped per spec"
    return True, ""


# ---------------------------------------------------------------------------
# Reduced ("smoke") variants: tiny same-family configs for CPU tests
# ---------------------------------------------------------------------------
def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny config of the same family/pattern for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        num_layers=min(cfg.num_layers, 2 * max(1, len(cfg.block_pattern))),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        block_pattern=cfg.block_pattern,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
        attn_logit_softcap=cfg.attn_logit_softcap,
        final_logit_softcap=cfg.final_logit_softcap,
        post_block_norm=cfg.post_block_norm,
        gated_mlp=cfg.gated_mlp,
        mlp_act=cfg.mlp_act,
        tie_embeddings=cfg.tie_embeddings,
        moe=None,
        encoder_layers=2 if cfg.encoder_layers else 0,
        cross_attention=cfg.cross_attention,
        frontend=cfg.frontend,
        frontend_dim=64 if cfg.frontend_dim else 0,
        frontend_fraction=cfg.frontend_fraction,
        rwkv_head_size=16,
        conv1d_width=cfg.conv1d_width,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, expert_d_ff=64,
                              num_shared_experts=cfg.moe.num_shared_experts)
    return ModelConfig(**kw)


SMOKE_SHAPE = ShapeConfig("smoke", 32, 2, "train")
