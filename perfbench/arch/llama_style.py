"""The Llama-style decoder family: every layer the same, RMSNorm before
GQA attention with RoPE (causal, within ``window`` keys where the
configuration states one), then a SwiGLU FFN or, where the configuration
has experts, a softmax-routed top-k MoE; the head on a final RMSNorm,
untied.  Mixtral (arXiv:2401.04088) and Yi (arXiv:2403.04652) are of it.

A family module is found by the ``"arch"`` a configuration file names
(``spec.load_arch``) and defines these plain functions (``spec.INTERFACE``):

- ``shapes(cfg)``: the sizes everything else reads, from the file;
- ``layer_leaves(m, i)``, ``outer_leaves(m)``: the weight layout;
- ``port_config(cfg, m)``: the served engine's ``ModelConfig``;
- ``served_logits(...)``: the plain reference, ``reference/<family>.py``;
- the counts ``counts.py`` hands on: ``prefill_flops``,
  ``decode_token_flops``, ``decode_step_weight_bytes``,
  ``decode_kv_bytes``, ``weight_params``, ``kv_bytes_per_position``,
  counted by ``counts.py``'s rule (what the inputs need, never padding,
  dead slots or copies).

``m`` below is ``shapes(cfg)`` with ``"arch"`` added (``spec.model_shapes``).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List

from perfbench.spec import load_module
from perfbench.weights import EMBED_STD, HEAD_STD, NORM_STD, ROUTER_STD, Leaf

REFERENCE = load_module(Path(__file__).resolve().parents[1] / "reference" / "llama_style.py",
                        "perfbench_reference_llama_style")


def shapes(cfg: Dict) -> Dict:
    """The sizes the counts, the weights and the reference read, from a
    configuration file (the source's own keys, as run): d, H, K, hd, L, V,
    ff (an expert's, for an MoE), theta, eps, window (0 for none), E (0 for
    a dense model), k, capacity_factor, dtype_bytes."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return {
        "d": d, "H": H, "K": cfg["num_key_value_heads"],
        "hd": cfg.get("head_dim") or d // H,
        "L": cfg["num_hidden_layers"], "V": cfg["vocab_size"],
        "ff": cfg["intermediate_size"], "theta": float(cfg["rope_theta"]),
        "eps": float(cfg["rms_norm_eps"]),
        "window": int(cfg["serving"].get("attention_window", 0)),
        "E": int(cfg.get("num_local_experts", 0)),
        "k": int(cfg.get("num_experts_per_tok", 0)),
        "capacity_factor": float(cfg["serving"].get("moe_capacity_factor", 0.0)),
        "dtype_bytes": {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]],
    }


def layer_leaves(m: Dict, i: int) -> List[Leaf]:
    """(dotted name, shape, std) of decoder layer ``i``'s leaves, in draw
    order; every layer alike."""
    d, H, K, hd = m["d"], m["H"], m["K"], m["hd"]
    leaves: List[Leaf] = [
        ("ln1", (d,), NORM_STD), ("ln2", (d,), NORM_STD),
        ("attn.wq", (d, H, hd), d ** -0.5), ("attn.wk", (d, K, hd), d ** -0.5),
        ("attn.wv", (d, K, hd), d ** -0.5), ("attn.wo", (H, hd, d), (H * hd) ** -0.5),
    ]
    ff = m["ff"]
    if m["E"]:
        E = m["E"]
        leaves += [("moe.router", (d, E), ROUTER_STD),
                   ("moe.w_in", (E, d, ff), d ** -0.5),
                   ("moe.w_gate", (E, d, ff), d ** -0.5),
                   ("moe.w_out", (E, ff, d), ff ** -0.5)]
    else:
        leaves += [("mlp.w_in", (d, ff), d ** -0.5),
                   ("mlp.w_gate", (d, ff), d ** -0.5),
                   ("mlp.w_out", (ff, d), ff ** -0.5)]
    return leaves


def outer_leaves(m: Dict) -> Dict[str, List[Leaf]]:
    """The parts outside the layers: the embedding; the head and final norm."""
    return {"embed": [("embed", (m["V"], m["d"]), EMBED_STD)],
            "head": [("final_norm", (m["d"],), NORM_STD),
                     ("head", (m["d"], m["V"]), HEAD_STD)]}


def engine_config(cfg: Dict, m: Dict):
    """The engine's ModelConfig that the file's ``port`` names: its depth,
    norm epsilon and attention window set from the file, every size that
    ``shapes`` reads held to the file's, and refused where one differs."""
    from repro_torch.configs import get_config
    port = cfg["port"]
    pc = get_config(port["name"], smoke=bool(port.get("smoke", False)))
    pc = dataclasses.replace(pc, num_layers=int(cfg["num_hidden_layers"]),
                             rms_eps=float(cfg["rms_norm_eps"]),
                             sliding_window=m["window"])
    got = {"d": pc.d_model, "H": pc.num_heads, "K": pc.num_kv_heads,
           "hd": pc.resolved_head_dim, "V": pc.vocab_size, "theta": pc.rope_theta,
           "eps": pc.rms_eps, "window": pc.sliding_window,
           "ff": pc.moe.expert_d_ff if pc.moe else pc.d_ff,
           "E": pc.moe.num_experts if pc.moe else 0,
           "k": pc.moe.top_k if pc.moe else 0,
           "capacity_factor": pc.moe.capacity_factor_eval if pc.moe else 0.0}
    bad = {k: (m[k], v) for k, v in got.items() if m[k] != v}
    if bad:
        raise ValueError(f"the engine's {port['name']} differs from the "
                         f"configuration file (file, engine): {bad}")
    return pc


def port_config(cfg: Dict, m: Dict):
    """``engine_config``, refused where the engine's layers lie outside the
    family: tied, not gated SiLU, q/k norms, softcaps, norms after the
    block, layers of more than one kind, or a window on layers the engine
    does not window."""
    from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
    pc = engine_config(cfg, m)
    kinds = set(pc.block_pattern)
    outside = [what for what, found in (
        ("tied embeddings", pc.tie_embeddings),
        ("an FFN that is not gated SiLU", not pc.gated_mlp or pc.mlp_act != "silu"),
        ("q/k norms", pc.qk_norm),
        ("softcaps", pc.attn_logit_softcap or pc.final_logit_softcap),
        ("norms after the block", pc.post_block_norm),
        (f"layers {sorted(kinds)}", kinds not in ({ATTN_GLOBAL}, {ATTN_LOCAL})),
        (f"a window of {m['window']} on unwindowed layers",
         m["window"] and kinds != {ATTN_LOCAL})) if found]
    if outside:
        raise ValueError(f"the engine's {cfg['port']['name']} is not of the llama_style "
                         f"family: {', '.join(outside)}")
    return pc


def served_logits(m: Dict, seed: int, seqs, *, dtype, device, precision: str = "f32"):
    """The plain reference's float32 logits at each position that predicts a
    served token (``reference/llama_style.py``); ``precision`` ``"f32"``,
    ``"bf16"`` (a witness at the program's precision) or ``"fp8"`` (the
    control)."""
    return REFERENCE.served_logits(m, seed, seqs, dtype=dtype, device=device,
                                   precision=precision)


# ---- counts -------------------------------------------------------------

def attn_matmul_params(m: Dict) -> int:
    d, H, K, hd = m["d"], m["H"], m["K"], m["hd"]
    return d * H * hd + 2 * d * K * hd + H * hd * d


def expert_params(m: Dict) -> int:
    """One expert's (or the dense FFN's) gated MLP: gate, up and down."""
    return 3 * m["d"] * m["ff"]


def layer_params(m: Dict) -> int:
    """Every parameter of one layer: attention, two norms, the FFN (all
    experts and the router, for an MoE)."""
    ffn = m["d"] * m["E"] + m["E"] * expert_params(m) if m["E"] else expert_params(m)
    return attn_matmul_params(m) + 2 * m["d"] + ffn


def weight_params(m: Dict) -> int:
    """The whole model: embedding, layers, final norm, untied head."""
    return 2 * m["V"] * m["d"] + m["d"] + m["L"] * layer_params(m)


def weight_bytes(m: Dict) -> int:
    return weight_params(m) * m["dtype_bytes"]


def kv_bytes_per_position(m: Dict) -> int:
    """K and V of one slot-position in every layer."""
    return m["L"] * 2 * m["K"] * m["hd"] * m["dtype_bytes"]


def attended(m: Dict, pos: int) -> int:
    """Keys a query at 0-based position ``pos`` attends (itself included)."""
    return min(pos + 1, m["window"]) if m["window"] else pos + 1


def token_matmul_params(m: Dict) -> int:
    """Weights one token multiplies by in one layer: attention, and the
    router with its top-k experts, or the dense FFN."""
    if m["E"]:
        return attn_matmul_params(m) + m["d"] * m["E"] + m["k"] * expert_params(m)
    return attn_matmul_params(m) + expert_params(m)


def _attn_flops(m: Dict, keys: int) -> int:
    """Scores and the weighted sum of one query over ``keys`` keys, all
    layers: 2 * hd * keys each, for every query head."""
    return m["L"] * 4 * m["H"] * m["hd"] * keys


def prefill_flops(m: Dict, S: int) -> int:
    """A prompt of ``S`` real tokens, causal, and the head at its last
    position (the first served token)."""
    keys = sum(attended(m, i) for i in range(S))
    return (2 * m["L"] * token_matmul_params(m) * S + _attn_flops(m, keys)
            + 2 * m["d"] * m["V"])


def decode_token_flops(m: Dict, pos: int) -> int:
    """One live token fed at position ``pos``: every layer, then the head."""
    return (2 * m["L"] * token_matmul_params(m) + _attn_flops(m, attended(m, pos))
            + 2 * m["d"] * m["V"])


def experts_hit(m: Dict, batch: int) -> float:
    """Experts a step of ``batch`` live tokens reads in one layer: all of a
    dense model's FFN; for an MoE, the expected number of distinct experts
    that ``batch`` tokens' top-k choices hit when routing is uniform."""
    if not m["E"]:
        return 1.0
    E, k = m["E"], m["k"]
    return E * (1.0 - (1.0 - k / E) ** batch)


def decode_step_weight_bytes(m: Dict, batch: int) -> float:
    """Weights a decode step of ``batch`` live tokens reads once: each
    layer's attention, norms, router and the experts its tokens hit, the
    final norm and head, and one embedding row per token."""
    b = m["dtype_bytes"]
    per_layer = attn_matmul_params(m) + 2 * m["d"] + m["d"] * m["E"]
    per_layer += experts_hit(m, batch) * expert_params(m)
    return b * (m["L"] * per_layer + m["d"] + m["d"] * m["V"] + batch * m["d"])


def decode_kv_bytes(m: Dict, pos: int) -> int:
    """A live token at ``pos``: the earlier positions it attends read once,
    its own new entry written once."""
    return attended(m, pos) * kv_bytes_per_position(m)
