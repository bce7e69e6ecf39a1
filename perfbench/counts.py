"""Operations and bytes the served work needs, from the configuration's
shapes alone, and the card's published peaks.

What is counted is what the inputs need, not what the program does: a
prefill's real prompt tokens (never its bucket's padding), a decode step's
live tokens (never its dead slots), each weight read once a step, the live
KV positions read once and each new entry written once.  Copies of the
whole cache, recomputation and padding are left out, so a change that
removes them shows as a higher share.

``m`` is ``spec.model_shapes``: d, H, K, hd, L, V, ff, E (0 for a dense
model), k, window (0 for none), dtype_bytes.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

# Published dense peaks (NVIDIA's data sheet, SXM part, 700 W), by the
# name ``torch.cuda.get_device_name()`` gives.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peak(device_name: str, what: str) -> Optional[float]:
    return PEAKS.get(device_name, {}).get(what)


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


def decode_positions(prompt_len: int, n_tokens: int) -> Iterable[int]:
    """Positions a request's decode steps feed: its first token comes from
    the prefill, each later one from a step at the previous position."""
    return range(prompt_len, prompt_len + n_tokens - 1)
