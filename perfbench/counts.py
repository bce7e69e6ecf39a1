"""Operations and bytes the served work needs, from the configuration's
shapes alone, and the card's published peaks.  The peaks and the positions
a request decodes at are the same for every architecture; each count is
the configuration's family's (``arch/<family>.py``), found by ``m["arch"]``.

What is counted is what the inputs need, not what the program does: a
prefill's real prompt tokens (never its bucket's padding), a decode step's
live tokens (never its dead slots), each weight read once a step, the live
KV positions read once and each new entry written once.  Copies of the
whole cache, recomputation and padding are left out, so a change that
removes them shows as a higher share.

``m`` is ``spec.model_shapes``: the family's shapes, with ``"arch"``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

from perfbench.spec import family

# Published dense peaks (NVIDIA's data sheet, SXM part, 700 W), by the
# name ``torch.cuda.get_device_name()`` gives.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peak(device_name: str, what: str) -> Optional[float]:
    return PEAKS.get(device_name, {}).get(what)


def weight_params(m: Dict) -> int:
    """Every parameter of the model as run."""
    return family(m).weight_params(m)


def kv_bytes_per_position(m: Dict) -> int:
    """The cache one slot-position holds, every layer."""
    return family(m).kv_bytes_per_position(m)


def prefill_flops(m: Dict, S: int) -> int:
    """A prompt of ``S`` real tokens, and the head at its last position."""
    return family(m).prefill_flops(m, S)


def decode_token_flops(m: Dict, pos: int) -> int:
    """One live token fed at position ``pos``: every layer, then the head."""
    return family(m).decode_token_flops(m, pos)


def decode_step_weight_bytes(m: Dict, batch: int) -> float:
    """Weights a decode step of ``batch`` live tokens reads once."""
    return family(m).decode_step_weight_bytes(m, batch)


def decode_kv_bytes(m: Dict, pos: int) -> int:
    """The cache a live token at ``pos`` reads, and its new entry written."""
    return family(m).decode_kv_bytes(m, pos)


def decode_positions(prompt_len: int, n_tokens: int) -> Iterable[int]:
    """Positions a request's decode steps feed: its first token comes from
    the prefill, each later one from a step at the previous position."""
    return range(prompt_len, prompt_len + n_tokens - 1)
