"""Weights made from ``--seed`` on the device, in the type they are served in.

Each part (the embedding, the head with the final norm, each layer) is one
draw of a generator of its own, seeded from (seed, part), cut into its
leaves and scaled leaf by leaf.  So set-up makes a layer in one call, and
the plain reference makes any layer again, alone and bit for bit, after the
program has been freed: it never reads a tensor the program held.

The layout is the served engine's parameter tree (``layers`` a tuple of
per-layer dicts, leaves named as there); the reference reads the same names.
RMSNorm scales are zero-centred, ``y * (1 + w)``, as the engine applies
them, drawn small and non-zero so that a norm applied wrongly shows.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

NORM_STD = 0.1          # zero-centred RMSNorm scales: 1 + N(0, 0.1^2)
EMBED_STD = 0.02
HEAD_STD = 0.02
ROUTER_STD = 0.02

Leaf = Tuple[str, Tuple[int, ...], float]


def layer_leaves(m: Dict) -> List[Leaf]:
    """(dotted name, shape, std) of one decoder layer's leaves."""
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


def part_seed(seed: int, part: str) -> int:
    """A 63-bit generator seed for one part, from the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [ord(c) for c in part]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def make_part(leaves: List[Leaf], seed: int, part: str, dtype, device) -> Dict:
    """One draw for the whole part, cut into its leaves (views), scaled."""
    sizes = [int(np.prod(shape)) for _, shape, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(part_seed(seed, part))
    flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
    out, off = {}, 0
    for (name, shape, std), n in zip(leaves, sizes):
        view = flat[off:off + n].view(shape)
        view.mul_(std)
        out[name] = view
        off += n
    return _nest(out)


def make_layer(m: Dict, seed: int, layer: int, dtype, device) -> Dict:
    return make_part(layer_leaves(m), seed, f"layer{layer}", dtype, device)


def make_outer(m: Dict, seed: int, part: str, dtype, device) -> Dict:
    return make_part(outer_leaves(m)[part], seed, part, dtype, device)


def make_tree(m: Dict, seed: int, dtype, device) -> Dict:
    """The engine's parameter tree for the run's seed."""
    head = make_outer(m, seed, "head", dtype, device)
    return {"embed": make_outer(m, seed, "embed", dtype, device)["embed"],
            "final_norm": head["final_norm"], "head": head["head"],
            "layers": tuple(make_layer(m, seed, i, dtype, device)
                            for i in range(m["L"]))}
