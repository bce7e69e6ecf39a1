"""Weights made from ``--seed`` on the device, in the type they are served in.

Each part (the embedding, the head with the final norm, each layer) is one
draw of a generator of its own, seeded from (seed, part), cut into its
leaves and scaled leaf by leaf.  So set-up makes a layer in one call, and
the plain reference makes any layer again, alone and bit for bit, after the
program has been freed: it never reads a tensor the program held.

The layout is the configuration's family's (``arch/<family>.py``:
``layer_leaves`` by layer index, ``outer_leaves`` by part), named as in
the served engine's parameter tree: the outer parts' leaves at its top,
``layers`` a tuple of per-layer dicts.  The reference reads the same names.
The standard deviations below are the families' common ones.  RMSNorm
scales are zero-centred, ``y * (1 + w)``, as the engine applies them, drawn
small and non-zero so that a norm applied wrongly shows.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.spec import family

NORM_STD = 0.1          # zero-centred RMSNorm scales: 1 + N(0, 0.1^2)
EMBED_STD = 0.02
HEAD_STD = 0.02
ROUTER_STD = 0.02

Leaf = Tuple[str, Tuple[int, ...], float]


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
    return make_part(family(m).layer_leaves(m, layer), seed, f"layer{layer}", dtype, device)


def make_outer(m: Dict, seed: int, part: str, dtype, device) -> Dict:
    return make_part(family(m).outer_leaves(m)[part], seed, part, dtype, device)


def make_tree(m: Dict, seed: int, dtype, device) -> Dict:
    """The engine's parameter tree for the run's seed: each outer part's
    leaves at the top, then ``layers``."""
    tree: Dict = {}
    for part in family(m).outer_leaves(m):
        tree.update(make_outer(m, seed, part, dtype, device))
    tree["layers"] = tuple(make_layer(m, seed, i, dtype, device) for i in range(m["L"]))
    return tree
