"""The comparison that decides ``correct``.

Once the window has closed and the engine is freed, a sample of the
window's finished requests (the longest among them, the rest drawn from the
seed) is replayed by the plain reference of the configuration's family
(``served_logits`` of ``arch/<family>.py``, ``reference/<family>.py``,
float32), once over each prompt with its served tokens.  The engine decodes
greedily, so each served token should be the reference's best at its
position, up to rounding.  Each served token's gap is how far its logit
lies below the reference's best there; a cell's limits name the numbers
compared: the widest gap (``max_logit_gap``) or the mean gap
(``mean_logit_gap``).

The control puts the reference computed from float8 operands in the
program's place: at the same positions, the gaps of the tokens that the
fp8 reference puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from perfbench import traffic
from perfbench.spec import Cell, family, model_shapes


def sample(requests: Sequence, n: int, seed: int) -> List:
    """The longest finished request and ``n - 1`` others drawn from the seed."""
    done = [r for r in requests if r.ok]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].prompt) + len(done[i].tokens))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(traffic.seed_words(seed) + [0xC0FFEE])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def _seqs(chosen: Sequence, max_seq: int, device) -> List[Dict]:
    import torch
    return [{"tokens": torch.tensor(np.concatenate([r.prompt, r.tokens[:-1]]).astype(np.int64),
                                    device=device),
             "prompt_len": len(r.prompt),
             "bucket": traffic.prefill_bucket(len(r.prompt), max_seq)} for r in chosen]


def _stats(g) -> Dict[str, float]:
    """Readings of per-token gaps: the widest, the mean (the numbers a
    cell's limits may name), high quantiles, and the share of tokens that
    are not the reference's best."""
    import torch
    q = torch.quantile(g, torch.tensor([0.9, 0.99], device=g.device)).tolist()
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "p99": q[1], "p90": q[0], "not_best": float((g > 0).float().mean()),
            "tokens_compared": int(g.numel())}


def verdict(reading: Dict[str, float], limits: Dict[str, float]):
    """(whether every number a cell's limits name lies within its limit,
    each number beside its limit): the same judgement for the program's
    reading and for the control's."""
    checks = {name: {"value": reading.get(name), "limit": limit}
              for name, limit in limits.items()}
    return (all(c["value"] is not None and c["value"] <= c["limit"]
                for c in checks.values()), checks)


def readings(cell: Cell, chosen: Sequence, *, seed: int, dtype, device,
             lower: Sequence[str] = ()) -> Dict[str, Dict[str, float]]:
    """The readings of the served tokens (``program``) and, for each
    precision in ``lower``, of the tokens that the reference computed in it
    puts first at the same positions: ``fp8`` is the control, ``bf16`` a
    second witness at the program's own precision."""
    import torch
    m = model_shapes(cell.config, cell.base)
    served_logits = family(m).served_logits
    seqs = _seqs(chosen, int(cell.traffic["max_seq"]), device)
    ref = served_logits(m, seed, seqs, dtype=dtype, device=device)
    best = [lg.max(-1).values for lg in ref]

    def per_token(picks):
        return torch.cat([b - lg.gather(-1, t[:, None])[:, 0]
                          for b, lg, t in zip(best, ref, picks)])
    out = {"program": _stats(per_token(
        [torch.tensor(r.tokens, dtype=torch.int64, device=device) for r in chosen]))}
    for prec in lower:
        low = served_logits(m, seed, seqs, dtype=dtype, device=device, precision=prec)
        out[prec] = _stats(per_token([lg.argmax(-1) for lg in low]))
    return out
