"""The plain float32 reference of the ``llama_style`` family, in plain torch.

One sequence at a time, no cache, no batching, layer by layer: each layer's
weights are made again from the run's seed (``perfbench.weights``), cast to
float32, used for every sequence, and dropped, so a 16-layer Mixtral stage
fits beside nothing else.  TF32 is off.

The equations, as published for Llama-style decoders (Mixtral,
arXiv:2401.04088; Yi, arXiv:2403.04652):

- RMSNorm with a zero-centred scale: ``x / rms(x) * (1 + w)``;
- GQA attention: H query heads share K key/value heads; rotary embedding
  on q and k (the two halves of each head rotated by
  ``theta ** (-i / (hd/2))``); causal, and within ``window`` keys where the
  configuration states one;
- FFN: SwiGLU, ``(silu(x W_gate) * (x W_in)) W_out``; for an MoE, a softmax
  router whose top-k probabilities, renormalised to sum to one, weight
  their experts' outputs;
- the head on the final RMSNorm, untied.

MoE capacity (GShard-style, capacity factor ``cf``).  The served engine
prefills one request at a time, padded to a bucket of ``B`` tokens, and
each expert there keeps the first ``min(kB, max(16, ceil(cf kB / E)))``
tokens routed to it, in token order; the padding comes last, so it never
displaces a real token.  The reference applies that capacity to the
prompt's positions.  A decode token shares its step's capacity with the
other slots' tokens, which the reference does not see; alone, a token is
never dropped (the capacity is at least 16 > k), so the reference drops no
decode token.

``precision="fp8"`` computes every product with a weight (projections,
router, experts, head) from float8 e4m3 operands: each weight scaled per
output column and each activation per row, both to the format's largest
value, 448.  It is the control: the precision below the configuration's
bfloat16.  ``precision="bf16"`` rounds those products' operands and
results, and the residual stream, to bfloat16: a second witness, the
reference at the program's own precision.

Another family's reference may reuse these pieces: ``forward`` runs the
embedding, the layers and the head for any ``layer_weights`` and ``block``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from perfbench.weights import make_layer, make_outer

FP8_MAX = 448.0
Q_BLOCK = 1024          # query rows scored at a time


def q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def rounding(prec: str):
    """What the residual stream is rounded by between sublayers."""
    return bf if prec == "bf16" else (lambda t: t)


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (T, din) @ w (din, dout); the weight already quantized for fp8."""
    if prec == "fp8":
        return q8(x, -1) @ w
    if prec == "bf16":
        return bf(bf(x) @ w)
    return x @ w


def layer_weights(raw: Dict, m: Dict, prec: str) -> Dict[str, torch.Tensor]:
    """The layer's weights as 2-D float32 matrices (din, dout), per expert
    (E, din, dout), quantized per output column for fp8."""
    d, H, K, hd = m["d"], m["H"], m["K"], m["hd"]
    w = {"ln1": raw["ln1"].float(), "ln2": raw["ln2"].float(),
         "wq": raw["attn"]["wq"].float().reshape(d, H * hd),
         "wk": raw["attn"]["wk"].float().reshape(d, K * hd),
         "wv": raw["attn"]["wv"].float().reshape(d, K * hd),
         "wo": raw["attn"]["wo"].float().reshape(H * hd, d)}
    ffn = raw["moe"] if m["E"] else raw["mlp"]
    for name in ("w_in", "w_gate", "w_out"):
        w[name] = ffn[name].float()
    if m["E"]:
        w["router"] = raw["moe"]["router"].float()
    if prec == "fp8":
        for name, t in w.items():
            if t.ndim >= 2:
                w[name] = q8(t, -2)
    return w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, n, hd) at positions 0..T-1."""
    T, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(m: Dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA over q (T, H, hd), k and v (T, K, hd), within
    ``m["window"]`` keys where it is not 0: (T, H * hd)."""
    T, H, hd = q.shape
    K = k.shape[1]
    q = q.reshape(T, K, H // K, hd)
    keys = torch.arange(T, device=q.device)
    out = torch.empty((T, K, H // K, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, T, Q_BLOCK):
        rows = keys[q0:q0 + Q_BLOCK]
        s = torch.einsum("qkgd,tkd->kgqt", q[q0:q0 + Q_BLOCK], k) / math.sqrt(hd)
        ok = keys[None, :] <= rows[:, None]
        if m["window"]:
            ok &= rows[:, None] - keys[None, :] < m["window"]
        s = s.masked_fill(~ok, float("-inf"))
        out[q0:q0 + Q_BLOCK] = torch.einsum("kgqt,tkd->qkgd", torch.softmax(s, -1), v)
    return out.reshape(T, H * hd)


def attention(m: Dict, w: Dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    T = h.shape[0]
    H, K, hd = m["H"], m["K"], m["hd"]
    q = rope(mm(h, w["wq"], prec).reshape(T, H, hd), m["theta"])
    k = rope(mm(h, w["wk"], prec).reshape(T, K, hd), m["theta"])
    v = mm(h, w["wv"], prec).reshape(T, K, hd)
    return mm(attend(m, q, k, v), w["wo"], prec)


def capacity(m: Dict, bucket: int) -> int:
    A = bucket * m["k"]
    return min(A, max(16, math.ceil(m["capacity_factor"] * A / m["E"])))


def moe(m: Dict, w: Dict, h: torch.Tensor, prompt_len: int, cap: int,
        prec: str) -> torch.Tensor:
    E, k = m["E"], m["k"]
    probs = torch.softmax(mm(h, w["router"], prec), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.ones_like(ids, dtype=torch.bool)
    for e in range(E):            # capacity over the prompt, in token order
        hits = ids[:prompt_len] == e
        rank = torch.cumsum(hits.any(-1).long(), 0)
        keep[:prompt_len] &= ~(hits & (rank > cap)[:, None])
    y = torch.zeros_like(h)
    for e in range(E):
        sel = (ids == e) & keep
        tok = sel.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        x = h[tok]
        a = F.silu(mm(x, w["w_gate"][e], prec)) * mm(x, w["w_in"][e], prec)
        y[tok] += (gates * sel)[tok].sum(-1, keepdim=True) * mm(a, w["w_out"][e], prec)
    return y


def mlp(w: Dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    a = F.silu(mm(h, w["w_gate"], prec)) * mm(h, w["w_in"], prec)
    return mm(a, w["w_out"], prec)


def ffn(m: Dict, w: Dict, h: torch.Tensor, s: Dict, prec: str) -> torch.Tensor:
    """The MoE at the capacity of the sequence's prefill bucket, or the
    dense SwiGLU."""
    if m["E"]:
        return moe(m, w, h, s["prompt_len"], capacity(m, s["bucket"]), prec)
    return mlp(w, h, prec)


def block(m: Dict, w: Dict, x: torch.Tensor, s: Dict, prec: str) -> torch.Tensor:
    """One decoder layer over sequence ``s``'s stream ``x`` (T, d)."""
    rnd = rounding(prec)
    x = rnd(x + attention(m, w, rnd(rms_norm(x, w["ln1"], m["eps"])), prec))
    h = rnd(rms_norm(x, w["ln2"], m["eps"]))
    return rnd(x + ffn(m, w, h, s, prec))


@torch.no_grad()
def forward(m: Dict, seed: int, seqs: Sequence[Dict], *, dtype, device, precision: str,
            layer_weights=layer_weights, block=block) -> List[torch.Tensor]:
    """The embedding, each layer (``layer_weights`` of its weights drawn
    again from the seed, then ``block`` over every sequence), and the head
    on the final norm at each position that predicts a served token."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        emb = make_outer(m, seed, "embed", dtype, device)["embed"]
        xs = [emb[s["tokens"].to(device)].float() for s in seqs]
        del emb
        for layer in range(m["L"]):
            w = layer_weights(make_layer(m, seed, layer, dtype, device), m, precision)
            xs = [block(m, w, x, s, precision) for x, s in zip(xs, seqs)]
            del w
        head = make_outer(m, seed, "head", dtype, device)
        norm, wh = head["final_norm"].float(), head["head"].float()
        if precision == "fp8":
            wh = q8(wh, -2)
        return [mm(rms_norm(x[s["prompt_len"] - 1:], norm, m["eps"]), wh, precision)
                for x, s in zip(xs, seqs)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def served_logits(m: Dict, seed: int, seqs: Sequence[Dict], *, dtype, device,
                  precision: str = "f32") -> List[torch.Tensor]:
    """Logits (n, V), float32, at each position that predicts a served
    token: ``seqs`` holds ``tokens`` (the prompt and every served token but
    the last, a 1-D int64 tensor), ``prompt_len`` and ``bucket`` (the
    engine's prefill bucket for the prompt)."""
    return forward(m, seed, seqs, dtype=dtype, device=device, precision=precision)
