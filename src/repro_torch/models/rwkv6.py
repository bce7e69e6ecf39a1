"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix.

Port of ``repro/models/rwkv6.py`` (arXiv:2404.05892; token-shift mixes for
r/k/v/g/w, per-channel data-dependent decay ``w_t = exp(-exp(w0 + lora(x_t)))``,
per-head linear-attention state with the first-token bonus ``u``, output
gated and group-normalized).

Full-sequence time-mix runs the recurrence one of two ways, by the option
``rwkv_impl``: ``"scan"`` (default) is a plain loop of single-step state
updates; ``"chunked"`` calls ``kernels.ops.wkv_chunked``, which launches the
hand-written Hopper kernel on a CUDA tensor and its plain version on a CPU
tensor.  Decode is a single state update.

On a mesh r/k/v/g shard on heads over "model" (``timemix_pds``), the block's
outputs are pinned where the reference pins them, and the recurrence runs
per rank on its own heads (``_wkv``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.wkv_chunk import wkv_chunked_plain
from repro_torch.models.common import PD, AxisRules

LORA_DIM = 64


def timemix_pds(cfg: ModelConfig) -> Dict[str, PD]:
    d = cfg.d_model
    return {
        "mix": PD((5, d), (None, "embed"), 0.02),        # r,k,v,g,w token-shift mixes
        "w0": PD((d,), ("embed",), "zeros"),             # decay base
        "w_a": PD((d, LORA_DIM), ("embed", None), 0.02), # decay lora in
        "w_b": PD((LORA_DIM, d), (None, "embed"), 0.02), # decay lora out
        "u": PD((d,), ("embed",), 0.02),                 # first-token bonus
        "wr": PD((d, d), ("embed", "heads")),
        "wk": PD((d, d), ("embed", "heads")),
        "wv": PD((d, d), ("embed", "heads")),
        "wg": PD((d, d), ("embed", "heads")),
        "wo": PD((d, d), ("heads", "embed")),
        "ln_x": PD((d,), ("embed",), "ones"),            # per-head group norm scale
    }


def channelmix_pds(cfg: ModelConfig) -> Dict[str, PD]:
    d = cfg.d_model
    return {
        "mix_k": PD((d,), ("embed",), 0.02),
        "wk": PD((d, cfg.d_ff), ("embed", "mlp")),
        "wv": PD((cfg.d_ff, d), ("mlp", "embed")),
    }


def _shifted(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B,T,D), prev (B,D) = last token of previous chunk -> x_{t-1}."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _tm_project(cfg: ModelConfig, p, x, xz, ax: AxisRules):
    """Compute r,k,v,g,w streams from x and shifted xz.  All (B,T,...)."""
    B, T, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    mix = p["mix"].float()

    def lerp(i):
        # in the input dtype, as the reference; only the decay chain is f32
        return x + (xz - x) * mix[i].to(x.dtype)

    r = (lerp(0) @ p["wr"]).reshape(B, T, H, hs)
    k = (lerp(1) @ p["wk"]).reshape(B, T, H, hs)
    v = (lerp(2) @ p["wv"]).reshape(B, T, H, hs)
    g = F.silu(lerp(3) @ p["wg"])
    wx = lerp(4).float()
    # the decay's last product on each rank's heads, as r/k/v/g (GSPMD
    # splits it so, following the heads it feeds; w_b is replicated); its
    # input stays replicated over "model", its gradient summed there
    lora = torch.tanh(ax.shared_product("btd,dl->btl", wx, p["w_a"].float()))
    lora = ax.constrain(lora, "batch", None, None)
    dec = p["w0"].float() + lora @ ax.constrain(p["w_b"].float(), None, "heads")
    w = torch.exp(-torch.exp(dec)).reshape(B, T, H, hs)   # in (0,1)
    return r, k, v, g, w


def _wkv_step(state, rkvw, u):
    """state (B,H,hs,hs); r,k,v,w (B,H,hs).  Returns (state', y (B,H,hs))."""
    r, k, v, w = rkvw
    kv = k[..., :, None] * v[..., None, :]              # (B,H,hs,hs)
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    state = state * w[..., :, None] + kv
    return state, y


def timemix_apply(cfg: ModelConfig, p, x, ax: AxisRules, *,
                  prev_shift, prev_state) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix.  Returns (y, last_x, last_state)."""
    B, T, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    xz = _shifted(x, prev_shift)
    r, k, v, g, w = _tm_project(cfg, p, x, xz, ax)
    u = p["u"].float().reshape(H, hs)
    state0 = prev_state.float()

    y, state = _wkv(r, k, v, w, u, state0, ax, impl=ax.opt("rwkv_impl", "scan"),
                    chunk=int(ax.opt("rwkv_chunk", 16)))

    y = _headnorm(cfg, p, y, B, T, d).to(x.dtype) * g
    return ax.constrain(y @ p["wo"], "batch", None, "embed"), x[:, -1, :], state


def _wkv_scan(r, k, v, w, u, state0):
    """The plain recurrence, one single-step update after another."""
    rf, kf, vf = r.float(), k.float(), v.float()
    state, ys = state0, []
    for t in range(r.shape[1]):
        state, yt = _wkv_step(state, (rf[:, t], kf[:, t], vf[:, t], w[:, t]), u)
        ys.append(yt)
    return torch.stack(ys, dim=1), state                    # (B,T,H,hs)


def _wkv(r, k, v, w, u, state0, ax: AxisRules, *, impl: str, chunk: int = 16):
    """The WKV recurrence over r/k/v/w (B,T,H,hs) from ``state0``: y in f32
    (the head norm's input) and the final state.  ``impl`` "chunked" is
    ``ops.wkv_chunked`` (the kernel on a CUDA tensor), "scan" the plain loop.

    On a mesh it runs per rank under ``local_map``: r/k/v/w, ``u`` and the
    state on (batch -> data, heads -> model), so each rank launches the
    kernel on its own heads (a custom op DTensor cannot see through), and
    the scan's per-head products never flatten two sharded dims."""
    def run(r, k, v, w, u, state0):
        if impl == "chunked":
            return ops.wkv_chunked(r, k, v, w, u, state0=state0, chunk=chunk,
                                   return_state=True, out_dtype=torch.float32)
        return _wkv_scan(r, k, v, w, u, state0)

    if ax.mesh is None:
        return run(r, k, v, w, u, state0)
    streams = ax.placements(ax.resolve(("batch", None, "heads", None), r.shape))
    heads = ax.placements(ax.resolve(("heads", None), u.shape))
    states = ax.placements(ax.resolve(("batch", "heads", None, None), state0.shape))
    # u is replicated over the batch axes, and each rank's body sees only
    # its rows: u's gradient there is a sum still owed
    return local_map(run, out_placements=(streams, states),
                     in_placements=(streams,) * 4 + (heads, states),
                     in_grad_placements=(streams,) * 4 + (
                         ax.grad_placements(heads, streams), states),
                     redistribute_inputs=True)(
        r, k, v, w, ax.replicated(u), ax.replicated(state0))


def _wkv_chunked(r, k, v, w, u, state0, *, chunk: int = 128):
    """The reference model's chunked WKV6 (``rwkv6.py::_wkv_chunked``) as plain
    PyTorch: the kernel's chunk arithmetic without the clamp on the carried
    k, f32 out, and the final state.  Returns (y, state)."""
    return wkv_chunked_plain(r, k, v, w, u, chunk=chunk, state0=state0,
                             return_state=True, out_dtype=torch.float32,
                             clamp_carry=False)


def _headnorm(cfg, p, y, B, T, d):
    hs = cfg.rwkv_head_size
    yf = y.reshape(B, T, d // hs, hs)
    mu = torch.mean(yf, -1, keepdim=True)
    var = torch.var(yf, -1, keepdim=True, correction=0)   # jnp.var: population
    yf = (yf - mu) * torch.rsqrt(var + 64e-5)
    return yf.reshape(B, T, d) * p["ln_x"].float()


def timemix_decode(cfg: ModelConfig, p, x, ax: AxisRules, *,
                   prev_shift, prev_state):
    """Single-token step.  x (B,1,D)."""
    B, _, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    xz = prev_shift[:, None, :]
    r, k, v, g, w = _tm_project(cfg, p, x, xz, ax)
    u = p["u"].float().reshape(H, hs)
    y, state = _wkv(r, k, v, w, u, prev_state.float(), ax, impl="scan")
    y = _headnorm(cfg, p, y, B, 1, d).to(x.dtype) * g
    return ax.constrain(y @ p["wo"], "batch", None, "embed"), x[:, -1, :], state


def channelmix_apply(cfg: ModelConfig, p, x, ax: AxisRules, *, prev_shift):
    """RWKV channel-mix (relu^2 FFN with token shift)."""
    xz = _shifted(x, prev_shift)
    mix = p["mix_k"].float()
    xf = x.float()
    xm = (xf + (xz.float() - xf) * mix).to(x.dtype)
    h = ax.constrain(torch.square(F.relu(xm @ p["wk"])), "batch", None, "mlp")
    return ax.constrain(h @ p["wv"], "batch", None, "embed"), x[:, -1, :]
