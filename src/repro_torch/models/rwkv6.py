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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


def _tm_project(cfg: ModelConfig, p, x, xz):
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
    dec = p["w0"].float() + torch.tanh(wx @ p["w_a"].float()) @ p["w_b"].float()
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
    r, k, v, g, w = _tm_project(cfg, p, x, xz)
    u = p["u"].float().reshape(H, hs)
    state0 = prev_state.float()

    if ax.opt("rwkv_impl", "scan") == "chunked":
        # the reference's chunked path keeps y in f32 for the head norm
        y, state = ops.wkv_chunked(r, k, v, w, u, state0=state0,
                                   chunk=int(ax.opt("rwkv_chunk", 16)),
                                   return_state=True, out_dtype=torch.float32)
    else:
        rf, kf, vf = r.float(), k.float(), v.float()
        state, ys = state0, []
        for t in range(T):
            state, yt = _wkv_step(state, (rf[:, t], kf[:, t], vf[:, t], w[:, t]), u)
            ys.append(yt)
        y = torch.stack(ys, dim=1)                          # (B,T,H,hs)

    y = _headnorm(cfg, p, y, B, T, d).to(x.dtype) * g
    return y @ p["wo"], x[:, -1, :], state


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
    r, k, v, g, w = _tm_project(cfg, p, x, xz)
    u = p["u"].float().reshape(H, hs)
    state, y = _wkv_step(
        prev_state.float(),
        (r.float()[:, 0], k.float()[:, 0], v.float()[:, 0], w[:, 0]), u)
    y = _headnorm(cfg, p, y[:, None].reshape(B, 1, H, hs), B, 1, d).to(x.dtype) * g
    return y @ p["wo"], x[:, -1, :], state


def channelmix_apply(cfg: ModelConfig, p, x, ax: AxisRules, *, prev_shift):
    """RWKV channel-mix (relu^2 FFN with token shift)."""
    xz = _shifted(x, prev_shift)
    mix = p["mix_k"].float()
    xf = x.float()
    xm = (xf + (xz.float() - xf) * mix).to(x.dtype)
    h = torch.square(F.relu(xm @ p["wk"]))
    return h @ p["wv"], x[:, -1, :]
