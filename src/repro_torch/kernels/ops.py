"""Public wrappers for the hand-written Hopper kernels.

On a CUDA tensor each wrapper launches its kernel (built from ``csrc/`` at
first use); on a CPU tensor it runs the kernel's plain PyTorch version.  The
choice follows the tensor's device and nothing else.

Head dims that are not a multiple of 128 (kimi's 112) are zero-padded to the
next multiple of 128 here, not inside the kernels, and ``q`` is rescaled by
``hd**-0.5 / padded**-0.5`` so the kernel's own ``padded**-0.5`` comes out as
the true scale; the kernels therefore see head dims of 128 or 256 only.

The tile keywords (``bq``, ``bk``, ``bm``, ``bn``, ``bkk``) are kept so callers
written for the reference port unchanged.  They are accepted and ignored: the
CUDA kernels choose their own tiles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import wkv_chunk as _wkv


def _pad_hd(x: torch.Tensor, align: int = 128):
    hd = x.shape[-1]
    pad = (-hd) % align
    if pad == 0:
        return x, hd
    return F.pad(x, (0, pad)), hd


def _rescale_q(qp: torch.Tensor, hd: int) -> torch.Tensor:
    if qp.shape[-1] == hd:
        return qp                       # ratio is exactly 1.0
    return qp * (hd ** -0.5 / qp.shape[-1] ** -0.5)


def flash_attention(q, k, v, *, causal=True, window=0, bq=128, bk=128):
    qp, hd = _pad_hd(q)
    kp, _ = _pad_hd(k)
    vp, _ = _pad_hd(v)
    # padding v's head dim just widens the output; sliced below
    out = _fa.flash_attention(_rescale_q(qp, hd), kp, vp, causal=causal,
                              window=window)
    return out[..., :hd]


def decode_attention(q, k, v, lengths, *, bk=256):
    qp, hd = _pad_hd(q)
    kp, _ = _pad_hd(k)
    vp, _ = _pad_hd(v)
    out = _dec.decode_attention(_rescale_q(qp, hd), kp, vp, lengths)
    return out[..., :hd]


def grouped_gemm(x, w, group_sizes, *, bm=128, bn=128, bkk=512):
    return _gg.grouped_gemm(x, w, group_sizes)


def wkv_chunked(r, k, v, w, u, *, chunk=16, state0=None, return_state=False,
                out_dtype=None):
    return _wkv.wkv_chunked(r, k, v, w, u, chunk=chunk, state0=state0,
                            return_state=return_state, out_dtype=out_dtype)


#: every kernel wrapper, by name: the launch counters live on these functions
KERNELS = {
    "flash_attention": _fa.flash_attention,
    "decode_attention": _dec.decode_attention,
    "grouped_gemm": _gg.grouped_gemm,
    "wkv_chunked": _wkv.wkv_chunked,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
