"""Prefill attention: the Hopper kernel, its wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(body ``_fwd_kernel``): forward ``softmax(q k^T * hd^-1/2 + mask) v`` by online
softmax with GQA, causal (top-left aligned, ``q_pos >= k_pos``) and
sliding-window masks; a row with no valid key gives 0.

On an H100 the work is bound by operations: a causal S = T = 2048 prefill at
32 heads of 128 does 34 GFLOP on 42 MB of q/k/v/o in bf16, far above the
card's ~295 FLOP per byte.  The design therefore keeps the running
``(m, l, acc)`` in registers for the whole KV loop (one block per
``(batch, head, q-tile)``; the TPU kernel's sequential innermost grid axis
becomes that loop), makes the causal and window tile skips the loop's bounds,
and masks ragged ``S`` and ``T`` on load from the caller's strided tensors
instead of padding and transposing copies.  bf16 runs on Hopper's warpgroup
tensor-core products (``wgmma``): 128-row q-tiles as two warpgroups, K/V tiles
arriving through a ``cp.async`` ring while the current tile is multiplied,
causal q-tiles scheduled heaviest first.  f32 inputs take an FMA path so the
result is true f32.  Source: ``csrc/flash_attention.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38   # the plain version's mask value, as in the reference


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,K,hd) with H % K == 0.  f32 accumulation."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, S, K, g, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qi >= ki
    if window:
        ok &= (qi - ki) < window
    s = torch.where(ok[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,K,hd).  Returns (B,S,H,hd).

    A CUDA tensor goes to the kernel, which takes ``hd`` of 128 or 256 (the
    ``ops`` wrapper pads) and float32 or bfloat16; a CPU tensor goes to the
    plain version.  Nothing else is tried: a failed build or launch raises.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if hd not in (128, 256):
        raise ValueError(f"kernel head dim must be 128 or 256, got {hd}")
    if H % K or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    code = _build.dtype_code(q.dtype)
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:     # nothing to compute: no launch, no count
        return out
    strides = _build.stride_array(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2))
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
            B, S, T, H, K, hd, strides, hd ** -0.5, int(bool(causal)),
            int(window), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


#: kernel launches made through this wrapper (plain-version calls not counted)
flash_attention.launches = 0
