"""Decode attention: the Hopper kernel, its wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::decode_attention``
(body ``_decode_kernel``): one query token per sequence against a KV cache,
positions at or past ``lengths[b]`` masked, KV tiles past the length skipped,
and the ``G = H/K`` query heads of a group sharing each KV tile.

On an H100 the work is bound by bytes: every key and value is read once and
used for ``4 G`` operations per element, far below the card's ~295 FLOP per
byte, so the least time is the valid cache's bytes over 3.35 TB/s.  The design
reads each KV tile from device memory once per group (one block per
``(batch, kv-head)``, all ``G`` query rows together), reads ``lengths[b]``
inside the block so the loop ends at the true length, and widens tiles to f32
in shared memory so one FMA path serves f32 and bf16.  Its limit:
``B * K`` blocks leave most of the 132 SMs idle at small batch; a split-KV
pass is the remedy and is not done here.  Source: ``csrc/decode_attention.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import NEG_INF


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,hd); k/v (B,T,K,hd); lengths (B,) valid prefix per row."""
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, K, g, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    ok = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd); k/v (B,T,K,hd); lengths (B,) integers.  -> (B,H,hd).

    A CUDA tensor goes to the kernel (``hd`` of 128 or 256, float32 or
    bfloat16, at most ``16 * 256 / hd`` query heads per KV head); a CPU tensor
    goes to the plain version.  A failed build or launch raises.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if hd not in (128, 256):
        raise ValueError(f"kernel head dim must be 128 or 256, got {hd}")
    if H % K or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd \
            or lengths.shape != (B,):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} lengths{tuple(lengths.shape)}")
    if H // K > 16 * 256 // hd:
        raise ValueError(f"kernel takes at most {16 * 256 // hd} query heads "
                         f"per KV head at head dim {hd}, got {H // K}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    code = _build.dtype_code(q.dtype)
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:     # nothing to compute: no launch, no count
        return out
    strides = _build.stride_array(
        q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1))
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lens.data_ptr(), code, B, T, H, K, hd, strides, hd ** -0.5, stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


#: kernel launches made through this wrapper (plain-version calls not counted)
decode_attention.launches = 0
