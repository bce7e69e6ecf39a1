"""Decode attention: the Hopper kernel, its wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::decode_attention``
(body ``_decode_kernel``): one query token per sequence against a KV cache,
positions at or past ``lengths[b]`` masked, KV tiles past the length skipped,
and the ``G = H/K`` query heads of a group sharing each KV tile.

On an H100 the work is bound by bytes: every key and value is read once and
used for ``4 G`` operations, far below the card's ~295 FLOP per byte, so the
least time is the valid cache's bytes over 3.35 TB/s.  The TPU kernel walks a
row's tiles in order on one core; here that walk is split over the keys
(flash-decoding): a block owns ``span`` keys of one ``(batch, kv-head)`` and
all ``G`` query rows, so each KV byte is read once per group, and a second
small kernel merges the splits' ``(m, l, o)`` in a fixed order.  The blocks
read ``lengths[b]`` themselves: a split past the length returns at once, and
the host never reads ``lengths`` (that would synchronise the stream), so the
split count follows from ``B``, ``K`` and the capacity ``T`` alone
(:func:`decode_splits`).  Inside a split, K/V tiles stream through a
``cp.async`` double buffer in their own dtype and each warp keeps its own
online softmax over a quarter of every tile.  Source:
``csrc/decode_attention.cu``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import NEG_INF

SPLIT_MIN_KEYS = 128    # the fewest keys a split owns
SPLIT_ALIGN = 64        # a split's span is a whole number of the kernel's bf16 tiles
BLOCKS_PER_SM = 32      # the grid that counts as filling the card


def decode_splits(B: int, K: int, T: int, n_sm: int = 132) -> int:
    """How many key splits the decode kernel runs for a (B, T, K) cache.

    From the shapes alone, never from ``lengths``.  One split when the
    ``B * K`` blocks already fill the card (``BLOCKS_PER_SM`` per SM: lengths
    are unknown and skewed, so more blocks than SMs balance a long row against
    short ones); otherwise enough splits to reach that grid, at most one per
    ``SPLIT_MIN_KEYS`` keys of capacity.  Always at least 1, and
    ``split_span(T, n)`` keys per split cover ``T`` with exactly ``n`` splits.
    """
    rows, target = B * K, BLOCKS_PER_SM * n_sm
    if rows >= target or T <= SPLIT_MIN_KEYS:
        return 1
    want = min(math.ceil(target / rows), math.ceil(T / SPLIT_MIN_KEYS))
    return math.ceil(T / split_span(T, want))


def split_span(T: int, splits: int) -> int:
    """Keys per split: ``T / splits`` rounded up to a multiple of ``SPLIT_ALIGN``."""
    return max(1, math.ceil(math.ceil(T / splits) / SPLIT_ALIGN) * SPLIT_ALIGN)


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
    splits = decode_splits(B, K, T, _n_sm(q.device))
    span = split_span(T, splits)
    part_o = part_ml = None
    if splits > 1:           # f32 partials of every split: o (hd values), then (m, l)
        rows = splits * B * H
        part = torch.empty(rows * (hd + 2), dtype=torch.float32, device=q.device)
        part_o = part.data_ptr()
        part_ml = part_o + rows * hd * part.element_size()
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
            lens.data_ptr(), part_o, part_ml, code, B, T, H, K, hd, splits,
            span, strides, hd ** -0.5, stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


#: kernel launches made through this wrapper (one per call that launches,
#: whether or not the combine pass ran; plain-version calls not counted)
decode_attention.launches = 0
