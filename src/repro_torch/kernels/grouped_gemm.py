"""Grouped GEMM for MoE experts: the Hopper kernel, its wrapper and its
plain version.

Replaces the TPU kernel ``repro/kernels/grouped_gemm.py::grouped_gemm`` (body
``_gg_kernel``): per-expert ``x[e] @ w[e]`` over capacity buffers, rows at or
past ``group_sizes[e]`` exactly 0.0, and m-tiles wholly past the group size
doing no multiply.

On an H100 the work is bound by tensor-core operations once an expert holds a
few hundred rows (mixtral's 4096 x 14336 expert reads 117 MB of bf16 weights,
so below ~300 live rows per expert the weights' bytes bound it instead).  The
bf16 path (``din`` and ``dout`` multiples of 8) is persistent: one block per
SM walks the live (expert, 256-column panel, 128-row tile) tiles, reading
``group_sizes`` on the device, with one producer warp keeping TMA loads in
flight through a 4-stage ring and two consumer warpgroups on ``wgmma``; the
dead m-tiles are zeroed by spare warps while the tensor cores work, so they
cost stores and no launch slot.  f32 and odd widths keep a grid of 64x64
tiles on FMA, so f32 stays true f32.  The host's choices (path, tile, grid)
come from the dtype, ``(E, C, din, dout)``, the SM count and the pointers'
alignment, never from ``group_sizes``: reading it would synchronise the
stream, and the oracle times these calls back to back (:func:`grouped_plan`,
which the C launcher mirrors).  All index arithmetic is 64-bit.
Source: ``csrc/grouped_gemm.cu``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# the bf16 path's tile and ring (csrc/grouped_gemm.cu, GG_*)
WGMMA_BM, WGMMA_BN, WGMMA_BK, WGMMA_STAGES = 128, 256, 64, 4
FMA_BM = FMA_BN = 64
SMEM_MAX = 232448       # dynamic shared memory one H100 block can have
GROUP_X_BYTES = 16 << 20  # X one raster group of m-tiles keeps in L2


class GemmPlan(NamedTuple):
    path: str           # "wgmma" or "fma"
    bm: int             # rows of an output tile
    bn: int             # columns of an output tile
    blocks: int         # blocks launched
    smem: int           # dynamic shared memory per block, bytes
    mgroup: int         # m-tiles per raster group of the walk (0: no walk)


def grouped_plan(dtype_code: int, E: int, C: int, din: int, dout: int,
                 n_sm: int, aligned: bool = True) -> GemmPlan:
    """The launch ``frontier_grouped_gemm`` makes, from shapes alone.

    ``dtype_code`` as :func:`_build.dtype_code`; ``n_sm``: the card's SM
    count; ``aligned``: x, w and y start on 16-byte boundaries (TMA's rule).
    bf16 with ``din`` and ``dout`` multiples of 8 (and ``din > 0``) takes the
    persistent ``wgmma`` kernel on ``min(n_sm, tiles)`` blocks, where
    ``tiles`` counts every output tile the capacity could hold live, walking
    an expert's m-tiles in raster groups whose rows of x fit
    ``GROUP_X_BYTES``.  Everything else takes the FMA grid.
    """
    smem = (1024 + WGMMA_STAGES * (WGMMA_BM + WGMMA_BN) * WGMMA_BK * 2
            + 2 * WGMMA_STAGES * 8 + 4 * (E + 1))
    if (dtype_code == 1 and din > 0 and din % 8 == 0 and dout % 8 == 0
            and aligned and smem <= SMEM_MAX):
        tiles = E * math.ceil(C / WGMMA_BM) * math.ceil(dout / WGMMA_BN)
        mgroup = max(1, GROUP_X_BYTES // (WGMMA_BM * din * 2))
        return GemmPlan("wgmma", WGMMA_BM, WGMMA_BN, min(n_sm, tiles), smem,
                        mgroup)
    blocks = math.ceil(dout / FMA_BN) * math.ceil(C / FMA_BM) * E
    return GemmPlan("fma", FMA_BM, FMA_BN, blocks, 0, 0)


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """x (E,C,din); w (E,din,dout); rows >= group_sizes[e] are masked to 0."""
    E, C, _ = x.shape
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    mask = torch.arange(C, device=x.device)[None, :] < group_sizes[:, None]
    return (y * mask[..., None]).to(x.dtype)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                 group_sizes: torch.Tensor) -> torch.Tensor:
    """x (E,C,din) @ w (E,din,dout) with per-expert row validity.

    A CUDA tensor goes to the kernel (float32 or bfloat16); a CPU tensor goes
    to the plain version.  A failed build or launch raises.
    """
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm runs on cuda or cpu, not {x.device}")
    E, C, din = x.shape
    dout = w.shape[2]
    if w.shape[:2] != (E, din) or group_sizes.shape != (E,):
        raise ValueError(f"bad shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"group_sizes{tuple(group_sizes.shape)}")
    if x.dtype != w.dtype:
        raise TypeError("x and w must share one dtype")
    code = _build.dtype_code(x.dtype)
    x, w = x.contiguous(), w.contiguous()
    gs = group_sizes.to(device=x.device, dtype=torch.int32).contiguous()
    y = torch.empty((E, C, dout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:       # nothing to compute: no launch, no count
        return y
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_grouped_gemm(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), gs.data_ptr(), code,
            E, C, din, dout, stream)
    _build.check(err, "grouped_gemm")
    grouped_gemm.launches += 1
    return y


#: kernel launches made through this wrapper (plain-version calls not counted)
grouped_gemm.launches = 0
