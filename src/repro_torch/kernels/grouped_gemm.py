"""Grouped GEMM for MoE experts: the Hopper kernel, its wrapper and its
plain version.

Replaces the TPU kernel ``repro/kernels/grouped_gemm.py::grouped_gemm`` (body
``_gg_kernel``): per-expert ``x[e] @ w[e]`` over capacity buffers, rows at or
past ``group_sizes[e]`` exactly 0.0, and m-tiles wholly past the group size
doing no multiply.

On an H100 the work is bound by operations once an expert holds a few hundred
rows (mixtral's 4096 x 14336 expert reads 117 MB of bf16 weights, so below
~300 live rows per expert the weights' bytes bound it instead).  The design is
a grid ``(n-tiles, m-tiles, E)`` with the K loop inside the block and the
accumulator in registers (the TPU kernel's sequential contraction axis becomes
that loop); bf16 tiles go to the tensor cores (``mma.sync`` m16n8k16, f32
accumulate), f32 takes an FMA path so the result is true f32.  A dead tile
returns after storing zeros, because the output is uninitialised memory: the
skip is kept on purpose, it is the ragged, wave-quantised cost that the
grouped-GEMM operator model exists to predict.  All index arithmetic is 64-bit.
Source: ``csrc/grouped_gemm.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


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
