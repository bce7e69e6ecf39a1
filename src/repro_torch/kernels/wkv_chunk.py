"""Chunked RWKV6 recurrence (WKV6): the Hopper kernel, its wrapper, its plain
version and the sequential oracle.

Replaces the TPU kernel ``repro/kernels/wkv_chunk.py::wkv_chunked`` (body
``_wkv_kernel``).  Per chunk of ``C`` steps the recurrence
``S_t = diag(w_t) S_{t-1} + k_t^T v_t``, ``y_t = r_t (S_{t-1} + u k_t^T v_t)``
is an inter-chunk product ``r_dec @ S``, a strictly lower ``(C, C)``
intra-chunk term, the ``u`` bonus, and the state carried to the chunk's end,
with decays taken as cumulative sums of ``log w`` and the Pallas kernel's
``exp(min(-clw, 60))`` clamp in both places it has it.

Two additions to the TPU kernel's function, both needed by the model's
prefill (the decode cache starts from the state prefill leaves): an initial
state ``state0 (B,H,hs,hs)`` f32 (``None`` means zeros, the TPU kernel's only
case) and the final state as a second output.

The work is small against the card: at one 2048-token request of rwkv6-1.6b
a layer moves 60 MB (bf16 r/k/v, f32 decays and output) and does 1.2 GFLOP of
chunk arithmetic, 0.018 ms at the H100's peaks.  What bounds it is the chain
of 128 chunks.  One block owns 16 state columns of one ``(head, batch row)``
(column ``j`` of the state and of ``y`` depends only on column ``j`` of
``v``), so one request fills 128 of the 132 SMs, and splits into three roles
joined by mbarrier rings: prep warps compute each chunk's state-free terms
(decays as running products of ``w``, ``r_dec``, the carried ``k``, the
intra-chunk matrix and its product with ``v``) a chunk or two ahead, from
inputs streamed in by ``cp.async``; carry warps hold the state slice in
registers and do only the carry, the serial chain; y warps form
``y = y_intra + r_dec @ S`` beside it.  All arithmetic is f32 FMA (no TF32),
for the reference tests' 5e-5 on f32 inputs.  Source: ``csrc/wkv_chunk.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

#: limits of the kernel's shared-memory layout (a ring slot and the prep space
#: hold several C x hs f32 tiles) and of its 256 prep threads (4 a chunk row)
MAX_HEAD_SIZE, MAX_CHUNK = 128, 64


def chunk_len(T: int, chunk: int) -> int:
    """The chunk the kernel runs: ``min(chunk, T)``, which must divide T."""
    C = min(chunk, T)
    if C <= 0 or T % C:
        raise ValueError(f"wkv_chunked needs T % chunk == 0; got T={T}, "
                         f"chunk={C}")
    return C


def wkv_sequential(r, k, v, w, u, *, state0=None, return_state=False):
    """The sequential oracle: one state update per step, f32 inside, output
    in r's dtype.  r/k/v/w (B,T,H,hs), u (H,hs)."""
    B, T, H, hs = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    S = (torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t],
                               S + uf[None, :, :, None] * kv))
        S = S * wf[:, t, :, :, None] + kv
    y = torch.stack(ys, dim=1).to(r.dtype)
    return (y, S) if return_state else y


def wkv_chunked_plain(r, k, v, w, u, *, chunk: int = 16,
                      state0: Optional[torch.Tensor] = None,
                      return_state: bool = False, out_dtype=None,
                      clamp_carry: bool = True):
    """The kernel's arithmetic in PyTorch ops, chunk by chunk.

    ``clamp_carry=False`` drops the clamp from the carried k, as the model's
    own ``_wkv_chunked`` in the reference does; the Pallas kernel keeps it.
    The two agree while a chunk's summed ``-log w`` stays under 60.
    """
    B, T, H, hs = r.shape
    C = chunk_len(T, chunk)

    def heads_first(x):
        return x.float().permute(0, 2, 1, 3)               # (B,H,T,hs)

    rf, kf, vf = heads_first(r), heads_first(k), heads_first(v)
    lw = torch.log(torch.clamp_min(heads_first(w), 1e-30))
    uf = u.float()[None, :, None, :]                         # (1,H,1,hs)
    S = (torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    lower = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for c0 in range(0, T, C):
        rc, kc, vc, lwc = (x[:, :, c0:c0 + C] for x in (rf, kf, vf, lw))
        clw = torch.cumsum(lwc, dim=2)
        r_dec = rc * torch.exp(clw - lwc)
        e = torch.exp(torch.clamp_max(-clw, 60.0))
        k_dec = kc * e
        y = r_dec @ S
        att = (r_dec @ k_dec.transpose(-1, -2)).masked_fill(~lower, 0.0)
        y = y + att @ vc
        bonus = (rc * uf * kc).sum(-1, keepdim=True)
        ys.append(y + bonus * vc)
        cw_last = torch.exp(clw[:, :, -1:, :])               # (B,H,1,hs)
        carry = cw_last * (e if clamp_carry else torch.exp(-clw))
        S = S * cw_last.transpose(-1, -2) + (kc * carry).transpose(-1, -2) @ vc
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(out_dtype or r.dtype)
    return (y, S) if return_state else y


def _strides(x: torch.Tensor):
    return x if x.stride(-1) == 1 else x.contiguous()


def wkv_chunked(r, k, v, w, u, *, chunk: int = 16,
                state0: Optional[torch.Tensor] = None,
                return_state: bool = False, out_dtype=None):
    """Chunked WKV6.  r/k/v/w (B,T,H,hs), u (H,hs); w is the per-step decay
    in (0, 1).  Returns y (B,T,H,hs) in ``out_dtype`` (default r's dtype), and
    with ``return_state`` also the final state (B,H,hs,hs) f32.

    A CUDA tensor goes to the kernel (r/k/v f32 or bf16, w and the output
    either); a CPU tensor goes to the plain version.  A failed build or
    launch raises.
    """
    if r.device.type == "cpu":
        return wkv_chunked_plain(r, k, v, w, u, chunk=chunk, state0=state0,
                                 return_state=return_state,
                                 out_dtype=out_dtype)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_chunked runs on cuda or cpu, not {r.device}")
    B, T, H, hs = r.shape
    C = chunk_len(T, chunk)
    if any(x.shape != r.shape for x in (k, v, w)) or u.shape != (H, hs):
        raise ValueError(f"bad shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} w{tuple(w.shape)} "
                         f"u{tuple(u.shape)}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("r, k and v must share one dtype")
    if hs > MAX_HEAD_SIZE or C > MAX_CHUNK:
        raise ValueError(f"wkv_chunked takes hs <= {MAX_HEAD_SIZE} and "
                         f"chunk <= {MAX_CHUNK}; got hs={hs}, chunk={C}")
    out_dtype = out_dtype or r.dtype
    codes = [_build.dtype_code(d) for d in (r.dtype, w.dtype, out_dtype)]
    r, k, v, w = (_strides(x) for x in (r, k, v, w))
    uf = u.to(device=r.device, dtype=torch.float32).contiguous()
    s0 = None
    if state0 is not None:
        if state0.shape != (B, H, hs, hs):
            raise ValueError(f"state0 must be {(B, H, hs, hs)}, got "
                             f"{tuple(state0.shape)}")
        s0 = state0.to(device=r.device, dtype=torch.float32).contiguous()
    y = torch.empty((B, T, H, hs), dtype=out_dtype, device=r.device)
    state = (torch.empty((B, H, hs, hs), dtype=torch.float32, device=r.device)
             if return_state else None)
    if y.numel() == 0:       # nothing to compute: no launch, no count
        if state is not None:
            state.copy_(s0 if s0 is not None else torch.zeros_like(state))
        return (y, state) if return_state else y
    strides = _build.stride_array(*(s for x in (r, k, v, w)
                                    for s in x.stride()[:3]))
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.frontier_wkv_chunked(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uf.data_ptr(), s0.data_ptr() if s0 is not None else None,
            y.data_ptr(), state.data_ptr() if state is not None else None,
            *codes, B, T, H, hs, C, strides, stream)
    _build.check(err, "wkv_chunked")
    wkv_chunked.launches += 1
    return (y, state) if return_state else y


#: kernel launches made through this wrapper (plain-version calls not counted)
wkv_chunked.launches = 0
