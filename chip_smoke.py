#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

    python3 chip_smoke.py            # needs one CUDA card, nvcc, no network

Drives the port's two paths through their own entry points: calibrate
mixtral-8x7b against the hand-written kernels and price steps from the fit
(``python -m repro_torch``'s ``calibrate``, at the full width of
mixtral-8x7b), and serve rwkv6-1.6b at full width through ``MiniEngine``,
whose prefill runs the chunked WKV6 kernel in every layer.  Phases, one JSON
line each:

1. ``env``        the card as ``nvidia-smi`` names it, torch and CUDA versions
2. ``build``      compiles ``src/repro_torch/kernels/csrc/*.cu``
3. ``kernels``    every kernel against its plain PyTorch version on the card,
                  f32 and bf16, then timed at every shape its path gives it,
                  each beside its bound, its plain version and a library
                  call where one exists, by CUDA events and by ``device_ms``:
                  the attention kernels at ``calibrate``'s prefills of 512,
                  2048 and 8192 tokens and decodes of one 8192-token row, 32
                  mixed rows and the skewed regime (``time_attention``,
                  beside SDPA); the grouped GEMM at three capacities of
                  ``calibrate``'s grid (``time_grouped``, beside
                  ``torch.bmm``); ``wkv_chunked`` at the served prefills of
                  256-2048 tokens (``time_wkv``)
4. ``calibrate``  the CLI's ``calibrate`` with the ``kernels`` oracle; the
                  three kernels it prices must each be launched
5. ``predict``    load the artifacts, price prefill and decode steps, and hold
                  the fitted parts to the fitted models' own predictions
6. ``oracle_clock`` every shape of a second ``calibrate`` run timed by the
                  oracle's CUDA events and by ``device_ms``; held-out MAPE of
                  the fit on each clock over the same shapes (a reading, no
                  gate on the MAPE)
7. ``serve``      rwkv6-1.6b, random weights from a seed: (a) f32 prefill of
                  one 2048-token prompt through the kernel and through the
                  plain sequential recurrence, logits and every layer's state
                  within 2e-3; (b) bf16 ``MiniEngine`` with 4 slots serving 6
                  requests (a warm pass, then a measured one): the kernel must
                  be launched once per layer per prefill, and every request's
                  tokens must equal a greedy loop over the model's own
                  ``prefill``/``decode``

Any failing phase makes the exit code non-zero.  There is no CPU path: without
a CUDA device the script fails.  The line before the card's name lists every
kernel with its launches on its path (``calibrate`` for the three it prices,
``serve`` for ``wkv_chunked``), error, time, plain version's time, roofline
bound and a library call's time; the last line is the verdict.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# importing the port first: a directory that holds this script alone fails here
from repro_torch.api import cli  # noqa: E402
from repro_torch.calib import calibrate, load_calibrated_ops  # noqa: E402
from repro_torch.calib.oracle import KernelOracle  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.hardware import H100_SXM, ParallelismConfig  # noqa: E402
from repro_torch.core.predictor import ExecutionPredictor  # noqa: E402
from repro_torch.core.routing import BalancedRouting  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.wkv_chunk import wkv_chunked_plain  # noqa: E402
from repro_torch.models import AxisRules, build_model, init_tree  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serving.engine import MiniEngine  # noqa: E402

# The main path's own sizes: the oracle's accelerator limits and a sample count
# that keeps the whole script well inside its time limit.
TRAIN_SAMPLES, EVAL_SAMPLES, MAX_LEN, MAX_BATCH = 400, 120, 8192, 64
CALIBRATE_KERNELS = ("flash_attention", "decode_attention", "grouped_gemm")

# The served path: rwkv6-1.6b at full width, prompts whose lengths are
# MiniEngine buckets (powers of two), so no pad token reaches the recurrent
# state and the engine's tokens are those of a plain greedy loop.
SERVE_ARCH = "rwkv6-1.6b"
SERVE_OPTIONS = {"rwkv_impl": "chunked", "rwkv_chunk": 16}
SERVE_PROMPTS = (256, 512, 1024, 2048, 512, 1024)
SERVE_NEW, SERVE_SLOTS, SERVE_MAX_SEQ, PARITY_LEN = 32, 4, 4096, 2048

# Published dense peaks of one H100 SXM at its full 700 W limit.
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# bf16: the reference tests' gate, 2e-2.  The GEMM outputs are O(1), so there
# it is taken as it stands.  Attention over thousands of near-uniform keys
# gives outputs of about 0.01, below an absolute 2e-2, so for bf16 attention
# the absolute part is scaled by each output row's rms: an element may differ
# by 2e-2 * (rms of its row + its own size) and no more.
# f32 attention: the same tests' gate.  f32 GEMM: sums 4096 deep in another
# order than cuBLAS, so the gate is relative to the largest output.
TOL_BF16 = dict(atol=2e-2, rtol=2e-2)
TOL_BF16_ATTN = dict(atol=2e-2, rtol=2e-2, atol_per_row_rms=True)
TOL_F32 = dict(atol=2e-5, rtol=2e-5)
TOL_F32_GEMM_REL = 1e-4
# WKV6: the reference's wkv test gates (tests/test_kernels.py), and its
# prefill-against-decode gate for a whole model (tests/test_models_smoke.py)
TOL_WKV_F32 = dict(atol=5e-5, rtol=5e-5)
TOL_WKV_BF16 = dict(atol=5e-2, rtol=5e-2)
TOL_PREFILL = dict(atol=2e-3, rtol=2e-3)

REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:85",
    "decode_attention": "src/repro/kernels/decode_attention.py:66",
    "grouped_gemm": "src/repro/kernels/grouped_gemm.py:52",
    "wkv_chunked": "src/repro/kernels/wkv_chunk.py:68",
}
SOURCES = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "grouped_gemm": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
    "wkv_chunked": "src/repro_torch/kernels/csrc/wkv_chunk.cu",
}

FAILURES = []


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)


def stop_if_failed(phase: str) -> None:
    if FAILURES:
        print(json.dumps({"phase": phase, "ok": False, "failures": FAILURES}),
              flush=True)
        raise SystemExit(1)


def randn(gen, *shape, dtype, scale=0.5):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


def time_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call by CUDA events, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call that the card takes for ``reps`` calls
    queued back to back, after one warm-up: a spin kernel holds the card
    while the host queues them, so the events around them see the card's
    time and none of the host's launch path.  The spin is doubled until the
    card is still in it when the last call has been queued."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22                          # about 2 ms at the H100's clock
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        caught_up = start.query()             # the card reached the calls first
        torch.cuda.synchronize()
        if not caught_up:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError("device_ms: the host never queued the calls ahead of the card")


def compare(name: str, case: str, got, want, tol=None, rel_to_max=None) -> float:
    """Hold ``got`` to ``want``; returns the largest absolute difference."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        fail(f"{name} [{case}]: shape {tuple(g.shape)} != {tuple(w.shape)}")
        return float("nan")
    if not bool(torch.isfinite(g).all()):
        fail(f"{name} [{case}]: non-finite output")
        return float("nan")
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if rel_to_max is not None:
        bad = err > rel_to_max * float(w.abs().max())
    else:
        atol = tol["atol"]
        if tol.get("atol_per_row_rms"):
            atol = atol * w.pow(2).mean(dim=-1, keepdim=True).sqrt()
        bad = bool((diff > atol + tol["rtol"] * w.abs()).any())
    if bad:
        fail(f"{name} [{case}]: max abs err {err:.3e} outside tolerance")
    return err


def bound(ops_count: float, nbytes: float, dtype):
    t_ops = ops_count / PEAK_OPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ phases --
def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stdout.strip()}")
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    say("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    stop_if_failed("env")
    return card


def phase_build(verbose: bool) -> None:
    t0 = time.perf_counter()
    _build.load(verbose=verbose)
    say("build", seconds=round(time.perf_counter() - t0, 2),
        nvcc_seconds=round(_build.last_build_s, 2),
        sources=[os.path.relpath(str(p), ROOT) for p in _build.sources()],
        library=os.path.relpath(str(_build.build()), ROOT))


def check_flash(gen, rows: dict) -> None:
    name = "flash_attention"
    H, K, hd = 32, 8, 128
    errs = []
    cases = [  # (label, S, T, causal, window)
        ("causal", 2048, 2048, True, 0),
        ("window", 1024, 1024, True, 300),
        ("s_ne_t", 500, 1301, True, 0),
        ("bidirectional", 333, 333, False, 0),
    ]
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16_ATTN)):
        for label, S, T, causal, window in cases:
            q = randn(gen, 1, S, H, hd, dtype=dtype)
            k = randn(gen, 1, T, K, hd, dtype=dtype)
            v = randn(gen, 1, T, K, hd, dtype=dtype)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
            errs.append(compare(name, f"{label} {dtype}", got, want, tol))
    # the pad path: a head dim that is no multiple of 128
    q = randn(gen, 2, 200, 8, 112, dtype=torch.float32)
    k = randn(gen, 2, 200, 8, 112, dtype=torch.float32)
    got = ops.flash_attention(q, k, k, causal=True)
    errs.append(compare(name, "hd112 f32", got,
                        ref.flash_attention_ref(q, k, k, causal=True), TOL_F32))

    rows[name] = dict(max_abs_err=max(errs))   # timed in time_attention


def check_decode(gen, rows: dict) -> None:
    name = "decode_attention"
    H, K, hd = 32, 8, 128
    B, T = 32, 4096
    errs = []
    lens = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    lens[0], lens[1], lens[2] = 1, T, 65
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16_ATTN)):
        q = randn(gen, B, H, hd, dtype=dtype)
        k = randn(gen, B, T, K, hd, dtype=dtype)
        v = randn(gen, B, T, K, hd, dtype=dtype)
        got = ops.decode_attention(q, k, v, lens)
        errs.append(compare(name, f"mixed lengths {dtype}", got,
                            ref.decode_attention_ref(q, k, v, lens), tol))
    # other group widths: MHA (G=1), G=7, and the pad path
    for Hh, Kk, hdd in ((8, 8, 128), (28, 4, 128), (16, 2, 112), (8, 1, 256)):
        q = randn(gen, 3, Hh, hdd, dtype=torch.float32)
        k = randn(gen, 3, 300, Kk, hdd, dtype=torch.float32)
        v = randn(gen, 3, 300, Kk, hdd, dtype=torch.float32)
        ln = torch.tensor([300, 1, 129], dtype=torch.int32, device="cuda")
        got = ops.decode_attention(q, k, v, ln)
        errs.append(compare(name, f"H={Hh} K={Kk} hd={hdd} f32", got,
                            ref.decode_attention_ref(q, k, v, ln), TOL_F32))

    rows[name] = dict(max_abs_err=max(errs))   # timed in time_attention


def flash_shape(S: int) -> str:
    return f"B=1 S=T={S} H=32 K=8 hd=128 causal bf16"


def time_attention() -> list:
    """The two attention kernels timed at the shapes ``calibrate`` gives them
    (mixtral-8x7b: 32 heads, 8 KV heads, hd 128, bf16, k passed as v as the
    oracle passes it), each beside its roofline bound and SDPA's time, by
    CUDA events around back-to-back calls (``ms``, what the oracle sees; the
    host's launch path sets it where the kernel is short) and by
    ``device_ms`` (the same calls queued behind a spin: the card's time), and
    held to its plain version (at the largest prefill on 8 of the 32 heads,
    which keeps the plain version's scores in memory).  Inputs come from a
    generator of their own, so two trees timed in two processes see the same
    tensors."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    H, K, hd, dtype = 32, 8, 128, torch.bfloat16
    out = []
    for n in FLASH_TIMED:
        S = KernelOracle(H100_SXM)._round(n)
        q = randn(gen, 1, S, H, hd, dtype=dtype)
        k = randn(gen, 1, S, K, hd, dtype=dtype)
        got = ops.flash_attention(q, k, k, causal=True)
        heads = H if S <= 4096 else 8         # 8 query heads = KV heads 0-1
        err = compare("flash_attention", f"timed S={S}", got[:, :, :heads],
                      ref.flash_attention_ref(q[:, :, :heads],
                                              k[:, :, :heads * K // H],
                                              k[:, :, :heads * K // H],
                                              causal=True), TOL_BF16_ATTN)
        ms = time_ms(lambda: ops.flash_attention(q, k, k, causal=True))
        today = n == TODAY["flash_attention"]
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, k, causal=True),
                           reps=3) if today else None
        qt, kt = q.transpose(1, 2), k.transpose(1, 2)   # views: K heads, no copy
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, kt, is_causal=True, enable_gqa=True)
        library_ms = time_ms(sdpa)
        dev = dict(device_ms=device_ms(lambda: ops.flash_attention(q, k, k, causal=True)),
                   library_device_ms=device_ms(sdpa))
        pairs = S * (S + 1) // 2
        # v is k's own memory here, as in the oracle's call: its bytes count once
        b_ms, b_by = bound(4.0 * hd * H * pairs, nbytes(q, k, got), dtype)
        out.append(dict(kernel="flash_attention", shape=flash_shape(S), today=today,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by,
                        library_ms=library_ms, **dev))
        del q, k, got
    for label, B, lens_of in DECODE_TIMED:
        lens = lens_of(gen)
        T = KernelOracle(H100_SXM)._round(int(lens.max()))
        q = randn(gen, B, H, hd, dtype=dtype)
        k = randn(gen, B, T, K, hd, dtype=dtype)
        got = ops.decode_attention(q, k, k, lens)
        err = compare("decode_attention", f"timed {label}", got,
                      ref.decode_attention_ref(q, k, k, lens), TOL_BF16_ATTN)
        ms = time_ms(lambda: ops.decode_attention(q, k, k, lens))
        today = label == TODAY["decode_attention"]
        plain_ms = time_ms(lambda: ref.decode_attention_ref(q, k, k, lens),
                           reps=3) if today else None
        qt, kt = q[:, :, None, :], k.transpose(1, 2)    # views: K heads, no copy
        mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, kt, attn_mask=mask, enable_gqa=True)
        library_ms = time_ms(sdpa)
        dev = dict(device_ms=device_ms(lambda: ops.decode_attention(q, k, k, lens)),
                   library_device_ms=device_ms(sdpa))
        total = int(lens.sum())
        # v is k's own memory here, as in the oracle's call: the valid cache's
        # bytes count once
        kv_bytes = total * K * hd * k.element_size()
        b_ms, b_by = bound(4.0 * hd * H * total, kv_bytes + nbytes(q, got, lens), dtype)
        out.append(dict(kernel="decode_attention", today=today,
                        shape=f"{label}: B={B} T={T} H={H} K={K} hd={hd} "
                              f"sum(lengths)={total} bf16",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by,
                        library_ms=library_ms, **dev))
        del q, k, got
    torch.cuda.empty_cache()
    return out


def _mixed_lengths(gen):
    """32 lengths in [1, 4096], three of them at the edges (1, 4096, 65)."""
    lens = torch.randint(1, 4097, (32,), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    lens[:3] = torch.tensor([1, 4096, 65], dtype=torch.int32, device="cuda")
    return lens


def _skewed_lengths(gen):
    """The calibration grid's skewed regime: one long row, many of 16-128."""
    lens = torch.randint(16, 129, (64,), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    lens[0] = 6000
    return lens


FLASH_TIMED = (512, 2048, 8192)     # prompt lengths; the oracle buckets them
DECODE_TIMED = (  # (label, batch, lengths from the generator)
    ("one row", 1, lambda gen: torch.tensor([8192], dtype=torch.int32, device="cuda")),
    ("mixed", 32, _mixed_lengths),
    ("skewed", 64, _skewed_lengths),
)
# the shapes the final kernels line reports, as earlier slices timed them
TODAY = {"flash_attention": 2048, "decode_attention": "mixed"}


def check_grouped(gen, rows: dict) -> None:
    name = "grouped_gemm"
    E, din, dout = 8, 4096, 14336
    errs = []

    def zeros_past(case, got, sizes):
        for e, n in enumerate(sizes):
            if not bool((got[e, n:] == 0).all()):
                fail(f"{name} [{case}]: rows past group size of expert {e} "
                     f"are not exactly 0.0")

    C = 320
    sizes = [0, 320, 1, 129, 64, 200, 319, 7]
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(gen, E, C, din, dtype=dtype)
        w = randn(gen, E, din, dout, dtype=dtype, scale=0.05)
        got = ops.grouped_gemm(x, w, gs)
        want = ref.grouped_gemm_ref(x, w, gs)
        if dtype == torch.float32:
            errs.append(compare(name, "ragged f32", got, want,
                                rel_to_max=TOL_F32_GEMM_REL))
        else:
            errs.append(compare(name, "ragged bf16", got, want, TOL_BF16))
        zeros_past(f"ragged {dtype}", got, sizes)
        del x, w, got, want
    # widths that are no multiple of 8 take the FMA path in bf16 too
    x = randn(gen, 3, 50, 100, dtype=torch.bfloat16)
    w = randn(gen, 3, 100, 70, dtype=torch.bfloat16, scale=0.1)
    g3 = torch.tensor([50, 0, 17], dtype=torch.int32, device="cuda")
    got = ops.grouped_gemm(x, w, g3)
    errs.append(compare(name, "odd widths bf16", got,
                        ref.grouped_gemm_ref(x, w, g3), TOL_BF16))
    zeros_past("odd widths bf16", got, [50, 0, 17])

    rows[name] = dict(max_abs_err=max(errs))   # timed in time_grouped


GROUPED_TIMED = (  # (label, group sizes): calibrate's own grid, mixtral-8x7b, --seed 0
    ("small", [111, 6, 7, 23, 2, 7, 10, 50]),              # train sample 39
    ("today", [2048, 0, 1500, 37, 1024, 2047, 600, 256]),  # the shape earlier slices timed
    ("large", [871, 692, 1145, 2831, 1710, 7388, 466, 501]),  # train sample 11
)


def time_grouped() -> list:
    """The grouped GEMM at three shapes of ``calibrate``'s grid (mixtral-8x7b
    experts, 4096 x 14336, bf16; capacity the bucket of the largest group, as
    the oracle calls it), each held to its plain version with rows past the
    group sizes exactly 0.0, timed by events and by ``device_ms`` beside its
    bound, the plain version and ``torch.bmm`` over every row of the capacity
    (dense, no mask).  Inputs come from a generator of their own, so two trees
    timed in two processes see the same tensors."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    E, din, dout, dtype = 8, 4096, 14336, torch.bfloat16
    out = []
    for label, sizes in GROUPED_TIMED:
        C = KernelOracle(H100_SXM)._round(max(sizes))
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        x = randn(gen, E, C, din, dtype=dtype)
        w = randn(gen, E, din, dout, dtype=dtype, scale=0.05)
        got = ops.grouped_gemm(x, w, gs)
        err = compare("grouped_gemm", f"timed C={C}", got,
                      ref.grouped_gemm_ref(x, w, gs), TOL_BF16)
        zeros = all(bool((got[e, n:] == 0).all()) for e, n in enumerate(sizes))
        if not zeros:
            fail(f"grouped_gemm [timed C={C}]: rows past a group size are not "
                 "exactly 0.0")
        ms = time_ms(lambda: ops.grouped_gemm(x, w, gs), reps=5)
        plain_ms = time_ms(lambda: ref.grouped_gemm_ref(x, w, gs), reps=2)
        library_ms = time_ms(lambda: torch.bmm(x, w), reps=5)
        dev = dict(device_ms=device_ms(lambda: ops.grouped_gemm(x, w, gs), reps=5),
                   library_device_ms=device_ms(lambda: torch.bmm(x, w), reps=5))
        live = sum(min(n, C) for n in sizes)
        experts = sum(1 for n in sizes if n > 0)
        moved = (live * din + experts * din * dout) * x.element_size() + nbytes(got, gs)
        b_ms, b_by = bound(2.0 * live * din * dout, moved, dtype)
        out.append(dict(kernel="grouped_gemm", today=label == "today",
                        shape=f"E={E} C={C} din={din} dout={dout} sizes={sizes} bf16",
                        max_abs_err=err, zeros_past_groups=zeros, ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=library_ms, **dev))
        del x, w, got
        torch.cuda.empty_cache()
    return out


def wkv_inputs(gen, B, T, H, hs, dtype):
    """r, k, v, decays in the reference test's (0.35, 0.95) band (f32, as the
    model's decay chain gives them), u."""
    r, k, v = (randn(gen, B, T, H, hs, dtype=dtype) for _ in range(3))
    w = torch.rand((B, T, H, hs), generator=gen, device="cuda") * 0.6 + 0.35
    return r, k, v, w, randn(gen, H, hs, dtype=torch.float32, scale=0.3)


def check_wkv(gen, rows: dict) -> None:
    name = "wkv_chunked"
    errs = []
    # the reference kernel test's shapes, then the served head size
    for dtype, tol in ((torch.float32, TOL_WKV_F32), (torch.bfloat16, TOL_WKV_BF16)):
        for B, T, H, hs, C in ((1, 16, 2, 16, 8), (2, 32, 3, 16, 8),
                               (1, 48, 2, 32, 16), (2, 256, 4, 64, 16)):
            r, k, v, w, u = wkv_inputs(gen, B, T, H, hs, dtype)
            w = w.to(dtype)
            got = ops.wkv_chunked(r, k, v, w, u, chunk=C)
            errs.append(compare(name, f"({B},{T},{H},{hs}) C={C} {dtype}", got,
                                ref.wkv_ref(r, k, v, w, u), tol))
    # a non-zero initial state: y and the final state, against the plain
    # chunked version and the sequential oracle
    r, k, v, w, u = wkv_inputs(gen, 2, 128, 4, 64, torch.float32)
    s0 = randn(gen, 2, 4, 64, 64, dtype=torch.float32, scale=0.3)
    y, s = ops.wkv_chunked(r, k, v, w, u, chunk=16, state0=s0, return_state=True)
    for label, (want_y, want_s) in (
            ("plain", wkv_chunked_plain(r, k, v, w, u, chunk=16, state0=s0,
                                        return_state=True)),
            ("sequential", ref.wkv_ref(r, k, v, w, u, state0=s0,
                                       return_state=True))):
        errs.append(compare(name, f"state0 y vs {label}", y, want_y, TOL_WKV_F32))
        errs.append(compare(name, f"state0 final state vs {label}", s, want_s,
                            TOL_WKV_F32))

    rows[name] = dict(max_abs_err=max(errs))   # timed in time_wkv


WKV_TIMED = (256, 512, 1024, 2048)     # the served prefills' lengths


def time_wkv() -> list:
    """``wkv_chunked`` as the served prefill calls it, at every prompt length
    ``serve`` gives it: one request at rwkv6-1.6b's width (32 heads of 64,
    chunk 16), bf16 r/k/v, f32 decays, output and a zero state in and out;
    held to its plain version, timed by events and by ``device_ms`` beside
    its bound and the plain version.  Inputs come from a generator of their
    own, so two trees timed in two processes see the same tensors."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    B, H, hs, C = 1, 32, 64, 16
    out = []
    for T in WKV_TIMED:
        r, k, v, w, u = wkv_inputs(gen, B, T, H, hs, torch.bfloat16)
        s0 = torch.zeros((B, H, hs, hs), dtype=torch.float32, device="cuda")

        def kernel():
            return ops.wkv_chunked(r, k, v, w, u, chunk=C, state0=s0,
                                   return_state=True, out_dtype=torch.float32)

        def plain():
            return wkv_chunked_plain(r, k, v, w, u, chunk=C, state0=s0,
                                     return_state=True, out_dtype=torch.float32)
        (y, s), (want_y, want_s) = kernel(), plain()
        err = max(compare("wkv_chunked", f"timed T={T} y", y, want_y, TOL_WKV_BF16),
                  compare("wkv_chunked", f"timed T={T} final state", s, want_s,
                          TOL_WKV_BF16))
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=3)
        dev_ms = device_ms(kernel)
        # per (b, h) and chunk: r_dec @ S and the state carry (C x hs x hs each),
        # the strictly lower intra-chunk r_dec k_dec^T and its product with v
        # (C(C-1)/2 x hs each), the bonus; all f32
        per_chunk = 4 * C * hs * hs + 2 * C * (C - 1) * hs + 4 * C * hs
        b_ms, b_by = bound(B * H * (T // C) * per_chunk,
                           nbytes(r, k, v, w, u, s0, y, s), torch.float32)
        out.append(dict(kernel="wkv_chunked", today=T == PARITY_LEN,
                        shape=f"B={B} T={T} H={H} hs={hs} C={C}, bf16 r/k/v, "
                              "f32 w/y/state",
                        max_abs_err=err, ms=ms, device_ms=dev_ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))   # no single PyTorch call computes WKV6
        del r, k, v, w, y, s, want_y, want_s
    torch.cuda.empty_cache()
    return out


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows: dict = {}
    for check in (check_flash, check_decode, check_grouped, check_wkv):
        check(gen, rows)
        torch.cuda.empty_cache()
    shapes = {"attention": time_attention(), "grouped_gemm": time_grouped(),
              "wkv_chunked": time_wkv()}
    for row in (r for group in shapes.values() for r in group):
        name = row["kernel"]   # the final line keeps one row per kernel, at today's shape
        if row["today"]:
            rows[name].update({key: row.get(key) for key in (
                "shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")},
                max_abs_err=max(rows[name]["max_abs_err"], row["max_abs_err"]))
    say("kernels", ok=not FAILURES, timed_shapes=shapes,
        tolerances={"bf16": TOL_BF16, "bf16_attention": TOL_BF16_ATTN,
                    "f32": TOL_F32,
                    "f32_gemm_rel_to_max": TOL_F32_GEMM_REL,
                    "wkv_f32": TOL_WKV_F32, "wkv_bf16": TOL_WKV_BF16},
        launches_so_far=ops.launch_counts(), rows=rows)
    stop_if_failed("kernels")
    return rows


def phase_calibrate(out_root: str) -> dict:
    entry_path = os.path.join(out_root, "entry.json")
    os.makedirs(out_root, exist_ok=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(["calibrate", "--model", "mixtral-8x7b", "--hardware",
                   "H100-SXM", "--oracle", "kernels", "--no-fidelity",
                   "-o", out_root, "--train-samples", str(TRAIN_SAMPLES),
                   "--eval-samples", str(EVAL_SAMPLES),
                   "--max-len", str(MAX_LEN), "--max-batch", str(MAX_BATCH),
                   "--label", "chip_smoke",
                   "--entry-out", entry_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if rc != 0:
        fail(f"calibrate exited with {rc}")
    for name in CALIBRATE_KERNELS:
        if counts[name] <= 0:
            fail(f"calibrate never launched {name}")
    fidelity = {}
    if os.path.isfile(entry_path):
        with open(entry_path) as f:
            fidelity = json.load(f)["operators"]
    else:
        fail("calibrate wrote no fidelity entry")
    say("calibrate", ok=not FAILURES, wall_s=round(wall, 2), launches=counts,
        n_train=TRAIN_SAMPLES, n_eval=EVAL_SAMPLES, max_len=MAX_LEN,
        max_batch=MAX_BATCH,
        fidelity=fidelity)
    stop_if_failed("calibrate")
    return counts


def phase_predict(out_root: str) -> None:
    cfg = get_config("mixtral-8x7b")
    hw = H100_SXM
    fitted = load_calibrated_ops(out_root, cfg, hw)
    pred = ExecutionPredictor(cfg, ParallelismConfig(tp=1), hw, fitted,
                              memoize=False)
    n_layers = len(cfg.pattern)
    moe = cfg.moe
    n_mats = 3 if cfg.gated_mlp else 2
    steps = []

    def expect(q_lens, kv_lens, decode):
        """The fitted models' own predictions, summed as the predictor sums."""
        attn = gg = 0.0
        toks = sum(q_lens)
        counts = BalancedRouting().assign(toks, moe.num_experts, moe.top_k, None)
        cap = math.ceil(moe.capacity_factor_eval * toks * moe.top_k
                        / moe.num_experts)
        kept = [min(int(c), cap) for c in counts]
        for kind in cfg.pattern:
            window = cfg.sliding_window if kind == "local" else 0
            if decode:
                a = fitted.attention.predict([1] * len(kv_lens), kv_lens,
                                             causal=False, window=window)
            else:
                a = fitted.attention.predict(q_lens, kv_lens, causal=True,
                                             window=window)
            attn += a
            gg += n_mats * fitted.grouped.predict(kept)
        return attn, gg

    for label, decode, lens in (
            ("prefill", False, [512, 1024, 300]),
            ("prefill", False, [2048]),
            ("decode", True, [900, 4000, 128, 2048] * 4),
            ("decode", True, [1500] * 8)):
        if decode:
            bd = pred.decode_time(lens)
            want_attn, want_gg = expect([1] * len(lens), lens, True)
        else:
            bd = pred.prefill_time(lens)
            want_attn, want_gg = expect(lens, lens, False)
        ok = (math.isfinite(bd.total) and bd.total > 0
              and math.isclose(bd.parts["attn"], want_attn, rel_tol=1e-12)
              and math.isclose(bd.parts["moe_expert_gemm"], want_gg,
                               rel_tol=1e-12))
        if not ok:
            fail(f"predict {label} {lens}: attn {bd.parts.get('attn')} vs "
                 f"{want_attn}, moe_expert_gemm "
                 f"{bd.parts.get('moe_expert_gemm')} vs {want_gg}, "
                 f"total {bd.total}")
        steps.append({"step": label, "lens": lens, "total_s": bd.total,
                      "attn_s": bd.parts["attn"],
                      "moe_expert_gemm_s": bd.parts["moe_expert_gemm"]})
    say("predict", ok=not FAILURES, layers=n_layers, steps=steps)
    stop_if_failed("predict")


class TwoClockOracle(KernelOracle):
    """The ``kernels`` oracle with a second clock: every shape it measures is
    timed as the oracle times it (a pair of CUDA events around each call, the
    host's launch path included) and by ``device_ms`` (the card's time alone).
    It answers with the events; ``pairs`` keeps both, in the order the shapes
    were measured, which is the order of ``_cache``."""

    def __init__(self, hw, **kwargs):
        super().__init__(hw, **kwargs)
        self.pairs = []

    def _time(self, fn, *args) -> float:
        events_s = super()._time(fn, *args)
        self.pairs.append((events_s, device_ms(lambda: fn(*args), reps=self.reps) * 1e-3))
        return events_s


def phase_oracle_clock() -> None:
    """``calibrate``'s fit on the oracle's clock and on the card's, over one
    set of shapes: each is timed both ways, the models are fitted and scored
    on the event times, then refitted and rescored on the device times."""
    orc = TwoClockOracle(H100_SXM)
    kw = dict(model="mixtral-8x7b", hardware="H100-SXM", oracle=orc,
              n_train=TRAIN_SAMPLES, n_eval=EVAL_SAMPLES, max_len=MAX_LEN,
              max_batch=MAX_BATCH, out_root=None)
    by_events = calibrate(**kw)
    measured = list(zip(orc._cache, orc.pairs))
    shapes = {}
    for kind in ("prefill", "decode", "grouped"):
        ev = np.array([e for key, (e, _) in measured if key[0] == kind])
        dv = np.array([d for key, (_, d) in measured if key[0] == kind])
        if not (ev.size and (dv > 0).all()):
            fail(f"oracle_clock: no {kind} shape, or a device time of 0")
            continue
        ratio = ev / dv
        shapes[kind] = dict(n=int(ev.size),
                            device_ms_p50=float(np.median(dv)) * 1e3,
                            events_minus_device_ms_p50=float(np.median(ev - dv)) * 1e3,
                            events_over_device_p50=float(np.median(ratio)),
                            events_over_device_p90=float(np.percentile(ratio, 90)))
    stop_if_failed("oracle_clock")
    orc._cache = {key: dev for key, (_, dev) in measured}
    by_device = calibrate(**kw)            # every shape is cached: no launch
    say("oracle_clock", ok=not FAILURES, shapes=shapes,
        fidelity={"events": by_events.fidelity, "device": by_device.fidelity})
    stop_if_failed("oracle_clock")


def _argmax(logits_row: torch.Tensor) -> int:
    return int(np.argmax(logits_row.float().cpu().numpy()))   # as MiniEngine


def greedy_tokens(engine: MiniEngine, prompt, n_new: int):
    """A plain greedy loop over the engine's model: prefill the prompt alone,
    then decode one token at a time.  Decode runs at the engine's batch width
    with the request in every row, so each matrix product has the shape it
    has inside the engine (a bf16 product's rounding depends on the kernel
    cuBLAS picks for the shape); rows never mix."""
    model, rows, dev = engine.model, engine.max_slots, engine.device
    toks = torch.from_numpy(np.asarray(prompt, np.int64)[None]).to(dev)
    logits, cache = model.prefill({"tokens": toks}, cache_len=engine.max_seq,
                                  all_logits=True)
    out = [_argmax(logits[0, len(prompt) - 1])]
    cache = tree_map(lambda c: c.expand(rows, *c.shape[1:]).contiguous(), cache)
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        tok = torch.full((rows, 1), out[-1], dtype=torch.int64, device=dev)
        logits, cache = model.decode(
            cache, tok, torch.full((rows,), pos, dtype=torch.int64, device=dev))
        out.append(_argmax(logits[0, 0]))
    return out


def serve_parity(cfg) -> dict:
    """(a) f32 prefill of one prompt through the kernel (chunked) and through
    the plain sequential recurrence (scan), on the same weights.

    Gated layer by layer: the scan runs the whole stack, and at every layer
    the chunked block takes the scan's input to that layer, so its output,
    its final state and the logits from its last output are held to the scan
    at 2e-3.  Run free, 24 layers of random weights amplify f32 rounding:
    the free-running difference is reported beside the model's own response
    to a 1e-6 relative nudge of its embeddings, and not gated."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_tree(gen, build_model(cfg).pds(), torch.float32, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, PARITY_LEN), generator=gen,
                         device="cuda")
    batch = {"tokens": toks}
    ax = {impl: AxisRules(None, dict(SERVE_OPTIONS, rwkv_impl=impl))
          for impl in ("chunked", "scan")}
    chunked = build_model(cfg, ax["chunked"], params=params)
    scan = build_model(cfg, ax["scan"], params=params)

    before = ops.launch_counts()["wkv_chunked"]
    t0 = time.perf_counter()
    free_logits, free_cache = chunked.prefill(batch, all_logits=True)
    torch.cuda.synchronize()
    wall = {"chunked": time.perf_counter() - t0}
    launched = ops.launch_counts()["wkv_chunked"] - before
    if launched != len(cfg.pattern):
        fail(f"serve parity: the chunked prefill launched wkv_chunked "
             f"{launched} times, not {len(cfg.pattern)}")

    # the scan's own stack, as LM.prefill runs it, with the chunked block
    # beside it at every layer
    x = scan._inputs_to_x(batch)
    state_errs, x_errs, scan_states = [], [], []
    t_scan = 0.0
    for i, (kind, p) in enumerate(zip(scan.kinds, scan.layers)):
        clen = cfg.kv_cache_len(PARITY_LEN, kind)
        t0 = time.perf_counter()
        xs, cs = tfm.block_prefill(cfg, kind, p, x, ax["scan"], cache_len=clen)
        torch.cuda.synchronize()
        t_scan += time.perf_counter() - t0
        xc, cc = tfm.block_prefill(cfg, kind, p, x, ax["chunked"], cache_len=clen)
        x_errs.append(compare("serve", f"f32 layer {i} output", xc, xs, TOL_PREFILL))
        state_errs.append(compare("serve", f"f32 layer {i} state", cc["state"],
                                  cs["state"], TOL_PREFILL))
        scan_states.append(cs["state"])
        x = xs
    wall["scan"] = t_scan
    scan_logits = scan._logits(x)
    logits_err = compare("serve", "f32 logits from the last layer",
                         scan._logits(xc), scan_logits, TOL_PREFILL)

    nudged = dict(params, embed=params["embed"] * (1 + 1e-6))
    nudge_logits, _ = build_model(cfg, ax["chunked"], params=nudged).prefill(
        batch, all_logits=True)
    free = {"logits": float((free_logits - scan_logits).abs().max()),
            "state": max(float((c["state"] - s).abs().max())
                         for c, s in zip(free_cache["layers"], scan_states)),
            "logits_after_1e-6_nudge": float((nudge_logits - free_logits).abs().max())}
    return {"tokens": PARITY_LEN,
            "max_abs_err_per_layer": {"output": max(x_errs),
                                      "state": max(state_errs),
                                      "logits": logits_err},
            "free_running_max_abs_diff": free,
            "prefill_wall_s": wall,
            "logits_finite": bool(torch.isfinite(free_logits).all())}


def phase_serve() -> dict:
    cfg = get_config(SERVE_ARCH)
    with torch.no_grad():
        parity = serve_parity(cfg)
    torch.cuda.empty_cache()
    stop_if_failed("serve")

    # (b) bf16 MiniEngine with the kernel on the prefill path
    t0 = time.perf_counter()
    eng = MiniEngine(cfg, max_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, seed=0,
                     dtype=torch.bfloat16, options=SERVE_OPTIONS)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
    eng.submit(prompts, SERVE_NEW)
    eng.run()                                   # warm pass
    eng.step_log.clear()
    ops.reset_launch_counts()
    reqs = eng.submit(prompts, SERVE_NEW)
    report = eng.run()                          # measured pass
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    prefills = [s for s in eng.step_log if s["kind"] == "prefill"]
    decodes = [s["dur"] for s in eng.step_log if s["kind"] == "decode"]
    want = len(cfg.pattern) * len(prefills)
    if len(prefills) != len(SERVE_PROMPTS) or counts["wkv_chunked"] != want:
        fail(f"serve: {len(prefills)} prefills launched wkv_chunked "
             f"{counts['wkv_chunked']} times, not {len(cfg.pattern)} each")
    mismatched = []
    with torch.no_grad():
        for req in reqs:
            want_toks = greedy_tokens(eng, req.prompt, SERVE_NEW)
            if req.tokens != want_toks:
                at = next(i for i, (a, b) in enumerate(zip(req.tokens, want_toks))
                          if a != b) if len(req.tokens) == len(want_toks) else -1
                mismatched.append({"rid": req.rid, "prompt": len(req.prompt),
                                   "first_difference": at})
    if mismatched:
        fail(f"serve: engine tokens differ from the greedy loop: {mismatched}")
    say("serve", ok=not FAILURES, arch=SERVE_ARCH, layers=len(cfg.pattern),
        d_model=cfg.d_model, vocab=cfg.vocab_size, options=SERVE_OPTIONS,
        parity_f32=parity, dtype="bf16", slots=SERVE_SLOTS,
        max_seq=SERVE_MAX_SEQ, prompts=list(SERVE_PROMPTS),
        new_tokens=SERVE_NEW, engine_init_s=init_s,
        launches=counts, greedy_equal=not mismatched,
        throughput_tok_s=report["throughput_tok_s"],
        ttft_mean_s=report["ttft_mean_s"], tpot_mean_s=report["tpot_mean_s"],
        decode_steps=report["decode_steps"], duration_s=report["duration_s"],
        output_tokens=report["output_tokens"],
        prefill_step_s=[{"tokens": s["tokens"], "s": s["dur"]} for s in prefills],
        decode_step_s={"mean": statistics.fmean(decodes),
                       "median": statistics.median(decodes),
                       "min": min(decodes), "max": max(decodes)},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    stop_if_failed("serve")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print each kernel's registers and shared memory")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: true f32

    card = phase_env()
    phase_build(args.ptxas)
    rows = phase_kernels()
    out_root = os.path.join(ROOT, "build", "calib")
    counts = phase_calibrate(out_root)
    phase_predict(out_root)
    phase_oracle_clock()
    counts["wkv_chunked"] = phase_serve()["wkv_chunked"]

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "shape": row["shape"], "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "device_ms": row["device_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}
               for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
