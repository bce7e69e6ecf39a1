#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

    python3 chip_smoke.py            # needs one CUDA card, nvcc, no network

Drives the port's paths through their own entry points: calibrate
mixtral-8x7b against the hand-written kernels and price steps from the fit
(``python -m repro_torch``'s ``calibrate``, at the full width of
mixtral-8x7b), simulate colocated, PD and AF deployments of mixtral-8x7b
priced by that fit (``python -m repro_torch run``) and the fleet and
observability layers (``run``, ``trace``), hold the simulator's prediction
of qwen2-7b and mixtral-8x7b to ``MiniEngine``'s measured throughput (the
paper's Table 2, ``repro_torch.launch.serve``), serve rwkv6-1.6b at full
width through ``MiniEngine``, whose prefill runs the chunked WKV6 kernel in
every layer, and train yi-9b at full width (``repro_torch.launch.train``, a
path that launches no kernel: none has a backward), run the sharded path at
full width in a threaded world of ranks on the one card (and its training
step, captured in a CUDA graph, on a one-rank NCCL world), and cost steps and
production meshes without running them (``repro_torch.launch.dryrun``, the
``hlo`` oracle), and run the twins of the examples (``examples_torch/``),
held to what the reference prints.  Phases,
one JSON line each (``simulate``, ``table2`` one per run or cell and one for the phase):

1. ``env``        the card as ``nvidia-smi`` names it, torch and CUDA versions
2. ``build``      compiles ``src/repro_torch/kernels/csrc/*.cu``
3. ``kernels``    every kernel against its plain PyTorch version on the card,
                  f32 and bf16 (decode and flash attention also at the
                  served engines' own shapes, ``SERVED_DECODE`` and
                  ``SERVED_PREFILL``), then timed at every shape its path gives it,
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
6. ``simulate``   ``python -m repro_torch run`` on three full-width
                  mixtral-8x7b deployments on ``H100-SXM`` (colocated 2 x tp2;
                  PD 1 x tp2 prefill, 2 x tp2 decode; AF 1 x tp2 prefill, m=4
                  attention and ep=4 experts, two-batch overlap), 100 Poisson
                  requests at 10/s, each with analytical operator models and
                  with the refined models ``calibrate`` just fitted: every run
                  completes all 100 requests with finite summaries; the
                  refined AF run, repeated, is byte-identical; the ``jit``
                  backend on the card equals ``numpy`` within 1e-5 on 64
                  mixed steps through the vectorised path (and a whole jit
                  run's distance from numpy is printed, with no gate); a
                  two-point jit ``sweep`` in spawned workers repeats the
                  in-process reports byte for byte; and
                  which clusters the fit prices (``refined_priced_by_fit``: it
                  is fitted at tp=1, so tp2 clusters take virtual kernels).
                  Then ``run`` of tests/test_golden.py's fleet spec and
                  ``run`` + ``trace`` of tests/test_obs.py's traced PD spec,
                  each equal to its CPU golden, and ``trace`` of the
                  analytical AF deployment: the chrome traces parse with
                  their timestamps in order, and traced metrics equal
                  untraced ones.
                  This path launches no kernel: it prices steps from the fit.
7. ``refit``      a second fit of the same kernels by the oracle as
                  ``calibrate`` makes it (C2, the fit's repeatability):
                  each shape's repeat spread between the two oracles, each
                  fit scored on the other's held-out truths, and the refined
                  AF deployment priced from each (``repro_torch.calib.study``
                  ``two_fits``).  Readings, no gate on a spread.
8. ``table2``     two ``calibrate`` fits of qwen2-7b (each must launch both
                  attention kernels); then each cell of ``TABLE2`` (qwen2-7b
                  at full width, mixtral-8x7b at 16 of its 32 layers; bf16,
                  random weights) measured on ``MiniEngine`` (a warm pass,
                  which captures its CUDA graphs, then the measured one;
                  every request must complete with its tokens, and every
                  measured prefill, graphed or eager, must launch the flash
                  attention kernel once per attention layer), each
                  qwen2-7b cell and mixtral-8x7b's first also with
                  ``eager=True``, in turns, the graphed tokens equal to
                  the eager ones; predicted from the graphed measurement
                  eight ways: analytical on the
                  ``H100-SXM`` preset and on ``measure_hardware``, refined
                  from each of two fits, each with the measured decode floor
                  as ``engine_overhead`` and with the predictor's default.
                  Every prediction completes every request with finite
                  summaries, and a refined one repeats byte for byte.  No
                  gate on the error: it is a reading.  Each model's engine
                  also decodes through its donated slot cache: every
                  replay launches the decode attention kernel once per
                  layer, and its logits lie within ``TOL_DONATED`` of the
                  same step through the functional path on a copy of the
                  slot cache (``donated_decode_gap``).  Then the device's
                  idle share over 10 steady decode steps of qwen2-7b at
                  batch 4, graphed and eager, by ``torch.profiler``
9. ``serve``      rwkv6-1.6b, random weights from a seed: (a) f32 prefill of
                  one 2048-token prompt through the kernel and through the
                  plain sequential recurrence, logits and every layer's state
                  within 2e-3; (b) bf16 ``MiniEngine`` with 4 slots serving 6
                  requests (a warm pass, then a measured one) from its CUDA
                  graphs, the kernel replayed in every prefill graph: its
                  launches, counted at each replay, must be one per layer
                  per prefill and equal an eager engine's and, in one more
                  graphed prefill, the WKV6 kernels ``torch.profiler`` sees
                  on the card; the tokens must
                  equal the eager engine's, and every request's tokens must
                  equal a greedy loop over the model's own
                  ``prefill``/``decode``
10. ``train``     yi-9b at full width in f32, random weights from a seed:
                  (a) one ``make_train_step`` of one layer on 1 x 128
                  ``SyntheticLM`` tokens on the card and on the CPU from the
                  same weights: the loss within 1e-5 relative, each leaf's
                  gradients within 1e-4 of its largest, and the card's AdamW
                  on the CPU's gradients within 1e-5 of the CPU's step
                  (``train_parity``); (b) ``repro_torch.launch.train.run``
                  of 8 layers, 12 steps of 2 x 4096 tokens, ``remat="full"``,
                  the step replayed from its CUDA graph after three eager
                  steps: finite losses, the last below the first, no kernel
                  launched, read as step ms, tok/s, model TFLOP/s and peak
                  memory, beside 4 eager steps whose losses must equal the
                  graphed run's; (c) ``python -m repro_torch.launch.train`` of
                  qwen3-8b's smoke geometry in a subprocess, 10 steps and a
                  checkpoint, then 10 resumed steps: the last loss within
                  2e-4 of a straight 20-step run (tests/test_training.py's
                  gate)
11. ``shard``     the sharded path, every rank a thread of this process on
                  the one card (torch's ``threaded`` backend; two NCCL ranks
                  on one card fail, which ``nccl_probe`` records first),
                  each run held to the same model unsharded on the card in
                  f32: (a) mixtral-8x7b at full width, 2 layers, mesh
                  (2, 4): ``LM.prefill`` logits of 4 x 512 tokens under
                  ``moe_dispatch`` psum and a2a within 1e-4 of the largest,
                  no token dropped; (b) yi-9b at full width, 2 layers,
                  (2, 4): one ZeRO-1 AdamW step of 4 x 512 tokens, the loss
                  within 1e-5 relative, gradients within 1e-4 of each
                  leaf's largest, the sharded AdamW on the unsharded
                  gradients within 1e-5, the world's peak memory; (c)
                  rwkv6-1.6b at full width, 4 layers, (1, 4): a chunked
                  prefill of 2048 tokens, the WKV6 kernel launched once per
                  rank per layer on 8 of the 32 heads, logits and states
                  within 1e-4; (d) yi-9b saved on (8,) and restored onto
                  (2, 4), every leaf byte-equal; (e) yi-9b, mixtral-8x7b and
                  rwkv6-1.6b at smoke width on (2, 4) (2 KV heads over 4
                  ranks): one loss within 1e-5 relative and every gradient
                  within 1e-4 of its largest; and first, right after the
                  probe, (f) ``mesh_graph``: in a process of its own, a
                  one-rank NCCL world whose (1, 1) mesh step
                  ``launch.train.run`` captures in a CUDA graph: yi-9b at
                  full width (4 layers, 2 x 4096 tokens, ``remat="full"``,
                  3 warm-up steps and 6 replays), the 100m geometry of
                  ``train_lm`` (20 steps) and mixtral-8x7b at full width (1
                  layer, 2 x 2048 tokens), each graphed losses equal to
                  ``eager=True``'s to the bit and within 1e-5 relative of
                  one card's graphed step; step ms of the three, peak GB,
                  and the NCCL kernels of one replay of mixtral-8x7b's
                  step (``torch.profiler``, by kernel name)
12. ``cost``      the cost extraction (``repro_torch.launch.hlo_cost``, steps
                  counted on fake tensors, nothing allocated): (a) the ``hlo``
                  oracle's prices of phase ``kernels``' three timed shapes
                  beside their device ms; (b) phase ``train``'s full-width
                  step counted, beside ``model_flops`` and its measured step
                  ms, with ``roofline_terms``; (c) ``python -m
                  repro_torch.launch.dryrun`` of mixtral-8x7b ``decode_32k``
                  and yi-9b ``train_4k`` on the pod mesh (a ``fake`` group
                  of 256 ranks) at full width, each in a subprocess; (d)
                  ``calibrate --oracle hlo`` of mixtral-8x7b; (e) first,
                  in a subprocess, ten smoke steps on fake (2, 4) and
                  (1, 4) worlds, each count equal to the CPU's
                  (``COUNTER_CELLS``).  Every cell and count must be finite
                  and positive, and no kernel may launch
13. ``examples``  the twins of ``examples/`` (``examples_torch/``): (a) the ten
                  simulation twins, each run as ``__main__`` by ``runpy`` in
                  a directory of its own, stdout equal to
                  ``expected/<name>.txt`` (wall clock masked); (b) ``python -m repro_torch run`` of
                  the eight specs that need no artifacts, each report's
                  ``stable_view`` hash equal to ``expected/specs.json``; (c)
                  ``calibration_study.py --smoke`` equal to its expected
                  file, then ``--oracle kernels`` at full width (600 / 150
                  samples) through the twin's ``main``: both attention
                  kernels launched, the grouped GEMM never (qwen2-7b is
                  dense), every MAPE and summary finite; (d)
                  ``serve_real_model.py`` on the card: finite, positive
                  measured and predicted tok/s beside the card's name; (e)
                  ``train_lm.py`` (100m): 200 straight steps, and 100 + 100
                  by the same command resumed from step 100, the last loss
                  equal to the straight run's to the bit, finite and
                  falling; then its step in this process for 20 steps,
                  graphed and eager, the losses equal to the bit

Any failing phase makes the exit code non-zero.  There is no CPU path: without
a CUDA device the script fails.  The line before the card's name lists every
kernel with its launches on its path (``calibrate`` for the three it prices
and ``examples`` (c) for the two attention kernels, ``serve`` and ``shard``
for ``wkv_chunked``), error, time, plain version's
time, roofline bound and a library call's time; the last line is the verdict.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import io
import json
import math
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# importing the port first: a directory that holds this script alone fails here
from repro_torch.api import SimSpec, build as build_system, cli, sweep  # noqa: E402
from repro_torch.calib import load_calibrated_ops  # noqa: E402
from repro_torch.calib import fit as calib_fit  # noqa: E402
from repro_torch.calib.oracle import HLOCostOracle, KernelOracle  # noqa: E402
from repro_torch.calib.study import (  # noqa: E402
    SIZES, af_spread, device_ms, fit, two_fits)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.hardware import H100_SXM, ParallelismConfig  # noqa: E402
from repro_torch.core.opmodels.calibration import measure_hardware  # noqa: E402
from repro_torch.core.workflows.colocated import build_colocated  # noqa: E402
from repro_torch.core.predictor import ExecutionPredictor  # noqa: E402
from repro_torch.core.routing import BalancedRouting  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.wkv_chunk import operations as wkv_operations  # noqa: E402
from repro_torch.kernels.wkv_chunk import wkv_chunked_plain  # noqa: E402
from repro_torch.launch import hlo_cost  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import AxisRules, build_model, init_tree  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import shape_tree, tree_leaves, tree_map  # noqa: E402
from repro_torch.serving.engine import MiniEngine  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    GRAPH_WARMUP, AdamW, AdamWConfig, make_train_step)

# The main path's own sizes: the oracle's accelerator limits and a sample count
# that keeps the whole script well inside its time limit.
TRAIN_SAMPLES, EVAL_SAMPLES, MAX_LEN, MAX_BATCH = (
    SIZES[k] for k in ("n_train", "n_eval", "max_len", "max_batch"))
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

# The simulated deployments: full-width mixtral-8x7b on the H100 preset, 100
# Poisson requests at 10/s.  Each runs with analytical operator models and
# with the refined models fitted by ``calibrate`` on the card.
SIM_MODEL = {"name": "mixtral-8x7b", "smoke": False}
SIM_WORKLOAD = {"n_requests": 100, "arrival": "poisson", "rate": 10.0,
                "prompt_mean": 1024, "output_mean": 128, "seed": 1}
SIM_DEPLOYMENTS = {   # name: (topology, pipeline)
    "colocated": ({"preset": "colocated", "n_replicas": 2, "tp": 2}, None),
    "pd": ({"preset": "pd", "n_prefill": 1, "prefill_tp": 2, "n_decode": 2,
            "decode_tp": 2}, None),
    "af": ({"preset": "af", "n_prefill": 1, "prefill_tp": 2, "n_decode": 1,
            "m": 4, "ffn_ep": 4}, {"preset": "two_batch", "ep_overlap": 0.5}),
}
JIT_STEPS, JIT_RTOL = 64, 1e-5   # tests/test_predictor_batch.py's float32 gate

# The goldens the fleet and observability runs are held to, with
# tests/test_golden.py's comparison: the spec hash exactly, every float to
# 1e-6 relative.  The specs are those tests' own (tests/test_golden.py's
# fleet spec; tests/test_obs.py's traced PD spec, whose chrome trace's
# pid/tid maps and event counts per phase are pinned).
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
GOLDEN_RTOL = 1e-6
FLEET_PD = {
    "name": "golden-fleet-pd",
    "model": {"name": "qwen2-7b", "smoke": True},
    "topology": {"preset": "colocated"},
    "workload": {"n_requests": 120, "rate": 40.0,
                 "rate_curve": "diurnal", "rate_period": 10.0,
                 "rate_amplitude": 0.7, "prompt_mean": 256,
                 "output_mean": 32, "prefix_groups": 4,
                 "prefix_len": 256, "seed": 15},
    "memory": {"manager": "prefix"},
    "slo": {"ttft_s": 0.5, "tpot_s": 0.05},
    "fleet": {
        "instances": [
            {"name": "colo", "count": 2},
            {"name": "pd", "count": 1,
             "topology": {"preset": "pd", "n_prefill": 1, "n_decode": 1}},
        ],
        "router": "prefix_affinity",
        "autoscaler": {"min_instances": 1, "max_instances": 4,
                       "interval_s": 0.5, "cooldown_s": 1.0,
                       "up_queue_depth": 8.0, "down_queue_depth": 1.0},
        "tenants": [
            {"name": "paid", "weight": 1, "ttft_s": 0.3},
            {"name": "free", "weight": 3, "ttft_s": 1.0, "priority": 1},
        ],
    },
    "seed": 15,
}
OBS_TINY_PD = {
    "name": "obs-tiny-pd",
    "model": {"name": "qwen2-7b", "smoke": True},
    "topology": {"preset": "pd", "n_prefill": 1, "n_decode": 1},
    "workload": {"n_requests": 12, "arrival": "burst", "burst_size": 12,
                 "burst_period": 1.0, "prompt_mean": 4096,
                 "output_mean": 16, "seed": 7},
    "seed": 7,
}

# Table 2 on the card: the real MiniEngine (bf16, the models' own ops, random
# weights from seed 0) against the simulator's prediction of the same fixed
# batch on one tp=1 replica.  The reference's grid (prompts x16, outputs x4,
# max_seq 1024; benchmarks/bench_e2e_accuracy.py) with powers-of-two
# prompts, so the engine's bucket padding adds nothing.  mixtral-8x7b keeps
# 16 of its 32 layers so its bf16 weights fit one card; each layer is whole.
TABLE2 = {  # model: (layers kept, None for all; cells (batch, prompt, output))
    "qwen2-7b": (None, ((2, 256, 128), (4, 512, 64), (8, 256, 64), (4, 128, 96))),
    "mixtral-8x7b": (16, ((4, 512, 64), (8, 256, 64))),
}
TABLE2_MAX_SEQ = 1024
# a donated decode step's logits against the functional path's: the largest
# gap over the largest logit (bf16 rounding; a length off by one reads
# 0.19-0.87 at the smoke size)
TOL_DONATED = 5e-2
# The device's idle share: qwen2-7b at full width, 4 slots of 128-token
# prompts, read over 10 steady decode steps (``decode_idle_share``).
IDLE_ARCH, IDLE_BATCH, IDLE_PROMPT, IDLE_STEPS = "qwen2-7b", 4, 128, 10

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


def src_env() -> dict:
    """This environment with the port's ``src/`` first on ``PYTHONPATH``,
    for the subprocesses the phases start."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


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
    # the shapes the served prefills give it, in bf16 at full size
    for arch, S in SERVED_PREFILL:
        cfg = get_config(arch)
        Hh, Kk, hdd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        window = cfg.sliding_window if "local" in cfg.pattern else 0
        q = randn(gen, 1, S, Hh, hdd, dtype=torch.bfloat16)
        k = randn(gen, 1, S, Kk, hdd, dtype=torch.bfloat16)
        v = randn(gen, 1, S, Kk, hdd, dtype=torch.bfloat16)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        errs.append(compare(name, f"{arch} S={S} H={Hh} K={Kk} hd={hdd} "
                                  f"window={window} bf16", got, want, TOL_BF16_ATTN))
        del q, k, v, got, want

    rows[name] = dict(max_abs_err=max(errs))   # timed in time_attention


# (model, bucket): the prefill attention the served engines run, each
# layer's causal core over a whole bucket: yi-9b's benchmark prompts (8
# query heads a KV head), mixtral-8x7b's (its window of 4096 at the last
# bucket), qwen2-7b's Table 2 engine (7 a KV head) and recurrentgemma-2b's
# local attention (10 query heads on one KV head of 256, a window of 2048)
SERVED_PREFILL = (("yi-9b", 4096), ("mixtral-8x7b", 4096),
                  ("qwen2-7b", TABLE2_MAX_SEQ), ("recurrentgemma-2b", 4096))


# (model, slots, cache length): the decode attention the served engines run,
# yi-9b's benchmark pool, qwen2-7b's Table 2 engine and recurrentgemma-2b's
# local attention (a ring of 2048, 10 query heads on one KV head)
SERVED_DECODE = (("yi-9b", 32, 4096), ("qwen2-7b", 8, TABLE2_MAX_SEQ),
                 ("recurrentgemma-2b", 16, 2048))


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
    # the shapes the served engines give it, in bf16 at full size
    for arch, B, T in SERVED_DECODE:
        cfg = get_config(arch)
        Hh, Kk, hdd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        ln = torch.randint(1, T + 1, (B,), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
        ln[0], ln[1] = 1, T
        q = randn(gen, B, Hh, hdd, dtype=torch.bfloat16)
        k = randn(gen, B, T, Kk, hdd, dtype=torch.bfloat16)
        v = randn(gen, B, T, Kk, hdd, dtype=torch.bfloat16)
        got = ops.decode_attention(q, k, v, ln)
        errs.append(compare(name, f"{arch} B={B} T={T} H={Hh} K={Kk} hd={hdd} bf16",
                            got, ref.decode_attention_ref(q, k, v, ln), TOL_BF16_ATTN))
        del q, k, v, got
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
        b_ms, b_by = bound(wkv_operations(B, T, H, hs, C),
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


def cli_calibrate(model: str, out_root: str) -> tuple:
    """``python -m repro_torch calibrate --oracle kernels`` on the card at
    this script's sizes; returns its exit code, wall seconds, launches and
    the oracle it made (kept from ``calibrate``'s own ``resolve_oracle``
    call, so its measured shapes can be read afterwards)."""
    entry_path = os.path.join(out_root, "entry.json")
    os.makedirs(out_root, exist_ok=True)
    made = []

    def keep(*args, **kwargs):
        made.append(resolve(*args, **kwargs))
        return made[-1]
    resolve, calib_fit.resolve_oracle = calib_fit.resolve_oracle, keep
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["calibrate", "--model", model, "--hardware",
                       "H100-SXM", "--oracle", "kernels", "--no-fidelity",
                       "-o", out_root, "--train-samples", str(TRAIN_SAMPLES),
                       "--eval-samples", str(EVAL_SAMPLES),
                       "--max-len", str(MAX_LEN), "--max-batch", str(MAX_BATCH),
                       "--label", "chip_smoke",
                       "--entry-out", entry_path])
        torch.cuda.synchronize()
    finally:
        calib_fit.resolve_oracle = resolve
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"calibrate --model {model} exited with {rc}")
    return rc, wall, ops.launch_counts(), made[0] if made else None


def phase_calibrate(out_root: str) -> tuple:
    entry_path = os.path.join(out_root, "entry.json")
    rc, wall, counts, oracle = cli_calibrate("mixtral-8x7b", out_root)
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
    return counts, oracle


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


def sim_spec(name: str, opmodel: dict) -> dict:
    topology, pipeline = SIM_DEPLOYMENTS[name]
    spec = {"name": f"{name}-{opmodel['name']}", "model": SIM_MODEL,
            "topology": dict(topology, hardware="H100-SXM"),
            "workload": SIM_WORKLOAD, "opmodel": opmodel, "seed": 1}
    if pipeline is not None:
        spec["pipeline"] = pipeline
    return spec


def stable_view(rep: dict) -> str:
    """tests/test_determinism.py::_stable_view of a saved report; a fleet
    report's instances, tenants and scale events stand in for clusters."""
    parts = (("clusters",) if "clusters" in rep
             else ("instances", "tenants", "scale_events"))
    return json.dumps({"summary": rep["summary"], "hash": rep["spec_hash"],
                       **{k: rep[k] for k in parts},
                       "conservation": rep["conservation"],
                       "events": rep["sim_events"]}, sort_keys=True)


def sim_run(spec: dict, out_dir: str, label: str) -> dict:
    """One ``python -m repro_torch run`` of ``spec`` on the card; checks the
    report and prints its line.  The CLI's own summary goes to a log beside
    the report."""
    t0 = time.perf_counter()
    rc, rep = cli_report(["run", spec_file(spec, out_dir), "-o", out_dir],
                         out_dir, spec["name"])
    wall = time.perf_counter() - t0
    if rc != 0 or not rep:
        fail(f"simulate {label}: run exited with {rc}")
        return {}
    s = rep["summary"]
    want = spec["workload"]["n_requests"]
    if s.get("n_completed") != want or rep["conservation"] != {"complete": want}:
        fail(f"simulate {label}: {s.get('n_completed')} of {want} completed, "
             f"conservation {rep['conservation']}")
    bad = sorted(k for k, v in s.items()
                 if not (isinstance(v, (int, float)) and math.isfinite(v)))
    if bad:
        fail(f"simulate {label}: summary values not finite: {bad}")
    line = {"run": label, "wall_s": wall, "report_wall_s": rep["wall_clock_s"],
            "events": rep["sim_events"],
            "events_per_s": rep["sim_events"] / rep["wall_clock_s"],
            "n_devices": rep["n_devices"], "n_completed": s.get("n_completed"),
            "duration_s": s.get("duration_s"),
            "predictor_cache_hit_rate": s.get("predictor_cache_hit_rate")}
    for key in ("throughput_tok_s", "throughput_tok_s_per_device",
                "ttft_mean_s", "ttft_p99_s", "tpot_mean_s", "tpot_p99_s"):
        line[key] = s.get(key)
    if "af" in rep["clusters"].get("decode", {}):
        line["af"] = rep["clusters"]["decode"]["af"]
        line["bubble_time_s"] = s.get("bubble_time_s")
        line["overlap_efficiency"] = s.get("overlap_efficiency")
    say("simulate_run", **line)
    return rep


def priced_by_fit(handle, fitted) -> dict:
    """Which clusters of a built deployment the card's fit prices.  The
    artifacts are fitted at the model's tp=1 geometry; a sharded shape falls
    back to the virtual-kernel model (the reference's rule).  Each cluster's
    first replica prices one prefill and one decode step of its role while
    the fitted models' calls are counted (``grouped`` is absent for a dense
    model)."""
    parts = {"attention": "attention_by_fit", "grouped": "grouped_gemm_by_fit"}
    parts = {p: key for p, key in parts.items() if getattr(fitted, p) is not None}
    counts = {}
    for part in parts:
        model = getattr(fitted, part)

        def counted(*args, _part=part, _predict=model.predict, **kwargs):
            counts[_part] = counts.get(_part, 0) + 1
            return _predict(*args, **kwargs)
        model.predict = counted
    coverage = {}
    try:
        for cname, cluster in handle.clusters.items():
            pred = cluster.replicas[0].predictor
            counts.clear()
            if cluster.role in ("prefill", "colocated"):
                pred.step_time([1024], [1024], decode=False)
            if cluster.role in ("decode", "colocated"):
                pred.step_time([1] * 8, [1100] * 8, decode=True)
            coverage[cname] = {key: counts.get(p, 0) > 0 for p, key in parts.items()}
    finally:
        for part in parts:                      # back to the class's own method
            del getattr(fitted, part).predict
    return coverage


def fit_coverage(name: str, calib_root: str) -> dict:
    """``priced_by_fit`` for a refined deployment of phase ``simulate``: a
    reading, no gate."""
    spec = SimSpec.from_dict(sim_spec(name, {"name": "refined",
                                             "calibration": calib_root}))
    fitted = load_calibrated_ops(calib_root, get_config(SIM_MODEL["name"]), H100_SXM)
    return priced_by_fit(build_system(spec, ops=fitted, device="cuda"), fitted)


def jit_steps_on_card() -> dict:
    """The colocated analytical deployment built for the card: the ``jit``
    backend's fused float32 roofline, evaluated by torch on the card, against
    the float64 ``numpy`` path on 64 steps of mixed lengths."""
    spec = SimSpec.from_dict(sim_spec("colocated", {"name": "analytical"}))
    pred = build_system(spec, device="cuda").clusters["colocated"].replicas[0].predictor
    vectorised = pred.device == "cuda" and pred._vectorized_ok()
    if not vectorised:
        fail("simulate jit: the colocated analytical predictor is not on the "
             "card's vectorised path")
    rng = np.random.default_rng(0)
    prefill, decode = [], []
    for _ in range(JIT_STEPS // 2):
        q = [int(x) for x in rng.integers(1, 4097, int(rng.integers(1, 9)))]
        prefill.append((q, [x + int(rng.integers(0, 4097)) for x in q]))
        kv = [int(x) for x in rng.integers(1, 8193, int(rng.integers(1, 65)))]
        decode.append(([1] * len(kv), kv))
    worst = 0.0
    for steps, is_decode in ((prefill, False), (decode, True)):
        jit = pred.step_time_batch(steps, decode=is_decode, backend="jit")
        num = pred.step_time_batch(steps, decode=is_decode, backend="numpy")
        if not (np.all(np.isfinite(jit)) and np.all(num > 0)):
            fail("simulate jit: non-finite or zero step times")
            continue
        worst = max(worst, float(np.max(np.abs(jit - num) / num)))
    if worst > JIT_RTOL:
        fail(f"simulate jit: {worst:.3e} relative from numpy, over {JIT_RTOL}")
    return {"steps": JIT_STEPS, "max_rel_err": worst, "rtol": JIT_RTOL,
            "vectorised": vectorised, "device": str(pred.device)}


def phase_simulate(calib_root: str) -> None:
    out_dir = os.path.join(ROOT, "build", "sim")
    os.makedirs(out_dir, exist_ok=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    opmodels = {"analytical": {"name": "analytical"},
                "refined": {"name": "refined", "calibration": calib_root}}
    reports = {}
    for name in SIM_DEPLOYMENTS:
        for kind, opmodel in opmodels.items():
            reports[name, kind] = sim_run(sim_spec(name, opmodel), out_dir,
                                          f"{name}/{kind}")
    stop_if_failed("simulate")
    again = sim_run(sim_spec("af", opmodels["refined"]), out_dir, "af/refined again")
    repeat_identical = bool(again) and \
        stable_view(again) == stable_view(reports["af", "refined"])
    if not repeat_identical:
        fail("simulate: the refined AF run differs when repeated")
    coverage = {name: fit_coverage(name, calib_root) for name in SIM_DEPLOYMENTS}
    jit = jit_steps_on_card()
    # a whole run on the jit backend, beside the numpy run: a reading
    whole = {}
    for backend in ("numpy", "jit"):
        spec = sim_spec("colocated", dict(opmodels["analytical"], backend=backend))
        spec["name"] += f"-{backend}"
        whole[backend] = sim_run(spec, out_dir, f"colocated/analytical/{backend}")
    jit["run_rel_diff"] = {
        key: (abs(v - whole["numpy"]["summary"][key])
              / max(abs(whole["numpy"]["summary"][key]), 1e-300))
        for key, v in whole["jit"].get("summary", {}).items()
        if key in whole["numpy"].get("summary", {}) and isinstance(v, float)}
    # sweep workers are spawned on the card (CUDA cannot be used in a child
    # forked after the parent initialised it); they must repeat in-process
    spec = SimSpec.from_dict(sim_spec("colocated", dict(opmodels["analytical"],
                                                        backend="jit")))
    axes = {"seed": [1, 2]}
    serial = sweep(spec, axes, jobs=1, device="cuda")
    spawned = sweep(spec, axes, jobs=2, device="cuda")
    sweep_identical = [stable_view(a.to_dict()) for a in serial] == \
        [stable_view(b.to_dict()) for b in spawned]
    if not sweep_identical:
        fail("simulate: spawned sweep workers differ from the in-process runs")
    goldens = golden_runs(out_dir, reports["af", "analytical"])
    counts = ops.launch_counts()
    say("simulate", ok=not FAILURES, wall_s=time.perf_counter() - t0,
        model=SIM_MODEL, workload=SIM_WORKLOAD, calibration=calib_root,
        runs=len(reports) + 11, refined_af_repeat_identical=repeat_identical,
        refined_priced_by_fit=coverage,
        spawned_sweep_identical=sweep_identical,
        jit=jit, fleet_and_obs=goldens, launches=counts)
    stop_if_failed("simulate")
    return reports["af", "refined"]


def golden_drift(name: str, rep: dict) -> list:
    """tests/test_golden.py's comparison of a report with its golden: the
    keys that drifted (the spec hash exactly, floats beyond 1e-6)."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    drift = [] if rep["spec_hash"] == golden["spec_hash"] else ["spec_hash"]
    want, got = golden["summary"], rep["summary"]
    for key in sorted(set(want) | set(got)):
        e, a = want.get(key, "<missing>"), got.get(key, "<missing>")
        if isinstance(e, float) and isinstance(a, float):
            if abs(e - a) > GOLDEN_RTOL * max(abs(e), abs(a), 1e-12):
                drift.append(key)
        elif e != a:
            drift.append(key)
    return drift


def spec_file(spec: dict, out_dir: str) -> str:
    path = os.path.join(out_dir, f"{spec['name']}.json")
    with open(path, "w") as f:
        json.dump(spec, f, indent=2, sort_keys=True)
    return path


def cli_report(argv: list, out_dir: str, base: str) -> tuple:
    """``python -m repro_torch`` with ``argv`` on the card, its own output
    to a log; returns its exit code and the report it wrote."""
    with open(os.path.join(out_dir, f"{base}.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        rc = cli.main(argv + ["--device", "cuda"])
    path = os.path.join(out_dir, f"{base}.report.json")
    if not os.path.isfile(path):
        return rc, {}
    with open(path) as f:
        return rc, json.load(f)


def traced(out_dir: str, spec_path: str, base: str, untraced: dict) -> tuple:
    """``python -m repro_torch trace`` of a spec: the chrome trace must
    parse with its timestamps in order, and every metric of the run must
    equal the untraced run's (the obs keys aside).  Returns the trace's
    events and a line of figures."""
    rc, rep = cli_report(["trace", spec_path, "-o", out_dir, "--base", base],
                         out_dir, base)
    with open(os.path.join(out_dir, f"{base}.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    ts = [e["ts"] for e in events if e["ph"] != "M"]
    monotone = bool(ts) and ts == sorted(ts) and ts[0] >= 0
    plain = {k: v for k, v in rep.get("summary", {}).items()
             if not k.startswith(("attribution_", "obs_"))}
    unchanged = plain == untraced.get("summary")
    if rc != 0 or not monotone or not unchanged:
        fail(f"simulate trace {base}: exit {rc}, timestamps in order "
             f"{monotone}, metrics equal the untraced run's {unchanged}")
    return events, {"exit": rc, "events": len(events), "timestamps_monotone": monotone,
                    "metrics_equal_untraced": unchanged,
                    "obs_spans": rep.get("summary", {}).get("obs_spans")}


def trace_structure(events: list) -> dict:
    """tests/test_obs.py's pinned view of a chrome trace: process and thread
    names, and the number of events of each phase."""
    by_phase = {}
    for e in events:
        by_phase[e["ph"]] = by_phase.get(e["ph"], 0) + 1
    return {"pid_map": {e["args"]["name"]: e["pid"] for e in events
                        if e["ph"] == "M" and e["name"] == "process_name"},
            "tid_map": {f'{e["pid"]}:{e["tid"]}': e["args"]["name"] for e in events
                        if e["ph"] == "M" and e["name"] == "thread_name"},
            "n_by_phase": by_phase}


def golden_runs(out_dir: str, af_analytical: dict) -> dict:
    """The fleet and observability layers on the card, through the CLI:
    ``run`` of the fleet golden's spec, ``run`` and ``trace`` of the traced
    PD golden's spec, and ``trace`` of the analytical AF deployment.  Each
    report equals its CPU golden; traced metrics equal untraced ones."""
    out = {}
    paths = {spec["name"]: spec_file(spec, out_dir) for spec in (FLEET_PD, OBS_TINY_PD)}
    rc, rep = cli_report(["run", paths["golden-fleet-pd"], "-o", out_dir],
                         out_dir, "golden-fleet-pd")
    drift = golden_drift("fleet_pd", rep) if rep else ["no report"]
    if rc != 0 or drift:
        fail(f"simulate fleet_pd: exit {rc}, drifted from the golden: {drift}")
    s = rep.get("summary", {})
    out["fleet_pd"] = {"exit": rc, "golden_equal": not drift,
                       "instances": len(rep.get("instances", {})),
                       "scale_events": len(rep.get("scale_events", [])),
                       "n_completed": s.get("n_completed"),
                       "throughput_tok_s": s.get("throughput_tok_s")}
    rc, untraced = cli_report(["run", paths["obs-tiny-pd"], "-o", out_dir],
                              out_dir, "obs-tiny-pd")
    events, line = traced(out_dir, paths["obs-tiny-pd"], "obs-tiny-pd-traced",
                          untraced)
    with open(os.path.join(GOLDEN_DIR, "obs_trace_pd.json")) as f:
        structure_equal = trace_structure(events) == json.load(f)
    if rc != 0 or not structure_equal:
        fail(f"simulate obs_trace_pd: exit {rc}, trace structure equals the "
             f"golden {structure_equal}")
    out["obs_trace_pd"] = dict(line, golden_equal=structure_equal)
    af_path = os.path.join(out_dir, f"{af_analytical['name']}.json")
    _, out["af_trace"] = traced(out_dir, af_path, "af-analytical-traced",
                                af_analytical)
    return out


def refined_af(calib_root: str, label: str) -> float:
    """Phase ``simulate``'s refined AF deployment priced from ``calib_root``."""
    out_dir = os.path.join(ROOT, "build", "sim")
    os.makedirs(out_dir, exist_ok=True)
    spec = sim_spec("af", {"name": "refined", "calibration": calib_root})
    spec["name"] += "-" + label.replace(" ", "-").replace(",", "")
    rep = sim_run(spec, out_dir, f"af/refined {label}")
    return rep.get("summary", {}).get("throughput_tok_s", float("nan"))


def phase_refit(oracle, calib_root: str, calib2_root: str,
                af_fit1: dict) -> None:
    """C2: a second fit of mixtral-8x7b's kernels by the oracle as
    ``calibrate`` makes it, held against phase ``calibrate``'s fit (the
    repeat spread of each shape, the cross-scores, and the refined AF
    deployment priced from each)."""
    t0 = time.perf_counter()
    second = KernelOracle(H100_SXM)
    fit(second, calib2_root)
    c2 = two_fits([oracle, second], [calib_root, calib2_root])
    c2["refined_af_tok_s"] = [af_fit1["summary"]["throughput_tok_s"],
                              refined_af(calib2_root, "fit 2")]
    c2["refined_af_spread"] = af_spread(c2["refined_af_tok_s"])
    say("refit", ok=not FAILURES, wall_s=time.perf_counter() - t0, **c2)
    stop_if_failed("refit")


def table2_calibrate() -> tuple:
    """Two fits of qwen2-7b's attention by the CLI's ``calibrate`` (C2: two
    fits priced side by side); each must launch both attention kernels."""
    roots, lines = [], []
    for k in (1, 2):
        roots.append(os.path.join(ROOT, "build", f"calib_qwen2_{k}"))
        rc, wall, counts, _ = cli_calibrate("qwen2-7b", roots[-1])
        for name in ("flash_attention", "decode_attention"):
            if counts[name] <= 0:
                fail(f"table2: calibrate --model qwen2-7b never launched {name}")
        with open(os.path.join(roots[-1], "entry.json")) as f:
            fidelity = json.load(f)["operators"]
        lines.append({"wall_s": wall, "launches": counts, "fidelity": fidelity})
    return roots, lines


def decode_parts(cfg, hw, ops, batch: int, context: int) -> dict:
    """Milliseconds by part of one decode step of ``batch`` rows of
    ``context`` keys, as ``launch.serve.predict``'s replica prices it (the
    predictor's default ``engine_overhead``)."""
    handle = build_colocated(cfg, hw, n_replicas=1, par=ParallelismConfig(tp=1),
                             ops=ops)
    pred = handle.clusters["colocated"].replicas[0].predictor
    return {k: v * 1e3 for k, v in pred.decode_time([context] * batch).parts.items()}


def summary_of(rep: dict) -> dict:
    return {key: rep.get(key) for key in (
        "throughput_tok_s", "ttft_mean_s", "ttft_p50_s", "tpot_mean_s",
        "tpot_p50_s", "n_completed")}


def measure_cell(cfg, batch: int, prompt: int, output: int, eager: bool) -> dict:
    """One Table 2 cell measured by ``launch.serve.measure``, on the engine's
    CUDA graphs or (``eager``) uncaptured, with each measured prefill's
    ``flash_attention`` launches (``prefill_attn_kernel``)."""
    gc.collect()                 # a graphed engine is freed by the collector
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    measured, floor, reqs, steps = serve_launch.measure(
        cfg, batch=batch, prompt_len=prompt, output_len=output,
        max_seq=TABLE2_MAX_SEQ, seed=0, device="cuda", dtype=torch.bfloat16,
        eager=eager)
    return {"measured": measured, "floor": floor,
            "prefill_attn_kernel": [s["attn_kernel"] for s in steps
                                    if s["kind"] == "prefill"],
            "line": {key: measured[key] for key in (
                "throughput_tok_s", "ttft_mean_s", "tpot_mean_s", "duration_s",
                "decode_steps", "output_tokens")},
            "tokens": [r.tokens for r in reqs],
            "measure_s": time.perf_counter() - t1,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def first_differences(got: list, want: list) -> list:
    """(request, first differing position) of each request whose tokens
    differ; position -1 where the lengths differ."""
    return [(i, next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), -1)
             if len(a) == len(b) else -1)
            for i, (a, b) in enumerate(zip(got, want)) if a != b]


def _union_us(spans: list) -> float:
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def decode_idle_share(cfg, eager: bool) -> dict:
    """The device's idle share over IDLE_STEPS steady decode steps of a
    bf16 ``MiniEngine`` (a graph captured and replayed, or eager), read by
    ``torch.profiler``: one minus the union of the device's kernel and copy
    intervals over the window's wall time.  Each step ends in a synchronise
    and the host's argmax.

    Beside it, in the same engine: CUDA events around each step's call of
    the decode step (the graph's replay, or the eager ops) give that call's
    device span, from its first device work to its last, in an unprofiled
    window and in the profiled one.  One minus their sum over the wall time
    is the share of the wall outside the decode call's device span, not an
    idle share: an eager span holds the device's gaps between the kernels
    the host dispatches.  The profiled spans show what tracing adds inside
    a replay, where the host takes no part."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gc.collect()
    torch.cuda.empty_cache()
    eng = MiniEngine(cfg, max_slots=IDLE_BATCH, max_seq=TABLE2_MAX_SEQ, seed=0,
                     dtype=torch.bfloat16, eager=eager)
    rng = np.random.default_rng(0)
    eng.submit([rng.integers(0, cfg.vocab_size, IDLE_PROMPT)
                for _ in range(IDLE_BATCH)], IDLE_PROMPT)
    spans, step = [], eng._decode

    def timed():
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step()
        ev[1].record()
        spans.append(ev)
        return out

    def window() -> tuple:
        """(wall us, the decode calls' device spans in ms)"""
        spans.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(IDLE_STEPS):
            eng._decode_step()
        wall = (time.perf_counter() - t0) * 1e6
        return wall, [a.elapsed_time(b) for a, b in spans]

    def outside(wall_us: float, span_ms: list) -> dict:
        return {"window_ms_per_step": wall_us / IDLE_STEPS / 1e3,
                "decode_call_device_span_ms": {"min": min(span_ms),
                                               "median": statistics.median(span_ms)},
                "share_of_wall_outside_decode_call_span":
                    1.0 - sum(span_ms) * 1e3 / wall_us}
    with torch.no_grad():
        eng._admit()
        for _ in range(5):                   # the first captures the graph
            eng._decode_step()
        eng._decode = timed
        plain = outside(*window())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_us, span_ms = window()
        t1 = time.perf_counter()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in device])
        by_name = {}
        for e in device:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    del eng, prof
    return {"idle_share": 1.0 - busy_us / wall_us if device else None,
            "profiled": {
                **outside(wall_us, span_ms),
                "device_events": len(device),
                "device_busy_ms_per_step": busy_us / IDLE_STEPS / 1e3,
                "top_device_ms_per_step": {k[:80]: v / IDLE_STEPS / 1e3
                                           for k, v in top},
                "post_s": time.perf_counter() - t1},
            "unprofiled": plain}


def table2_runs(cfg, k: int, batch: int, prompt: int, output: int) -> tuple:
    """The ``k``-th Table 2 cell of ``cfg`` served graphed and eager, in
    turns (mixtral's cells after its first graphed only), each run held to
    its tokens and to one ``flash_attention`` launch per attention layer in
    every measured prefill.  Returns the runs by mode and whether the graphed
    tokens equal the eager ones (``None`` without an eager run)."""
    arch = cfg.name
    cell = f"{arch} b{batch} p{prompt} o{output}"
    n_attn = sum(kind in ("global", "local") for kind in cfg.pattern)
    modes = (("graphed", "eager") if arch == "qwen2-7b" or k == 0
             else ("graphed",))
    runs = {mode: measure_cell(cfg, batch, prompt, output, eager=mode == "eager")
            for mode in (modes[::-1] if k % 2 else modes)}
    for mode, run in runs.items():
        if [len(t) for t in run["tokens"]] != [output] * batch:
            fail(f"table2 {cell} {mode}: tokens "
                 f"{[len(t) for t in run['tokens']]}")
        if run["prefill_attn_kernel"] != [n_attn] * batch:
            fail(f"table2 {cell} {mode}: prefill flash_attention launches "
                 f"{run['prefill_attn_kernel']}, want {n_attn} in each of {batch}")
    equal = (runs["eager"]["tokens"] == runs["graphed"]["tokens"]
             if "eager" in runs else None)
    if equal is False:
        fail(f"table2 {cell}: graphed tokens differ from eager ones at "
             f"{first_differences(runs['graphed']['tokens'], runs['eager']['tokens'])}")
    return runs, equal


def phase_table2(mixtral_roots: list) -> None:
    """Table 2 on the card (``TABLE2``): each cell measured on ``MiniEngine``
    (``launch.serve.measure``: a warm pass, then the measured one) and
    predicted four ways (analytical on the ``H100-SXM`` preset and on
    ``measure_hardware("cuda")``, refined from each of two fits), each with
    the measured decode floor as ``engine_overhead`` and with the
    predictor's default (``launch.serve.predict``)."""
    t0 = time.perf_counter()
    card_hw = measure_hardware("cuda")
    qwen_roots, fits_made = table2_calibrate()
    stop_if_failed("table2")
    roots = {"qwen2-7b": qwen_roots, "mixtral-8x7b": mixtral_roots}
    coverage, cells = {}, []
    for arch, (layers, grid) in TABLE2.items():
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        fitted = [load_calibrated_ops(root, full, H100_SXM) for root in roots[arch]]
        profiles = {"analytical, H100-SXM preset": (H100_SXM, None),
                    "analytical, measured card": (card_hw, None),
                    "refined, fit 1": (H100_SXM, fitted[0]),
                    "refined, fit 2": (H100_SXM, fitted[1])}
        coverage[arch] = {
            name: priced_by_fit(build_colocated(cfg, hw, n_replicas=1,
                                                par=ParallelismConfig(tp=1),
                                                ops=o), o)["colocated"]
            for name, (hw, o) in profiles.items() if o is not None}
        for k, (batch, prompt, output) in enumerate(grid):
            cell = f"{arch} b{batch} p{prompt} o{output}"
            runs, equal = table2_runs(cfg, k, batch, prompt, output)
            measured, floor = runs["graphed"]["measured"], runs["graphed"]["floor"]
            preds = {}
            t1 = time.perf_counter()
            for name, (hw, o) in profiles.items():
                for overhead, floor_s in (("floor", floor), ("default", None)):
                    rep = serve_launch.predict(cfg, hw, floor_s, o, batch=batch,
                                               prompt_len=prompt, output_len=output)
                    line = summary_of(rep)
                    finite = all(isinstance(v, (int, float)) and math.isfinite(v)
                                 for v in line.values())
                    if line["n_completed"] != batch or not finite:
                        fail(f"table2 {cell} {name}/{overhead}: {line}")
                        continue
                    line["rel_err_tok_s"] = (line["throughput_tok_s"]
                                             / measured["throughput_tok_s"] - 1.0)
                    preds[f"{name} / {overhead}"] = line
            if k == 0:                # a refined prediction repeats byte for byte
                again = [json.dumps(serve_launch.predict(
                    cfg, H100_SXM, floor, fitted[0], batch=batch,
                    prompt_len=prompt, output_len=output), sort_keys=True)
                    for _ in range(2)]
                if again[0] != again[1]:
                    fail(f"table2 {cell}: a refined prediction differs when repeated")
            cells.append(cell)
            parts = {name: decode_parts(cfg, hw, o, batch, prompt + output // 2)
                     for name, (hw, o) in profiles.items()}
            say("table2_cell", model=arch, layers=len(cfg.pattern), batch=batch,
                prompt=prompt, output=output, max_seq=TABLE2_MAX_SEQ,
                measured=runs["graphed"]["line"], decode_floor_s=floor,
                peak_mem_gb=runs["graphed"]["peak_mem_gb"],
                measure_s=runs["graphed"]["measure_s"],
                prefill_attn_kernel=runs["graphed"]["prefill_attn_kernel"],
                eager=({key: runs["eager"][key] for key in (
                    "line", "floor", "peak_mem_gb", "measure_s")}
                    if "eager" in runs else None),
                tokens_equal_eager=equal,
                order=list(runs), predict_s=time.perf_counter() - t1,
                predicted=preds, mid_decode_step_ms=parts)
        donated = donated_decode_gap(cfg, max(batch for batch, _, _ in grid))
        if (max(donated["gaps"]) > TOL_DONATED
                or set(donated["attn_kernel"]) != {donated["attention_layers"]}):
            fail(f"table2 {arch}: donated decode {donated}")
        say("table2_donated", model=arch, layers=len(cfg.pattern), **donated)
        stop_if_failed("table2")
    idle = {mode: decode_idle_share(get_config(IDLE_ARCH), eager=mode == "eager")
            for mode in ("graphed", "eager")}
    say("table2_idle", model=IDLE_ARCH, batch=IDLE_BATCH, prompt=IDLE_PROMPT,
        steps=IDLE_STEPS, **idle)
    stop_if_failed("table2")
    say("table2", ok=not FAILURES, wall_s=time.perf_counter() - t0, cells=cells,
        hardware={"H100-SXM preset": dataclasses.asdict(H100_SXM),
                  "measured card": dataclasses.asdict(card_hw)},
        fits={"qwen2-7b": dict(zip(qwen_roots, fits_made)),
              "mixtral-8x7b": mixtral_roots},
        fit_prices_tp1_cluster=coverage)
    stop_if_failed("table2")


def donated_decode_gap(cfg, batch: int, replays: int = 4) -> dict:
    """The graphed bf16 engine's decode, which hands the slot cache over
    (each entry written in place, the decode attention kernel over each
    slot's prefix), against the same step through the functional path
    (``model.decode`` on a copy of the slot cache, which it leaves as it
    was): ``replays`` replays at ragged lengths, each one's largest logit
    gap over the largest logit, and each decode's ``attn_kernel``."""
    gc.collect()
    torch.cuda.empty_cache()
    eng = MiniEngine(cfg, max_slots=batch, max_seq=TABLE2_MAX_SEQ, seed=0,
                     dtype=torch.bfloat16)
    step, gaps = eng._decode, []

    def checked():
        if not step.captured:
            return step()
        cache = tree_map(torch.clone, eng.cache)
        tokens, pos = eng.tokens.clone(), eng.pos.clone()
        out = step()
        with torch.no_grad():
            want, _ = eng.model.decode(cache, tokens, pos)
        want = want.float()
        gaps.append(float((out.float() - want).abs().max() / want.abs().max()))
        return out
    eng._decode = checked
    rng = np.random.default_rng(0)
    with torch.no_grad():
        eng.submit([rng.integers(0, cfg.vocab_size, int(n))
                    for n in rng.integers(64, 512, batch)], replays + 2)
        eng.run()
    n_attn = sum(k in ("global", "local") for k in eng.model.kinds)
    kernels = [s["attn_kernel"] for s in eng.step_log if s["kind"] == "decode"]
    del eng, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": batch, "gaps": gaps, "attention_layers": n_attn,
            "attn_kernel": kernels}


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


def serve_engine(cfg, prompts, eager: bool) -> tuple:
    """(b)'s engine: a warm pass, then the measured one with the launches
    counted from zero.  Returns the engine, the measured requests, report
    (with the measured pass's step log) and launches, and the init s."""
    t0 = time.perf_counter()
    eng = MiniEngine(cfg, max_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, seed=0,
                     dtype=torch.bfloat16, options=SERVE_OPTIONS, eager=eager)
    init_s = time.perf_counter() - t0
    eng.submit(prompts, SERVE_NEW)
    eng.run()                                   # warm pass: captures
    eng.step_log.clear()
    ops.reset_launch_counts()
    reqs = eng.submit(prompts, SERVE_NEW)
    report = eng.run()                          # measured pass
    torch.cuda.synchronize()
    report["step_log"] = list(eng.step_log)
    return eng, reqs, report, ops.launch_counts(), init_s


def wkv_in_one_prefill(eng, prompt) -> dict:
    """One more request of ``prompt`` on ``eng`` (a prefill, which replays
    its bucket's graph, and one decode step) under ``torch.profiler``: the
    ``wkv_chunked`` launches the replay counted, and the WKV6 kernels the
    card ran, as the profiler saw them inside the graph."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    before = ops.launch_counts()["wkv_chunked"]
    eng.submit([prompt], 1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    return {"counted": ops.launch_counts()["wkv_chunked"] - before,
            "profiled": sum(1 for e in prof.events()
                            if e.device_type == DeviceType.CUDA
                            and "wkv_chunk_kernel" in e.name)}


def phase_serve() -> dict:
    cfg = get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()        # this phase's own peak
    with torch.no_grad():
        parity = serve_parity(cfg)
    torch.cuda.empty_cache()
    stop_if_failed("serve")

    # (b) bf16 MiniEngine with the kernel on the prefill path: its CUDA
    # graphs (the default; the prefills replay the WKV6 kernel), then eager
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
    eng, reqs, report, counts, init_s = serve_engine(cfg, prompts, eager=False)
    _, eager_reqs, eager_report, eager_counts, _ = serve_engine(cfg, prompts,
                                                                eager=True)
    gc.collect()
    if [r.tokens for r in reqs] != [r.tokens for r in eager_reqs]:
        fail(f"serve: graphed tokens differ from eager ones at "
             f"{first_differences([r.tokens for r in reqs], [r.tokens for r in eager_reqs])}")

    prefills = [s for s in eng.step_log if s["kind"] == "prefill"]
    decodes = [s["dur"] for s in eng.step_log if s["kind"] == "decode"]
    want = len(cfg.pattern) * len(prefills)
    if len(prefills) != len(SERVE_PROMPTS) or counts["wkv_chunked"] != want:
        fail(f"serve: {len(prefills)} prefills launched wkv_chunked "
             f"{counts['wkv_chunked']} times, not {len(cfg.pattern)} each")
    if eager_counts["wkv_chunked"] != counts["wkv_chunked"]:
        fail(f"serve: replays counted {counts['wkv_chunked']} wkv_chunked "
             f"launches, the eager engine {eager_counts['wkv_chunked']}")
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
    # the replays' count is the wrappers' at capture: hold it once to the
    # kernels the card ran in a replay
    with torch.no_grad():
        on_device = wkv_in_one_prefill(eng, prompts[0])
    if not on_device["counted"] == on_device["profiled"] == len(cfg.pattern):
        fail(f"serve: one graphed prefill counted {on_device['counted']} "
             f"wkv_chunked launches and the profiler saw "
             f"{on_device['profiled']} WKV6 kernels, not {len(cfg.pattern)}")
    say("serve", ok=not FAILURES, arch=SERVE_ARCH, layers=len(cfg.pattern),
        d_model=cfg.d_model, vocab=cfg.vocab_size, options=SERVE_OPTIONS,
        parity_f32=parity, dtype="bf16", slots=SERVE_SLOTS,
        max_seq=SERVE_MAX_SEQ, prompts=list(SERVE_PROMPTS),
        new_tokens=SERVE_NEW, engine_init_s=init_s,
        launches=counts, greedy_equal=not mismatched,
        graphed={"decode_captured": eng._decode.captured,
                 "wkv_in_one_prefill": on_device,
                 "prefill_buckets_captured": sorted(
                     b for b, (_, st) in eng._prefills.items() if st.captured)},
        eager={"launches": eager_counts,
               "tokens_equal_graphed": [r.tokens for r in reqs]
               == [r.tokens for r in eager_reqs],
               "decode_floor_s": min(s["dur"] for s in eager_report["step_log"]
                                     if s["kind"] == "decode"),
               **{key: eager_report[key] for key in (
                   "throughput_tok_s", "ttft_mean_s", "tpot_mean_s",
                   "duration_s")}},
        decode_floor_s=min(decodes),
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


# ------------------------------------------------------------------- train --
# Phase ``train``: yi-9b at full width in f32 (TF32 off, as main() leaves it).
TRAIN_ARCH = "yi-9b"
TRAIN_RUN = dict(smoke=False, layers=8, steps=12, seq_len=4096, global_batch=2,
                 lr=3e-4, remat="full")
TRAIN_GRAD_TOKENS = 128              # (a): one batch of 1 x 128 tokens, 1 layer
TOL_TRAIN_LOSS_REL, TOL_TRAIN_GRAD_REL, TOL_TRAIN_PARAM = 1e-5, 1e-4, 1e-5
# (c): the reference test's resume (tests/test_training.py) through the CLI
RESUME_ARGS = ["--arch", "qwen3-8b", "--seq-len", "32", "--global-batch", "2",
               "--seed", "7", "--log-every", "100"]
RESUME_TOL = 2e-4
TRAIN_EAGER_STEPS = 4                # (b)'s eager steps, beside the graphed run


def train_step_on(device: str, cfg, host_params, batch) -> tuple:
    """One ``make_train_step`` of ``cfg`` on ``device`` from a copy of
    ``host_params``: (loss, gradient tree, updated parameter tree)."""
    params = tree_map(lambda t: t.to(device, copy=True), host_params)
    model = build_model(cfg, params=params)
    model.requires_grad_(True)
    opt = AdamW(AdamWConfig(zero1=False), model.ax)
    step = make_train_step(model, opt)
    params, _, metrics = step(params, opt.init(params),
                              {k: torch.from_numpy(v).to(device)
                               for k, v in batch.items()})
    return float(metrics["loss"]), tree_map(lambda p: p.grad, model.param_tree()), params


def train_parity() -> dict:
    """(a) one f32 AdamW step of full-width yi-9b (one layer) on the card and
    on the CPU from the same weights and batch: the loss within 1e-5
    relative, each leaf's gradients within 1e-4 of its largest, the updated
    parameters within 1e-5.

    Adam's first step is ``lr * g / (|g| + eps)``, steep where ``|g|`` is
    near ``eps``: there a gradient's rounding (held at 1e-4 above) moves the
    step by up to ``lr / 4 * |dg| / eps``.  So the parameters are held where
    that cannot reach them: the card's AdamW, handed the CPU's gradients,
    must give the CPU's parameters within 1e-5 (the update's arithmetic is
    the same on both), and the entries the full steps put more than 1e-5
    apart, through their gradients, are counted."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=1)
    gen = torch.Generator().manual_seed(0)
    host = init_tree(gen, build_model(cfg).pds(), torch.float32, "cpu")
    batch = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_GRAD_TOKENS, 1)).batch(0)
    t0 = time.perf_counter()
    loss_c, grads_c, params_c = train_step_on("cuda", cfg, host, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_h, grads_h, params_h = train_step_on("cpu", cfg, host, batch)
    cpu_s = time.perf_counter() - t0
    if not abs(loss_c - loss_h) <= TOL_TRAIN_LOSS_REL * abs(loss_h):
        fail(f"train: card loss {loss_c!r} != CPU loss {loss_h!r}")
    # the card's AdamW on the CPU's gradients
    params_x = tree_map(lambda t: t.to("cuda", copy=True), host)
    opt = AdamW(AdamWConfig(zero1=False), AxisRules(None))
    params_x, _ = opt.update(params_x, tree_map(lambda g: g.to("cuda"), grads_h),
                             opt.init(params_x))
    worst = {"grad_rel": (0.0, ""), "param_abs": (0.0, ""),
             "param_abs_given_cpu_grads": (0.0, "")}
    steep = 0
    for (path, g_card), g_host, p_card, p_host, p_x in zip(
            ckpt.flatten(grads_c).items(), tree_leaves(grads_h), tree_leaves(params_c),
            tree_leaves(params_h), tree_leaves(params_x)):
        g_err = float((g_card.cpu() - g_host).abs().max()) / float(g_host.abs().max())
        off = (p_card.detach().cpu() - p_host.detach()).abs()
        x_err = float((p_x.cpu() - p_host.detach()).abs().max())
        if not g_err <= TOL_TRAIN_GRAD_REL:
            fail(f"train: gradient of {path} {g_err:.3e} of its largest from the CPU's")
        if not x_err <= TOL_TRAIN_PARAM:
            fail(f"train: the card's AdamW on the CPU's gradients puts {path} "
                 f"{x_err:.3e} from the CPU's")
        steep += int((off > TOL_TRAIN_PARAM).sum())
        for key, err in (("grad_rel", g_err), ("param_abs", float(off.max())),
                         ("param_abs_given_cpu_grads", x_err)):
            worst[key] = max(worst[key], (err, path))
    return {"layers": 1, "tokens": TRAIN_GRAD_TOKENS, "loss": {"cuda": loss_c, "cpu": loss_h},
            "worst_leaf": {k: {"leaf": v[1], "err": v[0]} for k, v in worst.items()},
            "entries_past_1e-5_by_their_gradient": steep,
            "step_s": {"cuda_first": card_s, "cpu": cpu_s}}


def model_flops(cfg, tokens: int, seq_len: int, batch: int) -> float:
    """Model FLOPs of one training step: 6 N per token for the N weights of
    the matrix products (every layer's projections and FFN, and the head;
    not the embedding, a gather), plus attention's two S x S products over
    the full square as the naive path computes them, 4 B S^2 H hd a layer
    forward, three times that with backward.  Remat's recompute not counted."""
    pds = build_model(cfg).pds()
    n = sum(math.prod(pd.shape) for pd in tree_leaves(pds["layers"])
            if len(pd.shape) > 1) + math.prod(pds["head"].shape)
    attn = 12 * cfg.num_layers * batch * seq_len ** 2 * cfg.num_heads \
        * cfg.resolved_head_dim
    return 6 * n * tokens + attn


def steady_ms(step_s: list, eager: bool) -> dict:
    """Step ms of a ``launch.train.run``: the first step, the warm-up steps
    of a graphed run (the last of them also captures), and the steady ones
    (replays, or every eager step after the first)."""
    warm = 1 if eager else GRAPH_WARMUP
    steady = step_s[warm:]
    return {"mean": statistics.fmean(steady) * 1e3, "min": min(steady) * 1e3,
            "max": max(steady) * 1e3, "first": step_s[0] * 1e3,
            "warmup": [x * 1e3 for x in step_s[1:warm]]}


def train_full_width(card: str) -> dict:
    """(b) ``launch.train.run`` of yi-9b at full width, TRAIN_RUN's layers and
    steps, replayed from its CUDA graph: finite losses, the last below the
    first, and no kernel launched; then TRAIN_EAGER_STEPS eager steps from the
    same weights, their losses equal to the graphed run's first ones."""
    before = ops.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(sys.stderr):       # its log lines
        out = train_launch.run(TRAIN_ARCH, device="cuda", log_every=1,
                               **TRAIN_RUN)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train: full-width losses not finite and falling: {losses}")
    if ops.launch_counts() != before:
        fail(f"train: kernels launched on the training path: "
             f"{ops.launch_counts()} against {before}")
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_RUN["layers"])
    tokens = TRAIN_RUN["seq_len"] * TRAIN_RUN["global_batch"]
    step_ms = steady_ms(out["step_s"], eager=False)
    step_s = step_ms["mean"] / 1e3
    flops = model_flops(cfg, tokens, TRAIN_RUN["seq_len"], TRAIN_RUN["global_batch"])
    n_params = sum(p.numel() for p in tree_leaves(out["params"]))
    del out
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(sys.stderr):
        eager = train_launch.run(TRAIN_ARCH, device="cuda", log_every=1,
                                 eager=True, **dict(TRAIN_RUN, steps=TRAIN_EAGER_STEPS))
    eager_peak = torch.cuda.max_memory_allocated()
    eager_equal = eager["losses"] == losses[:TRAIN_EAGER_STEPS]
    if not eager_equal:
        fail(f"train: eager losses {eager['losses']} differ from the graphed "
             f"run's {losses[:TRAIN_EAGER_STEPS]}")
    eager_ms = steady_ms(eager["step_s"], eager=True)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": card, "arch": TRAIN_ARCH, **TRAIN_RUN, "dtype": "f32",
            "params": n_params, "losses": losses, "graphed": True,
            "step_ms": step_ms,
            "tokens_per_s": tokens / step_s,
            "model_tflop_per_step": flops / 1e12,
            "model_tflop_s": flops / step_s / 1e12,
            "flops_formula": "6*N*B*S + 12*L*B*S^2*H*hd, N = matmul weights",
            "peak_mem_gb": peak / 1e9,
            "eager": {"steps": TRAIN_EAGER_STEPS, "step_ms": eager_ms,
                      "losses_equal_graphed": eager_equal,
                      "peak_mem_gb": eager_peak / 1e9}}


def train_resume(out_dir: str) -> dict:
    """(c) ``python -m repro_torch.launch.train`` in a subprocess: 10 steps
    with a checkpoint at 10, then 10 resumed steps (checkpointed at 20, its
    manifest holding the last loss), against a straight 20-step run."""
    ck = os.path.join(out_dir, "ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    env = src_env()
    logs = []
    for extra in (["--steps", "10", "--ckpt-every", "10"],
                  ["--steps", "10", "--ckpt-every", "10", "--resume"]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *RESUME_ARGS,
             "--ckpt-dir", ck, *extra], cwd=ROOT, env=env, timeout=600,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(proc.stdout)
        if proc.returncode != 0:
            fail(f"train: the CLI exited with {proc.returncode}: {proc.stdout[-2000:]}")
            return {"logs": logs}
    if "resumed from step 10" not in logs[1]:
        fail("train: the second CLI run did not resume from step 10")
    with open(os.path.join(ck, "step_00000020", "manifest.json")) as f:
        resumed = json.load(f)["extra"]["loss"]
    straight = train_launch.run("qwen3-8b", steps=20, seq_len=32, global_batch=2,
                                seed=7, log_every=100, device="cuda")["last_loss"]
    if not abs(resumed - straight) <= RESUME_TOL * (1 + abs(straight)):
        fail(f"train: resumed loss {resumed!r} != straight run's {straight!r}")
    return {"resumed_last_loss": resumed, "straight_last_loss": straight,
            "diff": abs(resumed - straight), "bit_equal": resumed == straight}


def phase_train(card: str) -> dict:
    t0 = time.perf_counter()
    parity = train_parity()
    gc.collect()
    stop_if_failed("train")
    full = train_full_width(card)
    stop_if_failed("train")
    resume = train_resume(os.path.join(ROOT, "build", "train"))
    say("train", ok=not FAILURES, grads_cuda_vs_cpu=parity, full_width=full,
        resume=resume, wall_s=time.perf_counter() - t0)
    stop_if_failed("train")
    return full


# ------------------------------------------------------------------- shard --
# Phase ``shard``: the sharded path, every rank of a mesh a thread of this
# process on the one card (torch's ``threaded`` backend: collectives are
# copies between the ranks' tensors).  Each run is held to the same model run
# unsharded on the card, in f32 with TF32 off.  The ranks' local work and
# shards are real; their communication is not, and no time from it stands for
# a multi-card deployment.
SHARD_MOE = dict(arch="mixtral-8x7b", layers=2, mesh=(2, 4), batch=4, seq=512)
SHARD_TRAIN = dict(arch="yi-9b", layers=2, mesh=(2, 4), batch=4, seq=512)
SHARD_RWKV = dict(arch="rwkv6-1.6b", layers=4, mesh=(1, 4), seq=2048,
                  options={"rwkv_impl": "chunked", "rwkv_chunk": 16})
SHARD_RESHARD = dict(arch="yi-9b", layers=2, mesh_from=(8,), mesh_to=(2, 4))
SHARD_GRADS = dict(archs=("yi-9b", "mixtral-8x7b", "rwkv6-1.6b"), mesh=(2, 4),
                   batch=4, seq=32)
TOL_SHARD_REL = 1e-4          # logits, states, gradients: of the largest
TOL_SHARD_LOSS_REL = 1e-5
TOL_SHARD_UPDATE = 1e-5       # ZeRO-1 AdamW given the unsharded gradients


def axes_of(shape) -> tuple:
    return ("data", "model")[-len(shape):]


def threaded_world(world: int, fn, device) -> list:
    """``fn(rank)`` on ``world`` threads, each one rank of a torch.distributed
    world on the ``threaded`` backend (torch's in-process test backend), all
    on ``device``.  Returns the ranks' results in rank order; a rank's
    exception wakes the others' collectives and is raised here.

    The ranks' process groups are not destroyed one by one (torch 2.11's
    ``destroy_process_group`` reads a field its threaded world lacks): the
    threads' worlds end with them, and the backend's shared state is reset."""
    import threading
    import traceback
    import torch.distributed as dist
    from torch.testing._internal.distributed.multi_threaded_pg import (
        ProcessLocalGroup, _install_threaded_pg, _uninstall_threaded_pg)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out, errors = [None] * world, []
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    store = dist.HashStore()

    def run(rank):
        try:
            dist.init_process_group("threaded", rank=rank, world_size=world,
                                    store=store)
            if device.type == "cuda":
                torch.cuda.set_device(device)
            out[rank] = fn(rank)
        except BaseException as e:          # re-raised below, in this thread
            errors.append((rank, traceback.format_exc()))
            ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        ProcessLocalGroup.reset()
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errors:
        rank, tb = min(errors)
        raise RuntimeError(f"rank {rank} of the threaded world failed:\n{tb}")
    return out


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(got, want) -> float:
    scale = float(want.abs().max())
    return float((got.float() - want.float()).abs().max()) / (scale or 1.0)


def _shard_err(got, want, scale: float, past: float = TOL_SHARD_REL) -> tuple:
    """(max |got - want| / scale, entries more than ``past * scale`` apart)
    for a DTensor ``got`` and the same tensor whole on every rank: each rank
    compares its own shard with ``want``'s matching slice, so no rank
    gathers a full leaf; maxima and counts meet by all-reduces, and a
    replicated shard's entries count once."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = got.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p for p in got.placements)
    d = got.redistribute(mesh, pl).to_local().float()
    d = d.sub_(distribute_tensor(want, mesh, pl, src_data_rank=None).to_local()).abs_()
    first = all(mesh.get_local_rank(i) == 0 for i, p in enumerate(pl)
                if p.is_replicate())
    worst = d.max().reshape(1)
    count = ((d > past * scale).sum() * int(first)).reshape(1).to(torch.float64)
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    dist.all_reduce(count)
    return float(worst) / scale, int(count)


def _init(cfg, device, seed=0):
    pds = build_model(cfg).pds()
    gen = torch.Generator(device=device).manual_seed(seed)
    return pds, init_tree(gen, pds, torch.float32, device)


def shard_moe(cfg, mesh_shape, batch: int, seq: int, device) -> dict:
    """(a) ``LM.prefill`` logits of an MoE config on a mesh, under
    ``moe_dispatch`` "psum" and "a2a", against the unsharded prefill, with
    ``capacity_factor_eval = E / k``, which drops no token on any path (each
    expert's capacity is every token of its shard); each path's
    ``moe_drop_frac`` (from the blocks' aux at eval capacity) must be 0."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.launch.mesh import make_mesh
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor_eval=moe.num_experts / moe.top_k))
    device = torch.device(device)
    pds, params = _init(cfg, device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))

    def drop_frac(model, b):
        return float(_full(model._run_train(model._inputs_to_x(b), train=False)[1]
                           ["moe_drop_frac"]))

    with torch.no_grad():
        model = build_model(cfg, params=params)
        want = model.prefill({"tokens": tokens}, all_logits=True)[0]
        drops = {"unsharded": drop_frac(model, {"tokens": tokens})}
        del model

    def rank_fn(rank):
        mesh = make_mesh(mesh_shape, axes_of(mesh_shape), device.type)
        out = {}
        with torch.no_grad():
            sharded = shard_params(params, pds, AxisRules(mesh))
            for dispatch in ("psum", "a2a"):
                ax = AxisRules(mesh, {"moe_dispatch": dispatch})
                model = build_model(cfg, ax, params=sharded)
                b = place_batch(ax, {"tokens": tokens})
                got = _full(model.prefill(b, all_logits=True)[0])
                out[dispatch] = {"logits_rel": _rel(got, want),
                                 "moe_drop_frac": drop_frac(model, b)}
        return out

    per_rank = threaded_world(math.prod(mesh_shape), rank_fn, device)
    res = per_rank[0]
    failures = [f"{d}: logits {r['logits_rel']:.3e} of the largest from the "
                f"unsharded prefill's" for d, r in res.items()
                if not r["logits_rel"] <= TOL_SHARD_REL]
    failures += [f"{k}: moe_drop_frac {v}" for k, v in
                 [("unsharded", drops["unsharded"])]
                 + [(d, r["moe_drop_frac"]) for d, r in res.items()] if v != 0.0]
    return {"arch": cfg.name, "layers": cfg.num_layers, "mesh": list(mesh_shape),
            "batch": batch, "seq": seq, "tol_rel": TOL_SHARD_REL,
            "capacity_factor_eval": cfg.moe.capacity_factor_eval,
            "unsharded_moe_drop_frac": drops["unsharded"], **res,
            "failures": failures}


def shard_train(cfg, mesh_shape, batch: int, seq: int, device) -> dict:
    """(b) one ZeRO-1 AdamW step of ``cfg`` on a mesh against the same step
    unsharded: the loss within 1e-5 relative, each leaf's gradient within
    1e-4 of its largest, and the sharded AdamW handed the unsharded
    gradients within 1e-5 of the unsharded parameters.

    The parameters after the two whole steps are read, not gated: Adam's
    first step is ``lr * g / (|g| + eps)``, and where a sum cancels to a
    gradient near ``eps`` the rounding of the sharded sums (held at 1e-4
    above) moves it by up to ``lr``.  Their worst distance and the entries
    past 1e-4 of their leaf's largest are printed.  Errors are taken shard
    by shard (``_shard_err``)."""
    from repro_torch.convert import place, shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import tree_map_with
    device = torch.device(device)
    pds, params = _init(cfg, device)
    data = {k: torch.from_numpy(v).to(device) for k, v in
            SyntheticLM(DataConfig(cfg.vocab_size, seq, batch)).batch(0).items()}
    names = list(ckpt.flatten(params))

    def step(model, p, opt, b):
        """(loss, gradient tree, updated parameter tree, AdamW state)."""
        model.requires_grad_(True)
        p, st, metrics = make_train_step(model, opt)(p, opt.init(p, pds), b)
        return (float(_full(metrics["loss"])),
                tree_map(lambda x: x.grad, model.param_tree()), p, st)

    copy = tree_map(torch.clone, params)
    loss0, grads0, after0, _ = step(build_model(cfg, params=copy), copy,
                                    AdamW(AdamWConfig(zero1=False), AxisRules(None)),
                                    data)
    grads0 = tree_map(lambda g: g.detach(), grads0)
    g_scale, p_scale = ([float(t.abs().max()) or 1.0 for t in tree_leaves(tree)]
                        for tree in (grads0, after0))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def local_bytes(tree):
        return sum(t.to_local().numel() * t.element_size() for t in tree_leaves(tree))

    def rank_fn(rank):
        mesh = make_mesh(mesh_shape, axes_of(mesh_shape), device.type)
        ax = AxisRules(mesh)
        opt = AdamW(AdamWConfig(zero1=True), ax)

        def whole_step():
            p = shard_params(params, pds, ax)
            loss, grads, after, st = step(build_model(cfg, ax, params=p), p, opt,
                                          place_batch(ax, data))
            held = 2 * local_bytes(p) + local_bytes(st["m"]) + local_bytes(st["v"])
            errs = {"grad": [_shard_err(g, g0, s)[0] for g, g0, s in
                             zip(tree_leaves(grads), tree_leaves(grads0), g_scale)]}
            after = [_shard_err(a.detach(), b, s)
                     for a, b, s in zip(tree_leaves(after), tree_leaves(after0), p_scale)]
            errs["after"] = [e for e, _ in after]
            errs["past"] = sum(n for _, n in after)
            return loss, errs, held

        def given_grads():
            p = shard_params(params, pds, ax)
            g = tree_map_with(lambda x, g0: place(g0, mesh, x.placements), p, grads0)
            p, _ = opt.update(p, g, opt.init(p, pds))
            return [_shard_err(a, b, 1.0)[0]
                    for a, b in zip(tree_leaves(p), tree_leaves(after0))]

        loss, errs, held = whole_step()
        gc.collect()            # the step's tensors, before the second part
        return {"loss": loss, **errs, "given": given_grads(), "bytes": held}

    per_rank = threaded_world(math.prod(mesh_shape), rank_fn, device)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    r0 = per_rank[0]
    g_err, u_err, p_err = (max(zip(r0[k], names)) for k in ("grad", "given", "after"))
    loss_rel = abs(r0["loss"] - loss0) / abs(loss0)
    failures = []
    if not loss_rel <= TOL_SHARD_LOSS_REL:
        failures.append(f"loss {r0['loss']!r} against {loss0!r}")
    if not g_err[0] <= TOL_SHARD_REL:
        failures.append(f"gradient of {g_err[1]} {g_err[0]:.3e} of its largest")
    if not u_err[0] <= TOL_SHARD_UPDATE:
        failures.append(f"ZeRO-1 AdamW on the unsharded gradients puts "
                        f"{u_err[1]} {u_err[0]:.3e} away")
    return {"arch": cfg.name, "layers": cfg.num_layers, "mesh": list(mesh_shape),
            "batch": batch, "seq": seq, "zero1": True,
            "loss": {"sharded": r0["loss"], "unsharded": loss0, "rel": loss_rel},
            "grad_rel": {"leaf": g_err[1], "err": g_err[0]},
            "adamw_given_unsharded_grads_abs": {"leaf": u_err[1], "err": u_err[0]},
            "params_after_step_rel": {"leaf": p_err[1], "err": p_err[0],
                                      "entries_past_1e-4": r0["past"],
                                      "entries": sum(t.numel() for t in tree_leaves(after0))},
            "rank_gb_params_grads_moments": [r["bytes"] / 1e9 for r in per_rank],
            "world_peak_gb_threaded_one_card": None if peak is None else peak / 1e9,
            "failures": failures}


def shard_rwkv(cfg, mesh_shape, seq: int, options: dict, device) -> dict:
    """(c) a chunked prefill of one ``seq``-token prompt on a mesh against the
    unsharded chunked prefill: the last logits and every layer's final state
    within 1e-4 of their largest.  On a CUDA device the WKV6 kernel must be
    launched once per rank per layer, each rank on its own heads."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.launch.mesh import make_mesh
    device = torch.device(device)
    pds, params = _init(cfg, device)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    with torch.no_grad():
        want, cache = build_model(cfg, AxisRules(None, options),
                                  params=params).prefill({"tokens": tokens})
    states = [c["state"] for c in cache["layers"]]
    world = math.prod(mesh_shape)
    ops.reset_launch_counts()

    def rank_fn(rank):
        ax = AxisRules(make_mesh(mesh_shape, axes_of(mesh_shape), device.type),
                       options)
        with torch.no_grad():
            model = build_model(cfg, ax, params=shard_params(params, pds, ax))
            got, cache = model.prefill(place_batch(ax, {"tokens": tokens}))
            layers = cache["layers"]
            return {"logits_rel": _rel(_full(got), want),
                    "state_rel": max(_rel(_full(c["state"]), w)
                                     for c, w in zip(layers, states)),
                    "local_heads": layers[0]["state"].to_local().shape[1]}

    res = threaded_world(world, rank_fn, device)
    launches = ops.launch_counts()["wkv_chunked"]
    heads = cfg.d_model // cfg.rwkv_head_size
    failures = [f"{k} {res[0][k]:.3e} of the largest from the unsharded prefill's"
                for k in ("logits_rel", "state_rel") if not res[0][k] <= TOL_SHARD_REL]
    want_launches = world * cfg.num_layers if device.type == "cuda" else 0
    if launches != want_launches:
        failures.append(f"wkv_chunked launched {launches} times, not "
                        f"{want_launches} (once per rank per layer)")
    per_rank_heads = [r["local_heads"] for r in res]
    if per_rank_heads != [heads // mesh_shape[-1]] * world:
        failures.append(f"ranks held {per_rank_heads} heads each of {heads}")
    return {"arch": cfg.name, "layers": cfg.num_layers, "mesh": list(mesh_shape),
            "seq": seq, "options": options, "heads": heads,
            "heads_per_rank": per_rank_heads, "wkv_launches": launches,
            "logits_rel": res[0]["logits_rel"], "state_rel": res[0]["state_rel"],
            "tol_rel": TOL_SHARD_REL, "failures": failures}


def shard_grads(archs, mesh_shape, batch: int, seq: int, device) -> dict:
    """(e) one loss and every gradient of each smoke config in ``archs`` on a
    mesh against the same unsharded: the loss within 1e-5 relative, each
    leaf's gradient within 1e-4 of its largest.  Smoke widths, because there
    2 KV heads repeat over 4 "model" ranks (``AxisRules.shared_product``
    splits them and the K/V weight gradients; no full-width config above
    has fewer KV heads than ranks), and rwkv6's decay LoRA and bonus ``u``
    take their sharded gradients.  MoE experts get capacity E / k, so no
    rank drops a token."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.lowering import place_batch
    from repro_torch.launch.mesh import make_mesh
    device = torch.device(device)
    cases = []
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor_train=cfg.moe.num_experts / cfg.moe.top_k))
        data = {k: torch.from_numpy(v).to(device) for k, v in
                SyntheticLM(DataConfig(cfg.vocab_size, seq, batch)).batch(0).items()}
        cases.append((cfg, _init(cfg, device), data))

    def loss_grads(cfg, pds, params, data, ax):
        model = build_model(cfg, ax, params=shard_params(
            tree_map(torch.clone, params), pds, ax))
        model.requires_grad_(True)
        loss, _ = model.loss(place_batch(ax, data))
        loss.backward()
        return (float(_full(loss).detach()),
                [_full(t.grad) for t in tree_leaves(model.param_tree())])

    want = [loss_grads(cfg, pds, params, data, AxisRules(None))
            for cfg, (pds, params), data in cases]

    def rank_fn(rank):
        ax = AxisRules(make_mesh(mesh_shape, axes_of(mesh_shape), device.type))
        return [loss_grads(cfg, pds, params, data, ax)
                for cfg, (pds, params), data in cases]

    got = threaded_world(math.prod(mesh_shape), rank_fn, device)[0]
    rows, failures = [], []
    for arch, (loss, grads), (loss0, grads0) in zip(archs, got, want):
        row = {"arch": arch, "loss_rel": abs(loss - loss0) / abs(loss0),
               "grad_rel": max(_rel(g, g0) for g, g0 in zip(grads, grads0))}
        rows.append(row)
        if not row["loss_rel"] <= TOL_SHARD_LOSS_REL:
            failures.append(f"{arch} loss {row['loss_rel']:.3e} from the unsharded")
        if not row["grad_rel"] <= TOL_SHARD_REL:
            failures.append(f"{arch} gradient {row['grad_rel']:.3e} of its largest")
    return {"mesh": list(mesh_shape), "batch": batch, "seq": seq, "smoke": True,
            "archs": rows, "failures": failures}


def shard_reshard(cfg, mesh_from, mesh_to, device, out_dir: str) -> dict:
    """(d) save ``cfg``'s parameters sharded on ``mesh_from`` and restore them
    onto ``mesh_to`` (the reference's elastic-resharding test): every leaf
    byte-equal to the original, on the target mesh's placements."""
    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import shape_tree, tree_map_with
    device = torch.device(device)
    pds, params = _init(cfg, device)
    shutil.rmtree(out_dir, ignore_errors=True)

    def rank_fn(rank):
        ax_a = AxisRules(make_mesh(mesh_from, axes_of(mesh_from), device.type))
        t0 = time.perf_counter()
        ckpt.save(out_dir, params=shard_params(params, pds, ax_a), step=5)
        save_s = time.perf_counter() - t0
        mesh_b = make_mesh(mesh_to, axes_of(mesh_to), device.type)
        ax_b = AxisRules(mesh_b)
        placed = ax_b.placement_tree(pds)
        t0 = time.perf_counter()
        got, _, step, _ = ckpt.restore(out_dir, params_like=shape_tree(pds, torch.float32),
                                       shardings=placed, mesh=mesh_b)
        restore_s = time.perf_counter() - t0
        equal = [bool(torch.equal(_full(g), w))
                 for g, w in zip(tree_leaves(got), tree_leaves(params))]
        on_target = tree_leaves(tree_map_with(
            lambda g, pl: g.placements == pl, got, placed))
        return {"step": step, "equal": sum(equal), "on_target": sum(on_target),
                "leaves": len(equal), "save_s": save_s, "restore_s": restore_s}

    res = threaded_world(math.prod(mesh_to), rank_fn, device)[0]
    failures = []
    if res["step"] != 5 or not res["equal"] == res["on_target"] == res["leaves"]:
        failures.append(f"restored step {res['step']}: of {res['leaves']} leaves "
                        f"{res['equal']} byte-equal, {res['on_target']} on the "
                        f"target mesh's placements")
    return {"arch": cfg.name, "layers": cfg.num_layers, "mesh_from": list(mesh_from),
            "mesh_to": list(mesh_to), **res, "failures": failures}


NCCL_PROBE = r"""
import os, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("nccl", init_method="tcp://localhost:" + sys.argv[2],
                        rank=rank, world_size=2)
t = torch.ones(1, device="cuda:0")
try:
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print("ok", float(t))
except Exception as e:
    print(type(e).__name__ + ": " + str(e).splitlines()[0] if str(e) else type(e).__name__)
finally:
    dist.destroy_process_group()
"""


def nccl_probe() -> dict:
    """Two NCCL ranks on the one card (cuda:0 each), one all-reduce: the
    reason the sharded path runs as a threaded world here.  No gate."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_PROBE, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + "\n(killed after 90 s)")
    lines = [[ln.strip() for ln in o.splitlines() if ln.strip()] for o in outs]
    return {"ranks": 2, "device": "cuda:0", "exit_codes": [p.returncode for p in procs],
            "nccl_warnings": [[ln for ln in lns if "NCCL WARN" in ln][:3] for lns in lines],
            "last_lines": [lns[-1:] for lns in lines]}


# (f): the mesh step captured in a CUDA graph, on a one-rank NCCL world in a
# process of its own (its default group cannot share a process with the
# threaded worlds).  Each item is ``launch.train.run(mesh_shape=(1, 1))``
# graphed (GRAPH_WARMUP eager steps, then replays), beside eager=True on the
# mesh for MESH_GRAPH_EAGER_STEPS (the warm-up's and three replays' losses
# compared) and the graphed step on one card for MESH_GRAPH_ONE_CARD_STEPS
# (the warm-up and one replay); f32, TF32 off.
MESH_GRAPH = {    # name: (run's arguments, steps)
    "yi": (dict(arch="yi-9b", smoke=False, layers=4, seq_len=4096, global_batch=2,
                lr=3e-4, remat="full"), GRAPH_WARMUP + 6),
    "100m": (dict(arch="yi-9b", size="100m", seq_len=256, global_batch=4,
                  lr=3e-4), 20),
    "moe": (dict(arch="mixtral-8x7b", smoke=False, layers=1, seq_len=2048,
                 global_batch=2, lr=3e-4, remat="full"), GRAPH_WARMUP + 3),
}
MESH_GRAPH_EAGER_STEPS = GRAPH_WARMUP + 3
MESH_GRAPH_ONE_CARD_STEPS = GRAPH_WARMUP + 1
MESH_GRAPH_TIMEOUT_S = 300


def _mesh_graph_run(spec: dict, steps: int, **kw) -> dict:
    """One ``launch.train.run`` of ``spec``: whether it was captured, its
    losses, step ms, peak GB and wall s; its tensors and graph are freed
    before it returns."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spec = dict(spec)
    with contextlib.redirect_stdout(sys.stderr):
        out = train_launch.run(spec.pop("arch"), steps=steps, device="cuda",
                               log_every=1000, **spec, **kw)
    torch.cuda.synchronize()
    res = {"graphed": out["graphed"],
           "step_ms": steady_ms(out["step_s"], eager=not out["graphed"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": out["losses"], "steps_s": sum(out["step_s"])}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    return res


def _nccl_kernels(spec: dict, steps: int, **kw) -> dict:
    """NCCL kernels a run of ``steps`` put on the card, by
    ``torch.profiler``'s kernel names (any name holding "nccl")."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _mesh_graph_run(spec, steps, **kw)
    return {e.key: e.count for e in prof.key_averages() if "nccl" in e.key.lower()}


def mesh_graph_item(name: str) -> dict:
    """One item of (f): the mesh run graphed and eager (losses equal to the
    bit), and one card graphed (losses within TOL_SHARD_LOSS_REL); for the
    MoE item also the NCCL kernels of one replay: those of a profiled
    graphed run of GRAPH_WARMUP eager steps and one replay, less
    GRAPH_WARMUP eager steps' from a profiled eager run of two (run only
    where the graphed run had any: counts are never negative)."""
    spec, steps = MESH_GRAPH[name]
    mesh = dict(mesh_shape=(1, 1))
    runs = {"mesh_graphed": _mesh_graph_run(spec, steps, **mesh),
            "mesh_eager": _mesh_graph_run(spec, MESH_GRAPH_EAGER_STEPS, eager=True,
                                          **mesh),
            "one_card_graphed": _mesh_graph_run(spec, MESH_GRAPH_ONE_CARD_STEPS)}
    g, e, one = runs.values()
    failures = []
    if not (g["graphed"] and one["graphed"]) or e["graphed"]:
        failures.append(f"{name}: graphed mesh {g['graphed']}, eager mesh "
                        f"{e['graphed']}, one card {one['graphed']}")
    if not all(math.isfinite(x) for x in g["losses"]):
        failures.append(f"{name}: losses not finite: {g['losses']}")
    equal = g["losses"][:len(e["losses"])] == e["losses"]
    if not equal:
        failures.append(f"{name}: graphed mesh losses {g['losses']} differ from "
                        f"eager {e['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], one["losses"]))
    if not rel <= TOL_SHARD_LOSS_REL:
        failures.append(f"{name}: mesh losses {rel:.3e} (relative) from one card's")
    res = {**spec, "steps": steps, "runs": runs, "losses_equal_eager": equal,
           "loss_rel_to_one_card": rel,
           "mesh_over_one_card_ms": g["step_ms"]["mean"] / one["step_ms"]["mean"],
           "eager_over_graphed_ms": e["step_ms"]["mean"] / g["step_ms"]["mean"]}
    if name == "moe":
        graphed = _nccl_kernels(spec, GRAPH_WARMUP + 1, **mesh)
        eager = _nccl_kernels(spec, 2, eager=True, **mesh) if graphed else {}
        res["nccl_kernels"] = {
            "graphed_run": graphed, "eager_two_steps": eager,
            "per_replay": sum(graphed.values()) - GRAPH_WARMUP * sum(eager.values()) / 2}
    res["failures"] = failures
    return res


def mesh_graph_world(port: str, spawned: str) -> None:
    """(f)'s process: a one-rank NCCL world on the card, every item of
    MESH_GRAPH in turn; prints one JSON line, with the seconds from its
    spawn (``spawned``, the parent's ``time.time()``) to its world's start."""
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    out = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
           "start_s": time.time() - float(spawned)}
    before = ops.launch_counts()
    try:
        for name in MESH_GRAPH:
            t0 = time.perf_counter()
            out[name] = mesh_graph_item(name)
            out[name]["wall_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    out["kernel_launches"] = {k: n - before.get(k, 0)
                              for k, n in ops.launch_counts().items()}
    out["end_s"] = time.time() - float(spawned)
    print(json.dumps(out), flush=True)


def mesh_graph() -> dict:
    """(f) in a subprocess: its JSON, and its failures (a kernel launched on
    the training path among them)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.mesh_graph_world(*sys.argv[1:])", port, repr(time.time())],
            cwd=ROOT, env=src_env(), timeout=MESH_GRAPH_TIMEOUT_S,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except subprocess.TimeoutExpired as e:
        return {"failures": [f"killed after {MESH_GRAPH_TIMEOUT_S} s: "
                             f"{(e.stderr or '')[-2000:]}"]}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return {"failures": [f"exited with {proc.returncode}: {proc.stderr[-3000:]}"]}
    res = json.loads(lines[-1])
    res["failures"] = [msg for name in MESH_GRAPH for msg in res[name].pop("failures")]
    if any(res["kernel_launches"].values()):
        res["failures"].append(f"kernels launched on the training path: "
                               f"{res['kernel_launches']}")
    return res


def phase_shard(card: str) -> int:
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    probe = nccl_probe()
    say("shard", run="nccl_probe", **probe)

    def full_width(spec):
        return dataclasses.replace(get_config(spec["arch"]), num_layers=spec["layers"])

    runs = {}
    for name, fn in (
            ("mesh_graph", mesh_graph),
            ("moe", lambda: shard_moe(full_width(SHARD_MOE), SHARD_MOE["mesh"],
                                      SHARD_MOE["batch"], SHARD_MOE["seq"], "cuda")),
            ("train", lambda: shard_train(full_width(SHARD_TRAIN), SHARD_TRAIN["mesh"],
                                          SHARD_TRAIN["batch"], SHARD_TRAIN["seq"], "cuda")),
            ("rwkv", lambda: shard_rwkv(full_width(SHARD_RWKV), SHARD_RWKV["mesh"],
                                        SHARD_RWKV["seq"], SHARD_RWKV["options"], "cuda")),
            ("reshard", lambda: shard_reshard(
                full_width(SHARD_RESHARD), SHARD_RESHARD["mesh_from"],
                SHARD_RESHARD["mesh_to"], "cuda",
                os.path.join(ROOT, "build", "shard_ckpt"))),
            ("grads", lambda: shard_grads(SHARD_GRADS["archs"], SHARD_GRADS["mesh"],
                                          SHARD_GRADS["batch"], SHARD_GRADS["seq"],
                                          "cuda"))):
        t1 = time.perf_counter()
        res = fn()
        res["wall_s"] = time.perf_counter() - t1
        for msg in res["failures"]:
            fail(f"shard {name}: {msg}")
        runs[name] = res
        say("shard", run=name, card=card, world=(
            "one NCCL rank in a process of its own" if name == "mesh_graph"
            else "threaded ranks on one card"), **res)
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(ROOT, "build", "shard_ckpt"), ignore_errors=True)
    say("shard", ok=not FAILURES, card=card,
        world="(f) one NCCL rank; the rest threaded, every rank a thread on "
              "the one card; no time here stands for a multi-card deployment",
        wall_s=time.perf_counter() - t0,
        runs={k: {"failures": v["failures"], "wall_s": v["wall_s"]}
              for k, v in runs.items()})
    stop_if_failed("shard")
    return runs["rwkv"]["wkv_launches"]


# -------------------------------------------------------------------- cost --
# Phase ``cost``: the port's cost extraction (``launch/hlo_cost.py``), which
# runs steps on fake tensors and allocates nothing: the ``hlo`` oracle's
# prices against the kernels' device time, the training step counted against
# its measured time, two full-width dry-run cells on the production pod mesh
# (a ``fake`` process group of 256 ranks), and ``calibrate --oracle hlo``.
COST_CELLS = (("mixtral-8x7b", "decode_32k"), ("yi-9b", "train_4k"))
COST_MODEL = "mixtral-8x7b"
# Per-device flops of smoke steps on fake worlds, as the counter gives them on
# the CPU (tests/test_torch_dryrun.py holds this table to its own counts):
# (arch, step kind, ("data", "model") mesh) -> flops.  Phase cost counts them
# again with this machine's torch, on fake CUDA tensors; equal counts show
# that its DTensor hands the counter the same local ops.
COUNTER_SHAPES = {"train": ("mini_train", 32, 4, "train"),
                  "prefill": ("mini_prefill", 64, 4, "prefill"),
                  "decode": ("mini_dec", 64, 4, "decode")}
COUNTER_CELLS = {
    ("yi-9b", "train", (2, 4)): 11534336, ("yi-9b", "prefill", (2, 4)): 8945664,
    ("yi-9b", "decode", (2, 4)): 147456,
    ("mixtral-8x7b", "train", (2, 4)): 12910592,
    ("mixtral-8x7b", "prefill", (2, 4)): 12222464,
    ("mixtral-8x7b", "decode", (2, 4)): 284672,
    ("rwkv6-1.6b", "train", (2, 4)): 13565952,
    ("rwkv6-1.6b", "prefill", (2, 4)): 7503872,
    ("rwkv6-1.6b", "decode", (2, 4)): 149504,
    ("yi-9b", "train", (1, 4)): 23068672,
}


def counter_cells(device: str = "cuda") -> dict:
    """The counter's per-device flops of COUNTER_CELLS, each on a ``fake``
    world of its mesh, fake tensors on ``device``."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.lowering import build_step, lower_step
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for arch, kind, shape in COUNTER_CELLS:
        with fake_world(shape[0] * shape[1]):
            mesh = make_mesh(shape, ("data", "model"), device)
            bundle = build_step(get_config(arch, smoke=True), mesh,
                                ShapeConfig(*COUNTER_SHAPES[kind]))
            out[arch, kind, shape] = lower_step(bundle, mesh, device=device) \
                .compile().cost_analysis()["flops"]
    return out


def cost_counter() -> dict:
    """(e) COUNTER_CELLS counted in a subprocess (a process group of its
    own) and held exactly to the CPU's counts."""
    env = src_env()
    prog = ("import json, logging, chip_smoke; logging.getLogger("
            "'torch.distributed.tensor._redistribute').setLevel(logging.ERROR); "
            "print('COUNTS', json.dumps([[list(k), v] for k, v in "
            "chip_smoke.counter_cells().items()]))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, env=env, timeout=300,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("COUNTS ")]
    if proc.returncode != 0 or not lines:
        fail(f"cost: counter cells exited {proc.returncode}: {proc.stdout[-3000:]}")
        return {"rc": proc.returncode}
    got = {(a, k, tuple(m)): v for (a, k, m), v in json.loads(lines[-1][len("COUNTS "):])}
    cells = [{"arch": a, "kind": k, "mesh": list(m), "flops": got.get((a, k, m)),
              "cpu_flops": want} for (a, k, m), want in COUNTER_CELLS.items()]
    off = [c for c in cells if c["flops"] != c["cpu_flops"]]
    if off:
        fail(f"cost: the counter's flops differ from the CPU's on {off}")
    return {"cells": cells, "equal": not off, "process_wall_s": time.perf_counter() - t0}


def cost_oracle(rows: dict, device: str = "cuda") -> dict:
    """(a) ``HLOCostOracle(H100_SXM)`` at the shapes phase ``kernels`` timed
    today (PERF.md section 6, rows 1-3), beside their device ms."""
    import re
    orc = HLOCostOracle(H100_SXM, device=device)
    dec = re.search(r"B=(\d+) T=(\d+) H=(\d+) K=(\d+) hd=(\d+)",
                    rows["decode_attention"]["shape"])
    B, T, H, K, hd = (int(g) for g in dec.groups())
    sizes = dict(GROUPED_TIMED)["today"]
    t0 = time.perf_counter()
    price_s = {
        "flash_attention": orc.attention_prefill(
            [TODAY["flash_attention"]], [TODAY["flash_attention"]], 32, 8, 128),
        "decode_attention": orc.attention_decode([T] * B, H, K, hd),
        "grouped_gemm": orc.grouped_gemm(sizes, 4096, 14336),
    }
    wall = time.perf_counter() - t0
    out = {}
    for name, s in price_s.items():
        dev = rows[name]["device_ms"]
        if not (math.isfinite(s) and s > 0):
            fail(f"cost: the hlo oracle priced {name} at {s!r}")
        out[name] = {"shape": rows[name]["shape"], "hlo_price_ms": s * 1e3,
                     "device_ms": dev, "price_over_device": s * 1e3 / dev}
    return {"prices": out, "cache_keys": [list(k) for k in orc._cache],
            "oracle_dtype": "f32 (the reference's shapes)",
            "kernels_dtype": "bf16", "wall_s": wall}


def cost_train(full: dict, device: str = "cuda") -> dict:
    """(b) phase ``train``'s full-width step (TRAIN_RUN: yi-9b, 8 layers,
    2 x 4096 tokens, ``remat="full"``, f32) counted on fake CUDA tensors,
    beside ``model_flops`` and the step time phase ``train`` measured."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_RUN["layers"])
    ax = AxisRules(None)
    model = build_model(cfg, ax, remat=TRAIN_RUN["remat"])
    opt = AdamW(AdamWConfig(lr=TRAIN_RUN["lr"]), ax)
    step = make_train_step(model, opt)
    pds = model.pds()
    shape = ShapeConfig("chip_smoke_train", TRAIN_RUN["seq_len"],
                        TRAIN_RUN["global_batch"], "train")

    def train_step(params, opt_state, batch):
        model.load_params(params)
        model.requires_grad_(True)
        return step(params, opt_state, batch)
    args = (shape_tree(pds, torch.float32),
            shape_tree(opt.state_pds(pds), torch.float32), model.input_specs(shape))
    before = ops.launch_counts()
    t0 = time.perf_counter()
    mode = hlo_cost.fake_mode()
    with mode:
        fake = [hlo_cost.fake_args(a, mode, device) for a in args]
        with hlo_cost.Counter() as counter:
            train_step(*fake)
    wall = time.perf_counter() - t0
    costs = counter.totals()
    if ops.launch_counts() != before:
        fail("cost: counting the training step launched a kernel")
    if not costs["flops"] > 0:
        fail(f"cost: the training step counted {costs['flops']!r} flops")
    tokens = TRAIN_RUN["seq_len"] * TRAIN_RUN["global_batch"]
    formula = model_flops(cfg, tokens, TRAIN_RUN["seq_len"], TRAIN_RUN["global_batch"])
    step_s = full["step_ms"]["mean"] / 1e3
    arg_bytes = sum(math.prod(t.shape) * t.dtype.itemsize
                    for a in args for t in tree_leaves(a))
    return {"counted": costs, "model_flops": formula,
            "counted_over_model_flops": costs["flops"] / formula,
            "step_ms_measured": full["step_ms"]["mean"],
            "counted_tflop_s": costs["flops"] / step_s / 1e12,
            "model_tflop_s": formula / step_s / 1e12,
            "roofline_h100_sxm_preset": hlo_cost.roofline_terms(
                costs, n_chips=1, peak_flops=H100_SXM.peak_flops,
                hbm_bw=H100_SXM.hbm_bw, ici_bw=H100_SXM.intra_node_bw),
            "t_compute_f32_peak_s": costs["flops"] / PEAK_OPS[torch.float32],
            "counted_peak_gb": (arg_bytes + counter.peak_bytes) / 1e9,
            "measured_peak_gb": full["peak_mem_gb"], "wall_s": wall}


def cost_dryrun() -> list:
    """(c) ``python -m repro_torch.launch.dryrun`` of COST_CELLS on the pod
    mesh, each in a subprocess: a ``fake`` group of 256 ranks, fake CUDA
    tensors, full width."""
    import importlib.util
    if importlib.util.find_spec("torch.testing._internal.distributed.fake_pg") is None:
        fail("cost: this torch has no torch.testing._internal.distributed.fake_pg")
        return []
    out_dir = os.path.join(ROOT, "build", "dryrun_torch")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = src_env()
    out = []
    for arch, shape in COST_CELLS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", "pod", "--tag", "chip_smoke",
             "--out", out_dir], cwd=ROOT, env=env, timeout=600,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        wall = time.perf_counter() - t0
        path = os.path.join(out_dir, f"{arch}__{shape}__pod__chip_smoke.json")
        rec = {}
        if os.path.isfile(path):
            with open(path) as f:
                rec = json.load(f)
        if proc.returncode != 0 or rec.get("status") != "ok":
            fail(f"cost: dryrun {arch} x {shape} exited {proc.returncode}, "
                 f"status {rec.get('status')}: {proc.stdout[-3000:]}")
            out.append({"arch": arch, "shape": shape, "rc": proc.returncode,
                        "record": rec, "tail": proc.stdout[-3000:]})
            continue
        c, m = rec["hlo_corrected"], rec["memory_analysis"]
        if not all(math.isfinite(c[k]) and c[k] > 0
                   for k in ("flops", "bytes", "collective_bytes")):
            fail(f"cost: dryrun {arch} x {shape} counted {c}")
        out.append({"arch": arch, "shape": shape, "status": rec["status"],
                    "n_chips": rec["n_chips"], "step": rec["step"],
                    "lower_s": rec["lower_s"], "compile_s": rec["compile_s"],
                    "process_wall_s": wall, "flops": c["flops"],
                    "bytes": c["bytes"], "collective_bytes": c["collective_bytes"],
                    "collectives": {k: v for k, v in c.items() if k.startswith("coll_")},
                    "argument_gb": m["argument_bytes"] / 1e9,
                    "temp_gb": m["temp_bytes"] / 1e9,
                    "param_count": rec["meta"]["param_count"]})
    return out


def cost_calibrate(out_root: str, device: str = "cuda") -> dict:
    """(d) ``python -m repro_torch calibrate --oracle hlo`` of COST_MODEL on
    ``H100-SXM`` with phase ``calibrate``'s sample counts; no kernel runs."""
    entry_path = os.path.join(out_root, "entry.json")
    os.makedirs(out_root, exist_ok=True)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli.main(["calibrate", "--model", COST_MODEL, "--hardware", "H100-SXM",
                       "--oracle", "hlo", "--device", device,
                       "--no-fidelity", "-o", out_root,
                       "--train-samples", str(TRAIN_SAMPLES),
                       "--eval-samples", str(EVAL_SAMPLES),
                       "--label", "chip_smoke_hlo", "--entry-out", entry_path])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"cost: calibrate --oracle hlo exited with {rc}")
        return {"rc": rc, "wall_s": wall}
    if ops.launch_counts() != before:
        fail("cost: calibrate --oracle hlo launched a kernel")
    with open(entry_path) as f:
        fidelity = json.load(f)["operators"]
    return {"rc": rc, "wall_s": wall, "n_train": TRAIN_SAMPLES,
            "n_eval": EVAL_SAMPLES, "fidelity": fidelity}


def phase_cost(card: str, rows: dict, train_full: dict) -> None:
    t0 = time.perf_counter()
    for item, fn in (("counter", cost_counter),
                     ("oracle", lambda: cost_oracle(rows)),
                     ("train_step", lambda: cost_train(train_full)),
                     ("dryrun", lambda: {"cells": cost_dryrun()}),
                     ("calibrate", lambda: cost_calibrate(
                         os.path.join(ROOT, "build", "calib_hlo")))):
        t1 = time.perf_counter()
        res = fn()
        res["item_wall_s"] = time.perf_counter() - t1
        say("cost", item=item, card=card, **res)
        stop_if_failed("cost")
        gc.collect()
    say("cost", ok=not FAILURES, card=card, wall_s=time.perf_counter() - t0)
    stop_if_failed("cost")


# ---------------------------------------------------------------- examples --
# Phase ``examples``: the twins of examples/ in examples_torch/, held to what
# the reference prints on the CPU (examples_torch/expected/, written once from
# the reference; tests/test_torch_examples_*.py hold all three equal there).
EXAMPLES_DIR = os.path.join(ROOT, "examples_torch")
EXPECTED_DIR = os.path.join(EXAMPLES_DIR, "expected")
EXAMPLES_SIM = ("quickstart", "fault_tolerance_study", "fleet_capacity_study",
                "heterogeneous_cost_study", "heterogeneous_topology",
                "memory_pressure_study", "moe_af_simulation", "pareto_sweep",
                "pipelining_study", "trace_study")
EXAMPLE_SPECS = ("af_moe", "closed_loop", "fabric", "fleet", "memory",
                 "pipelining", "quickstart", "trace")   # calibration needs a fit
# The one wall-clock field the deterministic examples print (quickstart's
# "in 0.41s wall clock"); the expected files hold it masked.
WALL_CLOCK = re.compile(r"(?<= in )\d+\.\d+(?=s wall clock)")
TRAIN_EXAMPLE_STEPS = 200   # train_lm.py's default; resumed as 100 + 100
TRAIN_LM_STEPS = 20         # train_lm's step timed in-process, graphed and eager


def mask_wall_clock(text: str) -> str:
    return WALL_CLOCK.sub("X.XX", text)


def expected_text(name: str) -> str:
    with open(os.path.join(EXPECTED_DIR, f"{name}.txt")) as f:
        return f.read()


def first_difference(got: str, want: str) -> str:
    for i, (g, w) in enumerate(zip(got.splitlines(), want.splitlines())):
        if g != w:
            return f"line {i + 1}: {g!r} != {w!r}"
    return f"{len(got.splitlines())} lines != {len(want.splitlines())}"


def example_dir(name: str) -> str:
    """A fresh working directory for one twin, under build/examples/."""
    path = os.path.join(ROOT, "build", "examples", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def run_twin(name: str, argv: list, cwd: str) -> tuple:
    """``python examples_torch/<name>.py argv`` in a subprocess; returns its
    exit code, stdout and wall seconds (stderr to the log beside it)."""
    env = src_env()
    t0 = time.perf_counter()
    with open(os.path.join(ROOT, "build", "examples", f"{name}.stderr.log"), "a") as err:
        proc = subprocess.run(
            [sys.executable, os.path.join(EXAMPLES_DIR, f"{name}.py"), *argv],
            cwd=cwd, env=env, timeout=600, stdout=subprocess.PIPE,
            stderr=err, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def examples_sim() -> dict:
    """(a) Each simulation twin run as ``__main__`` (``runpy``, one interpreter
    for all ten: a process of its own each cost the phase about 2 s a twin),
    its stdout held to the reference's.  trace_study prints its artifacts'
    path relative to the working directory, so it runs from the repo root
    (its artifacts land in artifacts/, as the reference's do); the others
    each from a fresh directory.  A twin that raises, as one importing yaml
    does here, fails the phase with its traceback."""
    walls = {}
    here, argv = os.getcwd(), sys.argv
    for name in EXAMPLES_SIM:
        path = os.path.join(EXAMPLES_DIR, f"{name}.py")
        text = io.StringIO()
        t0 = time.perf_counter()
        try:
            os.chdir(ROOT if name == "trace_study" else example_dir(name))
            sys.argv = [path]
            with contextlib.redirect_stdout(text):
                runpy.run_path(path, run_name="__main__")
        except Exception:   # a failing twin is recorded; the next one runs
            fail(f"examples: {name} raised: {traceback.format_exc()[-2000:]}")
            continue
        finally:
            os.chdir(here)
            sys.argv = argv
            walls[name] = time.perf_counter() - t0
        got = mask_wall_clock(text.getvalue())
        if got != expected_text(name):
            fail(f"examples: {name} printed other than the reference: "
                 f"{first_difference(got, expected_text(name))}")
    return {"wall_s": walls}


def examples_specs() -> dict:
    """(b) ``python -m repro_torch run`` of each spec; the report's
    ``stable_view`` hashed and held to the reference's."""
    with open(os.path.join(EXPECTED_DIR, "specs.json")) as f:
        want = json.load(f)
    out_dir = example_dir("specs")
    walls = {}
    for name in EXAMPLE_SPECS:
        path = os.path.join(EXAMPLES_DIR, "specs", f"{name}.json")
        with open(path) as f:
            base = json.load(f)["name"]
        t0 = time.perf_counter()
        rc, rep = cli_report(["run", path, "-o", out_dir], out_dir, base)
        walls[name] = time.perf_counter() - t0
        digest = (hashlib.sha256(stable_view(rep).encode()).hexdigest()
                  if rep else None)
        if rc != 0 or digest != want[name]["stable_view_sha256"]:
            fail(f"examples: spec {name} exited with {rc}, stable_view "
                 f"sha256 {digest} != the reference's")
    return {"wall_s": walls}


def load_twin(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_calibration() -> dict:
    """(c) calibration_study: ``--smoke`` (kernelsim) held to the reference's
    stdout, then ``--oracle kernels`` at full width on the card through the
    twin's ``main`` into build/calib_examples/, its fit and runs kept as it
    makes them."""
    mod = load_twin("calibration_study")
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = mod.main(["--smoke", "--out", example_dir("calib_smoke")])
    smoke_s = time.perf_counter() - t0
    got = mask_wall_clock(text.getvalue())
    if rc != 0 or got != expected_text("calibration_study"):
        fail(f"examples: calibration_study --smoke exited with {rc} or printed "
             f"other than the reference: "
             f"{first_difference(got, expected_text('calibration_study'))}")

    made = {"fit": [], "runs": []}

    def keep(fn, into):
        def kept(*args, **kwargs):
            into.append(fn(*args, **kwargs))
            return into[-1]
        return kept
    mod.calibrate = keep(mod.calibrate, made["fit"])
    mod.run = keep(mod.run, made["runs"])
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out_root = os.path.join(ROOT, "build", "calib_examples")
    shutil.rmtree(out_root, ignore_errors=True)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = mod.main(["--oracle", "kernels", "--out", out_root])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before.get(k, 0) for k, v in ops.launch_counts().items()}
    if rc != 0 or len(made["fit"]) != 1 or len(made["runs"]) != 2:
        fail(f"examples: calibration_study --oracle kernels exited with {rc}")
        return {"smoke_s": smoke_s, "wall_s": wall, "launches": launches}
    for name in ("flash_attention", "decode_attention"):
        if launches.get(name, 0) <= 0:
            fail(f"examples: calibration_study never launched {name}")
    if launches.get("grouped_gemm", 0) != 0:
        fail("examples: calibration_study launched the grouped GEMM "
             "(qwen2-7b is dense)")
    mape = {f"{op}.{fam}": stats["mape"]
            for op, fams in made["fit"][0].fidelity.items()
            for fam, stats in fams.items() if "mape" in stats}
    keys = ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "throughput_tok_s")
    summary = {label: {k: rep.summary.get(k) for k in keys}
               for label, rep in zip(("analytical", "fitted"), made["runs"])}
    values = list(mape.values()) + [v for s in summary.values() for v in s.values()]
    if not mape or not all(isinstance(v, (int, float)) and math.isfinite(v)
                           for v in values):
        fail(f"examples: calibration_study gave non-finite MAPE or summary: "
             f"{mape} {summary}")
    return {"smoke_s": smoke_s, "wall_s": wall, "launches": launches,
            "mape": mape, "summary": summary,
            "table": text.getvalue().splitlines()}


def examples_serve() -> dict:
    """(d) serve_real_model on the card (its default device)."""
    card_name = torch.cuda.get_device_name(0)
    rc, out, wall = run_twin("serve_real_model", [], example_dir("serve_real_model"))
    tok_s = [float(x) for x in re.findall(r"throughput\s+(\S+) tok/s", out)]
    if (rc != 0 or len(tok_s) != 2
            or not all(math.isfinite(x) and x > 0 for x in tok_s)
            or card_name not in out):
        fail(f"examples: serve_real_model exited with {rc}, tok/s {tok_s}, "
             f"card named {card_name in out}: {out[-2000:]}")
    return {"wall_s": wall, "measured_tok_s": tok_s[:1],
            "predicted_tok_s": tok_s[1:], "stdout": out.splitlines()}


def examples_train() -> dict:
    """(e) train_lm (100m) on the card: 200 straight steps, and 100 + 100 by
    the same command resumed; the last losses read from the step-200
    checkpoints' manifests."""
    half = str(TRAIN_EXAMPLE_STEPS // 2)
    straight_dir, resume_dir = example_dir("train_straight"), example_dir("train_resume")
    runs = [run_twin("train_lm", ["--steps", str(TRAIN_EXAMPLE_STEPS),
                                  "--ckpt-dir", "ckpt"], straight_dir)]
    for _ in range(2):
        runs.append(run_twin("train_lm", ["--steps", half, "--ckpt-dir", "ckpt"],
                             resume_dir))
    if any(rc != 0 for rc, _, _ in runs):
        fail(f"examples: train_lm exited with {[rc for rc, _, _ in runs]}: "
             f"{[out[-1000:] for _, out, _ in runs]}")
        return {"wall_s": [w for _, _, w in runs]}
    if f"resumed from step {half}" not in runs[2][1]:
        fail(f"examples: the second train_lm run did not resume from step {half}")
    last = {}
    for label, cwd in (("straight", straight_dir), ("resumed", resume_dir)):
        with open(os.path.join(cwd, "ckpt", f"step_{TRAIN_EXAMPLE_STEPS:08d}",
                               "manifest.json")) as f:
            last[label] = json.load(f)["extra"]["loss"]
    logged = [float(x) for x in re.findall(r"^step\s+\d+ loss (\S+)", runs[0][1], re.M)]
    if not logged or not all(math.isfinite(x) for x in logged + list(last.values())):
        fail(f"examples: train_lm losses not finite: {logged} {last}")
    elif not last["straight"] < logged[0]:
        fail(f"examples: train_lm loss did not fall: {logged[0]} -> "
             f"{last['straight']}")
    diff = abs(last["resumed"] - last["straight"])
    if last["resumed"] != last["straight"]:       # graphed both: to the bit
        fail(f"examples: resumed loss {last['resumed']!r} != straight run's "
             f"{last['straight']!r}")
    return {"wall_s": [w for _, _, w in runs], "first_loss": logged[0],
            "last_loss": last, "diff": diff,
            "tok_s_line": [line for line in runs[0][1].splitlines()
                           if line.startswith("step")][-1],
            "step_ms": train_lm_steps()}


def train_lm_steps() -> dict:
    """train_lm's step (its arguments, TRAIN_LM_STEPS steps) in this process,
    graphed and eager: step ms, and the losses equal to the bit."""
    out = {}
    for mode in ("graphed", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        with contextlib.redirect_stdout(sys.stderr):
            res = train_launch.run("yi-9b", size="100m", steps=TRAIN_LM_STEPS,
                                   seq_len=256, global_batch=4, lr=3e-4,
                                   log_every=1000, device="cuda",
                                   eager=mode == "eager")
        out[mode] = {"step_ms": steady_ms(res["step_s"], eager=mode == "eager"),
                     "losses": res["losses"]}
    out["losses_equal"] = out["graphed"]["losses"] == out["eager"]["losses"]
    if not out["losses_equal"]:
        fail(f"examples: train_lm's graphed losses {out['graphed']['losses']} "
             f"differ from eager {out['eager']['losses']}")
    return out


def phase_examples(card: str) -> dict:
    """Phase ``examples``; returns the attention kernels' launches in (c)."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build", "examples"), exist_ok=True)
    launches = {}
    for item, fn in (("sim", examples_sim), ("specs", examples_specs),
                     ("calibration", examples_calibration),
                     ("serve", examples_serve),
                     ("train", examples_train)):
        t1 = time.perf_counter()
        res = fn()
        res["item_wall_s"] = time.perf_counter() - t1
        launches.update(res.get("launches", {}))
        say("examples", item=item, card=card, **res)
        stop_if_failed("examples")
        gc.collect()
    say("examples", ok=not FAILURES, card=card, wall_s=time.perf_counter() - t0)
    stop_if_failed("examples")
    return launches


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
    out_root, out2_root = (os.path.join(ROOT, "build", d) for d in ("calib", "calib2"))
    counts, oracle = phase_calibrate(out_root)
    phase_predict(out_root)
    af_fit1 = phase_simulate(out_root)
    phase_refit(oracle, out_root, out2_root, af_fit1)
    phase_table2([out_root, out2_root])
    counts["wkv_chunked"] = phase_serve()["wkv_chunked"]
    train_full = phase_train(card)
    counts["wkv_chunked"] += phase_shard(card)
    phase_cost(card, rows, train_full)
    for name, n in phase_examples(card).items():
        counts[name] = counts.get(name, 0) + n

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
