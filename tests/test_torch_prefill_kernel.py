"""Prefill attention through the flash attention kernel.

``models.attention.attention_train`` runs its self-attention core as
``kernels.ops.flash_attention`` where the call qualifies: a CUDA tensor that
autograd would not record, no mesh, no logit softcap, no cross-attention
memory, its own positions and ``attn_impl`` not "blockwise".  Every other
call keeps ``_sdpa`` (or the blockwise core) unchanged.

On the CPU: a prefill makes no kernel call and equals ``_sdpa`` called
directly bit for bit, and so does a dry run's fake CUDA tensor.  On the card
(``gpu``-marked, skipped elsewhere), in bf16 at head dim 128: the route
equals ``_sdpa`` within bf16 rounding for 8 and 4 query heads a KV head, a
sliding window and a ragged sequence inside a padded bucket, with one launch
a call, and the same core with a planted fault (heads on the wrong KV head,
each query seeing one key ahead, a window one key wider or narrower) lies
outside that tolerance; grad with parameters that require it, a softcap and cross-attention
launch nothing and give ``_sdpa``'s result; a graphed engine serves the eager
engine's tokens and every prefill entry counts one launch per attention
layer.

This file imports the port only, so it also runs where jax is not installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import hlo_cost
from repro_torch.models import attention as attn
from repro_torch.models import build_model, init_tree
from repro_torch.models.common import AxisRules
from repro_torch.serving.engine import MiniEngine

BF16 = dict(atol=2e-2, rtol=2e-2)     # the port's bf16 gate (test_torch_gpu_kernels)
# wq and wk scaled so the scores spread about 1.4: at fan-in scale they spread
# 0.09, attention is near uniform, and a mask one key off hides in rounding
SHARP = 4.0


def _layer(device, dtype, *, d_model=256, seed=0, cross=False, **geometry):
    """One attention layer's config and parameters (qwen2-7b's smoke config
    with ``geometry`` set on it), wq and wk scaled by ``SHARP``."""
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              d_model=d_model, **geometry)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = init_tree(gen, attn.attn_pds(cfg, cross=cross), dtype, device)
    with torch.no_grad():
        p["wq"].mul_(SHARP)
        p["wk"].mul_(SHARP)
    return cfg, p


def _x(cfg, device, dtype, S, *, B=1, seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((B, S, cfg.d_model), generator=gen, device=device).to(dtype)


def _naive(cfg, p, x, *, causal=True, window=0, memory=None, fault=""):
    """``attention_train``'s plain core called directly: the same
    projections, ``_sdpa`` over the bias of ``_valid``, the output
    projection.  ``fault`` plants one: "grouping" (head h reads KV head
    h % K, not h // G), "peek" (each query sees one key ahead), "wider" or
    "narrower" (the window one key off)."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pos = torch.arange(S, device=x.device).expand(B, S)
    if memory is None:
        q, k, v = attn._project_qkv(cfg, p, x, pos, AxisRules())
        k_pos = pos
    else:
        q = attn._proj(x, p["wq"])
        k, v = attn._proj(memory, p["wk"]), attn._proj(memory, p["wv"])
        k_pos = torch.arange(memory.shape[1], device=x.device).expand(B, -1)
        causal, window = False, 0
    q_pos = pos[0] + (fault == "peek")
    window += {"wider": 1, "narrower": -1}.get(fault, 0)
    bias = attn._bias(attn._valid(q_pos, k_pos[0], causal=causal, window=window))
    if fault == "grouping":
        q = q.reshape(B, S, H // K, K, hd).transpose(2, 3)
        out = attn._sdpa(cfg, q, k, v, bias).transpose(2, 3)
    else:
        out = attn._sdpa(cfg, q.reshape(B, S, K, H // K, hd), k, v, bias)
    return torch.einsum("bshk,hkd->bsd", out.reshape(B, S, H, hd), p["wo"])


@pytest.fixture
def no_kernel(monkeypatch):
    """Fail on any call of the kernel's wrapper from the models."""
    def refuse(*a, **k):
        raise AssertionError("the flash attention kernel was called")
    monkeypatch.setattr(attn.kernel_ops, "flash_attention", refuse)


# ------------------------------------------------------------------- CPU --
CPU_CASES = [
    ("causal-g2", dict(num_heads=4, num_kv_heads=2), 0, torch.float32),
    ("causal-g4-bf16", dict(num_heads=8, num_kv_heads=2), 0, torch.bfloat16),
    ("window", dict(num_heads=4, num_kv_heads=1), 8, torch.float32),
]


@pytest.mark.parametrize("geometry,window,dtype",
                         [c[1:] for c in CPU_CASES], ids=[c[0] for c in CPU_CASES])
@torch.no_grad()
def test_a_cpu_prefill_keeps_sdpa_to_the_bit(no_kernel, geometry, window, dtype):
    cfg, p = _layer("cpu", dtype, head_dim=16, **geometry)
    x = _x(cfg, "cpu", dtype, 24)
    n0 = flash_attention.launches
    got = attn.attention_train(cfg, p, x, AxisRules(), window=window)
    assert torch.equal(got, _naive(cfg, p, x, window=window))
    assert flash_attention.launches == n0


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b"])
@torch.no_grad()
def test_a_cpu_model_prefill_calls_no_kernel(no_kernel, arch):
    model = build_model(get_config(arch, smoke=True))
    gen = torch.Generator().manual_seed(0)
    model.load_params(init_tree(gen, model.pds(), torch.float32, "cpu"))
    n0 = flash_attention.launches
    logits, _ = model.prefill({"tokens": torch.arange(32)[None] % 97},
                              cache_len=64, all_logits=True)
    assert torch.isfinite(logits).all()
    assert flash_attention.launches == n0


@torch.no_grad()
def test_a_dry_runs_fake_cuda_tensors_keep_sdpa():
    """A dry run reaches the core on fake CUDA tensors, which have no storage
    to launch on: the plain core's ops are what it counts."""
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True), head_dim=128,
                              num_heads=4, num_kv_heads=2)
    with hlo_cost.fake_mode():
        q = torch.empty((1, 24, 4, 128), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((1, 24, 2, 128), dtype=torch.bfloat16, device="cuda")
        assert q.device.type == "cuda"
        assert not attn._flash_core(cfg, AxisRules(), q, k, k)


# ------------------------------------------------------------------ card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the flash attention kernel "
                    "has no interpret mode, and the engine's steps are graphed")
    return "cuda"


# (geometry, window, S, bucket): Yi's 8 and Mixtral's 4 query heads a KV head,
# a sliding window across the kernel's tiles, and 200 real rows padded to a
# bucket of 256 with one pad row repeated, as the engine pads with token 0
CARD = [("causal-g8", dict(num_heads=32, num_kv_heads=4), 0, 384, 384),
        ("causal-g4", dict(num_heads=32, num_kv_heads=8), 0, 384, 384),
        ("window", dict(num_heads=16, num_kv_heads=4), 100, 400, 400),
        ("ragged-in-bucket", dict(num_heads=32, num_kv_heads=4), 0, 200, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("geometry,window,S,bucket",
                         [c[1:] for c in CARD], ids=[c[0] for c in CARD])
@torch.no_grad()
def test_the_route_equals_sdpa_within_bf16(cuda, geometry, window, S, bucket):
    cfg, p = _layer(cuda, torch.bfloat16, head_dim=128, **geometry)
    x = _x(cfg, cuda, torch.bfloat16, bucket)
    x[:, S:] = x[:, S - 1:S]                   # the pad rows: one token repeated
    n0 = flash_attention.launches
    got = attn.attention_train(cfg, p, x, AxisRules(), window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    want = _naive(cfg, p, x, window=window)
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    # the tolerance separates: the core with a planted fault lies outside it
    for fault in ("grouping", "peek") + (("wider", "narrower") if window else ()):
        bad = _naive(cfg, p, x, window=window, fault=fault)
        assert not torch.allclose(bad.float(), want.float(), **BF16), fault
    if S < bucket:
        # causal: the real rows do not see the pad, so they equal the
        # unpadded call's
        alone = attn.attention_train(cfg, p, x[:, :S].contiguous(), AxisRules(),
                                     window=window)
        torch.testing.assert_close(got[:, :S].float(), alone.float(), **BF16)


@pytest.mark.gpu
def test_grad_with_trainable_parameters_keeps_sdpa(cuda):
    cfg, p = _layer(cuda, torch.bfloat16, head_dim=128, num_heads=8, num_kv_heads=2)
    for t in p.values():
        t.requires_grad_(True)
    x = _x(cfg, cuda, torch.bfloat16, 192)
    n0 = flash_attention.launches
    got = attn.attention_train(cfg, p, x, AxisRules())
    assert flash_attention.launches == n0
    with torch.no_grad():
        want = _naive(cfg, p, x)
    assert torch.equal(got, want)
    got.float().square().sum().backward()
    for name in ("wq", "wk", "wv", "wo"):
        assert p[name].grad is not None and p[name].grad.abs().max() > 0, name


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["softcap", "cross"])
@torch.no_grad()
def test_softcap_and_cross_attention_keep_sdpa(cuda, case):
    geometry = dict(head_dim=128, num_heads=8, num_kv_heads=2)
    if case == "softcap":
        geometry["attn_logit_softcap"] = 50.0
    cfg, p = _layer(cuda, torch.bfloat16, cross=case == "cross", **geometry)
    x = _x(cfg, cuda, torch.bfloat16, 160)
    memory = _x(cfg, cuda, torch.bfloat16, 96, seed=2) if case == "cross" else None
    n0 = flash_attention.launches
    got = attn.attention_train(cfg, p, x, AxisRules(), memory=memory)
    assert flash_attention.launches == n0
    assert torch.equal(got, _naive(cfg, p, x, memory=memory))


# (arch, the attention geometry set on its smoke config), as the decode
# kernel's card tests: head dim 128 with GQA, mixtral's sliding window, and
# recurrentgemma's local attention (10 query heads on one KV head, hd 256)
ENGINES = [("qwen2-7b", dict(head_dim=128)), ("mixtral-8x7b", dict(head_dim=128)),
           ("recurrentgemma-2b", dict(num_heads=10, num_kv_heads=1, head_dim=256))]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,geometry", ENGINES, ids=[e[0] for e in ENGINES])
def test_graphed_engine_counts_one_launch_a_layer_and_serves_the_eager_tokens(
        cuda, arch, geometry):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **geometry)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (12, 20, 7, 30)]
    out = {}
    for eager in (False, True):
        eng = MiniEngine(cfg, max_slots=2, max_seq=64, seed=0, device=cuda,
                         dtype=torch.bfloat16, eager=eager)
        n_attn = sum(k in ("global", "local") for k in eng.model.kinds)
        for _ in range(2):                       # the first pass captures
            reqs = eng.submit(prompts, 5)
            eng.run()
        out[eager] = [list(r.tokens) for r in reqs]
        prefills = [s for s in eng.step_log if s["kind"] == "prefill"]
        assert len(prefills) == 2 * len(prompts)
        assert [s["attn_kernel"] for s in prefills] == [n_attn] * len(prefills)
        assert n_attn > 0
    assert out[False] == out[True]
