"""A prefill's attention projects q/k/v once and fills its cache from them.

``models.attention.attention_prefill`` runs a layer's prompt attention and
returns its decode cache entry.  On one device (no mesh here) the entry is
built from the k/v the core attended over, so ``transformer.block_prefill``
projects q/k/v once per self-attention layer.  Held here on the CPU, in f32
and bf16, for every layer of smoke qwen2-7b (global attention, the cache
padded past the prompt), smoke mixtral-8x7b (a sliding window of 16 under a
prompt of 40, so the ring cache's stored window is rotated) and smoke
seamless-m4t-large-v2 (cross-attention over an encoder memory): one call of
``_project_qkv`` a layer, and the block's output and every cache leaf equal
to the bit what the two-projection computation gives (the core's projection
for attention, a second one for the cache).  Tensor parallelism keeps the
second projection (``attention_prefill``): ``tests/test_torch_dryrun.py``
holds its flops on the (2, 4) mesh.

This file imports the port only, so it also runs where jax is not installed.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN_LOCAL
from repro_torch.models import attention as attn
from repro_torch.models import init_tree
from repro_torch.models import transformer as tfm
from repro_torch.models.common import AxisRules, shape_tree, tree_map

# (arch, prompt length, memory length): the prompt longer than mixtral's
# window of 16, and not a multiple of it, so the ring is rotated
CASES = [("qwen2-7b", 24, 0), ("mixtral-8x7b", 40, 0),
         ("seamless-m4t-large-v2", 24, 12)]
CACHE_SEQ = 64


def _two_projections(cfg, kind, p, x, ax, *, memory, cache_len):
    """``block_prefill``'s attention block with a second q/k/v projection
    for the cache, from the private helpers: k/v projected apart from the
    core's, the cross-attention's memory k/v likewise."""
    B, S, _ = x.shape
    window = cfg.sliding_window if kind == ATTN_LOCAL else 0
    h = tfm._norm(cfg, p, "ln1", x)
    pos = torch.arange(S, device=x.device).expand(B, S)
    _, k, v = attn._project_qkv(cfg, p["attn"], h, pos, ax)
    a = attn.attention_train(cfg, p["attn"], h, ax, window=window, causal=True)
    x = x + tfm._post(cfg, p, "ln1_post", a)
    cache = attn._kv_to_cache(k, v, cache_len, window, ax)
    if memory is not None:
        x = x + attn.attention_train(cfg, p["xattn"], tfm._norm(cfg, p, "ln_x", x),
                                     ax, memory=memory)
        cache["xk"] = attn._proj(memory, p["xattn"]["wk"])
        cache["xv"] = attn._proj(memory, p["xattn"]["wv"])
    f, _ = tfm._ffn_train(cfg, p, tfm._norm(cfg, p, "ln2", x), ax, train=False)
    return x + tfm._post(cfg, p, "ln2_post", f), cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch,S,Tm", CASES, ids=[c[0] for c in CASES])
@torch.no_grad()
def test_one_projection_a_layer_and_the_same_bits(monkeypatch, arch, S, Tm, dtype):
    cfg = get_config(arch, smoke=True)
    ax = AxisRules()
    kinds = cfg.block_pattern * (cfg.num_layers // len(cfg.block_pattern))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, S, cfg.d_model), generator=gen).to(dtype)
    memory = torch.randn((2, Tm, cfg.d_model), generator=gen).to(dtype) if Tm else None

    calls = []
    project = attn._project_qkv

    def counted(*args, **kwargs):
        calls.append(args[2].shape)
        return project(*args, **kwargs)

    for i, kind in enumerate(kinds):
        p = init_tree(gen, tfm.block_pds(cfg, kind), dtype, "cpu")
        cache_len = cfg.kv_cache_len(CACHE_SEQ, kind)
        want_x, want_cache = _two_projections(cfg, kind, p, x, ax, memory=memory,
                                              cache_len=cache_len)
        with monkeypatch.context() as m:
            m.setattr(attn, "_project_qkv", counted)
            got_x, got_cache = tfm.block_prefill(cfg, kind, p, x, ax, memory=memory,
                                                 cache_len=cache_len)
        assert len(calls) == i + 1 and calls[-1] == x.shape
        assert torch.equal(got_x, want_x)
        assert list(got_cache) == list(want_cache)
        for name in want_cache:
            assert got_cache[name].dtype == want_cache[name].dtype
            assert torch.equal(got_cache[name], want_cache[name]), name
        specs = shape_tree(tfm.block_cache_pds(cfg, kind, 2, CACHE_SEQ, Tm), dtype)
        assert tree_map(lambda t: tuple(t.shape), got_cache) == \
            tree_map(lambda s: tuple(s.shape), specs)
        x = got_x
    if kinds[0] == ATTN_LOCAL:      # the ring was rotated: S is past the window
        assert S > cfg.sliding_window and S % cfg.sliding_window
