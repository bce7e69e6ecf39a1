"""Decode over a donated cache: ``model.decode(..., donate=True)`` writes each
row's new K/V entry into the cache it was handed and attends over each row's
live prefix with ``kernels.decode_attention`` (its plain version on the CPU);
without ``donate``, or where the kernel's path does not apply, the functional
path returns a new cache and leaves its input as it was.

On the CPU, in float32: for a dense model and a sliding-window MoE model whose
ring (16 slots) wraps, several steps with ragged per-row positions (a free
slot whose stale position never moves, rows past the window) give the
functional path's logits and cache contents, and return the input's own
tensors; gemma2's logit softcap and a scalar position take the functional
path.  The served engine hands its slot cache over and copies back only the
leaves returned as new tensors.  On the card (``gpu``-marked, skipped
elsewhere): the graphed bf16 engine launches the kernel once per attention
layer per replay and matches the functional decode's logits, at head dims
128 and 256 (recurrentgemma's 10 query heads a KV head) and at the smoke
head dim of 16, zero-padded.

This file imports the port only, so it also runs where jax is not installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import build_model, init_tree
from repro_torch.models.common import shape_tree, tree_leaves, tree_map
from repro_torch.serving.engine import MiniEngine

MAX_SEQ = 40
# one row per case: short, past the window (16) in two places, and a free
# slot whose stale position is never advanced
POS0 = (3, 17, 25, 9)
FREE = 3
STEPS = 6


def _model(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    model.load_params(init_tree(gen, model.pds(), torch.float32, "cpu"))
    return cfg, model


def _cache(model, batch):
    """A cache of random contents, as prefills would have left it."""
    gen = torch.Generator().manual_seed(1)
    return tree_map(lambda s: torch.randn(s.shape, generator=gen),
                    shape_tree(model.cache_pds(batch, MAX_SEQ), torch.float32))


def _positions(step):
    return torch.tensor([p if i == FREE else p + step
                         for i, p in enumerate(POS0)], dtype=torch.int64)


def _tokens(cfg, step):
    rng = np.random.default_rng(step)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (len(POS0), 1)))


def _kv(cache):
    return [t for c in cache["layers"] for name, t in sorted(c.items())
            if name in ("k", "v")]


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b"])
@torch.no_grad()
def test_donated_steps_equal_the_functional_path(arch):
    cfg, model = _model(arch)
    if arch == "mixtral-8x7b":
        assert cfg.sliding_window == 16 < MAX_SEQ       # the ring wraps
    functional = _cache(model, len(POS0))
    donated = tree_map(torch.clone, functional)
    for step in range(STEPS):
        toks, pos = _tokens(cfg, step), _positions(step)
        want, functional = model.decode(functional, toks, pos)
        inputs = _kv(donated)
        got, out = model.decode(donated, toks, pos, donate=True)
        assert all(a is b for a, b in zip(_kv(out), inputs)), step
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        # a later layer's entry follows from the earlier layers' outputs,
        # and the kernel's wrapper zero-pads the smoke head dim of 16: equal
        # to rounding, not to the bit
        for a, b in zip(tree_leaves(out), tree_leaves(functional)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        donated = out


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x7b"])
@torch.no_grad()
def test_a_call_that_does_not_donate_leaves_its_cache_untouched(arch):
    cfg, model = _model(arch)
    cache = _cache(model, len(POS0))
    before = tree_map(torch.clone, cache)
    _, out = model.decode(cache, _tokens(cfg, 0), _positions(0))
    for a, b in zip(tree_leaves(cache), tree_leaves(before)):
        assert torch.equal(a, b)
    assert not any(a is b for a, b in zip(_kv(out), _kv(cache)))


@pytest.mark.parametrize("arch,pos", [
    ("gemma2-27b", _positions(0)),       # attention logit softcap
    ("qwen2-7b", 17),                    # one position for the whole batch
], ids=["softcap", "scalar-pos"])
@torch.no_grad()
def test_donation_falls_back_where_the_kernel_path_does_not_apply(arch, pos):
    cfg, model = _model(arch)
    cache = _cache(model, len(POS0))
    before = tree_map(torch.clone, cache)
    want, _ = model.decode(tree_map(torch.clone, cache), _tokens(cfg, 0), pos)
    got, out = model.decode(cache, _tokens(cfg, 0), pos, donate=True)
    assert not any(a is b for a, b in zip(_kv(out), _kv(cache)))
    for a, b in zip(tree_leaves(cache), tree_leaves(before)):
        assert torch.equal(a, b)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-2b"])
def test_the_engine_hands_its_slot_cache_over(arch):
    """Every attention leaf the model returns is the slot cache's own tensor
    (written in place, not copied back); recurrent leaves come back new and
    are copied in."""
    cfg = get_config(arch, smoke=True)
    eng = MiniEngine(cfg, max_slots=2, max_seq=64, seed=0, device="cpu")
    decode, returned = eng.model.decode, []

    def record(cache, tokens, pos, donate=False):
        assert donate
        logits, out = decode(cache, tokens, pos, donate=donate)
        returned.append(out)
        return logits, out
    eng.model.decode = record
    rng = np.random.default_rng(0)
    reqs = eng.submit([rng.integers(0, cfg.vocab_size, n) for n in (12, 20, 7)], 4)
    eng.run()
    assert all(len(r.tokens) == 4 for r in reqs) and returned
    for out in returned:
        for c_all, c_new in zip(eng.cache["layers"], out["layers"]):
            for name, t in c_all.items():
                assert (c_new[name] is t) == (name in ("k", "v")), name
    for c_all, c_new in zip(eng.cache["layers"], returned[-1]["layers"]):
        for name, t in c_all.items():            # the last step's, copied in
            assert torch.equal(c_new[name], t), name


# ------------------------------------------------------------------ card --
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the decode attention kernel "
                    "has no interpret mode, and the engine's steps are graphed")
    return "cuda"


# (arch, the attention geometry set on its smoke config): head dim 128 with
# GQA, a wrapping ring (mixtral), recurrentgemma's own local attention (10
# query heads on one KV head at head dim 256), and the smoke head dim of 16,
# which the wrapper zero-pads to 128
CARD = [("qwen2-7b", dict(head_dim=128)), ("mixtral-8x7b", dict(head_dim=128)),
        ("recurrentgemma-2b", dict(num_heads=10, num_kv_heads=1, head_dim=256)),
        ("qwen2-7b", {})]
CARD_IDS = ["qwen2-7b-hd128", "mixtral-8x7b-hd128", "recurrentgemma-2b-hd256-g10",
            "qwen2-7b-hd16-padded"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,geometry", CARD, ids=CARD_IDS)
def test_graphed_engine_runs_the_kernel_and_matches_the_functional_decode(
        cuda, arch, geometry):
    """The graphed bf16 engine runs ``decode_attention`` once per attention
    layer per replay, and each decode step's logits lie within bf16
    rounding of the same step run through the functional path on a copy of
    the slot cache."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **geometry)
    eng = MiniEngine(cfg, max_slots=3, max_seq=64, seed=0, device=cuda,
                     dtype=torch.bfloat16)
    n_attn = sum(k in ("global", "local") for k in eng.model.kinds)
    step, gaps, launched = eng._decode, [], []

    def checked():
        before = tree_map(torch.clone, eng.cache)
        tokens, pos = eng.tokens.clone(), eng.pos.clone()
        n0 = decode_attention.launches
        out = step()
        launched.append(decode_attention.launches - n0)
        want, _ = eng.model.decode(before, tokens, pos)
        gaps.append(float((out.float() - want.float()).abs().max()
                          / want.float().abs().max()))
        return out
    eng._decode = checked
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for _ in range(2):                       # the first pass captures
            reqs = eng.submit([rng.integers(0, cfg.vocab_size, n)
                               for n in (12, 20, 7, 30)], 6)
            eng.run()
    assert eng._decode is checked and step.captured
    assert all(len(r.tokens) == 6 for r in reqs)
    decodes = [s for s in eng.step_log if s["kind"] == "decode"]
    assert len(decodes) == len(launched) >= 10
    assert launched == [n_attn] * len(launched)
    assert [s["attn_kernel"] for s in decodes] == launched
    assert max(gaps) < 5e-2, gaps            # a length off by one: 0.19-0.87
