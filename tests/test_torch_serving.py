"""The port's MiniEngine on the CPU against the reference's, with the same
weights (the reference's ``init_tree`` output carried across by ``convert``):
the same greedy tokens, request for request.  The rwkv6 prompt lengths are
chosen around the 16-token bucket: at 16 no pad token enters the recurrent
state, at 12 and 20 some do, and both engines let them (the bucket padding is
the reference's and is kept)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import NO_RULES as REF_NO_RULES
from repro.models import build_model as ref_build_model
from repro.models import init_tree as ref_init_tree
from repro.serving.engine import MiniEngine as RefMiniEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.serving.engine import MiniEngine

MAX_SEQ, N_NEW = 64, 8


def _engines(arch, seed, max_slots, options=None):
    """The reference engine and the port's, on the reference's weights."""
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    rparams = ref_init_tree(jax.random.PRNGKey(seed),
                            ref_build_model(rcfg, REF_NO_RULES).pds(), jnp.float32)
    ref = RefMiniEngine(rcfg, max_slots=max_slots, max_seq=MAX_SEQ,
                        params=rparams)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    port = MiniEngine(cfg, max_slots=max_slots, max_seq=MAX_SEQ, device="cpu",
                      params=lm_params_from_reference(cfg, tree, "cpu"),
                      options=options)
    return ref, port


def _serve(engine, prompts, n_new=N_NEW):
    reqs = engine.submit(prompts, n_new)
    report = engine.run()
    return [r.tokens for r in reqs], report


@torch.no_grad()
def _greedy(engine, prompt, n_new=N_NEW):
    """A plain greedy loop over the port's own prefill and decode, with the
    prompt unpadded."""
    model = engine.model
    toks = torch.from_numpy(np.asarray(prompt, np.int64))[None]
    logits, cache = model.prefill({"tokens": toks}, cache_len=engine.max_seq,
                                  all_logits=True)
    out = [int(torch.argmax(logits[0, len(prompt) - 1]))]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, cache = model.decode(cache, torch.tensor([[out[-1]]]), pos)
        out.append(int(torch.argmax(logits[0, 0])))
    return out


@pytest.mark.parametrize("arch,lengths,slots", [
    ("rwkv6-1.6b", (12, 16, 20), 3),
    ("qwen2-7b", (12, 20, 7), 3),
])
def test_engine_tokens_match_reference_engine(arch, lengths, slots):
    rng = np.random.default_rng(0)
    cfg = get_config(arch, smoke=True)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    ref, port = _engines(arch, 0, slots)
    want, want_rep = _serve(ref, prompts)
    got, rep = _serve(port, prompts)
    assert got == want
    for key in ("n_requests", "output_tokens", "decode_steps"):
        assert rep[key] == want_rep[key], key


def test_engine_chunked_rwkv_matches_reference_engine():
    """The chunked recurrence (the kernel's path) serves the same tokens as
    the reference engine's plain scan: buckets of 16 and 32 tokens split
    into whole chunks of 8."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n) for n in (16, 20)]
    ref, port = _engines("rwkv6-1.6b", 0, 2,
                         options={"rwkv_impl": "chunked", "rwkv_chunk": 8})
    assert _serve(port, prompts)[0] == _serve(ref, prompts)[0]


def test_engine_more_requests_than_slots():
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, 8) for _ in range(5)]
    ref, port = _engines("qwen2-7b", 1, 2)
    got, rep = _serve(port, prompts, 6)
    assert rep["n_requests"] == 5
    assert all(len(t) == 6 for t in got)
    assert got == _serve(ref, prompts, 6)[0]


@pytest.mark.parametrize("options", [None, {"rwkv_impl": "chunked"}])
def test_engine_at_a_bucket_length_is_true_greedy(options):
    """At 16 tokens the bucket adds no pad, so the engine's tokens are those
    of a greedy loop over the model."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, 16) for _ in range(2)]
    _, port = _engines("rwkv6-1.6b", 0, 2, options=options)
    got, _ = _serve(port, prompts)
    assert got == [_greedy(port, p) for p in prompts]


def test_engine_defaults_to_the_card(monkeypatch):
    """Without a device argument the engine runs on CUDA or raises: it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MiniEngine(get_config("rwkv6-1.6b", smoke=True))
