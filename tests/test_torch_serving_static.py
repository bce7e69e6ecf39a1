"""The port's MiniEngine runs each step on fixed tensors (the slot cache, the
decode inputs, one token buffer per prefill bucket), which the card captures
in CUDA graphs and the CPU runs uncaptured.  Here, on the CPU: the engine
serves the reference engine's greedy tokens, request for request, for four
families (dense, MoE, RWKV6 through the chunked recurrence, RG-LRU), with
more requests than slots and prompts in two buckets; and every fixed tensor
keeps its storage from step to step, which a replay needs.  Tokens are
compared exactly: both engines take the argmax of f32 logits from the same
weights (carried across by ``convert``)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.common import tree_leaves
from test_torch_serving import _engines, _serve

# (arch, options): rwkv6 through the chunked kernel's path, chunks of 8
# dividing both buckets
CASES = [("qwen2-7b", None), ("mixtral-8x7b", None),
         ("rwkv6-1.6b", {"rwkv_impl": "chunked", "rwkv_chunk": 8}),
         ("recurrentgemma-2b", None)]
LENGTHS = (12, 20, 7, 16, 30)      # buckets of 16 and 32 tokens
SLOTS, N_NEW = 2, 6


def _prompts(arch, seed=4):
    rng = np.random.default_rng(seed)
    vocab = get_config(arch, smoke=True).vocab_size
    return [rng.integers(0, vocab, n) for n in LENGTHS]


@pytest.mark.parametrize("arch,options", CASES, ids=[c[0] for c in CASES])
def test_static_engine_tokens_match_reference_engine(arch, options):
    ref, port = _engines(arch, 0, SLOTS, options=options)
    assert not port.graphed          # the CPU runs the same steps uncaptured
    prompts = _prompts(arch)
    want, want_rep = _serve(ref, prompts, N_NEW)
    got, rep = _serve(port, prompts, N_NEW)
    assert got == want
    assert sorted(port._prefills) == [16, 32]
    for key in ("n_requests", "output_tokens", "decode_steps"):
        assert rep[key] == want_rep[key], key


def _storages(engine):
    tensors = [engine.tokens, engine.pos, *tree_leaves(engine.cache)]
    tensors += [buf for buf, _ in engine._prefills.values()]
    return [(t.untyped_storage().data_ptr(), t.data_ptr()) for t in tensors]


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-1.6b"])
def test_fixed_tensors_keep_their_storage(arch):
    """Every step reads and writes the same tensors: the decode inputs, the
    slot cache and the buckets' token buffers are never replaced."""
    _, port = _engines(arch, 0, SLOTS)
    prompts = _prompts(arch, seed=5)
    _serve(port, prompts[:2], 3)            # makes both buckets' buffers
    before = _storages(port)
    cache_ids = [id(t) for t in tree_leaves(port.cache)]
    with torch.no_grad():
        for _ in range(2):
            _serve(port, prompts, 4)
            assert _storages(port) == before
    assert [id(t) for t in tree_leaves(port.cache)] == cache_ids
