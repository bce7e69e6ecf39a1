"""The ``llama_style`` family reads exactly what the harness read before the
architecture became a family: for ``mixtral-8x7b`` and ``yi-9b`` at the
smoke geometry, each leaf ``make_tree`` draws (its sum and sum of squares,
in float64), the reference's logits on three fixed sequences in each
precision (sums, sums of squares and argmaxes), every count on fixed inputs
at the smoke geometries and the two configuration files, and the shapes.

``pinned_llama_style.json`` holds the values the harness gave before
(``weights.layer_leaves``, ``reference/model.py``, the counts in
``counts.py``), computed by the functions below on one CPU thread (torch
2.13.0+cpu, x86-64; the logits' last bits depend on the torch build and
the CPU).  Each is compared equal, not close.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import smoke_config
from perfbench import counts
from perfbench.spec import family, load_config, model_shapes
from perfbench.weights import make_tree

PINNED = json.loads((Path(__file__).with_name("pinned_llama_style.json")).read_text())
SEED = PINNED["seed"]
PORTS = ["mixtral-8x7b", "yi-9b"]
CONFIGS = {"smoke:mixtral-8x7b": lambda: smoke_config("mixtral-8x7b")[0],
           "smoke:yi-9b": lambda: smoke_config("yi-9b")[0],
           "mixtral-8x7b-pp2": lambda: load_config("mixtral-8x7b-pp2"),
           "yi-9b": lambda: load_config("yi-9b")}
S_IN, POS_IN, B_IN = [1, 3, 17, 300, 4000], [0, 5, 63, 4095, 5000], [1, 2, 7, 32]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, pre=""):
    if isinstance(tree, torch.Tensor):
        yield pre, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}.{k}" if pre else k)
    else:
        for i, v in enumerate(tree):
            yield from _flat(v, f"{pre}.{i}")


def _moments(t):
    a = t.detach().double().numpy()
    return [float(a.sum()), float((a * a).sum())]


def _seqs(V):
    g = torch.Generator().manual_seed(7)
    return [{"tokens": torch.randint(0, V, (T,), generator=g), "prompt_len": pl, "bucket": b}
            for T, pl, b in ((40, 30, 32), (12, 5, 8), (63, 60, 64))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shapes_are_as_before_with_the_family_named(name):
    m = model_shapes(CONFIGS[name]())
    assert m == dict(PINNED["shapes"][name], arch="llama_style")


@pytest.mark.parametrize("port", PORTS)
def test_every_leaf_is_drawn_as_before(port, one_thread):
    m = model_shapes(smoke_config(port)[0])
    got = {n: _moments(t) for n, t in _flat(make_tree(m, SEED, torch.float32, "cpu"))}
    want = PINNED["smoke"][port]["leaves"]
    assert list(got) == list(want)          # names, in order
    assert got == want


@pytest.mark.parametrize("precision", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("port", PORTS)
def test_the_reference_gives_the_logits_it_gave(port, precision, one_thread):
    m = model_shapes(smoke_config(port)[0])
    logits = family(m).served_logits(m, SEED, _seqs(m["V"]), dtype=torch.float32,
                                     device="cpu", precision=precision)
    got = [_moments(lg) + [lg.argmax(-1).tolist()] for lg in logits]
    assert got == PINNED["smoke"][port]["logits"][precision]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_count_is_as_before(name):
    m = model_shapes(CONFIGS[name]())
    got = {
        "weight_params": counts.weight_params(m),
        "kv_bytes_per_position": counts.kv_bytes_per_position(m),
        "prefill_flops": [counts.prefill_flops(m, s) for s in S_IN],
        "decode_token_flops": [counts.decode_token_flops(m, p) for p in POS_IN],
        "decode_kv_bytes": [counts.decode_kv_bytes(m, p) for p in POS_IN],
        "decode_step_weight_bytes": [counts.decode_step_weight_bytes(m, b) for b in B_IN],
        "decode_positions": [list(counts.decode_positions(s, n))
                             for s, n in ((5, 1), (5, 4), (100, 3))],
    }
    assert got == PINNED["counts"][name]
    assert all(isinstance(v, int) for v in got["prefill_flops"] + got["decode_token_flops"])


def test_the_pinned_sums_are_not_trivial():
    """The moments would tell two draws apart: a leaf's sum of squares is
    its size times its variance, to a few percent."""
    m = model_shapes(smoke_config("yi-9b")[0])
    leaves = dict((n, (shape, std)) for n, shape, std in family(m).layer_leaves(m, 0))
    shape, std = leaves["attn.wq"]
    _, sq = PINNED["smoke"]["yi-9b"]["leaves"]["layers.0.attn.wq"]
    assert sq == pytest.approx(np.prod(shape) * std ** 2, rel=0.05)
