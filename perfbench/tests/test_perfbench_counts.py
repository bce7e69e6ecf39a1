"""The counts behind ``decode_mfu``, ``prefill_mfu`` and ``decode_mbu``,
tied to sizes worked by hand, and the rule that padding and dead slots are
not counted.  ``fam`` is the ``llama_style`` family, whose counts
``counts.py`` hands on."""
import pytest

from perfbench import counts
from perfbench.harness import Served, Window
from perfbench.spec import load_arch, load_config, load_metric, model_shapes

fam = load_arch("llama_style")


def shapes(name):
    return model_shapes(load_config(name))


@pytest.mark.parametrize("name,gb,params_b,kv", [
    # mixtral stage: 2 x 32000 x 4096 + 4096 + 16 x (41,943,040 attention
    # + 8,192 norms + 32,768 router + 8 x 176,160,768 experts)
    ("mixtral-8x7b-pp2", 46.96, 23.48, 64 * 1024),
    # yi-9b: 2 x 64000 x 4096 + 4096 + 48 x (37,748,736 + 8,192 + 135,266,304)
    ("yi-9b", 17.66, 8.83, 96 * 1024),
])
def test_weights_and_cache_match_the_hand_worked_sizes(name, gb, params_b, kv):
    m = shapes(name)
    assert round(counts.weight_params(m) / 1e9, 2) == params_b
    assert round(fam.weight_bytes(m) / 1e9, 2) == gb
    assert counts.kv_bytes_per_position(m) == kv


def test_exact_counts_of_the_mixtral_stage():
    m = shapes("mixtral-8x7b-pp2")
    assert fam.attn_matmul_params(m) == 41_943_040
    assert fam.expert_params(m) == 176_160_768
    assert counts.weight_params(m) == 2 * 32000 * 4096 + 4096 + 16 * (
        41_943_040 + 8_192 + 32_768 + 8 * 176_160_768)
    # a token multiplies by attention, the router and two experts
    assert fam.token_matmul_params(m) == 41_943_040 + 32_768 + 2 * 176_160_768


def test_prefill_flops_by_hand():
    m = shapes("yi-9b")
    S = 3
    per_token = 2 * 48 * (37_748_736 + 135_266_304)
    keys = 1 + 2 + 3                      # causal: query i attends i + 1 keys
    attn = 48 * 4 * 32 * 128 * keys
    head = 2 * 4096 * 64000               # the last position only
    assert counts.prefill_flops(m, S) == per_token * S + attn + head


def test_window_bounds_the_keys():
    m = dict(shapes("mixtral-8x7b-pp2"), window=4)
    assert [fam.attended(m, p) for p in range(7)] == [1, 2, 3, 4, 4, 4, 4]


def test_experts_hit():
    m = shapes("mixtral-8x7b-pp2")
    assert fam.experts_hit(m, 1) == pytest.approx(2.0)
    assert fam.experts_hit(m, 32) == pytest.approx(8.0, rel=1e-3)
    assert fam.experts_hit(shapes("yi-9b"), 5) == 1.0


def _window(name, steps, requests, max_slots=8):
    return Window(seconds=1.0, busy_s=1.0, close=1.0, steps=steps, requests=requests,
                  max_slots=max_slots,
                  shapes=shapes(name), device_name="NVIDIA H100 80GB HBM3")


def _req(S, n):
    import numpy as np
    return Served(prompt=np.zeros(S, np.int32), max_new_tokens=n, submitted=0.0,
                  tokens=[0] * n, stamps=[0.0] * n)


def test_prefill_padding_is_not_counted():
    """A prompt of 300 tokens ran in a bucket of 512: only the 300 count."""
    m = shapes("yi-9b")
    w = _window("yi-9b", [{"kind": "prefill", "tokens": 300, "dur": 0.1}], [])
    got = load_metric("prefill_mfu").read(w)
    assert got == pytest.approx(100 * counts.prefill_flops(m, 300) / (0.1 * 989e12))
    assert counts.prefill_flops(m, 300) < counts.prefill_flops(m, 512)


def test_dead_slots_are_not_counted():
    """Two live requests on eight slots: the flops are the live tokens',
    and the bytes the weights a step of two tokens reads."""
    m = shapes("mixtral-8x7b-pp2")
    reqs = [_req(10, 3), _req(20, 3)]          # two decode steps each
    steps = [{"kind": "decode", "batch": 2, "dur": 0.01}] * 2
    w = _window("mixtral-8x7b-pp2", steps, reqs)
    flops = sum(counts.decode_token_flops(m, p) for p in (10, 11, 20, 21))
    assert load_metric("decode_mfu").read(w) == pytest.approx(
        100 * flops / (0.02 * 989e12))
    kv = sum(fam.attended(m, p) for p in (10, 11, 20, 21)) * 64 * 1024
    wb = 2 * counts.decode_step_weight_bytes(m, 2)
    assert load_metric("decode_mbu").read(w) == pytest.approx(
        100 * (wb + kv) / (0.02 * 3.35e12))
    # two tokens hit at most four experts: less than all eight
    assert counts.decode_step_weight_bytes(m, 2) < counts.decode_step_weight_bytes(m, 8)
    assert load_metric("decode_occupancy").read(w) == pytest.approx(25.0)


def test_an_unknown_card_reads_nothing():
    w = _window("yi-9b", [{"kind": "decode", "batch": 2, "dur": 0.01}], [_req(4, 2)])
    w.device_name = "cpu"
    for name in ("decode_mfu", "prefill_mfu", "decode_mbu"):
        assert load_metric(name).read(w) is None


def test_the_decode_weights_of_a_full_step_are_the_whole_model_less_the_embedding():
    m = shapes("yi-9b")
    b = 16
    full = counts.decode_step_weight_bytes(m, b)
    assert full == 2 * (counts.weight_params(m) - 64000 * 4096 + b * 4096)
