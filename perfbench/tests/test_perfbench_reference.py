"""The plain reference held to the port on the smoke geometries of both
configurations, float32 on the CPU: full-sequence logits (GQA, RoPE, the
sliding window, the MoE and the head), the MoE's capacity where it drops
tokens, and the served tokens of a run whose requests are admitted part-way
through a wave and decode through the slot cache."""
import time

import pytest
import torch

from conftest import SMOKE_SECONDS, smoke_cell, smoke_config
from perfbench import harness, traffic
from perfbench.reference import llama_style as ref
from perfbench.spec import model_shapes
from perfbench.weights import make_layer, make_tree

F32 = torch.float32


@pytest.mark.parametrize("port", ["mixtral-8x7b", "yi-9b"])
def test_logits_equal_the_ports_prefill(port):
    from repro_torch.models import build_model
    cfg, pc = smoke_config(port)
    m = model_shapes(cfg)
    seed = 2 ** 31 + 5
    model = build_model(pc)
    model.load_params(make_tree(m, seed, F32, "cpu"))
    T = 40                                 # longer than mixtral's smoke window (16)
    toks = torch.randint(0, m["V"], (1, T), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = model.prefill({"tokens": toks}, all_logits=True)
    got = ref.served_logits(m, seed, [{"tokens": toks[0], "prompt_len": 1, "bucket": T}],
                            dtype=F32, device="cpu")[0]
    assert got.shape == want[0].shape
    torch.testing.assert_close(got, want[0], atol=2e-5, rtol=1e-4)


def test_a_norm_scale_matters():
    """The norms' zero-centred scales are drawn non-zero, so a reference
    that left them out would not match."""
    cfg, _ = smoke_config("yi-9b")
    layer = make_layer(model_shapes(cfg), 3, 0, F32, "cpu")
    assert layer["ln1"].abs().max() > 0.05


def test_moe_capacity_drops_as_the_port_does():
    """Eight experts, a router that sends every token to experts 0 and 1:
    the prefill's capacity (half the bucket) drops the later half, in the
    port and in the reference alike; without the capacity they differ."""
    from repro_torch.models.common import NO_RULES
    from repro_torch.models.moe import moe_apply
    cfg, pc = smoke_config("mixtral-8x7b", moe={"num_experts": 8})
    m = model_shapes(cfg)
    layer = make_layer(m, 11, 0, F32, "cpu")
    g = torch.Generator().manual_seed(2)
    T, d = 64, m["d"]
    u = torch.randn(d, generator=g)
    u /= u.norm()
    h = torch.randn(1, T, d, generator=g) + 4.0 * u
    layer["moe"]["router"][:, 0] = 3.0 * u
    layer["moe"]["router"][:, 1] = 2.5 * u
    with torch.no_grad():
        want, aux = moe_apply(pc, layer["moe"], h, NO_RULES, train=False)
    assert float(aux["moe_drop_frac"]) > 0.2
    w = ref.layer_weights(layer, m, "f32")
    cap = ref.capacity(m, T)
    assert cap == 32
    got = ref.moe(m, w, h[0], T, cap, "f32")
    torch.testing.assert_close(got, want[0], atol=2e-5, rtol=1e-4)
    uncapped = ref.moe(m, w, h[0], T, 10 ** 9, "f32")
    assert (uncapped - want[0]).abs().max() > 1e-2


@pytest.mark.parametrize("port", ["mixtral-8x7b", "yi-9b"])
def test_served_tokens_are_the_references_best(port):
    """Four slots and a burst of about ten arrivals: the later requests wait
    for a slot and are admitted part-way, prefilled in their buckets and
    decoded through the slot cache beside the others; every served token of
    every request is the reference's best to rounding."""
    cell = smoke_cell(port, limit=1e-4, rate=200.0, check={"requests": 64})
    r = harness.run(cell, seed=2 ** 33 + 1, seconds=0.05, trace=False,
                    t0=time.perf_counter(), device="cpu")
    assert r["attempted"] == len(traffic.schedule(cell.traffic, 0.05)) > 4
    assert r["failed"] == 0
    assert r["checks"]["max_logit_gap"]["value"] <= 1e-4
    assert r["correct"]
