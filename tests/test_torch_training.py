"""The port's gradients against the JAX trainer's, in f32 at smoke size.

The same weights (``test_torch_parity.both``) and the same numpy batches go
through both packages: the gradients of ``loss`` equal
``jax.grad(rmodel.loss)`` leaf by leaf for every smoke config the model tests
cover; ``remat`` "none" / "full" / "dots" and blockwise attention give the
naive path's gradients, and remat really recomputes; the kernel wrappers'
plain versions differentiate on the CPU.  The AdamW steps, the data and the
moment descriptors are in ``tests/test_torch_training_steps.py``.

Tolerances: 2e-5 (``TOL``) on loss and metrics; a leaf's gradients within
2e-5 of that leaf's largest reference gradient, ``max|g|``.  rwkv6's WKV
gradient is ill-conditioned in f32 where a head's output has almost no
variance (the first tokens), and the reference's own scan and chunked paths
differ there by up to 3.5e-5 of ``max|g|``: a leaf of rwkv6 past 2e-5 passes
only within twice that spread of the reference at the same leaf, and is
named in a warning (``assert_grads_close``).
"""
import numpy as np
import pytest
import torch

from test_torch_parity import (
    TOL, as_port_tree, assert_grads_close, batch_for, both, case_id, f32,
    leaf_errors, port_grads, ref_grads)
from repro_torch.convert import from_numpy, lm_params_from_reference
from repro_torch.kernels import _build, ops
from repro_torch.kernels.wkv_chunk import wkv_sequential
from repro_torch.models import AxisRules, build_model
from repro_torch.models import transformer as tfm

S = 24   # past the smoke configs' 16-token windows; a multiple of rwkv_chunk

CASES = [
    ("yi-9b", None),                  # dense GQA
    ("qwen3-8b", None),               # qk_norm
    ("gemma2-27b", None),             # local/global window + softcaps + postnorm
    ("mixtral-8x7b", None),           # MoE, 4 experts at train capacity; window
    ("pixtral-12b", None),            # patch embeds
    ("rwkv6-1.6b", None),             # the recurrence by its plain loop
    ("rwkv6-1.6b", {"rwkv_impl": "chunked", "rwkv_chunk": 8}),  # plain on the CPU
    ("recurrentgemma-2b", None),      # RG-LRU + conv + local attention, tail
    ("seamless-m4t-large-v2", None),  # encoder-decoder with cross-attention
]


@pytest.mark.parametrize("arch,options", CASES,
                         ids=[case_id(a, o) for a, o in CASES])
def test_gradients_match_reference(arch, options):
    cfg, model, rmodel, rparams, _ = both(arch, options)
    batch = batch_for(cfg, np.random.default_rng(2), S)
    want_loss, want_m, want_g = ref_grads(rmodel, rparams, batch)
    got_loss, got_m, got_g = port_grads(model, from_numpy(batch, "cpu"))
    np.testing.assert_allclose(f32(got_loss.detach()), f32(want_loss), **TOL)
    for name in want_m:
        np.testing.assert_allclose(f32(got_m[name].detach()), f32(want_m[name]),
                                   **TOL, err_msg=name)
    want = as_port_tree(cfg, want_g)
    spread = None
    if arch.startswith("rwkv6"):     # the reference's other WKV path
        other = None if options else {"rwkv_impl": "chunked", "rwkv_chunk": 8}
        _, _, rmodel2, _, _ = both(arch, other)
        other_g = as_port_tree(cfg, ref_grads(rmodel2, rparams, batch)[2])
        spread = {k: e for k, (e, _) in leaf_errors(other_g, want).items()}
    assert_grads_close(got_g, want, spread)


REMAT_CASES = [("yi-9b", None), ("gemma2-27b", None),
               ("recurrentgemma-2b", None), ("seamless-m4t-large-v2", None)]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch,options", REMAT_CASES,
                         ids=[case_id(a, o) for a, o in REMAT_CASES])
def test_remat_keeps_gradients_and_recomputes(arch, options, remat, monkeypatch):
    cfg, model, _, _, tree = both(arch, options)
    batch = from_numpy(batch_for(cfg, np.random.default_rng(3), S), "cpu")
    calls = []
    block_train = tfm.block_train
    monkeypatch.setattr(tfm, "block_train",
                        lambda *a, **k: calls.append(1) or block_train(*a, **k))
    _, _, want = port_grads(model, batch)
    plain_calls = len(calls)
    calls.clear()
    rmodel = build_model(cfg, AxisRules(None), remat=remat,
                         params=lm_params_from_reference(cfg, tree, "cpu"))
    _, _, got = port_grads(rmodel, batch)
    assert_grads_close(got, want)
    # every whole period of the decoder runs again in backward
    period = len(cfg.block_pattern)
    assert len(calls) == plain_calls + (cfg.num_layers // period) * period


def test_blockwise_attention_gradients_equal_naive():
    cfg, model, _, _, tree = both("gemma2-27b")
    batch = from_numpy(batch_for(cfg, np.random.default_rng(4), S), "cpu")
    _, _, want = port_grads(model, batch)
    bmodel = build_model(cfg, AxisRules(None, {"attn_impl": "blockwise",
                                               "attn_block": 8}),
                         params=lm_params_from_reference(cfg, tree, "cpu"))
    _, _, got = port_grads(bmodel, batch)
    assert_grads_close(got, want)


def test_blockwise_attention_forward_is_unchanged_by_grad_mode():
    cfg, _, _, _, tree = both("yi-9b")
    model = build_model(cfg, AxisRules(None, {"attn_impl": "blockwise",
                                              "attn_block": 8}),
                        params=lm_params_from_reference(cfg, tree, "cpu"))
    batch = from_numpy(batch_for(cfg, np.random.default_rng(4), S), "cpu")
    with torch.no_grad():
        want, _ = model.loss(batch)
    model.requires_grad_(True)
    got, _ = model.loss(batch)
    assert torch.equal(got.detach(), want)


def test_plain_wkv_chunked_differentiates_on_the_cpu():
    """The kernel's wrapper on CPU tensors runs the plain version, which
    autograd differentiates: its gradients equal the sequential oracle's
    within 2e-5 of each input's largest gradient."""
    rng = np.random.default_rng(6)
    B, T, H, hs = 2, 16, 2, 8
    r, k, v = (torch.tensor(rng.normal(size=(B, T, H, hs)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    w = torch.tensor(rng.uniform(0.8, 0.99, (B, T, H, hs)), dtype=torch.float32,
                     requires_grad=True)
    u = torch.tensor(rng.normal(size=(H, hs)), dtype=torch.float32,
                     requires_grad=True)
    leaves = (r, k, v, w, u)
    ct = torch.tensor(rng.normal(size=(B, T, H, hs)), dtype=torch.float32)
    y = ops.wkv_chunked(r, k, v, w, u, chunk=8)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * ct).sum(), leaves)
    want = torch.autograd.grad((wkv_sequential(r, k, v, w, u) * ct).sum(), leaves)
    for name, g, w_ in zip("rkvwu", got, want):
        assert float((g - w_).abs().max()) <= TOL["atol"] * float(w_.abs().max()), name


def test_refuse_grad_names_the_kernel():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="grouped_gemm: the CUDA kernel has no backward"):
        _build.refuse_grad("grouped_gemm", x, None)
    with torch.no_grad():
        _build.refuse_grad("grouped_gemm", x, None)
    _build.refuse_grad("grouped_gemm", x.detach(), None)
