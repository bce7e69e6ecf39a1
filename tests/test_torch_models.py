"""The port's attention-family models against the reference's, with the same
weights (``test_torch_parity``): loss and metrics, prefill logits and
teacher-forced decode at 2e-5 in f32, the port's own prefill+decode against
its full prefill at 2e-3; and mixtral's MoE layer with its aux metrics."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import TOL, case_id, check_model_matches_reference, f32
from repro.configs import get_config as ref_get_config
from repro.models import AxisRules as RefAxisRules
from repro.models import init_tree as ref_init_tree
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy
from repro_torch.models import AxisRules
from repro_torch.models import moe

CASES = [
    ("yi-9b", None),                  # plain GQA global attention
    ("qwen3-8b", None),               # qk_norm
    ("gemma2-27b", None),             # local/global + softcaps + postnorm
    ("mixtral-8x7b", None),           # MoE + sliding window (ring cache)
    ("pixtral-12b", None),            # patch-embed frontend
    ("yi-9b", {"attn_impl": "blockwise", "attn_block": 8}),
]


@pytest.mark.parametrize("arch,options", CASES,
                         ids=[case_id(a, o) for a, o in CASES])
def test_model_matches_reference(arch, options):
    """The attention families; the recurrent ones and the encoder-decoder are
    in tests/test_torch_models_recurrent.py."""
    check_model_matches_reference(arch, options)


@pytest.mark.parametrize("train", [True, False])
@torch.no_grad()
def test_moe_layer_and_aux_metrics_match_reference(train):
    """mixtral's MoE layer alone: output, load-balance and z losses, drop
    fraction (train capacity drops assignments) and load CV."""
    cfg, rcfg = get_config("mixtral-8x7b", smoke=True), ref_get_config("mixtral-8x7b", smoke=True)
    rp = ref_init_tree(jax.random.PRNGKey(3), ref_moe.moe_pds(rcfg), jnp.float32)
    p = from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    # inputs leaning towards experts 0 and 1, so train capacity drops some
    router = np.asarray(rp["router"])
    x = (np.random.default_rng(3).normal(size=(3, 20, cfg.d_model))
         + 300 * (router[:, 0] + router[:, 1])).astype(np.float32)
    want_y, want_aux = jax.jit(functools.partial(
        ref_moe.moe_apply, rcfg, ax=RefAxisRules(None), train=train))(rp, jnp.asarray(x))
    got_y, got_aux = moe.moe_apply(cfg, p, torch.from_numpy(x), AxisRules(None),
                                   train=train)
    np.testing.assert_allclose(f32(got_y), f32(want_y), **TOL)
    assert set(got_aux) == set(want_aux)
    for name in want_aux:
        np.testing.assert_allclose(f32(got_aux[name]), f32(want_aux[name]), **TOL,
                                   err_msg=name)
    if train:
        assert float(got_aux["moe_drop_frac"]) > 0    # the capacity bites
