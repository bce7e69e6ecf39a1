"""The weights carried across: the converter between the reference's stacked
parameter layout and the port's per-layer one, and the port's own
``init_tree``/``stack_pds``/``shape_tree`` against the reference's
descriptors and distributions."""
import jax
import numpy as np
import pytest
import torch

from test_torch_parity import both, ref_params
from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_transformer
from repro.models.common import stack_pds as ref_stack_pds
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.models import build_model, init_tree, shape_tree
from repro_torch.models.common import PD, stack_pds, tree_map


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2", "mixtral-8x7b",
                                  "pixtral-12b"])
def test_weights_round_trip(arch):
    """Reference layout -> per-layer tree -> reference layout is the identity,
    and a tree that does not fit the config is refused."""
    cfg, _, _, _, tree = both(arch)
    back = lm_params_to_reference(cfg, lm_params_from_reference(cfg, tree, "cpu"))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)
    with pytest.raises(ValueError, match="keys"):     # qwen3 has qk norms
        lm_params_from_reference(get_config("yi-9b", smoke=True),
                                 jax.tree_util.tree_map(np.asarray,
                                                        ref_params("qwen3-8b")), "cpu")


def test_init_tree_draws_the_reference_distributions():
    """Shapes, dtypes, exact zeros/ones, and each fan-in or fixed std, from an
    explicit generator on an explicit device."""
    cfg = get_config("rwkv6-1.6b", smoke=True)
    pds = build_model(cfg).pds()
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = init_tree(gen, pds, torch.float32, "cpu")
    seen = []

    def check(pd, t):
        assert tuple(t.shape) == pd.shape and t.dtype == torch.float32
        if pd.init in ("zeros", "ones"):
            assert bool((t == (pd.init == "ones")).all())
        elif t.numel() >= 1000:
            std = (float(np.prod(pd.shape[:-1])) ** -0.5 if pd.init == "fan_in"
                   else float(pd.init))
            assert abs(float(t.std()) / std - 1) < 0.1, (pd, float(t.std()))
        seen.append(pd)

    def walk(pd, t):
        if isinstance(pd, PD):
            return check(pd, t)
        for key in (pd if isinstance(pd, dict) else range(len(pd))):
            walk(pd[key], t[key])
    walk(pds, params)
    assert len(seen) == len(jax.tree_util.tree_leaves(
        tree_map(lambda _: 0, pds)))
    again = init_tree(torch.Generator(device="cpu").manual_seed(0), pds,
                      torch.float32, "cpu")
    assert torch.equal(params["embed"], again["embed"])


def test_stack_pds_and_shape_tree_match_reference():
    """Stacked descriptors equal the reference's, and a stacked matrix draws
    with the fan-in of one layer (the "layers" axis is left out)."""
    cfg = get_config("yi-9b", smoke=True)
    layer = build_model(cfg).pds()["layers"][0]
    stacked = stack_pds(layer, 3)
    want = ref_stack_pds(ref_transformer.block_pds(
        ref_get_config("yi-9b", smoke=True), cfg.pattern[0]), 3)
    def described(tree):     # jax flattens both dicts in sorted key order
        return [(p.shape, p.axes, p.init) for p in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: hasattr(x, "axes"))]
    assert described(stacked) == described(want)
    specs = shape_tree(stacked, torch.float32)
    assert specs["attn"]["wq"].shape == (3,) + layer["attn"]["wq"].shape
    w = init_tree(torch.Generator().manual_seed(0),
                  PD((8, 256, 256), ("layers", "embed", "mlp")), torch.float32,
                  "cpu")
    assert abs(float(w.std()) * 256 ** 0.5 - 1) < 0.02
