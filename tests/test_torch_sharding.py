"""The port's sharding rules against the reference's, on the host alone.

``AxisRules.resolve``/``spec_tree`` must give the reference's
``PartitionSpec`` (as a plain tuple) for every descriptor of every smoke
config on four meshes: the parameters, AdamW's moments under ZeRO-1 and the
decode cache.  Neither side needs devices or a process group here: the
reference's ``AxisRules`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, the port's only ``mesh.mesh_dim_names`` and
``mesh.shape``, so each gets a stand-in with those fields.  The reference
stacks each block-pattern position's layers under ``groups`` (its leading
``layers`` axis is never sharded) and the port holds one tree per layer, so
the reference's specs are compared with their first entry dropped.
"""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models.common import AxisRules as RefAxisRules
from repro.models.model import build_model as ref_build_model
from repro.training.optimizer import AdamW as RefAdamW
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch.configs import get_config
from repro_torch.models import AxisRules, build_model
from repro_torch.training.optimizer import AdamW, AdamWConfig

MESHES = {
    "model8": ((8,), ("model",)),
    "data2_model4": ((2, 4), ("data", "model")),
    "prod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}
ARCHS = list(ARCH_IDS) + ["qwen2-7b"]


def rules(mesh_key, options=None):
    shape, axes = MESHES[mesh_key]
    ref = RefAxisRules(SimpleNamespace(axis_names=axes,
                                       devices=SimpleNamespace(shape=shape)),
                       options)
    port = AxisRules(SimpleNamespace(mesh_dim_names=axes, shape=shape), options)
    return ref, port


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def _unstack(spec):
    assert spec[0] is None, spec          # "layers" is never sharded
    return tuple(spec)[1:]


def ref_layers(cfg, tree):
    """The reference's stacked spec tree (groups/tail) as the port's list of
    per-layer trees of plain tuples."""
    period = len(cfg.block_pattern)
    n = (cfg.num_layers // period) * period
    unstack = lambda t: jax.tree_util.tree_map(_unstack, t, is_leaf=_is_spec)
    plain = lambda t: jax.tree_util.tree_map(tuple, t, is_leaf=_is_spec)
    return ([unstack(tree["groups"][i % period]) for i in range(n)]
            + [plain(t) for t in tree["tail"]])


def ref_as_port(cfg, tree):
    """A reference spec tree of params (or of a moment) in the port's layout."""
    def lm(c, t):
        out = {k: tuple(t[k]) for k in ("embed", "final_norm", "head") if k in t}
        out["layers"] = tuple(ref_layers(c, t))
        return out
    if cfg.encoder_layers:
        enc_cfg = dataclasses.replace(cfg, cross_attention=False,
                                      num_layers=cfg.encoder_layers)
        return {"enc": {"layers": tuple(ref_layers(enc_cfg, tree["enc"])),
                        "norm": tuple(tree["enc"]["norm"])},
                "dec": lm(cfg, tree["dec"])}
    return lm(cfg, tree)


def _flat(tree, prefix=""):
    """{path: spec tuple}, a spec tuple being a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and tree and isinstance(tree[0], (dict, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree)}


def assert_same(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    bad = {k: (g[k], w[k]) for k in w if g[k] != w[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_equals_reference(arch, mesh_key):
    """Parameters, AdamW moments under ZeRO-1, and the decode cache at a
    batch that divides the batch axes and one that does not."""
    ref_ax, ax = rules(mesh_key)
    ref_model = ref_build_model(ref_get_config(arch, smoke=True), ref_ax)
    model = build_model(get_config(arch, smoke=True), ax)
    cfg = model.cfg
    ref_pds, pds = ref_model.pds(), model.pds()
    assert_same(ax.spec_tree(pds), ref_as_port(cfg, ref_ax.spec_tree(ref_pds)))

    ref_st = RefAdamW(RefAdamWConfig(zero1=True), ref_ax).state_pds(ref_pds)
    opt = AdamW(AdamWConfig(zero1=True), ax)
    st = opt.state_pds(pds)
    assert opt.data_size == ax.axis_sizes.get("data", 1)
    for k in ("m", "v"):
        assert_same(ax.spec_tree(st[k]), ref_as_port(cfg, ref_ax.spec_tree(ref_st[k])))
    assert ax.spec_tree(st["step"]) == tuple(ref_ax.spec_tree(ref_st["step"]))

    for batch in (64, 6):
        ref_cache = ref_ax.spec_tree(ref_model.cache_pds(batch, 128))
        cache = ax.spec_tree(model.cache_pds(batch, 128))
        assert_same(cache["layers"], ref_layers(cfg, ref_cache))


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_batch_and_model_axes_equal_reference(mesh_key):
    ref_ax, ax = rules(mesh_key)
    assert ax.axis_sizes == ref_ax.axis_sizes
    assert ax.batch_axes == ref_ax.batch_axes
    assert ax.model_axis == ref_ax.model_axis
    assert ax.model_size() == ref_ax.model_size()
    for dim in list(range(1, 70)) + [96, 128, 256, 512, 1000, 1024, 4096]:
        assert ax.batch(dim) == ref_ax.batch(dim), dim
        assert ax.model(dim) == ref_ax.model(dim), dim


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_resolve_claims_each_mesh_axis_once(mesh_key):
    """Every logical axis, including 'zero' and the first-claimant rule on
    MoE expert weights (EP when E divides, d_ff when it does not)."""
    ref_ax, ax = rules(mesh_key)
    cases = [
        (("expert", "embed", "mlp"), (16, 64, 128)),
        (("expert", "embed", "mlp"), (6, 64, 128)),
        (("expert", "mlp", "embed"), (8, 128, 64)),
        (("zero", "heads", None), (64, 16, 8)),
        (("batch", "kv_seq", None, None), (64, 256, 2, 16)),
        (("batch", "heads", "mlp"), (32, 32, 32)),
        (("vocab", "embed"), (512, 64)),
        (("layers", "embed", "kv", None), (3, 64, 10, 16)),
        ((None, "batch"), (5, 12)),
    ]
    for axes, shape in cases:
        assert ax.resolve(axes, shape) == tuple(ref_ax.resolve(axes, shape)), (axes, shape)
    with pytest.raises(ValueError, match="unknown logical axis"):
        ax.resolve(("nope",), (4,))


def test_placements_follow_the_spec():
    """A spec becomes one placement per mesh dim; a dim split over two axes
    is sharded by both, in mesh order."""
    _, ax = rules("multipod")
    assert ax.placements((("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert ax.placements((None, "data")) == (Replicate(), Shard(1), Replicate())
    assert ax.placements(()) == (Replicate(),) * 3
    pds = build_model(get_config("yi-9b", smoke=True), ax).pds()
    placed = ax.placement_tree(pds)
    assert placed["embed"] == ax.placements(ax.resolve(("vocab", "embed"), (512, 64)))
    np.testing.assert_equal(len(placed["layers"]), len(pds["layers"]))
