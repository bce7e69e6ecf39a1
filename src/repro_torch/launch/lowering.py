"""Step construction and sharding trees shared by ``train.py`` and the tests.

Port of ``repro/launch/lowering.py``.  ``build_step(cfg, mesh, shape)``
returns what one (architecture x input shape) step on a mesh needs, without
allocating anything: the step callable, ``TensorSpec`` argument trees, trees
of DTensor placements for each argument (the reference's ``NamedSharding``
in-shardings), donation indices and ``meta``.  The reference's
``lower_step`` (``jax.jit(...).lower``) has no torch counterpart yet; it
comes with the dry run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import place
from repro_torch.models.common import (
    AxisRules, TensorSpec, shape_tree, tree_leaves,
)
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import AdamW, AdamWConfig, make_train_step


@dataclass
class StepBundle:
    name: str
    fn: Callable
    args: Tuple[Any, ...]                 # TensorSpec trees
    in_shardings: Tuple[Any, ...]         # trees of placements on the mesh
    donate_argnums: Tuple[int, ...]
    model: Any
    meta: Dict[str, Any]


def batch_shardings(ax: AxisRules, specs: Dict[str, Any]) -> Dict[str, tuple]:
    """Each batch tensor's placements: dim 0 over the batch axes (as far as
    it divides), the rest replicated."""
    return {k: ax.placements((ax.batch(v.shape[0]),) + (None,) * (len(v.shape) - 1))
            for k, v in specs.items()}


def place_batch(ax: AxisRules, batch: Dict[str, torch.Tensor]):
    """A batch of full tensors (the same on every rank) placed by
    ``batch_shardings``; as it is without a mesh."""
    if ax.mesh is None:
        return batch
    return {k: place(v, ax.mesh, pl)
            for (k, v), pl in zip(batch.items(), batch_shardings(ax, batch).values())}


def scan_trip_counts(cfg: ModelConfig) -> Dict[str, int]:
    period = len(cfg.block_pattern)
    tc = {"layer_groups": cfg.num_layers // period}
    if cfg.encoder_layers:
        tc["encoder_groups"] = cfg.encoder_layers
    return tc


def _holding(model, params, *, train: bool):
    """Make ``model`` hold ``params``: the step callables take the parameter
    tree, as the reference's do, and the port's model holds it."""
    model.load_params(params)
    model.requires_grad_(train)


def build_step(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
               remat: str = "none", param_dtype=torch.bfloat16,
               zero1: bool = True,
               options: Optional[Dict[str, Any]] = None) -> StepBundle:
    ax = AxisRules(mesh, options)
    model = build_model(cfg, ax, remat=remat)
    pds = model.pds()
    params_sds = shape_tree(pds, param_dtype)
    params_sh = ax.placement_tree(pds)
    in_specs = model.input_specs(shape)
    batch_sh = batch_shardings(ax, in_specs)

    meta = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(ax.axis_sizes),
        "param_count": sum(math.prod(l.shape) for l in tree_leaves(params_sds)),
        "scan_trip_counts": scan_trip_counts(cfg),
    }

    if shape.kind == "train":
        opt = AdamW(AdamWConfig(zero1=zero1), ax)
        opt_pds = opt.state_pds(pds)
        opt_sds = shape_tree(opt_pds, torch.float32)
        opt_sh = ax.placement_tree(opt_pds)
        step = make_train_step(model, opt)

        def train_step(params, opt_state, batch):
            _holding(model, params, train=True)
            return step(params, opt_state, batch)
        return StepBundle(
            name="train_step", fn=train_step,
            args=(params_sds, opt_sds, in_specs),
            in_shardings=(params_sh, opt_sh, batch_sh),
            donate_argnums=(0, 1), model=model, meta=meta)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            _holding(model, params, train=False)
            return model.prefill(batch)
        return StepBundle(
            name="prefill_step", fn=prefill_step,
            args=(params_sds, in_specs),
            in_shardings=(params_sh, batch_sh),
            donate_argnums=(), model=model, meta=meta)

    # decode: one new token against a KV cache of shape.seq_len
    B = shape.global_batch
    cache_pds = model.cache_pds(B, shape.seq_len)
    cache_sds = shape_tree(cache_pds, param_dtype)
    rules = AxisRules(mesh)
    cache_sh = rules.placement_tree(cache_pds)
    tok_sh = rules.placements((rules.batch(B), None))
    pos_sds = TensorSpec((), torch.int32)
    pos_sh = rules.placements(())

    def serve_step(params, cache, tokens, pos):
        _holding(model, params, train=False)
        return model.decode(cache, tokens, pos)

    meta["cache_bytes_global"] = sum(math.prod(l.shape) * l.dtype.itemsize
                                     for l in tree_leaves(cache_sds))
    return StepBundle(
        name="serve_step", fn=serve_step,
        args=(params_sds, cache_sds, in_specs["tokens"], pos_sds),
        in_shardings=(params_sh, cache_sh, tok_sh, pos_sh),
        donate_argnums=(1,), model=model, meta=meta)
