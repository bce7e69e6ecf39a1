"""AdamW from scratch, as the reference writes it (``repro/training/optimizer.py``).

The same arithmetic in the same float order: a global-norm clip in f32, bias
corrections from the step as f32, decoupled weight decay, and each parameter
updated as ``(p.float() - lr * delta).to(p.dtype)``.  Where the reference
returns new trees from a jitted function, the port writes the new parameters
and moments in place under ``torch.no_grad()``, so the model that holds the
parameter tensors (``build_model(cfg, params=tree)``) sees them.

Moments are declared as PD trees (``state_pds``) like the parameters.  On a
mesh with ``zero1`` each moment also shards its first data-divisible
replicated axis over "data" (logical axis "zero"), and ``update`` runs
ZeRO-1 by hand: each gradient is redistributed to its moments' placements
(a reduce-scatter over "data"), the moments and the step are computed on
the shard, and the new shard is gathered back to the parameter's
placements before it is written.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.models.common import (
    PD, AxisRules, tree_leaves, tree_map, tree_map_with,
)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = True
    moment_dtype: Any = torch.float32


def _zero1_pd(pd: PD, data_size: int) -> PD:
    """Extend a moment PD's axes with the 'zero' logical axis if possible."""
    if data_size <= 1:
        return pd
    axes = list(pd.axes)
    for i, (a, d) in enumerate(zip(axes, pd.shape)):
        if a in (None, "embed") and d % data_size == 0 and d >= data_size:
            axes[i] = "zero"
            return PD(pd.shape, tuple(axes), "zeros")
    return PD(pd.shape, pd.axes, "zeros")


class AdamW:
    def __init__(self, cfg: AdamWConfig, ax: AxisRules):
        self.cfg = cfg
        self.ax = ax
        self.data_size = ax.axis_sizes.get("data", 1) if cfg.zero1 else 1

    def state_pds(self, param_pds) -> Dict[str, Any]:
        def mom(pd: PD) -> PD:
            return _zero1_pd(PD(pd.shape, pd.axes, "zeros"), self.data_size)
        return {"m": tree_map(mom, param_pds), "v": tree_map(mom, param_pds),
                "step": PD((), (), "zeros")}

    def init(self, params, pds=None) -> Dict[str, Any]:
        """Zero moments and step, in ``params``' structure.  On a mesh they are
        DTensors placed by ``state_pds(pds)`` (``pds`` is the parameters'
        descriptors, needed there), each rank allocating its shards only."""
        device = tree_leaves(params)[0].device
        if self.ax.mesh is None:
            def zeros(p):
                return torch.zeros(p.shape, dtype=self.cfg.moment_dtype,
                                   device=p.device)
            return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                    "step": torch.zeros((), dtype=torch.int32, device=device)}
        if pds is None:
            raise ValueError("on a mesh AdamW.init needs the parameters' pds "
                             "to place the moments")
        ax, mesh = self.ax, self.ax.mesh

        def zeros(p, pd):
            return dtensor_zeros(pd.shape, dtype=self.cfg.moment_dtype,
                                 device_mesh=mesh,
                                 placements=ax.placements(ax.resolve(pd.axes, pd.shape)))
        moments = self.state_pds(pds)["m"]
        return {"m": tree_map_with(zeros, params, moments),
                "v": tree_map_with(zeros, params, moments),
                "step": dtensor_zeros((), dtype=torch.int32, device_mesh=mesh,
                                      placements=ax.placements(()))}

    @torch.no_grad()
    def update(self, params, grads, state) -> Tuple[Any, Any]:
        """One step.  Writes the new values into ``params``' tensors and the
        moments into ``state``'s, and returns ``(params, new_state)``."""
        c = self.cfg
        step = state["step"] + 1
        # global-norm clip in f32
        gsq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
        gnorm = torch.sqrt(gsq)
        scale = (torch.clamp_max(c.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
                 if c.grad_clip else torch.ones((), device=gnorm.device))
        t = step.float()
        bc1 = 1.0 - c.b1 ** t
        bc2 = 1.0 - c.b2 ** t

        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            # on a mesh: the gradient and the parameter on the moments'
            # shards (in-place DTensor ops need equal placements)
            gf = _like(g, m).to(c.moment_dtype) * scale
            pm = _like(p, m)
            m.copy_(c.b1 * m + (1.0 - c.b1) * gf)
            v.copy_(c.b2 * v + (1.0 - c.b2) * torch.square(gf))
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * pm.to(mh.dtype)
            p.copy_(_like((pm.float() - c.lr * delta.float()).to(p.dtype), p))
        return params, {"m": state["m"], "v": state["v"], "step": step}


def _like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``ref``'s placements (a no-op off a mesh)."""
    if isinstance(ref, DTensor) and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def _storage(t: torch.Tensor) -> tuple:
    local = t.to_local() if isinstance(t, DTensor) else t
    return local.untyped_storage()._cdata, local.storage_offset()


def make_train_step(model, optimizer: AdamW):
    """(params, opt_state, batch) -> (params', opt_state', metrics).

    ``params`` is the tree whose tensors ``model`` holds (the one handed to
    ``build_model(cfg, params=...)`` or ``load_params``), with grad enabled by
    ``model.requires_grad_(True)``.  Each step clears the gradients, runs
    ``model.loss(batch).backward()`` and hands the gradients, in ``params``'
    layout, to ``optimizer.update``."""
    def train_step(params, opt_state, batch):
        held = tree_leaves(model.param_tree())
        if [_storage(p) for p in held] != [_storage(p) for p in tree_leaves(params)]:
            raise ValueError("params are not the tensors the model holds")
        for p in held:
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), model.param_tree())
        params, opt_state = optimizer.update(params, grads, opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics
    return train_step
