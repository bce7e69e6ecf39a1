"""AdamW from scratch, as the reference writes it (``repro/training/optimizer.py``).

The same arithmetic in the same float order: a global-norm clip in f32, bias
corrections from the step as f32, decoupled weight decay, and each parameter
updated as ``(p.float() - lr * delta).to(p.dtype)``.  Where the reference
returns new trees from a jitted function, the port writes the new parameters
and moments in place under ``torch.no_grad()``, so the model that holds the
parameter tensors (``build_model(cfg, params=tree)``) sees them.

Moments are declared as PD trees (``state_pds``) like the parameters.  One
device: ``AxisRules`` carries no mesh, so ZeRO-1's data axis has size 1 and
``_zero1_pd`` leaves every descriptor as it is; sharded moments wait for the
multi-device slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import PD, AxisRules, tree_leaves, tree_map


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
        self.data_size = 1      # ax.mesh is None: no data axis to shard over

    def state_pds(self, param_pds) -> Dict[str, Any]:
        def mom(pd: PD) -> PD:
            return _zero1_pd(PD(pd.shape, pd.axes, "zeros"), self.data_size)
        return {"m": tree_map(mom, param_pds), "v": tree_map(mom, param_pds),
                "step": PD((), (), "zeros")}

    def init(self, params) -> Dict[str, Any]:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.cfg.moment_dtype, device=p.device)
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

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
            gf = g.to(c.moment_dtype) * scale
            m.copy_(c.b1 * m + (1.0 - c.b1) * gf)
            v.copy_(c.b2 * v + (1.0 - c.b2) * torch.square(gf))
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + c.eps) + c.weight_decay * p.to(mh.dtype)
            p.copy_((p.float() - c.lr * delta.float()).to(p.dtype))
        return params, {"m": state["m"], "v": state["v"], "step": step}


def make_train_step(model, optimizer: AdamW):
    """(params, opt_state, batch) -> (params', opt_state', metrics).

    ``params`` is the tree whose tensors ``model`` holds (the one handed to
    ``build_model(cfg, params=...)`` or ``load_params``), with grad enabled by
    ``model.requires_grad_(True)``.  Each step clears the gradients, runs
    ``model.loss(batch).backward()`` and hands the gradients, in ``params``'
    layout, to ``optimizer.update``."""
    def train_step(params, opt_state, batch):
        held = tree_leaves(model.param_tree())
        if [p.data_ptr() for p in held] != [p.data_ptr() for p in tree_leaves(params)]:
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
