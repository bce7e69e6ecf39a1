"""Common model machinery: parameter descriptors, init, norms, RoPE.

Parameters are declared as trees of :class:`PD` (shape, logical axis names,
init scale).  ``init_tree`` materializes a tree of tensors from one explicit
``torch.Generator`` on an explicit device; ``ParamTree`` holds such a tree
inside an ``nn.Module``, read as ``p["tm"]["wr"]`` like the reference's dicts.

Single device only: ``AxisRules`` carries the execution options; its mesh and
sharding half (the reference's ``resolve``/``spec_tree``/``constrain``) waits
for the multi-device slice, so there is no ``constrain`` call anywhere in the
port's models.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class PD:
    """Param descriptor: shape + logical axes + init (+ dtype override)."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: Union[str, float] = "fan_in"   # "fan_in" | "zeros" | "ones" | const std
    dtype: Any = None                    # None -> caller-provided default

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


@dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: Any


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _init_one(gen: torch.Generator, pd: PD, dtype, device) -> torch.Tensor:
    dtype = pd.dtype or dtype
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=device)
    if pd.init == "fan_in":
        # the product of all but the last dim, leaving out a stacked "layers"
        fan_in = 1
        for d, a in zip(pd.shape[:-1], pd.axes[:-1]):
            if a != "layers":
                fan_in *= d
        std = fan_in ** -0.5
    else:
        std = float(pd.init)
    x = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def init_tree(generator: torch.Generator, tree, dtype=torch.bfloat16,
              device=None):
    """Materialize a PD tree, drawing leaf after leaf from ``generator`` on
    ``device`` (the generator's own device when not given).  The draws differ
    from the reference's ``jax.random`` bits; the distributions are the same."""
    device = torch.device(device) if device is not None else generator.device
    return tree_map(lambda pd: _init_one(generator, pd, dtype, device), tree)


def shape_tree(tree, dtype=torch.bfloat16):
    """PD tree -> TensorSpec tree (no allocation)."""
    return tree_map(lambda pd: TensorSpec(pd.shape, pd.dtype or dtype), tree)


def stack_pds(tree, n: int):
    """Add a leading stacked 'layers' axis of length n to every descriptor
    (the reference's layout; the port's models hold one tree per layer)."""
    return tree_map(
        lambda pd: PD((n,) + pd.shape, ("layers",) + pd.axes, pd.init, pd.dtype),
        tree)


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters, read as ``p["a"]["b"]``.

    Parameters are frozen (``requires_grad=False``): the port serves and
    does not train yet."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, dict):
                self.add_module(name, ParamTree(val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


class AxisRules:
    """Execution options threaded to the layer implementations (perf levers):
    ``attn_impl`` "naive" | "blockwise", ``attn_block``; ``rwkv_impl`` "scan" |
    "chunked", ``rwkv_chunk``.  Single device: ``mesh`` must be None."""

    def __init__(self, mesh=None, options: Optional[Dict[str, Any]] = None):
        if mesh is not None:
            raise NotImplementedError("the port runs on one device; sharded "
                                      "AxisRules are not ported yet")
        self.mesh = None
        self.options: Dict[str, Any] = dict(options or {})

    def opt(self, key: str, default: Any = None) -> Any:
        return self.options.get(key, default)


NO_RULES = AxisRules(None)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if zero_centered else scale.float()
    return (y * s).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin of shape (..., head_dim//2), float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., n_heads, head_dim); cos/sin: broadcastable (..., 1, head_dim//2)."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in f32.  logits (..., V), labels (...) integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
