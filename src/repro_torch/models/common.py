"""Common model machinery: parameter descriptors, init, norms, RoPE, sharding.

Parameters are declared as trees of :class:`PD` (shape, logical axis names,
init scale).  ``init_tree`` materializes a tree of tensors from one explicit
``torch.Generator`` on an explicit device; ``ParamTree`` holds such a tree
inside an ``nn.Module``, read as ``p["tm"]["wr"]`` like the reference's dicts.

``AxisRules`` maps logical axes onto a ``torch.distributed`` ``DeviceMesh``
by the reference's rules.  ``resolve`` gives the reference's
``PartitionSpec`` as a plain tuple (one entry per tensor dim: ``None``, a
mesh axis name, or a tuple of names); ``placements`` turns such a spec into
DTensor placements (one ``Shard``/``Replicate`` per mesh dim).  With a mesh
the models run on DTensors: parameters placed by ``placement_tree`` (see
``convert.shard_params``), activations propagated by DTensor and pinned by
``constrain`` where the reference calls ``with_sharding_constraint``.
Without one (``NO_RULES``) every call is a no-op and the models run on plain
tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


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


def tree_map_with(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn(leaf, *other_leaves)`` over ``tree``'s structure, each of
    ``others`` indexed alongside it; their leaves may be tuples (a spec, a
    placement tuple), since only ``tree`` is walked."""
    if isinstance(tree, dict):
        return {k: tree_map_with(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts, tuples and lists, in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


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

    Parameters are registered frozen (``requires_grad=False``), as serving
    wants them; training makes them trainable with the stock
    ``model.requires_grad_(True)``."""

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
    """Resolves logical param/activation axes onto a mesh, and carries the
    execution options threaded to the layer implementations (perf levers):
    ``attn_impl`` "naive" | "blockwise", ``attn_block``; ``rwkv_impl`` "scan" |
    "chunked", ``rwkv_chunk``; ``moe_dispatch`` "psum" | "a2a".

    ``mesh`` is a ``DeviceMesh`` with ``mesh_dim_names`` (``launch/mesh.py``),
    or None for one device.  ``batch_axes`` covers DP ("pod", "data");
    ``model_axis`` covers TP/EP.  An axis maps to its mesh axis only when the
    dimension is divisible by the mesh axis's size, otherwise it replicates
    (recurrentgemma's 10 heads on a 16-way model axis)."""

    def __init__(self, mesh=None, options: Optional[Dict[str, Any]] = None):
        self.mesh = mesh
        if mesh is None:
            self.axis_sizes: Dict[str, int] = {}
        else:
            self.axis_sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in self.axis_sizes)
        self.model_axis: Optional[str] = "model" if "model" in self.axis_sizes else None
        self.options: Dict[str, Any] = dict(options or {})

    def opt(self, key: str, default: Any = None) -> Any:
        return self.options.get(key, default)

    # -- helpers ----------------------------------------------------------
    def batch(self, dim: int):
        """Mesh mapping for a batch dimension of size `dim` (best effort)."""
        axes = list(self.batch_axes)
        while axes:
            prod = 1
            for a in axes:
                prod *= self.axis_sizes[a]
            if dim % prod == 0:
                return tuple(axes) if len(axes) > 1 else axes[0]
            axes.pop(0)  # drop "pod" first, then "data"
        return None

    def model(self, dim: int):
        if self.model_axis and dim % self.axis_sizes[self.model_axis] == 0:
            return self.model_axis
        return None

    def model_size(self) -> int:
        return self.axis_sizes.get("model", 1)

    # -- resolution --------------------------------------------------------
    def resolve(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> tuple:
        """Logical axes + concrete dims -> the reference's PartitionSpec, as a
        tuple.

        A mesh axis may appear at most once per spec: the first logical axis
        that claims it wins, later claimants replicate (MoE expert weights
        (E, d, ff): 'expert' takes "model" so 'mlp' replicates under EP; when
        E is not divisible 'expert' falls back and 'mlp' takes "model", the
        TP-over-d_ff layout ``moe_apply`` uses for mixtral)."""
        out = []
        used = set()
        for a, d in zip(axes, shape):
            m = None
            if a in ("vocab", "heads", "kv", "mlp", "expert", "kv_seq"):
                m = self.model(d)
            elif a == "batch":
                m = self.batch(d)
            elif a == "zero":  # ZeRO-1 optimizer-state sharding over data
                ds = self.axis_sizes.get("data", 1)
                m = "data" if ds > 1 and d % ds == 0 else None
            elif a in ("embed", "layers", None):
                m = None
            else:
                raise ValueError(f"unknown logical axis {a!r}")
            flat = m if isinstance(m, tuple) else (m,)
            if m is not None and any(f in used for f in flat):
                m = None
            if m is not None:
                used.update(flat)
            out.append(m)
        return tuple(out)

    def spec_tree(self, pd_tree):
        return tree_map(lambda pd: self.resolve(pd.axes, pd.shape), pd_tree)

    def placements(self, spec: Sequence) -> tuple:
        """A resolved spec -> one placement per mesh dim: ``Shard(d)`` where
        tensor dim ``d`` names that mesh axis, else ``Replicate()``.  A dim
        named by several axes (("pod", "data")) is split over them in mesh
        order, as JAX splits it.  A mesh axis of size 1 replicates: its one
        shard is the whole tensor, and DTensor refuses views across a dim it
        holds sharded, even over one rank."""
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, m in enumerate(spec)
                    if m == name or (isinstance(m, tuple) and name in m)]
            split = dims and self.axis_sizes[name] > 1
            out.append(Shard(dims[0]) if split else Replicate())
        return tuple(out)

    def placement_tree(self, pd_tree):
        """PD tree -> tree of placements (the reference's NamedSharding tree)."""
        return tree_map(
            lambda pd: self.placements(self.resolve(pd.axes, pd.shape)), pd_tree)

    def replicated(self, t: torch.Tensor) -> torch.Tensor:
        """A plain tensor that every rank computes alike (positions, masks,
        zero states) as a replicated DTensor on the mesh, so it meets the
        model's DTensors in one op; itself without a mesh.  JAX treats such
        constants as replicated implicitly."""
        if self.mesh is None or isinstance(t, DTensor):
            return t
        return DTensor.from_local(t, self.mesh, (Replicate(),) * self.mesh.ndim,
                                  run_check=False)

    def constrain(self, x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
        """Redistribute to the logical axes' placements (the reference's
        ``with_sharding_constraint``); a no-op without a mesh.  A plain
        tensor is taken as the same on every rank (``replicated``).

        The backward sums a ``Partial`` gradient to the same placements
        (JAX's constraint binds the cotangent too; megatron's pair of region
        operators).  Without it DTensor lets the residual stream's gradient
        stay ``Partial`` (the vocab-sharded head leaves it so), and every
        product of a TP region's backward that meets it gathers its sharded
        operand and runs whole on every rank."""
        if self.mesh is None:
            return x
        return _Constrain.apply(self.replicated(x),
                                self.placements(self.resolve(axes, x.shape)))

    def grad_placements(self, placements: Sequence, tokens: Sequence) -> tuple:
        """The gradient's placements for a ``local_map`` input of
        ``placements`` whose body sees only the tokens of ``tokens``'
        placements: ``Partial()`` (a sum still owed) on each mesh dim where
        the input is replicated and the tokens are split, else unchanged."""
        return tuple(Partial() if isinstance(p, Replicate) and isinstance(t, Shard)
                     else p for p, t in zip(placements, tokens))

    def shared_product(self, eq: str, x: torch.Tensor, w: torch.Tensor,
                       rep: int = 1) -> torch.Tensor:
        """``torch.einsum(eq, x, w)`` of an ``x`` replicated over "model" and
        a replicated weight ``w`` (``eq`` contracts x's last dim with w's
        first), partitioned as GSPMD partitions the reference's product.

        With ``rep`` > 1, w's dim 1 indexes heads that the output repeats
        ``rep`` times each (``repeat_interleave``) and splits over "model":
        each rank projects only the heads it holds, where DTensor would
        project them all and slice.  The weight's gradient, alike on every
        "model" rank, is computed for 1/tp of w's first dim on each and
        gathered, where DTensor would compute it whole on each.  Without a
        mesh it is the plain product."""
        if self.mesh is None or self.model_size() == 1:
            y = torch.einsum(eq, x, w)
            return y if rep == 1 else torch.repeat_interleave(
                y, rep, dim=_head_dim(eq))
        x = self.replicated(x)
        mi = self.mesh.mesh_dim_names.index(self.model_axis)
        x_pl = tuple(Replicate() if i == mi else p for i, p in enumerate(x.placements))
        x = x.redistribute(self.mesh, x_pl)
        w = self.replicated(w).redistribute(self.mesh, (Replicate(),) * self.mesh.ndim)
        return _SharedProduct.apply(x, w, eq, rep, mi)

    # -- collectives inside a ``local_map`` body -----------------------------
    # c10d's stable calls under autograd functions that state their own
    # backward, the same on every torch version and backend (gloo, nccl, the
    # threaded test backend)
    def sum_over(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """All-reduce (sum) over mesh ``axis``, the reference's ``psum``.  Its
        backward is the identity: the sum leaves the body replicated over
        ``axis``, so each rank's term takes the whole incoming gradient
        (megatron's reduce from the model-parallel region)."""
        return _SumOverRanks.apply(x, self.mesh.get_group(axis))

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Tiled all-to-all over mesh ``axis`` on dim 0 (JAX's ``all_to_all``
        with split and concat on axis 0, ``tiled=True``): chunk j of dim 0
        goes to rank j, and the chunks received come back in rank order.  It
        is its own transpose, so the backward is the same exchange."""
        return _AllToAll.apply(x, self.mesh.get_group(axis))


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``placements``; a ``Partial`` gradient summed
    to them."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        if any(p.is_partial() for p in grad.placements):
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad, None


def _head_dim(eq: str) -> int:
    """The output dim of ``eq`` that w's dim 1 (its heads) becomes."""
    ins, out = eq.split("->")
    return out.index(ins.split(",")[1][1])


class _SharedProduct(torch.autograd.Function):
    """``AxisRules.shared_product`` on DTensors: ``x`` replicated over mesh
    dim ``mi`` (and split on its batch dims elsewhere), ``w`` replicated."""

    @staticmethod
    def forward(ctx, x, w, eq, rep, mi):
        mesh = x.device_mesh
        tp, m = mesh.size(mi), mesh.get_local_rank(mi)
        xl, wl = x.to_local(), w.to_local()
        y_pl = list(x.placements)
        if rep > 1:
            # the heads this rank holds, of K * rep split over tp ranks
            per = wl.shape[1] * rep // tp
            idx = torch.arange(m * per, (m + 1) * per, device=wl.device) // rep
            wl = wl.index_select(1, idx)
            y_pl[mi] = Shard(_head_dim(eq))
        ctx.save_for_backward(xl, wl)
        ctx.meta = (eq, rep, mi, tp, m, x.placements, tuple(y_pl), w.shape)
        y = torch.einsum(eq, xl, wl)
        return DTensor.from_local(y, mesh, y_pl, run_check=False)

    @staticmethod
    def backward(ctx, gy):
        xl, wl = ctx.saved_tensors
        eq, rep, mi, tp, m, x_pl, y_pl, w_shape = ctx.meta
        mesh = gy.device_mesh
        ins, out = eq.split("->")
        xs, ws = ins.split(",")
        if tuple(gy.placements) != y_pl:
            gy = gy.redistribute(mesh, y_pl)
        gl = gy.to_local()
        gx = torch.einsum(f"{out},{ws}->{xs}", gl, wl)
        gx_pl = list(x_pl)
        if rep > 1:     # each rank's heads give part of x's gradient
            gx_pl[mi] = Partial()
            full = list(y_pl)
            full[mi] = Replicate()
            gl = gy.redistribute(mesh, full).to_local()
            h = _head_dim(eq)
            gl = gl.unflatten(h, (w_shape[1], rep)).sum(h + 1)
        # the weight's gradient: 1/tp of w's first dim on each rank, summed
        # over the batch dims the ranks split, then gathered over "model"
        D = xl.shape[-1]
        gw_pl = [Partial() if p.is_shard() else Replicate() for p in x_pl]
        if D % tp == 0:
            xl = xl[..., m * D // tp:(m + 1) * D // tp]
            gw_pl[mi] = Shard(0)
        gw = DTensor.from_local(torch.einsum(f"{xs},{out}->{ws}", xl, gl), mesh,
                                gw_pl, run_check=False)
        gw_pl[mi] = Replicate()
        return (DTensor.from_local(gx, mesh, gx_pl, run_check=False),
                gw.redistribute(mesh, gw_pl), None, None, None)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


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
    # a fill on the device, not a copy from the host, which a step captured
    # in a CUDA graph cannot make
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
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
