"""Step construction and sharding trees shared by ``train.py`` and the tests.

Port of ``repro/launch/lowering.py``.  ``build_step(cfg, mesh, shape)``
returns what one (architecture x input shape) step on a mesh needs, without
allocating anything: the step callable, ``TensorSpec`` argument trees, trees
of DTensor placements for each argument (the reference's ``NamedSharding``
in-shardings), donation indices and ``meta``.

``lower_step(bundle, mesh)`` is the counterpart of ``jax.jit(...).lower``:
it makes the arguments fake tensors (``FakeTensorMode``: nothing is
allocated), each rank's own shard placed on the mesh with
``DTensor.from_local``, and its ``.compile()`` runs the step once under
``hlo_cost.Counter``.  ``Compiled.cost_analysis()`` gives the counter's
per-device totals and ``memory_analysis()`` this rank's bytes.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import place
from repro_torch.launch import hlo_cost
from repro_torch.models.common import (
    AxisRules, TensorSpec, shape_tree, tree_leaves, tree_map_with,
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


@dataclass
class MemoryAnalysis:
    """One rank's bytes, the fields of the reference's ``memory_analysis()``
    record.  ``temp_bytes`` is the peak of bytes held by storages the step
    created, while they were alive (the counter's ``peak_bytes``).  Eager
    torch generates no code, so ``generated_code_bytes`` is ``None``."""
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_bytes: int
    generated_code_bytes: Optional[int] = None


class Compiled:
    """A step run once on fake tensors: ``cost_analysis()``, the counter's
    per-device totals; ``memory_analysis()``; ``kernels``, the calls of each
    hand-written kernel's op."""

    def __init__(self, costs: Dict[str, float], memory: MemoryAnalysis,
                 kernels: Dict[str, int]):
        self._costs, self._memory, self.kernels = costs, memory, kernels

    def cost_analysis(self) -> Dict[str, float]:
        return dict(self._costs)

    def memory_analysis(self) -> MemoryAnalysis:
        return self._memory


def _local_bytes(tree) -> int:
    """This rank's bytes of the tensors in ``tree``, each storage once."""
    seen, n = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            st = local.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                n += st.nbytes()
    return n


class Lowered:
    """``bundle``'s arguments as fake tensors on ``device``, placed on the
    mesh; ``compile()`` runs the step.

    An integer scalar argument (decode's position) is the Python int 0: the
    step reads its value (``int(pos)``) and a fake tensor has none.  No
    count depends on it; its 4 bytes stay in ``argument_bytes``."""

    def __init__(self, bundle: StepBundle, mesh, device):
        if (bundle.name == "train_step" and torch.device(device).type == "cuda"
                and not torch.backends.cuda.is_built()):
            raise RuntimeError(
                "a train step on fake CUDA tensors needs torch built with CUDA "
                "(autograd asks the CUDA device guard); this torch is CPU "
                "only: pass device='cpu'")
        self.bundle = bundle
        self.mode = hlo_cost.fake_mode()
        self.arg_bytes = [0] * len(bundle.args)   # this rank's, per argument

        def fake(i, spec, pl):
            local = _local_shape(spec.shape, pl, mesh)
            self.arg_bytes[i] += math.prod(local) * spec.dtype.itemsize
            if spec.shape == () and not spec.dtype.is_floating_point:
                return 0
            t = torch.empty(local, dtype=spec.dtype, device=device)
            if mesh is None:
                return t
            stride = torch.empty(spec.shape, dtype=spec.dtype, device="meta").stride()
            return DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=torch.Size(spec.shape), stride=stride)
        with self.mode:
            self.args = tuple(
                tree_map_with(functools.partial(fake, i), a, sh)
                for i, (a, sh) in enumerate(zip(bundle.args, bundle.in_shardings)))

    def compile(self) -> Compiled:
        b = self.bundle
        with self.mode:
            with hlo_cost.Counter() as counter:
                out = b.fn(*self.args)
        memory = MemoryAnalysis(
            argument_bytes=sum(self.arg_bytes), output_bytes=_local_bytes(out),
            alias_bytes=sum(self.arg_bytes[i] for i in b.donate_argnums),
            temp_bytes=counter.peak_bytes)
        return Compiled(counter.totals(), memory, dict(counter.kernels))


def _local_shape(shape, placements, mesh) -> list:
    """Rank 0's shard of ``shape``: the first chunk of each split dim, as
    ``torch.chunk`` deals them."""
    local = list(shape)
    if mesh is not None:
        for pl, n in zip(placements, mesh.shape):
            if isinstance(pl, Shard):
                local[pl.dim] = -(-local[pl.dim] // n)
    return local


def lower_step(bundle: StepBundle, mesh, device="cuda") -> Lowered:
    """The counterpart of ``jax.jit(bundle.fn, in_shardings=...).lower``:
    fake arguments on ``device`` ("cuda", the default, needs no card: a
    fake CUDA tensor is metadata), each rank's shard placed by
    ``bundle.in_shardings``.  Nothing is scattered or allocated."""
    return Lowered(bundle, mesh, device)
