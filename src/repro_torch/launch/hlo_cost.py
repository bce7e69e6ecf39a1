"""Cost extraction: the reference's HLO text parser, and the port's counter.

Port of ``repro/launch/hlo_cost.py``, in two halves.

**(a) The HLO text parser, copied.**  ``parse_hlo``, ``analyze`` and
``roofline_terms`` are the reference's, line for line, so the port reads any
compiled (SPMD, per-device) HLO text the reference can.  ``analyze`` is
scan-aware: ``compiled.cost_analysis()`` counts a ``while`` (lax.scan) body
ONCE, which would understate a scanned transformer's FLOPs/bytes by about
num_layers x, so it parses the text into a computation call graph,
multiplies per-computation costs by the product of ``known_trip_count``
values along the call chain, and returns corrected totals:

- flops: dot/convolution FLOPs,
- bytes: HBM traffic under XLA's fusion model: each *top-level* op in a
  computation reads its operands and writes its output; ops inside fusions
  are free,
- collective bytes per kind (all-gather / all-reduce / reduce-scatter /
  all-to-all / collective-permute), using output-shape bytes.

**(b) The port's extractor.**  A torch step has no HLO, so ``Counter`` (a
``TorchDispatchMode``) counts what the step dispatches, run once on fake
tensors (``FakeTensorMode``: nothing is allocated), and ``count(fn, *args)``
wraps it.  It returns the reference's keys:

- ``flops``: products only (mm, addmm, bmm, baddbmm, convolution, SDPA, by
  ``torch.utils.flop_counter``'s formulas), as ``analyze`` counts only
  ``dot`` and ``convolution``; a hand-written kernel reached on a fake CUDA
  tensor (a ``repro_torch::`` op) adds the operations its roofline bound
  counts;
- ``bytes``: ``analyze``'s model applied to eager ops.  Eager torch fuses
  nothing, so every op is top level: it reads its operands and writes its
  outputs.  Views and metadata ops (view, expand, transpose, permute,
  slice, select, split, detach, alias, ``prim.device``) and allocations
  (``empty*``) cost nothing.  An update of part of a buffer (``copy_``,
  ``index_put_``, ``slice_scatter``, ``select_scatter``, ``scatter*``,
  ``index_add``/``index_copy``) is charged at 3x the update, as
  ``dynamic-update-slice`` is, so a cache or a stacked buffer is not
  charged O(L^2); a gather (``index``, ``index_select``, ``gather``,
  ``embedding``) at 2x its output, as ``gather`` is.  So the port's bytes
  count every intermediate that XLA would fuse away: for naive attention
  they are well above ``analyze``'s (ROADMAP Queue C, "No HLO");
- ``collective_bytes`` and ``coll_<kind>``: each ``_c10d_functional`` or
  ``c10d`` collective at its output's bytes, under ``analyze``'s kind names;
  ``wait_tensor`` is free.  A collective's bytes count in ``bytes`` too, as
  a top-level HLO collective's do;
- ``transcendentals``: elements written by ops that evaluate one (exp, log,
  tanh, sigmoid, rsqrt, sqrt, erf, sin, cos, softmax, silu, gelu), as XLA's
  own ``cost_analysis`` counts them.  ``analyze`` leaves this key at 0.

**Per device.**  ``analyze``'s totals are per device, from SPMD HLO, and so
are the counter's: it counts *below* DTensor.  For an op on DTensors it
returns ``NotImplemented``, so DTensor runs first and turns the op into
collectives and ops on this rank's local tensors, which come back through
the counter and are charged at their local shapes.  The ops DTensor runs on
global-shaped fake tensors only to learn an output's metadata
(``ShardingPropagator._propagate_tensor_meta_non_cached``) are not the
step's and are skipped.  Bodies under ``local_map`` see local tensors and
are counted as they run.  In a ``fake`` process group the counts are rank
0's.

**No scan correction.**  Eager runs every layer, so the trip counts
``analyze`` reads from ``known_trip_count`` are in the count by
construction: a Python loop of N products counts N products.

``Counter`` also tracks the bytes of storages its ops create while they are
alive, and keeps their peak (``temp_bytes`` in ``lowering.Compiled``).
"""
from __future__ import annotations

import contextlib
import json
import re
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import wkv_chunk as _wkv
from repro_torch.models.common import tree_map

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "token": 0,
    "s2": 1, "u2": 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
# NB: parameters may be tuple-typed (nested parens) — match greedily to the
# arrow.  Instruction lines contain " = " and are excluded in parse_hlo.
_DEF_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w\.\-]+)\s+\(.*\)\s*->")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.*)$")
_CALLED_BRACED_RE = re.compile(r"(?:calls|branch_computations)=\{([^}]*)\}")
_CALLED_SINGLE_RE = re.compile(r"(?:to_apply|body|condition|calls)=%?([\w\.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_OPERAND_RE = re.compile(r"%([\w\.\-]+)")


def _parse_shapes(s: str) -> List[Tuple[str, List[int]]]:
    """All dtype[dims] shape tokens in a string prefix (before operands)."""
    out = []
    for m in _SHAPE_RE.finditer(s):
        dt, dims = m.group(1), m.group(2)
        if dt not in DTYPE_BYTES:
            continue
        out.append((dt, [int(x) for x in dims.split(",") if x] if dims else []))
    return out


def _nbytes(dt: str, dims: List[int]) -> int:
    n = DTYPE_BYTES.get(dt, 4)
    for d in dims:
        n *= d
    return n


def _numel(dims: List[int]) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


@dataclass
class Instr:
    name: str
    op: str
    out_shapes: List[Tuple[str, List[int]]]
    body: str
    called: List[str] = field(default_factory=list)
    trip_count: int = 1
    is_root: bool = False


@dataclass
class Computation:
    name: str
    instrs: List[Instr] = field(default_factory=list)
    is_fusion_body: bool = False


def parse_hlo(text: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        if " = " not in line:
            d = _DEF_RE.match(line)
            if d and "{" in line:
                cur = Computation(d.group(1))
                comps[cur.name] = cur
                continue
        if cur is None:
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        is_root = bool(re.match(r"^\s*ROOT\b", line))
        name, rest = m.group(1), m.group(2)
        # op comes after shape: "f32[8,16]{1,0} dot(%a, %b), ..."
        opm = re.search(r"\}?\s*([a-z][a-z0-9\-_]*)\(", rest)
        op = opm.group(1) if opm else ""
        # output shapes: everything before the op name
        cut = opm.start() if opm else len(rest)
        out_shapes = _parse_shapes(rest[:cut])
        ins = Instr(name, op, out_shapes, rest, is_root=is_root)
        rest_wo = _CALLED_BRACED_RE.sub(" ", rest)
        for grp in _CALLED_BRACED_RE.findall(rest):
            for c in grp.split(","):
                c = c.strip().lstrip("%")
                if c:
                    ins.called.append(c)
        for c in _CALLED_SINGLE_RE.findall(rest_wo):
            ins.called.append(c)
        tm = _TRIP_RE.search(rest)
        if tm:
            ins.trip_count = int(tm.group(1))
        cur.instrs.append(ins)
    return comps


def _dot_flops(instr: Instr, comps: Dict[str, Computation],
               operand_shapes: Dict[str, List[Tuple[str, List[int]]]]) -> float:
    """2 * numel(out) * K for dot ops; K from contracting dims of lhs."""
    body = instr.body
    out_elems = sum(_numel(d) for _, d in instr.out_shapes) or 1
    km = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", body)
    ops = _OPERAND_RE.findall(body.split("(", 1)[1]) if "(" in body else []
    k = 1
    if km and ops:
        lhs_shape = operand_shapes.get(ops[0])
        if lhs_shape:
            dims = lhs_shape[0][1]
            for idx in (int(x) for x in km.group(1).split(",") if x):
                if idx < len(dims):
                    k *= dims[idx]
    return 2.0 * out_elems * k


def _operands(i: Instr) -> List[str]:
    if "(" not in i.body:
        return []
    return _OPERAND_RE.findall(i.body.split("(", 1)[1].split(")")[0])


_PARAM_NUM_RE = re.compile(r"parameter\((\d+)\)")


def _instr_bytes(i: Instr, comps: Dict[str, Computation],
                 shapes: Dict[str, List[Tuple[str, List[int]]]]) -> float:
    """HBM bytes for one top-level instruction under XLA's in-place model.

    dynamic-(update-)slice and scatter touch only the slice/updates (the
    big aliased buffer is updated in place) — critical for scanned models
    whose stacked weights / KV caches / ys-accumulators would otherwise be
    charged O(L^2) traffic.  XLA routinely FUSES those slices into consumer
    fusions, so for fusion instructions we inspect the body: an operand that
    is only dynamic-sliced inside is charged at slice size; an operand that
    is the target of a dynamic-update-slice is charged at update size.
    """
    out_b = sum(_nbytes(dt, d) for dt, d in i.out_shapes)
    ops_ = _operands(i)

    def op_bytes(o: str) -> int:
        return sum(_nbytes(dt, d) for dt, d in shapes.get(o, []))

    if i.op == "scatter":
        upd_b = op_bytes(ops_[2]) if len(ops_) > 2 else out_b
        return 3.0 * upd_b
    if i.op == "gather":
        return 2.0 * out_b
    if i.op == "dynamic-slice":
        return 2.0 * out_b
    if i.op == "dynamic-update-slice":
        upd_b = op_bytes(ops_[1]) if len(ops_) > 1 else out_b
        return 3.0 * upd_b

    if i.op != "fusion":
        return float(out_b + sum(op_bytes(o) for o in ops_))

    # ---- fusion: slice-aware operand accounting ---------------------------
    body: Optional[Computation] = None
    for callee in i.called:
        body = comps.get(callee)
        if body is not None:
            break
    if body is None or not body.instrs:
        return float(out_b + sum(op_bytes(o) for o in ops_))

    param_of: Dict[str, int] = {}
    for instr in body.instrs:
        if instr.op == "parameter":
            m = _PARAM_NUM_RE.search(instr.body)
            if m:
                param_of[instr.name] = int(m.group(1))
    # alias pass-through: copy/bitcast/convert/reshape chains keep pointing
    # at the underlying parameter (these ops are layout/dtype plumbing that
    # does not exist on the TPU target for in-place scan buffers)
    for instr in body.instrs:
        if instr.op in ("copy", "bitcast", "convert", "reshape", "transpose"):
            bops = _operands(instr)
            if bops and bops[0] in param_of:
                param_of[instr.name] = param_of[bops[0]]

    charge: Dict[int, float] = {}       # param idx -> bytes override
    dus_update_b = 0.0
    has_dus = False
    for instr in body.instrs:
        bops = _operands(instr)
        if instr.op == "dynamic-slice" and bops and bops[0] in param_of:
            idx = param_of[bops[0]]
            sl = sum(_nbytes(dt, d) for dt, d in instr.out_shapes)
            charge[idx] = charge.get(idx, 0.0) + sl
        elif instr.op == "dynamic-update-slice" and bops and bops[0] in param_of:
            has_dus = True
            idx = param_of[bops[0]]
            upd = op_bytes(bops[1]) if len(bops) > 1 and bops[1] in shapes \
                else sum(_nbytes(dt, d) for dt, d in instr.out_shapes)
            if len(bops) > 1:
                # update operand may itself be a body instr with known shape
                b1 = bops[1]
                if b1 in shapes:
                    upd = op_bytes(b1)
            charge[idx] = charge.get(idx, 0.0) + 2.0 * upd
            dus_update_b += upd
        elif instr.op == "dynamic-update-slice":
            has_dus = True
            dus_update_b += sum(_nbytes(dt, d) for dt, d in instr.out_shapes[:1])

    in_b = 0.0
    for pos, o in enumerate(ops_):
        in_b += charge.get(pos, None) if pos in charge else op_bytes(o)
    if has_dus:
        # the fusion writes only the updated slices (aliased big buffer)
        out_b = max(dus_update_b, 0.0)
    return float(out_b + in_b)


def analyze(text: str, *, entry: Optional[str] = None) -> Dict[str, float]:
    """Corrected totals from compiled (SPMD, per-device) HLO text."""
    comps = parse_hlo(text)
    if not comps:
        return {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0}

    # operand shape lookup per computation (instr name -> shapes)
    shapes: Dict[str, List[Tuple[str, List[int]]]] = {}
    for c in comps.values():
        for i in c.instrs:
            shapes[i.name] = i.out_shapes

    # entry = computation never called by others, preferring one named main*
    called_by = defaultdict(list)
    for c in comps.values():
        for i in c.instrs:
            for callee in i.called:
                if callee in comps:
                    called_by[callee].append(c.name)
    if entry is None:
        roots = [n for n in comps if n not in called_by]
        mains = [n for n in roots if n.startswith("main")]
        entry = mains[0] if mains else (roots[0] if roots else next(iter(comps)))

    # fusion bodies: bytes/flops of *internal* ops follow XLA's model:
    # internal elementwise are free for bytes; dots inside fusions still
    # count flops.  Identify them from fusion instrs' `calls=`.
    fusion_bodies = set()
    for c in comps.values():
        for i in c.instrs:
            if i.op == "fusion":
                for callee in i.called:
                    fusion_bodies.add(callee)

    totals = {"flops": 0.0, "bytes": 0.0, "collective_bytes": 0.0,
              "transcendentals": 0.0}
    per_coll: Dict[str, float] = defaultdict(float)

    # producer index (instr name -> Instr) for collective dtype tracing
    producer: Dict[str, Instr] = {}
    for c in comps.values():
        for i in c.instrs:
            producer[i.name] = i

    SKIP_BYTES_OPS = {"parameter", "constant", "tuple", "get-tuple-element",
                      "bitcast", "while", "conditional", "call", "custom-call",
                      "after-all", "partition-id", "replica-id"}

    seen_stack = set()

    def walk(name: str, mult: float, in_fusion: bool):
        if name not in comps or name in seen_stack:
            return
        seen_stack.add(name)
        c = comps[name]
        for i in c.instrs:
            m = mult * (i.trip_count if i.op == "while" else 1)
            # recurse into called computations
            if i.op in ("while", "conditional", "call", "fusion"):
                sub_fusion = in_fusion or i.op == "fusion"
                for callee in i.called:
                    if i.op == "while":
                        # body and condition both run trip_count times
                        walk(callee, mult * i.trip_count, in_fusion)
                    elif i.op == "conditional":
                        walk(callee, mult, in_fusion)  # upper bound: all branches? take max later
                    else:
                        walk(callee, mult, sub_fusion)
            elif i.called and i.op not in ("all-reduce", "reduce", "scatter",
                                           "reduce-scatter", "reduce-window",
                                           "sort", "map", "select-and-scatter",
                                           "all-to-all"):
                for callee in i.called:
                    walk(callee, mult, in_fusion)

            if i.op in ("dot", "convolution"):
                totals["flops"] += mult * _dot_flops(i, comps, shapes)
            if i.op in COLLECTIVES:
                nb = sum(_nbytes(dt, d) for dt, d in i.out_shapes)
                # XLA:CPU hoists bf16->f32 converts above collectives; on
                # the TPU target the collective runs at the program dtype.
                # Charge at the pre-convert width when the operand is a
                # convert(-fusion) of a narrower tensor.
                ops_c = _operands(i)
                if ops_c:
                    prod = producer.get(ops_c[0])
                    if prod is not None and "convert" in prod.name:
                        pops = _operands(prod)
                        if pops and pops[0] in shapes and shapes[pops[0]]:
                            src_dt = shapes[pops[0]][0][0]
                            out_dt = i.out_shapes[0][0] if i.out_shapes else "f32"
                            sb = DTYPE_BYTES.get(src_dt, 4)
                            ob = DTYPE_BYTES.get(out_dt, 4)
                            if sb < ob:
                                nb = nb * sb / ob
                totals["collective_bytes"] += mult * nb
                per_coll[i.op] += mult * nb

            if not in_fusion and i.op not in SKIP_BYTES_OPS and i.op:
                totals["bytes"] += mult * _instr_bytes(i, comps, shapes)
        seen_stack.discard(name)

    walk(entry, 1.0, False)
    for k, v in per_coll.items():
        totals[f"coll_{k}"] = v
    return totals


def roofline_terms(costs: Dict[str, float], *, n_chips: int,
                   peak_flops: float = 197e12, hbm_bw: float = 819e9,
                   ici_bw: float = 50e9, flops_total_all_chips: bool = False,
                   ) -> Dict[str, float]:
    """Three roofline terms in seconds.  `costs` are per-device (SPMD HLO)."""
    t_compute = costs["flops"] / peak_flops
    t_memory = costs["bytes"] / hbm_bw
    t_coll = costs["collective_bytes"] / ici_bw
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dom[1],
    }


# ---------------------------------------------------------------------------
# (b) The port's extractor: a step's dispatched ops, counted on fake tensors
# ---------------------------------------------------------------------------
_aten = torch.ops.aten

#: allocations: no traffic until something writes them
_ALLOC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
          _aten.new_empty, _aten.new_empty_strided}
#: ops charged at 2x their output (``analyze``'s gather / dynamic-slice)
_GATHER = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
#: updates of part of a buffer, charged at 3x the update
#: (``analyze``'s dynamic-update-slice / scatter): op -> the update's arg index
_UPDATE = {_aten.index_put: 2, _aten.index_put_: 2, _aten._index_put_impl_: 2,
           _aten.slice_scatter: 1, _aten.select_scatter: 1,
           _aten.scatter: 3, _aten.scatter_: 3, _aten.scatter_add: 3,
           _aten.scatter_add_: 3, _aten.scatter_reduce: 3,
           _aten.scatter_reduce_: 3, _aten.index_add: 3, _aten.index_add_: 3,
           _aten.index_copy: 3, _aten.index_copy_: 3}
_TRANSCENDENTAL = {_aten.exp, _aten.exp_, _aten.exp2, _aten.expm1, _aten.log,
                   _aten.log_, _aten.log1p, _aten.log2, _aten.tanh, _aten.tanh_,
                   _aten.sigmoid, _aten.sigmoid_, _aten.rsqrt, _aten.rsqrt_,
                   _aten.sqrt, _aten.sqrt_, _aten.erf, _aten.sin, _aten.cos,
                   _aten._softmax, _aten._log_softmax, _aten.silu, _aten.silu_,
                   _aten.gelu}
#: collectives by op name (``_c10d_functional``: DTensor's; ``c10d``: the
#: ``local_map`` bodies'), under ``analyze``'s kind names; ``None`` is free
#: (the wait on a handle)
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "allreduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "wait_tensor": None,
}


def _kernel_operations(func, args) -> float:
    """The operations a hand-written kernel's op (``repro_torch::``, reached
    on fake CUDA tensors) does, as its roofline bound counts them."""
    if func._opname != "wkv_chunked":
        raise NotImplementedError(f"no operation count for {func}")
    r, chunk = args[0], args[6]
    B, T, H, hs = r.shape
    return _wkv.operations(B, T, H, hs, _wkv.chunk_len(T, chunk))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes_of(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """Every output aliases an input and none is written: metadata only."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


_propagating = [0]


@contextlib.contextmanager
def _marking_propagation():
    """Mark the ops DTensor runs on global-shaped fake tensors to learn an
    output's metadata, so the counter can leave them out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError(f"this torch's ShardingPropagator has no {name}; the "
                           "counter cannot tell DTensor's metadata ops from the step's")

    def marked(self, *args, **kwargs):
        _propagating[0] += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _propagating[0] -= 1
    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class Counter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered, per device (module
    docstring).  Enter it inside a ``FakeTensorMode``; read ``totals()``,
    ``kernels`` (calls of each hand-written kernel's op) and ``peak_bytes``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.kernels: Dict[str, int] = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._marking = None

    def __enter__(self):
        self._marking = _marking_propagation()
        self._marking.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marking.__exit__(*exc)

    def totals(self) -> Dict[str, float]:
        out = {"flops": self.flops, "bytes": self.bytes,
               "collective_bytes": sum(self.coll.values()),
               "transcendentals": self.transcendentals}
        out.update((f"coll_{k}", v) for k, v in self.coll.items())
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor first: local ops come back here
        out = func(*args, **kwargs)
        if not _propagating[0]:
            self._charge(func, args, kwargs, out)
        return out

    def _track(self, ins: List[torch.Tensor], outs: List[torch.Tensor]) -> None:
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _charge(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        if not outs or func.overloadpacket in _ALLOC or _is_view(func):
            if outs and func.overloadpacket in _ALLOC:
                self._track([], outs)
            return
        ins = _tensors((args, kwargs))
        self._track(ins, outs)
        packet = func.overloadpacket
        out_b = sum(_nbytes_of(t) for t in outs)
        if func.namespace in ("_c10d_functional", "c10d"):
            name = func._opname
            if name not in _COLLECTIVE_KIND:
                raise NotImplementedError(f"no collective kind for {func}")
            kind = _COLLECTIVE_KIND[name]
            if kind is None:
                return
            coll_out = outs if func.namespace == "_c10d_functional" else \
                _tensors(out[0] if isinstance(out, (tuple, list)) else out)
            self.coll[kind] += sum(_nbytes_of(t) for t in coll_out)
        elif func.namespace == "repro_torch":
            self.kernels[func._opname] += 1
            self.flops += _kernel_operations(func, args)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if packet in _GATHER:
            self.bytes += 2.0 * out_b
        elif packet in _UPDATE:
            upd = args[_UPDATE[packet]]
            self.bytes += 3.0 * (_nbytes_of(upd) if isinstance(upd, torch.Tensor)
                                 else out_b)
        elif packet is _aten.copy_:
            # the written view twice (read and write, in place) and the source
            self.bytes += 2.0 * _nbytes_of(args[0]) + _nbytes_of(args[1])
        else:
            self.bytes += out_b + sum(_nbytes_of(t) for t in ins)


def fake_mode() -> FakeTensorMode:
    """The fake-tensor mode the extractor runs in.  Constants a module holds
    as real tensors are taken in as fake ones."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def count(fn: Callable, *args: Any, device="cuda") -> Dict[str, float]:
    """``fn(*args)`` run once on fake tensors under a ``Counter``; its totals.

    ``args`` may hold real tensors (taken in as fake ones of the same shape,
    dtype and device) or shape specs (anything with ``shape`` and ``dtype``,
    such as ``models.common.TensorSpec``), made as fake tensors on
    ``device``.  Nothing is allocated on any device."""
    mode = fake_mode()
    with mode:
        fake = [fake_args(a, mode, device) for a in args]
        with Counter() as counter:
            fn(*fake)
    return counter.totals()


def fake_args(tree, mode: FakeTensorMode, device):
    """``tree`` with its tensors made fake tensors of ``mode``: a real tensor
    as one of its shape, dtype and device, a shape spec (``shape`` and
    ``dtype``) as a fake tensor on ``device``."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x if getattr(x, "fake_mode", None) is mode else mode.from_tensor(x)
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return torch.empty(tuple(x.shape), dtype=x.dtype, device=device)
        return x
    return tree_map(one, tree)
