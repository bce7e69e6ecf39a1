"""Mixture-of-Experts layer with expert parallelism.

Port of ``repro/models/moe.py``: a softmax router with top-k gates, a
capacity-padded dispatch (stable sort of the assignments by expert, each
expert's first ``C_e`` kept, the rest dropped GShard-style), batched expert
GEMMs, a gate-weighted combine, and the router's aux metrics.  Empty
capacity slots point at a dump row past the real tokens, as in the
reference, so the scatters are ``index_put_`` and the combine ``index_add_``.

On a mesh the router runs under DTensor propagation, and dispatch, expert
compute and combine run per rank under ``local_map`` (the reference's
``shard_map``), in one of the reference's layouts:

- EP   (E % tp == 0): expert axis sharded over "model"; each rank selects the
  tokens routed to its ``E/tp`` experts (``e_offset = rank * E_l``) from the
  batch shard it holds whole, and the combine is a sum over "model".
- TPFF (E % tp != 0, mixtral's 8 experts on 16 ranks): every rank holds all
  experts with their d_ff sharded over "model"; the same sum combines.
- a2a  (EP, ``moe_dispatch="a2a"`` and S % tp == 0): tokens sharded over
  batch and sequence; each rank ships its assignments to the experts' ranks
  in per-destination capacity buffers with one tiled all-to-all, computes,
  and ships the results back, gates applied at the source.

Capacity is per token shard, so the sharded result equals the one-device
result exactly when no token is dropped.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import PD, AxisRules, activation


def moe_pds(cfg: ModelConfig) -> Dict[str, PD]:
    moe = cfg.moe
    d, ff, E = cfg.d_model, moe.expert_d_ff, moe.num_experts
    p = {
        "router": PD((d, E), ("embed", None), 0.02),
        "w_in": PD((E, d, ff), ("expert", "embed", "mlp")),
        "w_out": PD((E, ff, d), ("expert", "mlp", "embed")),
    }
    if cfg.gated_mlp:
        p["w_gate"] = PD((E, d, ff), ("expert", "embed", "mlp"))
    return p


def _capacity(T_l: int, k: int, E: int, cf: float, *, train: bool) -> int:
    A = T_l * k
    if train:
        return max(1, math.ceil(cf * A / E))
    return min(A, max(16, math.ceil(cf * A / E)))


def _expert_ffn(cfg: ModelConfig, xb, w_in, w_gate, w_out):
    """xb (E_l,C,D) -> (E_l,C,D) via batched expert GEMMs."""
    act = activation(cfg.mlp_act)
    h = torch.bmm(xb, w_in)
    if cfg.gated_mlp:
        h = act(torch.bmm(xb, w_gate)) * h
    else:
        h = act(h)
    return torch.bmm(h, w_out)


def _slots(keys, n: int, cap: int):
    """Capacity slots for assignment ``keys`` in [0, n] (n: not ours).

    A stable sort by key; each key's first ``cap`` assignments take slots
    ``key * cap + position``, the rest (and key n) the dump slot ``n * cap``.
    Returns (order, dst, valid), ``dst`` and ``valid`` in sorted order."""
    A = keys.shape[0]
    order = torch.sort(keys, stable=True).indices
    s_key = keys[order]
    # bincount with its length fixed (keys lie in [0, n]), so the shape
    # does not depend on the data (a fake tensor has none)
    counts = keys.new_zeros(n + 1).scatter_add_(0, keys, torch.ones_like(keys))[:n]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(A, device=keys.device) - starts[torch.clamp_max(s_key, n - 1)]
    valid = (s_key < n) & (pos < cap)
    dst = torch.where(valid, s_key * cap + pos, n * cap)
    return order, dst, valid


def _scatter(n_slots: int, dst, values, fill):
    """A (n_slots,) tensor of ``fill`` with ``values`` written at ``dst``; the
    dump slot ``n_slots`` takes every dropped write and is cut off."""
    out = torch.full((n_slots + 1,), fill, dtype=values.dtype, device=values.device)
    return out.index_put_((dst,), values)[:-1]


def _dispatch_compute_combine(cfg: ModelConfig, x_flat, ids, gates,
                              w_in, w_gate, w_out, *,
                              E_l: int, e_offset: int, C_e: int):
    """Local capacity dispatch -> expert FFN -> combine over the experts
    ``[e_offset, e_offset + E_l)``.

    x_flat (T, D); ids/gates (T, k).  Returns (y (T, D), kept scalar)."""
    T, D = x_flat.shape
    k = ids.shape[-1]
    A = T * k
    flat_ids = ids.reshape(A)
    tok = torch.arange(A, device=x_flat.device) // k
    local = (flat_ids >= e_offset) & (flat_ids < e_offset + E_l)
    le = torch.where(local, flat_ids - e_offset, E_l)

    order, dst, valid = _slots(le, E_l, C_e)
    # slot -> source token (T is the dump row of zeros) and slot -> gate
    slot_src = _scatter(E_l * C_e, dst, tok[order], T)
    slot_gate = _scatter(E_l * C_e, dst, gates.reshape(A)[order], 0)

    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, D))], dim=0)
    xb = x_pad[slot_src].reshape(E_l, C_e, D)
    yb = _expert_ffn(cfg, xb, w_in, w_gate, w_out).reshape(E_l * C_e, D)
    yb = yb * slot_gate[:, None].to(yb.dtype)

    y = x_flat.new_zeros((T + 1, D)).index_add_(0, slot_src, yb)[:T]
    return y, valid.float().sum()


def _a2a_body(cfg: ModelConfig, ax: AxisRules, xs, idss, gatess, w_in, w_gate,
              w_out, *, E_l: int, tp: int, C_r: int, C_e: int):
    """Sequence-sharded EP with all-to-all dispatch (MegaScale-style).

    Each rank routes its own T_ls tokens into per-destination-rank capacity
    buffers, ships them with one tiled all-to-all over "model", computes its
    local experts, and ships the results back.  Gates never travel: the
    return buffer is slot-aligned with the send buffer, so weighting happens
    at the source."""
    D = xs.shape[-1]
    k = idss.shape[-1]
    x_flat = xs.reshape(-1, D)
    T_ls = x_flat.shape[0]
    A = T_ls * k
    flat_ids = idss.reshape(A)
    tok = torch.arange(A, device=xs.device) // k

    # ---- source side: per-destination-rank capacity buffers ---------------
    dest = flat_ids // E_l
    order, dst, valid = _slots(dest, tp, C_r)
    slot_src = _scatter(tp * C_r, dst, tok[order], T_ls)
    slot_gate = _scatter(tp * C_r, dst, gatess.reshape(A)[order], 0)
    slot_eid = _scatter(tp * C_r, dst, (flat_ids % E_l)[order], E_l)

    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, D))], 0)
    xbuf = x_pad[slot_src]                              # (tp * C_r, D)

    # ---- ship tokens and local-expert ids ----------------------------------
    xr = ax.all_to_all(xbuf, "model")
    le = ax.all_to_all(slot_eid, "model")

    # ---- dest side: per-expert capacity buffers + expert FFN --------------
    A_r = tp * C_r
    order2, dst2, valid2 = _slots(le, E_l, C_e)
    eslot_src = _scatter(E_l * C_e, dst2,
                         torch.arange(A_r, device=xs.device)[order2], A_r)
    xr_pad = torch.cat([xr, xr.new_zeros((1, D))], 0)
    xe = xr_pad[eslot_src].reshape(E_l, C_e, D)
    ye = _expert_ffn(cfg, xe, w_in, w_gate, w_out).reshape(E_l * C_e, D)
    yr = xs.new_zeros((A_r + 1, D)).index_add_(0, eslot_src, ye.to(xs.dtype))[:A_r]

    # ---- ship back (slot-aligned) and combine at the source ----------------
    ybuf = ax.all_to_all(yr, "model") * slot_gate[:, None].to(xs.dtype)
    y = xs.new_zeros((T_ls + 1, D)).index_add_(0, slot_src, ybuf)[:T_ls]

    # kept: assignments that found a slot on both sides, summed over the mesh
    kept = valid.float().sum() - ((~valid2) & (le[order2] < E_l)).float().sum()
    return y.reshape(xs.shape), _sum_mesh(ax, kept)


def _sum_mesh(ax: AxisRules, t: torch.Tensor) -> torch.Tensor:
    for axis in ax.mesh.mesh_dim_names:
        t = ax.sum_over(t, axis)
    return t


def _rows(ax: AxisRules, fn, x: torch.Tensor, out_placements):
    """``fn`` on each rank's rows of ``x`` (B, S, ·), pinned (batch, -, -).
    For the router's ops that mix no rows and may have no DTensor sharding
    rule (``topk``, ``index_add_``)."""
    if ax.mesh is None:
        return fn(x)
    x = ax.constrain(x, "batch", None, None)
    return local_map(fn, out_placements=out_placements,
                     in_placements=(x.placements,))(x)


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor, ax: AxisRules, *,
              train: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B,S,D) -> (y (B,S,D), aux metrics incl. load-balance loss)."""
    moe = cfg.moe
    B, S, D = x.shape
    E, k = moe.num_experts, moe.top_k
    cf = moe.capacity_factor_train if train else moe.capacity_factor_eval
    mesh = ax.mesh

    # ---- router under DTensor propagation ---------------------------------
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    rows = (None if mesh is None
            else ax.placements(ax.resolve(("batch", None, None), probs.shape)))
    # topk: row-local, run under local_map on each rank's rows
    gates, ids = _rows(ax, lambda pr: torch.topk(pr, k, dim=-1), probs,
                       (rows, rows))
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    gates = gates.to(x.dtype)

    # load-balance aux (switch-style) + router z-loss.  index_add_ has no
    # DTensor sharding rule: each rank counts its rows, and the counts are a
    # sum still owed (Partial) over the batch axes
    def count(i):
        return torch.zeros((E,), dtype=torch.float32, device=i.device).index_add_(
            0, i.reshape(-1), torch.ones(i.numel(), device=i.device))
    counted = (None if mesh is None else
               tuple(Partial() if isinstance(r, Shard) else r for r in rows))
    count_e = _rows(ax, count, ids, (counted,))
    f_e = count_e / torch.clamp_min(count_e.sum(), 1.0)
    P_e = probs.reshape(-1, E).mean(dim=0)
    lb_loss = E * torch.sum(f_e * P_e)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # ---- dispatch / compute / combine -------------------------------------
    tp = ax.model_size()
    w_in, w_gate, w_out = p["w_in"], p.get("w_gate"), p["w_out"]
    if mesh is None:
        C_e = _capacity(B * S, k, E, cf, train=train)
        y, kept = _dispatch_compute_combine(
            cfg, x.reshape(B * S, D), ids.reshape(B * S, k), gates.reshape(B * S, k),
            w_in, w_gate, w_out, E_l=E, e_offset=0, C_e=C_e)
        y = y.reshape(B, S, D)
    elif tp <= 1:
        # the reference runs the one-device body on the global arrays; here
        # every rank runs it on the whole batch, replicated
        C_e = _capacity(B * S, k, E, cf, train=train)
        rep = (Replicate(),) * mesh.ndim

        def whole(xs, idss, gatess, w_in, w_out, *w_gate):
            y, kept = _dispatch_compute_combine(
                cfg, xs.reshape(B * S, D), idss.reshape(B * S, k),
                gatess.reshape(B * S, k), w_in, w_gate[0] if w_gate else None,
                w_out, E_l=E, e_offset=0, C_e=C_e)
            return y.reshape(B, S, D), kept

        ws = (w_in, w_out) + ((w_gate,) if w_gate is not None else ())
        y, kept = local_map(whole, out_placements=(rep, rep),
                            in_placements=(rep,) * (3 + len(ws)),
                            redistribute_inputs=True)(x, ids, gates, *ws)
    else:
        y, kept = _sharded(cfg, ax, x, ids, gates, w_in, w_gate, w_out,
                           cf=cf, train=train)
        # back to the block's layout (the a2a body leaves the sequence split
        # over "model"): the all-gather at the sequence-reshard boundary
        y = ax.constrain(y, "batch", None, "embed")
    aux = {
        "moe_lb_loss": lb_loss,
        "moe_z_loss": z_loss,
        "moe_drop_frac": 1.0 - kept / float(B * S * k),
        "moe_load_cv": torch.std(count_e, correction=0)
        / torch.clamp_min(torch.mean(count_e), 1e-9),
    }
    return y, aux


def _sharded(cfg: ModelConfig, ax: AxisRules, x, ids, gates, w_in, w_gate,
             w_out, *, cf: float, train: bool):
    """The reference's ``shard_map`` branches of ``moe_apply`` (tp > 1)."""
    mesh = ax.mesh
    B, S, D = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    tp = ax.model_size()
    ep_mode = E % tp == 0
    bspec = ax.batch(B)
    n_b = 1
    for a in (bspec if isinstance(bspec, tuple) else (bspec,) if bspec else ()):
        n_b *= ax.axis_sizes[a]
    T_l = (B // n_b) * S
    E_l = E // tp if ep_mode else E
    C_e = _capacity(T_l, k, E, cf, train=train)
    rep = (Replicate(),) * mesh.ndim
    # EP: expert axis sharded.  TPFF: expert d_ff sharded (w_in on its last
    # axis, w_out on its middle axis).
    w_in_pl = ax.placements(("model", None, None) if ep_mode else (None, None, "model"))
    w_out_pl = ax.placements(("model", None, None) if ep_mode else (None, "model", None))
    if w_gate is None:  # keep the arity static, as the reference does
        w_gate = ax.replicated(torch.zeros((E, 1, 1), dtype=x.dtype, device=x.device))
        gate_pl = ax.placements(("model", None, None) if ep_mode else (None, None, None))
    else:
        gate_pl = w_in_pl

    a2a = ep_mode and S % tp == 0 and ax.opt("moe_dispatch", "psum") == "a2a"
    if a2a:
        tok = ax.placements((bspec, "model", None))
        tok_grad = tok        # every token's gradient comes home
        T_ls = max(T_l // tp, 1)
        body = functools.partial(
            _a2a_body, cfg, ax, E_l=E_l, tp=tp,
            C_r=max(1, math.ceil(cf * T_ls * k / tp)), C_e=C_e)
    else:
        tok = ax.placements((bspec, None, None))
        # each "model" rank adds its experts' (or d_ff slice's) share of the
        # tokens' gradient
        tok_grad = tuple(Partial() if name == "model" else pl
                         for name, pl in zip(mesh.mesh_dim_names, tok))

        def body(xs, idss, gatess, w_in, w_gate, w_out):
            e_off = mesh.get_local_rank("model") * E_l if ep_mode else 0
            y, kept = _dispatch_compute_combine(
                cfg, xs.reshape(-1, D), idss.reshape(-1, k), gatess.reshape(-1, k),
                w_in, w_gate, w_out, E_l=E_l, e_offset=e_off, C_e=C_e)
            y = ax.sum_over(y, "model")
            kept = _sum_mesh(ax, kept)
            if not ep_mode:  # TPFF ranks duplicate the same assignments
                kept = kept / tp
            return y.reshape(xs.shape), kept

    ws = (w_in_pl, gate_pl, w_out_pl)
    return local_map(
        body, out_placements=(tok, rep),
        in_placements=(tok, tok, tok) + ws,
        in_grad_placements=(tok_grad, tok, tok_grad)
        + tuple(ax.grad_placements(w, tok) for w in ws),
        redistribute_inputs=True)(x, ids, gates, w_in, w_gate, w_out)
