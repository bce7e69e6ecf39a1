"""Model assembly: decoder-only LM and encoder-decoder.

Port of ``repro/models/model.py``.  Where the reference scans
over stacked groups of layers, ``LM`` holds one parameter module per layer in
an ``nn.ModuleList`` and runs them in order.  Public API::

    model  = build_model(cfg, ax, remat="none")   # structure only
    pds    = model.pds()                          # param descriptors
    model.load_params(init_tree(gen, pds, dtype, device))
    loss, metrics = model.loss(batch)
    model.requires_grad_(True); loss.backward()   # training (frozen by default)
    logits, cache = model.prefill(batch)
    logits, cache = model.decode(cache, tokens, pos)

A parameter tree is ``{"embed", "final_norm", "layers": (one dict per
layer, ...), "head"}`` (no ``head`` with tied embeddings); ``convert.py``
maps the reference's stacked ``groups``/``tail`` layout onto it.  Caches are
``{"layers": (one dict per layer, ...)}`` with the batch on axis 0.

On a mesh (``AxisRules(mesh)``) the parameters are DTensors placed by
``convert.shard_params`` and a batch is placed ``Shard(0)`` over the batch
axes (``launch.lowering.place_batch``); the embedding lookup is vocab-sharded
(a local gather and a sum over "model" under ``local_map``) and embeddings
and logits are pinned where the reference pins them.

``remat`` mirrors the reference's rematerialisation of each scanned group
(one period of ``block_pattern``; the layers past the last whole period run
plain): ``"full"`` recomputes a group's forward in backward
(``torch.utils.checkpoint``); ``"dots"`` keeps the outputs of the products
with no batch dimensions and recomputes the rest, as JAX's
``dots_with_no_batch_dims_saveable``.  It changes memory, never values.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    NO_RULES, PD, AxisRules, ParamTree, TensorSpec, rms_norm, softcap,
)
from repro_torch.models.transformer import AUX_KEYS

REMAT = ("none", "full", "dots")


def _save_dots(ctx, op, *args, **kwargs):
    """Keep products with no batch dimensions: ``mm``, and ``bmm`` over a
    batch of one, which is what ``einsum`` lowers a projection to.
    Attention's and the experts' batched products are recomputed."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _save_dots)


class LM(nn.Module):
    """Decoder-only LM covering dense / moe / ssm / hybrid / vlm families."""

    def __init__(self, cfg: ModelConfig, ax: AxisRules = NO_RULES,
                 params: Optional[Dict[str, Any]] = None, *,
                 remat: str = "none"):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        self.cfg = cfg
        self.ax = ax
        self.remat = remat
        self.kinds = cfg.pattern
        self.period = len(cfg.block_pattern)
        self.layers = nn.ModuleList()
        if params is not None:
            self.load_params(params)

    # ------------------------------------------------------------ params --
    def pds(self) -> Dict[str, Any]:
        cfg = self.cfg
        tree: Dict[str, Any] = {
            "embed": PD((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), 0.02),
            "final_norm": PD((cfg.d_model,), ("embed",), "zeros"),
            "layers": tuple(tfm.block_pds(cfg, kind) for kind in self.kinds),
        }
        if not cfg.tie_embeddings:
            tree["head"] = PD((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), 0.02)
        return tree

    def load_params(self, tree: Dict[str, Any]) -> None:
        """Hold ``tree``'s tensors (not copies) as this module's parameters.
        An encoder stack's tree has ``layers`` only."""
        if len(tree["layers"]) != len(self.kinds):
            raise ValueError(f"{len(tree['layers'])} layers given, "
                             f"{self.cfg.name} has {len(self.kinds)}")
        for name in ("embed", "final_norm", "head"):
            if name in tree:
                setattr(self, name, nn.Parameter(tree[name], requires_grad=False))
        self.layers = nn.ModuleList(ParamTree(t) for t in tree["layers"])

    def param_tree(self) -> Dict[str, Any]:
        """The parameters this module holds, in the layout of ``pds()``."""
        def tree(mod):
            out = {n: p for n, p in mod._parameters.items()}
            out.update((n, tree(m)) for n, m in mod._modules.items())
            return out

        out = {n: getattr(self, n) for n in ("embed", "final_norm")
               if n in self._parameters}
        out["layers"] = tuple(tree(p) for p in self.layers)
        if "head" in self._parameters:
            out["head"] = self.head
        return out

    # --------------------------------------------------------- embeddings --
    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Megatron-style vocab-sharded lookup (local gather + sum over
        "model"); a plain gather on one device or when the padded vocab
        does not divide over "model"."""
        cfg, ax = self.cfg, self.ax
        ids = ids.long()
        tp = ax.model_size()
        if ax.mesh is None or tp <= 1 or cfg.padded_vocab % tp != 0:
            x = self.embed[ax.replicated(ids)]
        else:
            Vl = cfg.padded_vocab // tp
            mesh = ax.mesh

            def body(e_l, ids_l):
                loc = ids_l - mesh.get_local_rank("model") * Vl
                ok = (loc >= 0) & (loc < Vl)
                g = e_l[torch.clamp(loc, 0, Vl - 1)]
                g = torch.where(ok[..., None], g, torch.zeros((), dtype=g.dtype,
                                                              device=g.device))
                return ax.sum_over(g, "model")

            e_pl = ax.placements(("model", None))
            ids_pl = ax.placements((ax.batch(ids.shape[0]), None))
            x = local_map(
                body, out_placements=(ax.placements((ax.batch(ids.shape[0]),
                                                     None, None)),),
                in_placements=(e_pl, ids_pl),
                in_grad_placements=(ax.grad_placements(e_pl, ids_pl), ids_pl),
                redistribute_inputs=True)(self.embed, ax.replicated(ids))
        if cfg.tie_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return ax.constrain(x, "batch", None, "embed")

    def _inputs_to_x(self, batch) -> torch.Tensor:
        x = self._embed(batch["tokens"])
        if self.cfg.frontend == "patch" and "embeds" in batch:
            pe = self.ax.constrain(batch["embeds"].to(x.dtype), "batch", None, "embed")
            x = torch.cat([pe, x], dim=1)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.rms_eps, zero_centered=True)
        logits = x @ (self.embed.T if cfg.tie_embeddings else self.head)
        logits = softcap(logits, cfg.final_logit_softcap)
        return self.ax.constrain(logits, "batch", None, "vocab")

    # ------------------------------------------------------------- stacks --
    def _run_train(self, x, *, causal=True, train=True, memory=None):
        def group(x, kinds, layers):
            aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                   for k in AUX_KEYS}
            for kind, p in zip(kinds, layers):
                x, a = tfm.block_train(self.cfg, kind, p, x, self.ax,
                                       causal=causal, train=train, memory=memory)
                aux = {k: aux[k] + a[k] for k in AUX_KEYS}
            return x, aux

        run = group
        if self.remat != "none" and train and torch.is_grad_enabled():
            run = functools.partial(
                checkpoint, group, use_reentrant=False,
                context_fn=_DOTS_CONTEXT if self.remat == "dots" else noop_context_fn)

        total = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                 for k in AUX_KEYS}
        for g0 in range(0, len(self.kinds), self.period):
            g1 = min(g0 + self.period, len(self.kinds))
            # a whole period is one of the reference's scanned groups; the
            # tail past the last one runs plain
            fn = run if g1 - g0 == self.period else group
            x, aux = fn(x, self.kinds[g0:g1], self.layers[g0:g1])
            total = {k: total[k] + aux[k] for k in AUX_KEYS}
        n = max(self.cfg.num_layers, 1)
        return x, {k: v / n for k, v in total.items()}

    def _run_prefill(self, x, *, cache_len: int, memory=None):
        caches = []
        for kind, p in zip(self.kinds, self.layers):
            x, c = tfm.block_prefill(self.cfg, kind, p, x, self.ax, memory=memory,
                                     cache_len=self.cfg.kv_cache_len(cache_len, kind))
            caches.append(c)
        return x, {"layers": tuple(caches)}

    def _run_decode(self, cache, x, pos, donate: bool = False):
        caches = []
        for kind, p, c in zip(self.kinds, self.layers, cache["layers"]):
            x, c = tfm.block_decode(self.cfg, kind, p, x, c, pos, self.ax,
                                    donate=donate)
            caches.append(c)
        return x, {"layers": tuple(caches)}

    # -------------------------------------------------------------- steps --
    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self._inputs_to_x(batch)
        x, aux = self._run_train(x, train=True)
        logits = self._logits(x)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:  # vlm: loss on text tail only
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        loss = self._sharded_ce(logits, torch.clamp_min(labels, 0), labels >= 0)
        moe_loss = 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        metrics = dict(aux)
        metrics["ce_loss"] = loss
        return loss + moe_loss, metrics

    def _sharded_ce(self, logits, labels, mask) -> torch.Tensor:
        """Mean token NLL in f32 over vocab-sharded logits without a gather:
        the label's logit is picked by comparing with an iota, as the
        reference does (``cross_entropy_loss``'s value, to the bit)."""
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        iota = self.ax.replicated(torch.arange(lf.shape[-1], device=lf.device))
        picked = torch.sum(torch.where(iota == labels.long()[..., None], lf, 0.0),
                           dim=-1)
        m = mask.float()
        return torch.sum((lse - picked) * m) / torch.clamp_min(torch.sum(m), 1.0)

    def prefill(self, batch, *, cache_len: Optional[int] = None,
                all_logits: bool = False):
        x = self._inputs_to_x(batch)
        x, cache = self._run_prefill(x, cache_len=cache_len or x.shape[1])
        return self._logits(x if all_logits else x[:, -1:, :]), cache

    def decode(self, cache, tokens, pos, donate: bool = False):
        """One token a row against ``cache``; ``donate`` hands the cache
        over, to be written in place where a layer can
        (``attention.attention_decode``).  -> (logits, cache)."""
        x, cache = self._run_decode(cache, self._embed(tokens), pos, donate)
        return self._logits(x), cache

    # ------------------------------------------------------------- shapes --
    def cache_pds(self, batch: int, seq: int, memory_len: int = 0):
        return {"layers": tuple(
            tfm.block_cache_pds(self.cfg, kind, batch, seq, memory_len)
            for kind in self.kinds)}

    def input_specs(self, shape: ShapeConfig) -> Dict[str, TensorSpec]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind in ("train", "prefill"):
            out = {"tokens": TensorSpec((B, S), i32)}
            if cfg.frontend == "patch":
                Sp = int(S * cfg.frontend_fraction)
                out = {"tokens": TensorSpec((B, S - Sp), i32),
                       "embeds": TensorSpec((B, Sp, cfg.d_model), torch.bfloat16)}
            if shape.kind == "train":
                out["labels"] = TensorSpec((B, S), i32)
            return out
        return {"tokens": TensorSpec((B, 1), i32)}


class EncDec(nn.Module):
    """Encoder-decoder (seamless).  Same step API as LM."""

    def __init__(self, cfg: ModelConfig, ax: AxisRules = NO_RULES,
                 params: Optional[Dict[str, Any]] = None, *,
                 remat: str = "none"):
        super().__init__()
        self.cfg = cfg
        self.ax = ax
        enc_cfg = dataclasses.replace(cfg, cross_attention=False,
                                      num_layers=cfg.encoder_layers)
        self.encoder = LM(enc_cfg, ax, remat=remat)
        self.decoder = LM(cfg, ax, remat=remat)
        if params is not None:
            self.load_params(params)

    def pds(self):
        enc = self.encoder.pds()
        return {
            "enc": {"layers": enc["layers"],
                    "norm": PD((self.cfg.d_model,), ("embed",), "zeros")},
            "dec": self.decoder.pds(),
        }

    def load_params(self, tree) -> None:
        self.encoder.load_params({"layers": tree["enc"]["layers"]})
        self.enc_norm = nn.Parameter(tree["enc"]["norm"], requires_grad=False)
        self.decoder.load_params(tree["dec"])

    def param_tree(self) -> Dict[str, Any]:
        return {"enc": {"layers": self.encoder.param_tree()["layers"],
                        "norm": self.enc_norm},
                "dec": self.decoder.param_tree()}

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        x = self.ax.constrain(frames.to(self.decoder.embed.dtype),
                              "batch", None, "embed")
        x, _ = self.encoder._run_train(x, causal=False, train=False)
        return rms_norm(x, self.enc_norm, self.cfg.rms_eps, zero_centered=True)

    def loss(self, batch):
        memory = self.encode(batch["frames"])
        dec = self.decoder
        x, aux = dec._run_train(dec._embed(batch["tokens"]), train=True,
                                memory=memory)
        labels = batch["labels"]
        loss = dec._sharded_ce(dec._logits(x), torch.clamp_min(labels, 0),
                               labels >= 0)
        metrics = dict(aux)
        metrics["ce_loss"] = loss
        return loss, metrics

    def prefill(self, batch, *, cache_len: Optional[int] = None,
                all_logits: bool = False):
        memory = self.encode(batch["frames"])
        dec = self.decoder
        x = dec._embed(batch["tokens"])
        x, cache = dec._run_prefill(x, cache_len=cache_len or x.shape[1],
                                    memory=memory)
        return dec._logits(x if all_logits else x[:, -1:, :]), cache

    def decode(self, cache, tokens, pos, donate: bool = False):
        dec = self.decoder
        x, cache = dec._run_decode(cache, dec._embed(tokens), pos, donate)
        return dec._logits(x), cache

    def cache_pds(self, batch: int, seq: int, memory_len: int = 0):
        return self.decoder.cache_pds(batch, seq, memory_len or 4096)

    def input_specs(self, shape: ShapeConfig) -> Dict[str, TensorSpec]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        frames = TensorSpec((B, S, cfg.frontend_dim), torch.float32)
        if shape.kind == "train":
            return {"frames": frames, "tokens": TensorSpec((B, S), i32),
                    "labels": TensorSpec((B, S), i32)}
        if shape.kind == "prefill":
            return {"frames": frames, "tokens": TensorSpec((B, 1024), i32)}
        return {"tokens": TensorSpec((B, 1), i32)}


def build_model(cfg: ModelConfig, ax: AxisRules = NO_RULES, params=None, *,
                remat: str = "none"):
    if cfg.encoder_layers:
        return EncDec(cfg, ax, params, remat=remat)
    return LM(cfg, ax, params, remat=remat)
