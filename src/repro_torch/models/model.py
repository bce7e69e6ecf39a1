"""Model assembly: decoder-only LM and encoder-decoder.

Port of ``repro/models/model.py`` on one device.  Where the reference scans
over stacked groups of layers, ``LM`` holds one parameter module per layer in
an ``nn.ModuleList`` and runs them in order.  Public API::

    model  = build_model(cfg, ax)                 # structure only
    pds    = model.pds()                          # param descriptors
    model.load_params(init_tree(gen, pds, dtype, device))
    loss, metrics = model.loss(batch)
    logits, cache = model.prefill(batch)
    logits, cache = model.decode(cache, tokens, pos)

A parameter tree is ``{"embed", "final_norm", "layers": (one dict per
layer, ...), "head"}`` (no ``head`` with tied embeddings); ``convert.py``
maps the reference's stacked ``groups``/``tail`` layout onto it.  Caches are
``{"layers": (one dict per layer, ...)}`` with the batch on axis 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    NO_RULES, PD, AxisRules, ParamTree, cross_entropy_loss, rms_norm, softcap,
)
from repro_torch.models.transformer import AUX_KEYS


class LM(nn.Module):
    """Decoder-only LM covering dense / moe / ssm / hybrid / vlm families."""

    def __init__(self, cfg: ModelConfig, ax: AxisRules = NO_RULES,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.cfg = cfg
        self.ax = ax
        self.kinds = cfg.pattern
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

    # --------------------------------------------------------- embeddings --
    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embed[ids.long()]
        if self.cfg.tie_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _inputs_to_x(self, batch) -> torch.Tensor:
        x = self._embed(batch["tokens"])
        if self.cfg.frontend == "patch" and "embeds" in batch:
            x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.rms_eps, zero_centered=True)
        logits = x @ (self.embed.T if cfg.tie_embeddings else self.head)
        return softcap(logits, cfg.final_logit_softcap)

    # ------------------------------------------------------------- stacks --
    def _run_train(self, x, *, causal=True, train=True, memory=None):
        aux = {k: torch.zeros((), dtype=torch.float32, device=x.device)
               for k in AUX_KEYS}
        for kind, p in zip(self.kinds, self.layers):
            x, a = tfm.block_train(self.cfg, kind, p, x, self.ax, causal=causal,
                                   train=train, memory=memory)
            aux = {k: aux[k] + a[k] for k in AUX_KEYS}
        n = max(self.cfg.num_layers, 1)
        return x, {k: v / n for k, v in aux.items()}

    def _run_prefill(self, x, *, cache_len: int, memory=None):
        caches = []
        for kind, p in zip(self.kinds, self.layers):
            x, c = tfm.block_prefill(self.cfg, kind, p, x, self.ax, memory=memory,
                                     cache_len=self.cfg.kv_cache_len(cache_len, kind))
            caches.append(c)
        return x, {"layers": tuple(caches)}

    def _run_decode(self, cache, x, pos):
        caches = []
        for kind, p, c in zip(self.kinds, self.layers, cache["layers"]):
            x, c = tfm.block_decode(self.cfg, kind, p, x, c, pos, self.ax)
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
        loss = cross_entropy_loss(logits, torch.clamp_min(labels, 0), labels >= 0)
        moe_loss = 0.01 * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        metrics = dict(aux)
        metrics["ce_loss"] = loss
        return loss + moe_loss, metrics

    def prefill(self, batch, *, cache_len: Optional[int] = None,
                all_logits: bool = False):
        x = self._inputs_to_x(batch)
        x, cache = self._run_prefill(x, cache_len=cache_len or x.shape[1])
        return self._logits(x if all_logits else x[:, -1:, :]), cache

    def decode(self, cache, tokens, pos):
        x, cache = self._run_decode(cache, self._embed(tokens), pos)
        return self._logits(x), cache

    # ------------------------------------------------------------- shapes --
    def cache_pds(self, batch: int, seq: int, memory_len: int = 0):
        return {"layers": tuple(
            tfm.block_cache_pds(self.cfg, kind, batch, seq, memory_len)
            for kind in self.kinds)}


class EncDec(nn.Module):
    """Encoder-decoder (seamless).  Same step API as LM."""

    def __init__(self, cfg: ModelConfig, ax: AxisRules = NO_RULES,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.cfg = cfg
        self.ax = ax
        enc_cfg = dataclasses.replace(cfg, cross_attention=False,
                                      num_layers=cfg.encoder_layers)
        self.encoder = LM(enc_cfg, ax)
        self.decoder = LM(cfg, ax)
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

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(self.decoder.embed.dtype)
        x, _ = self.encoder._run_train(x, causal=False, train=False)
        return rms_norm(x, self.enc_norm, self.cfg.rms_eps, zero_centered=True)

    def loss(self, batch):
        memory = self.encode(batch["frames"])
        dec = self.decoder
        x, aux = dec._run_train(dec._embed(batch["tokens"]), train=True,
                                memory=memory)
        labels = batch["labels"]
        loss = cross_entropy_loss(dec._logits(x), torch.clamp_min(labels, 0),
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

    def decode(self, cache, tokens, pos):
        dec = self.decoder
        x, cache = dec._run_decode(cache, dec._embed(tokens), pos)
        return dec._logits(x), cache

    def cache_pds(self, batch: int, seq: int, memory_len: int = 0):
        return self.decoder.cache_pds(batch, seq, memory_len or 4096)


def build_model(cfg: ModelConfig, ax: AxisRules = NO_RULES, params=None):
    if cfg.encoder_layers:
        return EncDec(cfg, ax, params)
    return LM(cfg, ax, params)
