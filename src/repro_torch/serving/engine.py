"""MiniEngine: a real (executing) continuous-batching serving engine.

Port of ``repro/serving/engine.py``, the measured system of the paper's
Table-2 protocol, on one device (the card unless ``device="cpu"`` is asked
for; without CUDA the default raises rather than running on the CPU).

Design (vLLM-like, slot-based), as the reference:
- a fixed pool of ``max_slots`` sequence slots with a shared cache;
- prefill runs per request, padded with token 0 to a power-of-two length
  bucket of at least 16, and its cache is copied into the request's slot;
- decode steps run the whole slot pool with per-slot positions;
- slots free on completion; waiting requests are admitted at once.

The bucket padding is kept as the reference has it.  For attention it is
invisible (decode masks the padded positions); a recurrent block (rwkv6,
RG-LRU) carries its state and token shift through the pad tokens, so its
decode starts from a state that has seen them.  The tokens equal the
reference engine's, and equal a plain greedy loop only for prompts whose
length is a bucket.

Where the reference jits its decode step and one prefill per bucket, the
port runs each step on fixed tensors: the slot cache, the decode inputs
``tokens`` (max_slots, 1) and ``pos`` (max_slots,), and one (1, bucket)
token buffer per prefill bucket.  Each step ``copy_``s its inputs into them
and the decode step copies the cache the model returns into the slot cache
(the model returns a new cache, it does not write in place).  On the card
each step is captured once in a CUDA graph and replayed after
(``repro_torch.graphs``): the decode step at the first decode, each prefill
at its bucket's first prefill, the capturing step's own call run eagerly on
a side stream and its result used.  On the CPU, or with ``eager=True`` on
the card, the same steps run uncaptured.

The additions to the reference's interface are ``options``, handed to
``AxisRules(None, options)``: it is how a caller reaches the layers'
execution options, ``{"rwkv_impl": "chunked"}`` among them (the chunked WKV6
kernel); and ``eager``.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.graphs import Graphed
from repro_torch.models import build_model
from repro_torch.models.common import AxisRules, init_tree, shape_tree, tree_map


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    submitted: float = 0.0
    first_token: Optional[float] = None
    finished: Optional[float] = None
    tokens: List[int] = field(default_factory=list)


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


class MiniEngine:
    def __init__(self, cfg: ModelConfig, *, max_slots: int = 8,
                 max_seq: int = 256, seed: int = 0, params=None,
                 dtype=torch.float32, device="cuda",
                 options: Optional[Dict[str, Any]] = None,
                 eager: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MiniEngine runs on the card by default and "
                               "found no CUDA device; pass device='cpu' to "
                               "run on the CPU")
        self.cfg = cfg
        self.ax = AxisRules(None, options)
        self.model = build_model(cfg, self.ax)
        self.max_slots = max_slots
        self.max_seq = max_seq
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_tree(gen, self.model.pds(), dtype, self.device)
        self.params = params
        self.model.load_params(params)
        self.cache = tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
            shape_tree(self.model.cache_pds(max_slots, max_seq), dtype))
        self.slots: List[Optional[ServeRequest]] = [None] * max_slots
        self.slot_pos = np.zeros(max_slots, np.int32)   # next write position
        self.slot_tok = np.zeros(max_slots, np.int32)   # last emitted token
        self.waiting: List[ServeRequest] = []
        self.step_log: List[Dict] = []

        # the steps' fixed inputs, and the steps themselves
        self.graphed = self.device.type == "cuda" and not eager
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.int64,
                                  device=self.device)
        self.pos = torch.zeros((max_slots,), dtype=torch.int64, device=self.device)
        self._decode = self._step(self._decode_body)
        self._prefills: Dict[int, tuple] = {}    # bucket -> (tokens, step)
        # One memory pool for every bucket's graph.  Safe only because each
        # prefill's outputs are used up (copied into the slot, the first
        # token read) before the next prefill replays any of them.
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None

    def _step(self, fn, pool=None):
        """``fn`` captured and replayed on the card, else ``fn`` itself."""
        return Graphed(fn, pool=pool) if self.graphed else fn

    def _decode_body(self) -> torch.Tensor:
        logits, cache = self.model.decode(self.cache, self.tokens, self.pos)
        for c_all, c_new in zip(self.cache["layers"], cache["layers"]):
            for name, t in c_all.items():
                t.copy_(c_new[name])
        return logits

    def _prefill_body(self, tokens: torch.Tensor):
        return self.model.prefill({"tokens": tokens}, cache_len=self.max_seq,
                                  all_logits=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- intake --
    def submit(self, prompts: List[np.ndarray], max_new_tokens: int) -> List[ServeRequest]:
        now = time.perf_counter()
        reqs = [ServeRequest(rid=i, prompt=np.asarray(p, np.int32),
                             max_new_tokens=max_new_tokens, submitted=now)
                for i, p in enumerate(prompts)]
        self.waiting.extend(reqs)
        return reqs

    # ----------------------------------------------------------- internals --
    def _prefill(self, req: ServeRequest, slot: int) -> None:
        S = len(req.prompt)
        bucket = min(_bucket(S), self.max_seq)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :S] = req.prompt
        if bucket not in self._prefills:
            buf = torch.zeros((1, bucket), dtype=torch.int64, device=self.device)
            self._prefills[bucket] = (buf, self._step(
                functools.partial(self._prefill_body, buf), pool=self._pool))
        buf, step = self._prefills[bucket]
        t0 = time.perf_counter()
        buf.copy_(torch.from_numpy(toks))
        logits, cache1 = step()
        self._sync()
        dt = time.perf_counter() - t0
        self.step_log.append({"kind": "prefill", "tokens": int(S), "dur": dt})

        # copy the request's cache into its slot (batch axis 0 of every
        # leaf); eager, since the slot is the host's
        for c_all, c_one in zip(self.cache["layers"], cache1["layers"]):
            for name, t in c_all.items():
                t[slot:slot + 1] = c_one[name].to(t.dtype)
        # the first token comes from the TRUE last prompt position S-1
        # (causal masking makes it independent of the padding)
        first = int(np.argmax(logits[0, S - 1].float().cpu().numpy()))
        req.first_token = time.perf_counter()
        req.tokens.append(first)
        self.slots[slot] = req
        self.slot_pos[slot] = S
        self.slot_tok[slot] = first

    def _admit(self) -> None:
        for i in range(self.max_slots):
            if self.slots[i] is None and self.waiting:
                self._prefill(self.waiting.pop(0), i)

    def _decode_step(self) -> None:
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        self.tokens.copy_(torch.from_numpy(self.slot_tok.astype(np.int64)[:, None]))
        self.pos.copy_(torch.from_numpy(self.slot_pos.astype(np.int64)))
        t0 = time.perf_counter()
        logits = self._decode()
        self._sync()
        dt = time.perf_counter() - t0
        self.step_log.append({"kind": "decode", "batch": len(active), "dur": dt})
        nxt = np.argmax(logits[:, 0].float().cpu().numpy(), axis=-1)
        now = time.perf_counter()
        for i in active:
            req = self.slots[i]
            req.tokens.append(int(nxt[i]))
            self.slot_pos[i] += 1
            self.slot_tok[i] = int(nxt[i])
            if (len(req.tokens) >= req.max_new_tokens
                    or self.slot_pos[i] >= self.max_seq - 1):
                req.finished = now
                self.slots[i] = None

    # ---------------------------------------------------------------- run --
    @torch.no_grad()
    def run(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        served: List[ServeRequest] = list(self.waiting)
        while self.waiting or any(s is not None for s in self.slots):
            self._admit()
            self._decode_step()
        dur = time.perf_counter() - t0
        toks = sum(len(r.tokens) for r in served)
        ttfts = [r.first_token - r.submitted for r in served if r.first_token]
        tpots = [(r.finished - r.first_token) / max(len(r.tokens) - 1, 1)
                 for r in served if r.finished and r.first_token]
        return {
            "n_requests": len(served),
            "output_tokens": toks,
            "duration_s": dur,
            "throughput_tok_s": toks / dur,
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else float("nan"),
            "tpot_mean_s": float(np.mean(tpots)) if tpots else float("nan"),
            "decode_steps": sum(1 for s in self.step_log if s["kind"] == "decode"),
        }
