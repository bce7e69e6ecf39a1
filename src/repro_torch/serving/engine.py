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
token buffer per prefill bucket.  Each step ``copy_``s its inputs into them.
The engine owns its slot cache, so its decode step hands it over
(``model.decode(..., donate=True)``): each attention layer without a logit
softcap writes its new entry into the slot cache in place and attends with
the hand-written decode attention kernel over each slot's live prefix (on
the CPU, its plain version), returning the slot cache's own tensors.  The
step copies back only what the model returns as new tensors (recurrent
states, and softcapped attention layers).  On the card each prefill's
attention layers without a logit softcap run the hand-written flash
attention kernel over the padded bucket (``models.attention``); on the CPU
they keep the reference's plain core.  On the card each step is captured
once in a CUDA graph and replayed after
(``repro_torch.graphs``): the decode step at the first decode, each prefill
at its bucket's first prefill, the capturing step's own call run eagerly on
a side stream and its result used.  On the CPU, or with ``eager=True`` on
the card, the same steps run uncaptured.

The additions to the reference's interface are ``options``, handed to
``AxisRules(None, options)``: it is how a caller reaches the layers'
execution options, ``{"rwkv_impl": "chunked"}`` among them (the chunked WKV6
kernel); ``eager``; and the engine's own record of its steps, ``step_log``.

``step_log`` holds one dict per step, appended once the step's device work
is synchronised.  Every entry has ``kind`` ("prefill" or "decode"), ``dur``
(seconds of the synchronised step: a prefill's from its input copy to the
synchronise, a decode's from the call to the synchronise, its inputs
already copied), and ``start`` and ``end`` (the whole step, readback and
bookkeeping included, on ``time.perf_counter``'s clock, as
``ServeRequest``'s stamps are).  A decode entry has ``batch`` (the live
slots); a prefill entry ``tokens`` (the prompt's length) and ``queued``
(``start`` less the request's ``submitted``: how long the engine held it).
On the card an entry also carries device seconds, from timing events
recorded where the work runs and read after the step's synchronise (none
added): decode ``device`` (its body, start to end) and ``copyback`` (from
the model's return to the end of the copy of its cache into the slot
cache, an empty interval where nothing is copied back); prefill ``device``
(the bucket's body) and ``slot_copy_device``.  Every entry on the card
also has ``attn_kernel``: the attention kernel launches the step made, one
per attention layer where the kernel's path applies and 0 elsewhere
(``decode_attention`` for a decode step, on the donated path;
``flash_attention`` for a prefill).  A replay reads them from its graph's
own tally, with no synchronise (``repro_torch.graphs``); an eager or
capturing call, as the change in the process-wide count across the call.
Inside a captured step the events are ``external``: each is an event node
of the graph and records at every replay (``repro_torch.graphs``).

While a profiler runs (``torch.autograd._profiler_enabled()``) each host
phase of a step is a range named ``MiniEngine.<kind>.<phase>``, so the
device trace names what the host did in each gap: decode ``inputs`` (the
``tokens`` / ``pos`` copies), ``replay`` (the interval ``dur`` measures),
``readback`` (the logits to the host and their argmax), ``bookkeeping``
(each live slot's token appended, finished slots freed); prefill
``replay`` (the interval ``dur`` measures), ``inputs`` (the bucket's token
copy, inside ``replay``), ``slot_copy`` (the request's cache into its
slot), ``readback`` (the first token's argmax); and ``MiniEngine.submit``.
With no profiler no range is entered.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.graphs import Graphed
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import build_model
from repro_torch.models.common import AxisRules, init_tree, shape_tree, tree_map


@dataclass
class ServeRequest:
    """One request and its life on ``time.perf_counter``'s clock: submitted,
    first token, finished.  ``rid`` is the engine's count of the requests
    submitted to it, unique across ``submit`` calls."""
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    submitted: float = 0.0
    first_token: Optional[float] = None
    finished: Optional[float] = None
    tokens: List[int] = field(default_factory=list)


def _range(phase: str):
    """A host range named ``MiniEngine.<phase>`` while a profiler runs, else
    nothing; with no profiler it costs one flag test.  The range is
    function-scope, named in the trace like an operator: a user-scope
    ``record_function`` would also be projected onto the device's timeline,
    where a trace's reader counts it among the device's operations."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    from torch._C._profiler import _RecordFunctionFast
    return _RecordFunctionFast("MiniEngine." + phase)


class _DeviceMarks:
    """Timing events a step records on the device, by index; ``external``
    ones recorded under capture are event nodes of the graph and record at
    each replay.  ``read(entry, key, a, b)`` stores the seconds between two,
    once the stream has passed both, and nothing where either was never
    recorded (a step body that records none)."""

    def __init__(self, n: int, external: bool):
        self.events = [torch.cuda.Event(enable_timing=True, external=external)
                       for _ in range(n)]
        self.seen = set()

    def record(self, i: int) -> None:
        self.events[i].record()
        self.seen.add(i)

    def read(self, entry: Dict, key: str, a: int, b: int) -> None:
        if a in self.seen and b in self.seen:
            entry[key] = self.events[a].elapsed_time(self.events[b]) / 1e3


def _launches(step, replay: bool, kernel, before: int) -> int:
    """``kernel``'s launches in one call of ``step``: a replay's from its
    graph's tally, an eager or capturing call's as the change in the
    process-wide count from ``before``."""
    return step.tally.get(kernel, 0) if replay else kernel.launches - before


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


class MiniEngine:
    """The served engine: ``submit`` queues requests, ``run`` serves the
    queue to its end; ``step_log`` records every step (module docstring)."""

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
        self._rids = itertools.count()

        # the steps' fixed inputs, and the steps themselves
        self.graphed = self.device.type == "cuda" and not eager
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.int64,
                                  device=self.device)
        self.pos = torch.zeros((max_slots,), dtype=torch.int64, device=self.device)
        self._decode_marks = self._marks(3, external=True)
        self._slot_marks = self._marks(2, external=False)
        self._decode = self._step(self._decode_body)
        self._prefills: Dict[int, tuple] = {}    # bucket -> (tokens, step)
        self._prefill_marks: Dict[int, Optional[_DeviceMarks]] = {}
        # One memory pool for every bucket's graph.  Safe only because each
        # prefill's outputs are used up (copied into the slot, the first
        # token read) before the next prefill replays any of them.
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None

    def _step(self, fn, pool=None):
        """``fn`` captured and replayed on the card, else ``fn`` itself."""
        return Graphed(fn, pool=pool) if self.graphed else fn

    def _marks(self, n: int, external: bool) -> Optional[_DeviceMarks]:
        return _DeviceMarks(n, external) if self.device.type == "cuda" else None

    def _decode_body(self) -> torch.Tensor:
        marks = self._decode_marks
        if marks is not None:
            marks.record(0)
        logits, cache = self.model.decode(self.cache, self.tokens, self.pos,
                                          donate=True)
        if marks is not None:
            marks.record(1)
        for c_all, c_new in zip(self.cache["layers"], cache["layers"]):
            for name, t in c_all.items():
                if c_new[name] is not t:      # written in place: nothing to copy
                    t.copy_(c_new[name])
        if marks is not None:
            marks.record(2)
        return logits

    def _prefill_body(self, tokens: torch.Tensor, marks: Optional[_DeviceMarks]):
        if marks is not None:
            marks.record(0)
        out = self.model.prefill({"tokens": tokens}, cache_len=self.max_seq,
                                 all_logits=True)
        if marks is not None:
            marks.record(1)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- intake --
    def submit(self, prompts: List[np.ndarray], max_new_tokens: int) -> List[ServeRequest]:
        with _range("submit"):
            now = time.perf_counter()
            reqs = [ServeRequest(rid=next(self._rids), prompt=np.asarray(p, np.int32),
                                 max_new_tokens=max_new_tokens, submitted=now)
                    for p in prompts]
            self.waiting.extend(reqs)
        return reqs

    # ----------------------------------------------------------- internals --
    def _prefill(self, req: ServeRequest, slot: int) -> None:
        start = time.perf_counter()
        S = len(req.prompt)
        entry = {"kind": "prefill", "tokens": int(S), "start": start,
                 "queued": start - req.submitted}
        bucket = min(_bucket(S), self.max_seq)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :S] = req.prompt
        if bucket not in self._prefills:
            buf = torch.zeros((1, bucket), dtype=torch.int64, device=self.device)
            marks = self._prefill_marks[bucket] = self._marks(2, external=True)
            self._prefills[bucket] = (buf, self._step(
                functools.partial(self._prefill_body, buf, marks), pool=self._pool))
        buf, step = self._prefills[bucket]
        marks = self._prefill_marks[bucket]
        replay = isinstance(step, Graphed) and step.captured
        launches = flash_attention.launches
        with _range("prefill.replay"):
            t0 = time.perf_counter()
            with _range("prefill.inputs"):
                buf.copy_(torch.from_numpy(toks))
            logits, cache1 = step()
            self._sync()
            entry["dur"] = time.perf_counter() - t0
        self.step_log.append(entry)

        # copy the request's cache into its slot (batch axis 0 of every
        # leaf); eager, since the slot is the host's
        slot_marks = self._slot_marks
        with _range("prefill.slot_copy"):
            if slot_marks is not None:
                slot_marks.record(0)
            for c_all, c_one in zip(self.cache["layers"], cache1["layers"]):
                for name, t in c_all.items():
                    t[slot:slot + 1] = c_one[name].to(t.dtype)
            if slot_marks is not None:
                slot_marks.record(1)
        # the first token comes from the TRUE last prompt position S-1
        # (causal masking makes it independent of the padding)
        with _range("prefill.readback"):
            first = int(np.argmax(logits[0, S - 1].float().cpu().numpy()))
        if marks is not None:       # the readback waited for every event
            marks.read(entry, "device", 0, 1)
            slot_marks.read(entry, "slot_copy_device", 0, 1)
            entry["attn_kernel"] = _launches(step, replay, flash_attention, launches)
        req.first_token = time.perf_counter()
        req.tokens.append(first)
        self.slots[slot] = req
        self.slot_pos[slot] = S
        self.slot_tok[slot] = first
        entry["end"] = time.perf_counter()

    def _admit(self) -> None:
        for i in range(self.max_slots):
            if self.slots[i] is None and self.waiting:
                self._prefill(self.waiting.pop(0), i)

    def _decode_step(self) -> None:
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        entry = {"kind": "decode", "batch": len(active), "start": time.perf_counter()}
        with _range("decode.inputs"):
            self.tokens.copy_(torch.from_numpy(self.slot_tok.astype(np.int64)[:, None]))
            self.pos.copy_(torch.from_numpy(self.slot_pos.astype(np.int64)))
        step = self._decode
        replay = isinstance(step, Graphed) and step.captured
        launches = decode_attention.launches
        with _range("decode.replay"):
            t0 = time.perf_counter()
            logits = step()
            self._sync()
            entry["dur"] = time.perf_counter() - t0
        marks = self._decode_marks
        if marks is not None:
            marks.read(entry, "device", 0, 2)
            marks.read(entry, "copyback", 1, 2)
            entry["attn_kernel"] = _launches(step, replay, decode_attention, launches)
        self.step_log.append(entry)
        with _range("decode.readback"):
            nxt = np.argmax(logits[:, 0].float().cpu().numpy(), axis=-1)
        with _range("decode.bookkeeping"):
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
        entry["end"] = time.perf_counter()

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
