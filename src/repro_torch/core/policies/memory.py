"""KV-cache memory subsystem: managers, preemption policy, transfer plans.

The decode cluster's ClusterScheduler tracks memory through a
:class:`KVCacheManager`; ``free`` events trigger MEMORY_AVAILABLE signals to
the GlobalController — the backpressure mechanism of PD disaggregation.

Three managers are registered (``MEMORY`` / :func:`resolve_memory`,
mirroring the batching/routing/scheduler registries):

- ``"paged"`` — vLLM-style paged allocator: fixed-size token blocks per
  request, watermark-guarded admission AND growth (decode growth must not
  silently drain the reserve admission keeps).
- ``"prefix"`` — radix-style prefix cache on top of the paged allocator:
  requests carrying a ``prefix_id`` share the whole blocks of their common
  prefix (ref-counted); completed prefixes stay cached cold and are evicted
  LRU under pressure.  A hit advances ``Request.prefill_progress`` so the
  batching policies skip the cached prefill compute, and the manager
  reports hit-token fractions.
- ``"monolithic"`` — TensorRT-LLM-v1-style contiguous allocation: each
  request reserves its full ``prompt_len + output_len`` bound up front
  (``max_len`` is only the fallback when no bound is known).

Every manager also carries the *preemption policy* for the replicas using
it: ``preemption="recompute"`` drops the KV and re-prefills the full
context through an entry cluster; ``preemption="swap"`` moves the KV to
host memory over ``swap_bw`` and restores it in place when blocks free.

:class:`KVTransferPlan` prices layer-wise streamed KV transfer between
clusters (DistServe/MegaScale discipline): per-layer chunks pipeline over
the link while later prefill layers still compute, so only the exposed
tail delays the decode handoff.  ``overlap=0`` reproduces the legacy
lump-sum pricing bit-for-bit.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

PREEMPTION_MODES = ("recompute", "swap")


class KVCacheManager:
    """Block-granular KV accounting shared by every manager.

    The base implementation IS the paged allocator; subclasses refine the
    reservation rule (monolithic) or add block sharing (prefix cache).
    """

    name = "base"

    def __init__(self, total_bytes: float, kv_bytes_per_token: float, *,
                 block_tokens: int = 16, watermark: float = 0.02,
                 preemption: str = "recompute", swap_bw: float = 32e9):
        if preemption not in PREEMPTION_MODES:
            raise ValueError(f"preemption must be one of {PREEMPTION_MODES}, "
                             f"got {preemption!r}")
        self.block_tokens = block_tokens
        self.kv_bytes_per_token = kv_bytes_per_token
        self.block_bytes = kv_bytes_per_token * block_tokens
        self.total_blocks = int(total_bytes // max(self.block_bytes, 1))
        self.free_blocks = self.total_blocks
        self.watermark_blocks = int(self.total_blocks * watermark)
        self.preemption = preemption
        self.swap_bw = swap_bw
        self._held: Dict[int, int] = {}   # rid -> unique blocks
        # observability
        self.peak_used_blocks = 0
        self.hit_tokens = 0
        self.prompt_tokens = 0
        self.evictions = 0
        self.evicted_blocks = 0

    # ----------------------------------------------------------- sizing --
    def blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_tokens))

    def _floor(self, ignore_watermark: bool) -> int:
        return 0 if ignore_watermark else self.watermark_blocks

    def _track_peak(self) -> None:
        used = self.total_blocks - self.free_blocks
        if used > self.peak_used_blocks:
            self.peak_used_blocks = used

    # --------------------------------------------------------- admission --
    def can_admit(self, tokens: int, max_tokens: Optional[int] = None) -> bool:
        return (self.free_blocks - self.blocks_for(tokens)
                >= self.watermark_blocks)

    def admit(self, rid: int, tokens: int, *,
              max_tokens: Optional[int] = None,
              ignore_watermark: bool = False) -> bool:
        need = self.blocks_for(tokens)
        if self.free_blocks - need < self._floor(ignore_watermark):
            return False
        self.free_blocks -= need
        self._held[rid] = need
        self._track_peak()
        return True

    def admit_request(self, r) -> bool:
        """Admit a request's (possibly restored) prefill context.

        Subclasses may use the request's prefix identity here; the base
        manager reserves blocks for ``prefill_total`` tokens with the
        per-request ``prompt_len + output_len`` bound for managers that
        reserve up front.
        """
        return self.admit(r.rid, r.prefill_total,
                          max_tokens=r.prompt_len + r.output_len)

    def prefix_hit(self, r) -> int:
        """Cached-prefix tokens this request would skip (0 for non-sharing
        managers); a probe only — ``admit_request`` applies the hit."""
        return 0

    # ------------------------------------------------------------ growth --
    def grow(self, rid: int, new_tokens: int, *,
             ignore_watermark: bool = False) -> bool:
        """Ensure rid holds enough blocks for new total token count.

        Honors the same watermark reserve as ``admit`` — decode growth must
        not silently drain the headroom admission keeps; replicas may pass
        ``ignore_watermark=True`` as a last resort before preempting the
        only resident request.
        """
        need = self.blocks_for(new_tokens)
        have = self._held.get(rid, 0)
        if need <= have:
            return True
        extra = need - have
        if self.free_blocks - extra < self._floor(ignore_watermark):
            return False
        self.free_blocks -= extra
        self._held[rid] = need
        self._track_peak()
        return True

    # ----------------------------------------------------------- release --
    def free(self, rid: int, *, insert: bool = True,
             full_extent: bool = True) -> int:
        """Release rid's blocks.  ``insert=False`` (replica failure, swap)
        tells sharing managers not to cache the request's prefix;
        ``full_extent=False`` (recompute preemption) caps the cached fold
        at the declared shared prefix instead of everything computed."""
        blocks = self._held.pop(rid, 0)
        self.free_blocks += blocks
        assert self.free_blocks <= self.total_blocks
        return blocks

    def holds(self, rid: int) -> bool:
        return rid in self._held

    # -------------------------------------------------------------- swap --
    def swap_time(self, tokens: int) -> float:
        """Host<->device KV movement time for a preempt/restore swap."""
        if not self.swap_bw:
            return 0.0
        return tokens * self.kv_bytes_per_token / self.swap_bw

    # ------------------------------------------------------------- state --
    @property
    def utilization(self) -> float:
        if self.total_blocks == 0:
            return 1.0
        return 1.0 - self.free_blocks / self.total_blocks

    @property
    def peak_utilization(self) -> float:
        if self.total_blocks == 0:
            return 1.0
        return self.peak_used_blocks / self.total_blocks

    @property
    def prefix_hit_rate(self) -> float:
        if not self.prompt_tokens:
            return 0.0
        return self.hit_tokens / self.prompt_tokens

    def held_blocks(self) -> int:
        return sum(self._held.values())

    def cached_blocks(self) -> int:
        return 0


class PagedKVManager(KVCacheManager):
    """vLLM-style paged allocator: fixed-size token blocks per request."""

    name = "paged"


class _PrefixEntry:
    __slots__ = ("blocks", "refs", "lru")

    def __init__(self, blocks: int = 0, refs: int = 0, lru: int = 0):
        self.blocks = blocks
        self.refs = refs
        self.lru = lru


class PrefixCachingKVManager(KVCacheManager):
    """Radix-style prefix cache over the paged allocator.

    Requests tagged with a ``prefix_id`` share the whole blocks of their
    common prefix: on admission the cached portion counts as already
    prefilled (``Request.prefill_progress`` advances past it, capped one
    token short so the first output token is still computed), and only the
    unique suffix allocates fresh blocks.  When a request frees, its prefix
    blocks are folded into the cache (cold, ref-count 0) instead of
    returning to the free pool; cold prefixes are evicted LRU whenever an
    allocation needs the space.
    """

    name = "prefix"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._prefix: Dict[int, _PrefixEntry] = {}
        self._refs: Dict[int, Tuple[int, int]] = {}    # rid -> (pid, blocks)
        self._insert: Dict[int, Tuple[int, int]] = {}  # rid -> (pid, declared)
        self._extent: Dict[int, int] = {}              # rid -> computed toks
        self._clock = itertools.count(1)

    # ---------------------------------------------------------- eviction --
    def _cold_blocks(self) -> int:
        return sum(e.blocks for e in self._prefix.values() if e.refs == 0)

    def _evict_one(self, protect: Optional[int]) -> bool:
        victim, best = None, None
        for pid, e in self._prefix.items():
            if e.refs or pid == protect or not e.blocks:
                continue
            if best is None or e.lru < best:
                victim, best = pid, e.lru
        if victim is None:
            return False
        entry = self._prefix.pop(victim)
        self.free_blocks += entry.blocks
        self.evictions += 1
        self.evicted_blocks += entry.blocks
        return True

    def _reserve(self, n: int, *, protect: Optional[int] = None,
                 ignore_watermark: bool = False) -> bool:
        floor = self._floor(ignore_watermark)
        while self.free_blocks - n < floor:
            if not self._evict_one(protect):
                break
        return self.free_blocks - n >= floor

    # --------------------------------------------------------- admission --
    def _hit_blocks(self, r) -> Tuple[Optional[int], int]:
        pid = r.prefix_id
        if pid is None:
            return None, 0
        # cap one token short of the prefill target: the last prompt token
        # must be computed to emit the first output token
        plen = min(r.prefix_len, max(r.prefill_total - 1, 0))
        entry = self._prefix.get(pid)
        hit = min(entry.blocks, plen // self.block_tokens) \
            if entry is not None else 0
        return pid, hit

    def prefix_hit(self, r) -> int:
        return self._hit_blocks(r)[1] * self.block_tokens

    def can_admit(self, tokens: int, max_tokens: Optional[int] = None) -> bool:
        # cold cached prefixes are reclaimable on demand
        return (self.free_blocks + self._cold_blocks()
                - self.blocks_for(tokens) >= self.watermark_blocks)

    def admit(self, rid: int, tokens: int, *,
              max_tokens: Optional[int] = None,
              ignore_watermark: bool = False) -> bool:
        need = self.blocks_for(tokens)
        if not self._reserve(need, ignore_watermark=ignore_watermark):
            return False
        self.free_blocks -= need
        self._held[rid] = need
        self._track_peak()
        return True

    def admit_request(self, r) -> bool:
        pid, hit = self._hit_blocks(r)
        if pid is None:
            ok = self.admit(r.rid, r.prefill_total,
                            max_tokens=r.prompt_len + r.output_len)
            if ok and not r.restore_pending:
                self.prompt_tokens += r.prefill_total
            return ok
        unique = max(self.blocks_for(r.prefill_total) - hit, 0)
        if not self._reserve(unique, protect=pid):
            return False
        self.free_blocks -= unique
        self._held[r.rid] = unique
        self._track_peak()
        if hit:
            entry = self._prefix[pid]
            entry.refs += 1
            entry.lru = next(self._clock)
            self._refs[r.rid] = (pid, hit)
            hit_toks = hit * self.block_tokens
            if hit_toks > r.prefill_progress:
                r.prefill_progress = hit_toks
            if not r.restore_pending:
                self.hit_tokens += hit_toks
        self._insert[r.rid] = (pid, min(r.prefix_len, r.prefill_total))
        self._extent[r.rid] = r.prefill_total
        if not r.restore_pending:
            # recompute-restore re-admissions still *use* their own cached
            # prefix (the compute saving is real) but are excluded from the
            # hit-rate stat: prefix_hit_token_frac measures cross-request
            # sharing, not preemption churn
            self.prompt_tokens += r.prefill_total
        return True

    # ------------------------------------------------------------ growth --
    def grow(self, rid: int, new_tokens: int, *,
             ignore_watermark: bool = False) -> bool:
        ref = self._refs.get(rid, (None, 0))[1]
        need = max(self.blocks_for(new_tokens) - ref, 0)
        have = self._held.get(rid, 0)
        if need <= have:
            return True
        extra = need - have
        if not self._reserve(extra, ignore_watermark=ignore_watermark):
            return False
        self.free_blocks -= extra
        self._held[rid] = need
        if rid in self._extent and new_tokens > self._extent[rid]:
            self._extent[rid] = new_tokens
        self._track_peak()
        return True

    # ----------------------------------------------------------- release --
    def free(self, rid: int, *, insert: bool = True,
             full_extent: bool = True) -> int:
        blocks = self._held.pop(rid, 0)
        self.free_blocks += blocks
        target = self._insert.pop(rid, None)
        extent = self._extent.pop(rid, 0)
        if target is not None and insert:
            pid, declared = target
            # radix semantics: everything this request computed is a valid
            # prefix for its successors (a conversation's next turn extends
            # the whole prior context, not just the declared prefix_len);
            # consumers' hits stay capped by THEIR declared prefix_len.
            # A recompute preemption (full_extent=False) folds only the
            # provably shared declared prefix — folding the whole context
            # into a ref-pinned entry would leave un-evictable blocks no
            # consumer can hit, during the very OOM preemption relieves
            if not full_extent:
                extent = min(extent, declared)
            pblocks = extent // self.block_tokens
            entry = self._prefix.get(pid)
            if entry is None:
                entry = self._prefix[pid] = _PrefixEntry()
            growth = min(pblocks - entry.blocks, self.free_blocks)
            if growth > 0:
                # the request's prefix blocks stay resident as cold cache
                self.free_blocks -= growth
                entry.blocks += growth
            entry.lru = next(self._clock)
        ref = self._refs.pop(rid, None)
        if ref is not None:
            entry = self._prefix.get(ref[0])
            if entry is not None and entry.refs > 0:
                entry.refs -= 1
        assert self.free_blocks <= self.total_blocks
        return blocks

    def cached_blocks(self) -> int:
        return sum(e.blocks for e in self._prefix.values())


class MonolithicKVManager(KVCacheManager):
    """Contiguous per-request allocation (TensorRT-LLM v1 style static
    memory): each request reserves its full ``prompt_len + output_len``
    bound at admission; ``max_len`` is only the fallback when a raw admit
    carries no per-request bound."""

    name = "monolithic"

    def __init__(self, total_bytes: float, kv_bytes_per_token: float,
                 max_len: int = 8192, **kw):
        kw.setdefault("block_tokens", 1)
        super().__init__(total_bytes, kv_bytes_per_token, **kw)
        self.max_len = max_len

    def _bound(self, tokens: int, max_tokens: Optional[int]) -> int:
        return max(max_tokens if max_tokens is not None else self.max_len,
                   tokens)

    def can_admit(self, tokens: int, max_tokens: Optional[int] = None) -> bool:
        return (self.free_blocks - self._bound(tokens, max_tokens)
                >= self.watermark_blocks)

    def admit(self, rid: int, tokens: int, *,
              max_tokens: Optional[int] = None,
              ignore_watermark: bool = False) -> bool:
        need = self._bound(tokens, max_tokens)
        if self.free_blocks - need < self._floor(ignore_watermark):
            return False
        self.free_blocks -= need
        self._held[rid] = need
        self._track_peak()
        return True
    # grow() is inherited: block_tokens == 1, and the reservation already
    # covers every context length up to the per-request bound, so growth
    # within the reserve is free and growth beyond it allocates the excess.


MEMORY = {c.name: c for c in (PagedKVManager, PrefixCachingKVManager,
                              MonolithicKVManager)}


def resolve_memory(spec) -> Tuple[type, dict]:
    """Resolve a memory-manager spec to ``(cls, constructor_kwargs)``.

    Unlike batching/routing, KV managers need build-time arguments (the
    per-replica byte budget), so resolution returns the class plus any
    extra kwargs; the system builder supplies budget/kv_bytes_per_token.
    Accepts None (paged defaults), a registered name, or a mapping
    ``{"name": ..., **kwargs}`` (e.g. block_tokens, watermark, preemption,
    swap_bw).
    """
    if spec is None:
        return PagedKVManager, {}
    if isinstance(spec, str):
        spec = {"name": spec}
    if isinstance(spec, dict):
        kw = dict(spec)
        name = kw.pop("name", None)
        if name not in MEMORY:
            raise KeyError(f"unknown memory manager {name!r}; "
                           f"registered: {sorted(MEMORY)}")
        if kw.get("preemption") is not None \
                and kw["preemption"] not in PREEMPTION_MODES:
            raise KeyError(f"unknown preemption mode {kw['preemption']!r}; "
                           f"modes: {PREEMPTION_MODES}")
        return MEMORY[name], kw
    raise TypeError(f"memory must be None, a name, or a mapping; "
                    f"got {type(spec).__name__}")


# ---------------------------------------------------- streamed KV transfer --
@dataclass(frozen=True)
class KVTransferPlan:
    """Layer-wise streamed KV transfer over one inter-cluster link.

    A prefill's KV is moved as ``n_layers`` per-layer chunks.  Layer *i*'s
    chunk can start streaming while layers *i+1..L* still prefill, so by
    the time prefill completes only the un-hidden tail is exposed on the
    critical path.  ``overlap`` in [0, 1] scales how much of that
    opportunity the transport realizes: 0 is the legacy lump-sum transfer
    (``exposed_time == serial_time`` exactly), 1 hides everything the
    compute window allows — never less than the last layer's chunk plus
    the link latency.
    """
    n_layers: int
    bytes_per_layer: float
    bandwidth: float
    latency: float = 0.0
    overlap: float = 0.0

    @property
    def total_bytes(self) -> float:
        return self.n_layers * self.bytes_per_layer

    @property
    def layer_time(self) -> float:
        return self.bytes_per_layer / self.bandwidth if self.bandwidth else 0.0

    @property
    def serial_time(self) -> float:
        """The lump-sum (no-streaming) price of the whole transfer."""
        return self.latency + (self.total_bytes / self.bandwidth
                               if self.bandwidth else 0.0)

    def exposed_time(self, compute_window: float = 0.0) -> float:
        """Transfer time left on the critical path after prefill completes.

        ``compute_window`` is the wall-clock span the producing prefill
        occupied (first schedule -> transfer start): the window in which
        the first L-1 chunks could stream behind remaining layers.
        """
        serial = self.serial_time
        if self.overlap <= 0.0 or self.n_layers <= 1:
            return serial
        hideable = (self.n_layers - 1) * self.layer_time
        # layer i's chunk only overlaps compute of layers AFTER i: in a
        # balanced pipeline (L-1)/L of the window is usable
        window = max(compute_window, 0.0) * (self.n_layers - 1) / self.n_layers
        hidden = self.overlap * min(hideable, window)
        return max(serial - hidden, self.latency + self.layer_time)
