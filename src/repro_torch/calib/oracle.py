"""Operator-latency oracles — the ground truth calibration fits against.

An ``Oracle`` answers "how long does this operator take on this hardware
for this exact heterogeneous batch?" in seconds.  Two backends so far:

``kernels``    timing of the hand-written CUDA kernels in ``kernels/ops.py``
               on the card (CUDA events, bf16 inputs, median of several
               repetitions after a warm-up); with ``device="cpu"`` the
               kernels' plain versions are timed with ``perf_counter`` under
               much smaller shape limits.
``kernelsim``  the ``VirtualKernels`` tile-level simulator: deterministic,
               fast, models wave quantization and head/tile parallelism.

``resolve_oracle`` maps "auto" to ``kernels``.  It never looks for a GPU and
steps down: ``kernels`` on ``device="cuda"`` without a CUDA device raises, and
``kernelsim`` is chosen by name.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional, Sequence

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.opmodels.kernelsim import VirtualKernels


class Oracle:
    """Protocol: per-operator latency (seconds) for one heterogeneous batch.

    ``limits()`` advertises the largest shapes the backend can measure in
    reasonable time — the grid sampler clamps to it, so a slow backend
    (the plain versions on a CPU) still calibrates, just on a smaller domain.
    """

    name = "oracle"

    def attention_prefill(self, q_lens: Sequence[int],
                          kv_lens: Sequence[int], n_heads: int,
                          n_kv_heads: int, head_dim: int, *,
                          causal: bool = True, window: int = 0) -> float:
        raise NotImplementedError

    def attention_decode(self, context_lens: Sequence[int], n_heads: int,
                         n_kv_heads: int, head_dim: int, *,
                         window: int = 0) -> float:
        raise NotImplementedError

    def grouped_gemm(self, tokens_per_expert: Sequence[int], d_in: int,
                     d_out: int) -> float:
        raise NotImplementedError

    def limits(self) -> Dict[str, int]:
        return {"max_len": 8192, "max_batch": 128, "max_tokens": 16384}

    # fit_attention_model-compatible entry point: decode batches are the
    # all-q==1 case, matching how the predictor prices decode attention
    def attention(self, q_lens, kv_lens, n_heads, n_kv_heads, head_dim,
                  causal=True, window=0) -> float:
        if any(int(q) > 1 for q in q_lens):
            return self.attention_prefill(q_lens, kv_lens, n_heads,
                                          n_kv_heads, head_dim,
                                          causal=causal, window=window)
        return self.attention_decode(kv_lens, n_heads, n_kv_heads,
                                     head_dim, window=window)


class KernelSimOracle(Oracle):
    """VirtualKernels tile-level simulator as ground truth (default on CPU)."""

    name = "kernelsim"

    def __init__(self, hw: HardwareSpec, device=None):
        # ``device`` is accepted so every oracle constructs alike; the
        # simulator is host arithmetic and never reads it
        self.hw = hw
        self.kernels = VirtualKernels(hw)

    def attention_prefill(self, q_lens, kv_lens, n_heads, n_kv_heads,
                          head_dim, *, causal=True, window=0) -> float:
        return self.kernels.attention_prefill(q_lens, kv_lens, n_heads,
                                              n_kv_heads, head_dim,
                                              causal=causal, window=window)

    def attention_decode(self, context_lens, n_heads, n_kv_heads, head_dim,
                         *, window=0) -> float:
        return self.kernels.attention_decode(context_lens, n_heads,
                                             n_kv_heads, head_dim,
                                             window=window)

    def grouped_gemm(self, tokens_per_expert, d_in, d_out) -> float:
        return self.kernels.grouped_gemm(tokens_per_expert, d_in, d_out)


class KernelOracle(Oracle):
    """Timing of the real kernels (``kernels/ops.py``) on ``device``.

    On the card this measures the CUDA kernels with ``torch.cuda.Event``:
    one warm-up call, then ``reps`` timed calls, and the median is kept.
    Inputs are random bf16 drawn from an explicit ``torch.Generator``.  With
    ``device="cpu"`` the wrappers run their plain versions, which are timed
    with ``perf_counter`` on f32 inputs, and ``limits()`` shrinks the
    sampling domain to keep a calibration run tractable.  Per-shape timings
    are cached, bucketed geometrically by length; the cache is sound because
    kernel latency is a function of the shape.
    """

    name = "kernels"

    def __init__(self, hw: HardwareSpec, device="cuda",
                 reps: Optional[int] = None, bucket: float = 1.25,
                 seed: int = 0):
        import torch
        self.hw = hw
        self.bucket = bucket
        self.device = torch.device(device)
        self._on_accel = self.device.type == "cuda"
        if self._on_accel and not torch.cuda.is_available():
            raise RuntimeError(
                "the 'kernels' oracle on device 'cuda' needs a CUDA device "
                "and found none; pass device='cpu' to time the plain "
                "versions, or choose the 'kernelsim' oracle by name")
        self.reps = reps if reps is not None else (5 if self._on_accel else 2)
        self.dtype = torch.bfloat16 if self._on_accel else torch.float32
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._cache: Dict[tuple, float] = {}

    def limits(self) -> Dict[str, int]:
        if self._on_accel:
            return {"max_len": 8192, "max_batch": 64, "max_tokens": 8192}
        return {"max_len": 160, "max_batch": 4, "max_tokens": 512}

    def _round(self, n: int) -> int:
        # geometric bucketing: pads lengths up so the shape cache hits
        if n <= 16:
            return 16
        b = 16
        while b < n:
            b = max(b + 16, int(b * self.bucket) // 16 * 16)
        return b

    def _randn(self, *shape: int):
        import torch
        return torch.randn(shape, generator=self._gen, device=self.device,
                           dtype=torch.float32).to(self.dtype)

    def _time(self, fn: Callable, *args) -> float:
        import torch
        fn(*args)                                   # warm-up (and the build)
        if self._on_accel:
            torch.cuda.synchronize(self.device)
            times = []
            for _ in range(self.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3)
            return statistics.median(times)
        t0 = time.perf_counter()
        for _ in range(self.reps):
            fn(*args)
        return (time.perf_counter() - t0) / self.reps

    def attention_prefill(self, q_lens, kv_lens, n_heads, n_kv_heads,
                          head_dim, *, causal=True, window=0) -> float:
        from repro_torch.kernels import ops
        total = 0.0
        for q_len, kv_len in zip(q_lens, kv_lens):
            s, t = self._round(int(q_len)), self._round(int(kv_len))
            key = ("prefill", s, t, n_heads, n_kv_heads, head_dim,
                   causal, window)
            if key not in self._cache:
                q = self._randn(1, s, n_heads, head_dim)
                k = self._randn(1, t, n_kv_heads, head_dim)
                bq = bk = min(128, max(16, s))
                self._cache[key] = self._time(
                    lambda q, k: ops.flash_attention(
                        q, k, k, causal=causal, window=window, bq=bq, bk=bk),
                    q, k)
            total += self._cache[key]
        return total

    def attention_decode(self, context_lens, n_heads, n_kv_heads, head_dim,
                         *, window=0) -> float:
        import torch
        from repro_torch.kernels import ops
        # one fused decode kernel over the whole batch: pad contexts to the
        # bucketed max and pass true lengths, exactly how the engine runs it
        b = len(context_lens)
        t = self._round(max(int(x) for x in context_lens))
        key = ("decode", b, t, n_heads, n_kv_heads, head_dim, window)
        if key not in self._cache:
            q = self._randn(b, n_heads, head_dim)
            k = self._randn(b, t, n_kv_heads, head_dim)
            lengths = torch.tensor([min(int(x), t) for x in context_lens],
                                   dtype=torch.int32, device=self.device)
            self._cache[key] = self._time(
                lambda q, k, lengths: ops.decode_attention(
                    q, k, k, lengths, bk=min(256, t)),
                q, k, lengths)
        return self._cache[key]

    def grouped_gemm(self, tokens_per_expert, d_in, d_out) -> float:
        import torch
        from repro_torch.kernels import ops
        e = len(tokens_per_expert)
        cap = self._round(max(1, max(int(x) for x in tokens_per_expert)))
        key = ("grouped", e, cap, d_in, d_out)
        if key not in self._cache:
            x = self._randn(e, cap, d_in)
            w = self._randn(e, d_in, d_out)
            sizes = torch.tensor([min(int(t), cap)
                                  for t in tokens_per_expert],
                                 dtype=torch.int32, device=self.device)
            bm = min(128, max(16, cap))
            self._cache[key] = self._time(
                lambda x, w, sizes: ops.grouped_gemm(
                    x, w, sizes, bm=bm, bn=min(128, d_out),
                    bkk=min(512, d_in)),
                x, w, sizes)
        return self._cache[key]


ORACLES: Dict[str, type] = {
    "kernelsim": KernelSimOracle,
    "kernels": KernelOracle,
}


def default_oracle_name() -> str:
    """The real kernels.  Never a look for a GPU and a step down."""
    return "kernels"


def resolve_oracle(spec, hw: HardwareSpec, device="cuda") -> Oracle:
    """Oracle instance / name / {"name": ..., **kwargs} / None ("auto")."""
    if isinstance(spec, Oracle):
        return spec
    if spec is None or spec == "auto":
        spec = default_oracle_name()
    if isinstance(spec, str):
        name, kwargs = spec, {}
    else:
        kwargs = dict(spec)
        name = kwargs.pop("name", None)
    if name not in ORACLES:
        raise KeyError(f"unknown oracle {name!r}; available: "
                       f"{sorted(ORACLES)} (or 'auto')")
    kwargs.setdefault("device", device)
    return ORACLES[name](hw, **kwargs)
