"""One run of one cell: set-up, the measured window, the trace, the check.

The system under test is ``repro_torch.serving.engine.MiniEngine``, driven
only through its public ``submit``, ``run`` and ``waiting`` and read through
its ``step_log``.  Token times are the benchmark's own: after ``submit`` each
request's token list is replaced by a list that stamps the host clock when
the engine appends a token to it, the moment the host holds the token.

1. Set-up (``setup_s``, from the process's start): weights from the seed on
   the device, the engine, a warm pass through every prefill bucket the
   mix reaches and the decode step, so every CUDA graph is captured before
   the window.
2. The window: the mix's open loop (``traffic``).  Each request is submitted
   at its arrival time: while ``run()`` is in flight, at the next token the
   engine hands back (so before its next admission, as a queue fed from
   another thread would be); while the engine is idle, by a sleep until the
   arrival.  A request's time to first token runs from its arrival.
3. With ``trace``: NVML's utilisation samples of the window, then a
   profiled segment at the window's load for the breakdown.
4. The check: a sample of the window's requests, drawn from the seed with
   the longest among them, replayed by the plain reference once the
   engine is freed (``perfbench.check``).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from perfbench import check, devtrace, traffic
from perfbench.spec import HERE, Cell, family, load_metric, model_shapes
from perfbench.stats import pct
from perfbench.weights import make_tree


class NoDevice(RuntimeError):
    pass


class TimedTokens(list):
    """A request's token list that stamps the host clock at each append,
    then lets the open loop submit what has arrived meanwhile."""

    def __init__(self, loop: "OpenLoop"):
        super().__init__()
        self.stamps: List[float] = []
        self.loop = loop

    def append(self, tok) -> None:
        self.stamps.append(time.perf_counter())
        super().append(tok)
        self.loop.tick()


@dataclass
class Served:
    """What the benchmark keeps of one request: its own prompt, the tokens
    served, and its own clock's readings."""
    prompt: np.ndarray
    max_new_tokens: int
    submitted: float
    tokens: List[int] = field(default_factory=list)
    stamps: List[float] = field(default_factory=list)
    withdrawn: bool = False

    @property
    def ok(self) -> bool:
        return (len(self.tokens) == self.max_new_tokens
                and len(self.stamps) == len(self.tokens))


class OpenLoop:
    """Offers ``reqs`` (arrival second, prompt, output length) to the engine
    at ``start`` + each arrival.  ``hooks`` run at every tick with the
    clock's reading."""

    def __init__(self, engine, reqs, start: float):
        self.engine, self.reqs, self.start = engine, reqs, start
        self.next = 0
        self.pending: List[tuple] = []          # (engine request, Served)
        self.hooks: List[Callable[[float], None]] = []
        self.busy_s = 0.0                       # time inside run()
        self._in_run: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        while self.next < len(self.reqs) and self.start + self.reqs[self.next][0] <= now:
            t, prompt, n = self.reqs[self.next]
            req = self.engine.submit([prompt], n)[0]
            req.tokens = TimedTokens(self)
            self.pending.append((req, Served(prompt=prompt, max_new_tokens=n,
                                             submitted=self.start + t)))
            self.next += 1
        for hook in self.hooks:
            hook(now)

    def withdraw(self) -> None:
        """The requests still queued leave the engine's queue unserved."""
        queued = {id(req) for req, s in self.pending if not req.tokens}
        self.engine.waiting[:] = [r for r in self.engine.waiting if id(r) not in queued]
        for req, s in self.pending:
            s.withdrawn = id(req) in queued

    def busy_until(self, now: float) -> float:
        """Seconds inside ``run()`` up to ``now``."""
        return self.busy_s + (now - self._in_run if self._in_run is not None else 0.0)

    def drive(self) -> List[Served]:
        """Until every request has arrived and the engine has drained."""
        while True:
            self.tick()
            if not self.engine.waiting:
                if self.next >= len(self.reqs):
                    break
                time.sleep(max(0.0, self.start + self.reqs[self.next][0]
                               - time.perf_counter()))
                continue
            self._in_run = time.perf_counter()
            self.engine.run()
            self.busy_s += time.perf_counter() - self._in_run
            self._in_run = None
        for req, s in self.pending:
            s.tokens = [int(t) for t in req.tokens]
            s.stamps = list(getattr(req.tokens, "stamps", []))
        return [s for _, s in self.pending if not s.withdrawn]


@dataclass
class Window:
    """What the per-layer readers read."""
    seconds: float              # the window's length
    busy_s: float               # of which the engine's run() was in flight
    steps: List[Dict]           # the engine's step_log entries of the window
    requests: List[Served]
    max_slots: int
    shapes: Dict
    device_name: str
    close: float                # the window's end on the host clock
    nvml_busy_percent: Optional[float] = None


def port_config(cfg: Dict, base: Path = HERE):
    """The engine's ModelConfig for a configuration file, from its family
    (``arch/<family>.py``), which refuses one that disagrees with the file."""
    m = model_shapes(cfg, base)
    return family(m).port_config(cfg, m)


def check_fits(cfg: Dict, mix: Dict) -> None:
    """Refuses a mix whose longest request would not fit its slot or would
    pass the model's context."""
    longest = int(mix["prompt"]["max"]) + int(mix["output"]["max"])
    if longest > int(mix["max_seq"]) - 1:
        raise ValueError(f"a request of {longest} tokens would not fit a slot of "
                         f"{mix['max_seq']}")
    if longest > int(cfg["max_position_embeddings"]):
        raise ValueError(f"a request of {longest} tokens passes the model's context "
                         f"of {cfg['max_position_embeddings']}")


def build_engine(cell: Cell, seed: int, dev, params=None):
    """The engine at the cell's sizes, on weights from the seed, every
    graph the mix reaches captured."""
    import torch
    from repro_torch.serving.engine import MiniEngine
    m = model_shapes(cell.config, cell.base)
    mix = cell.traffic
    check_fits(cell.config, mix)
    dtype = getattr(torch, cell.config["dtype"])
    with torch.no_grad():
        engine = MiniEngine(port_config(cell.config, cell.base), max_slots=int(mix["slots"]),
                            max_seq=int(mix["max_seq"]),
                            params=params if params is not None
                            else make_tree(m, seed, dtype, dev),
                            dtype=dtype, device=dev)
    _warm(engine, mix, m["V"], seed)
    return engine


def _warm(engine, mix: Dict, vocab: int, seed: int) -> None:
    """Every prefill bucket the mix reaches, and the decode step, twice:
    the first pass captures each graph, the second replays it."""
    rng = np.random.default_rng(traffic.seed_words(seed) + [0xFFFFFFFF])
    reqs = [(0.0, rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32), 3)
            for n in traffic.warm_lengths(mix)]
    for _ in range(2):
        OpenLoop(engine, reqs, time.perf_counter()).drive()


def window(engine, mix: Dict, reqs, seconds: float, nvml=None) -> Window:
    """The measured window: ``reqs`` offered from now.  A mix judged by its
    tails has every request served to its end, and the window lasts until
    then; one judged by its throughput closes after ``seconds``, when the
    queue is withdrawn (the requests in flight finish, outside it)."""
    gc.collect()
    gc.freeze()
    first_step = len(engine.step_log)
    start = time.perf_counter()
    loop = OpenLoop(engine, reqs, start)
    close = start + seconds
    last_step: List[Optional[int]] = [None]
    busy = [None]
    if mix["judge"] == "throughput":
        def at_close(now: float) -> None:
            if now >= close and last_step[0] is None:
                last_step[0] = len(engine.step_log)
                busy[0] = loop.busy_until(now)
                loop.withdraw()
        loop.hooks.append(at_close)
    if nvml is not None:
        nvml.start()
    served = loop.drive()
    if mix["judge"] != "throughput":
        close = time.perf_counter()
    if nvml is not None:
        nvml.stop()
    gc.unfreeze()
    steps = [dict(s) for s in engine.step_log[first_step:last_step[0]]]
    return Window(seconds=close - start,
                  busy_s=loop.busy_s if busy[0] is None else busy[0], steps=steps,
                  requests=served, max_slots=int(mix["slots"]), shapes={},
                  device_name="", close=close,
                  nvml_busy_percent=(nvml.busy_percent(start, close)
                                     if nvml is not None else None))


def end_to_end(w: Window) -> Dict[str, float]:
    done = [r for r in w.requests if r.ok]
    return {
        "out_tok_s": sum(sum(t <= w.close for t in r.stamps) for r in w.requests) / w.seconds,
        "ttft_p95_ms": pct([(r.stamps[0] - r.submitted) * 1e3 for r in done], 95),
        "tpot_p95_ms": pct([(r.stamps[-1] - r.stamps[0]) * 1e3 / (len(r.tokens) - 1)
                            for r in done if len(r.tokens) > 1], 95),
    }


def _trace_segment(engine, mix: Dict, vocab: int, seed: int, device) -> Dict:
    """The profiled segment after the window: the schedule replayed with
    fresh ids, under the profiler from its start (with the engine idle),
    the ``profile_s`` seconds after ``warm_s`` marked as the span the
    breakdown reads; the profiler stops and the queue is withdrawn at the
    span's end.  Busy seconds, the span's length, and the breakdown."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    spec = mix["trace"]
    warm, span = float(spec["warm_s"]), float(spec["profile_s"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    marker = record_function(devtrace.SPAN)
    loop = OpenLoop(engine, traffic.requests(mix, seed, warm + span, vocab, stream=1), 0.0)
    on = [None, None]

    def stop() -> None:
        on[1] = time.perf_counter()
        marker.__exit__(None, None, None)
        prof.stop()

    def profiler(now: float) -> None:
        if on[0] is None and now >= loop.start + warm:
            on[0] = now
            marker.__enter__()
        elif on[0] is not None and on[1] is None and now >= on[0] + span:
            stop()
            loop.withdraw()
    loop.hooks.append(profiler)
    prof.start()
    loop.start = time.perf_counter()
    loop.drive()
    if on[1] is None:
        if on[0] is None:
            prof.stop()
            return {}
        stop()
    busy_s, brk = devtrace.breakdown(prof)
    return {"busy_s": busy_s, "window_s": on[1] - on[0], "breakdown": brk}


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", lower: Optional[Sequence[str]] = None) -> Dict:
    """One run of ``cell``; the result line's dict.  ``t0`` is the
    process's start on ``time.perf_counter``'s clock.  ``lower`` (for
    setting limits, never in the benchmark's runs) adds ``readings``: the
    sample's gaps, and beside them those of the reference computed in each
    precision of ``lower`` (``check.readings``), with ``control``: each
    lower precision's verdict by the cell's own limits."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or torch.cuda.device_count() < cell.chips):
        raise NoDevice(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    m = model_shapes(cell.config, cell.base)
    mix = cell.traffic
    dtype = getattr(torch, cell.config["dtype"])
    engine = build_engine(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reqs = traffic.requests(mix, seed, seconds, m["V"])
    nvml = devtrace.Nvml.open(dev) if trace and dev.type == "cuda" else None
    setup_s = time.perf_counter() - t0
    win = window(engine, mix, reqs, float(seconds), nvml)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    win.shapes, win.device_name = m, name

    result: Dict = {"correct": False, "attempted": len(win.requests),
                    "failed": sum(not r.ok for r in win.requests)}
    traced = {}
    if trace:
        metrics = {}
        for spec in cell.per_layer:
            value = load_metric(spec["name"], cell.base).read(win)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        traced = _trace_segment(engine, mix, m["V"], seed, dev)
    else:
        e2e = dict(end_to_end(win), setup_s=setup_s)
        metrics = {s["name"]: {"value": e2e[s["name"]], "unit": s["unit"]}
                   for s in cell.end_to_end}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                        "kind": name, "count": cell.chips if dev.type == "cuda" else 0,
                        "memory_peak_bytes": int(peak)}
    if traced:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = traced["breakdown"]

    # the program's state goes before the reference runs
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    chosen = check.sample(win.requests, int(mix["check"]["requests"]), seed)
    got = (check.readings(cell, chosen, seed=seed, dtype=dtype, device=dev,
                          lower=lower or ()) if chosen else {})
    ok, checks = check.verdict(got.get("program", {}), cell.limits)
    if lower is not None:
        result["readings"] = got
        result["control"] = {p: check.verdict(got[p], cell.limits)[0] for p in lower}
    result["correct"] = result["failed"] == 0 and bool(win.requests) and ok
    result["checks"] = checks
    return result
