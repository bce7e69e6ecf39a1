"""Steps captured in CUDA graphs: the port's twin of the reference's ``jax.jit``.

The reference compiles its served and trained steps once and calls the
compiled step after (``jax.jit`` in ``repro/serving/engine.py`` and
``repro/launch/train.py``).  On the card the port captures a step's kernels
once in a CUDA graph (``torch.cuda.graph``) and replays them: the same
kernels in the same order on the same buffers, so a replayed step computes
what the step computes eagerly, without the host dispatching each op.

A :class:`Graphed` step wraps a function of no arguments that reads fixed
input tensors and returns tensors.  Its caller ``copy_``s each step's inputs
into those tensors before the call, outside the graph.  The first
``warmup`` calls run the function eagerly on a side stream and are real
calls: their results are the step's results.  After the last of them the
function is captured, which executes nothing, and every later call replays
the graph and returns the tensors the capture returned; the next replay
overwrites them, so a caller reads them before it calls again.  A failed
capture raises; nothing falls back to running eagerly.

A kernel wrapper counts its launches in Python, which a replay never calls:
under capture ``_build.count_launch`` records into the graph's tally, and
each replay adds that tally, so ``ops.launch_counts()`` still counts the
kernels the card ran.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import _build


class Graphed:
    """``fn()`` run eagerly ``warmup`` times, then captured and replayed.

    ``pool`` is a memory pool handle (``torch.cuda.graph_pool_handle()``)
    shared with other graphs; sharing is safe only where each graph's
    outputs are used up before another graph of the pool replays.
    ``capture_error_mode`` is ``torch.cuda.graph``'s: "global" forbids
    unsafe CUDA calls in every thread while the capture lasts,
    "thread_local" only in the capturing thread."""

    def __init__(self, fn: Callable[[], Any], *, warmup: int = 1,
                 pool: Optional[tuple] = None, capture_error_mode: str = "global"):
        if warmup < 1:
            raise ValueError("a graph needs at least one warm-up call")
        self.fn, self.warmup, self.pool = fn, warmup, pool
        self.capture_error_mode = capture_error_mode
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        self.tally: dict = {}

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self) -> Any:
        if self.graph is not None:
            self.graph.replay()
            _build.add_launches(self.tally)
            return self.out
        # eager on a side stream, as torch.cuda.graph's capture stream is:
        # lazy state (cuBLAS workspaces, the kernels' build) is made here
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self.fn()
        torch.cuda.current_stream().wait_stream(side)
        self.calls += 1
        if self.calls >= self.warmup:
            self._capture()
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        with _build.recording() as tally:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode=self.capture_error_mode):
                out = self.fn()
        self.graph, self.out, self.tally = graph, out, tally
