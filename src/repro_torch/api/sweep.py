"""Parallel experiment sweeps: ``sweep(base_spec, axes) -> [Report]``.

Axes are dotted spec paths mapped to value lists; grid mode takes the
cartesian product, zip mode pairs them positionally.  Points fan out over
a ``ProcessPoolExecutor`` (each point re-builds its own simulator from the
pickled spec dict, so no RNG or cache state leaks between points), stream
to JSONL as they complete, and come back in deterministic point order.
When the points run on the card (``device="cuda"``) the pool spawns its
workers instead of forking them: CUDA cannot be used in a child forked
after the parent initialised it.
Capacity-planning studies are ~10 lines::

    base = SimSpec.load("examples/specs/quickstart.yaml")
    reports = sweep(base, {"topology.tp": [1, 2, 4],
                           "workload.rate": [5, 10, 20]},
                    jobs=8, jsonl="artifacts/capacity.jsonl")
    print(best_under_slo(reports, ttft_p99=0.5, tpot_p99=0.05).point)
"""
from __future__ import annotations

import itertools
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.api.run import Report, run
from repro_torch.api.spec import SimSpec, SpecError, set_path
from repro_torch.core.metrics import pareto_frontier


# ------------------------------------------------------------- expansion --
def expand(base: SimSpec, axes: Mapping[str, Sequence[Any]],
           mode: str = "grid",
           seeds: Optional[Sequence[int]] = None,
           ) -> List[Tuple[SimSpec, Dict[str, Any]]]:
    """Expand ``axes`` over ``base`` into ``(spec, point)`` pairs.

    ``point`` records the axis assignment of each spec.  ``seeds``
    replicates every point once per seed (deterministic per-point seeds —
    results are independent of execution order and parallelism).
    """
    if mode not in ("grid", "zip"):
        raise SpecError(f"sweep mode must be 'grid' or 'zip', got {mode!r}")
    names = list(axes)
    values = [list(axes[n]) for n in names]
    for n, v in zip(names, values):
        if not v:
            raise SpecError(f"axis {n!r}: empty value list")
    if mode == "grid":
        combos = list(itertools.product(*values)) if names else [()]
    else:
        lens = {len(v) for v in values}
        if len(lens) > 1:
            raise SpecError(
                f"zip mode needs equal-length axes; got "
                f"{ {n: len(v) for n, v in zip(names, values)} }")
        combos = list(zip(*values)) if names else [()]
    seed_list: List[Optional[int]] = list(seeds) if seeds else [None]
    points: List[Tuple[SimSpec, Dict[str, Any]]] = []
    base_dict = base.to_dict()
    for combo in combos:
        for s in seed_list:
            d = json.loads(json.dumps(base_dict))   # deep copy
            point: Dict[str, Any] = {}
            for n, v in zip(names, combo):
                set_path(d, n, v)
                point[n] = v
            if s is not None:
                d["seed"] = s
                point["seed"] = s
            points.append((SimSpec.from_dict(d).validate(), point))
    return points


# --------------------------------------------------------------- workers --
def _sweep_worker(args: Tuple[int, Dict[str, Any], Dict[str, Any], str]
                  ) -> Tuple[int, Dict[str, Any]]:
    i, spec_dict, point, device = args
    rep = run(SimSpec.from_dict(spec_dict), device=device)
    rep.point = point
    return i, rep.to_dict()


def _stream(jsonl: Optional[str], rep: Report) -> None:
    if jsonl is None:
        return
    os.makedirs(os.path.dirname(jsonl) or ".", exist_ok=True)
    with open(jsonl, "a") as f:
        f.write(rep.to_json())
        f.write("\n")


# ----------------------------------------------------------------- sweep --
def sweep(base: SimSpec, axes: Mapping[str, Sequence[Any]], *,
          mode: str = "grid",
          jobs: int = 1,
          seeds: Optional[Sequence[int]] = None,
          jsonl: Optional[str] = None,
          progress=None,
          device: str = "cuda") -> List[Report]:
    """Run the expanded grid; return Reports in deterministic point order.

    ``jobs > 1`` fans points out over a process pool.  ``jsonl`` streams
    each finished Report as one JSON line (append; written as points
    complete, so partial sweeps leave usable artifacts).  ``progress`` is
    an optional ``fn(done, total, report)`` callback.  ``device`` is
    handed to every point's :func:`run`.
    """
    points = expand(base, axes, mode=mode, seeds=seeds)
    total = len(points)
    results: List[Optional[Report]] = [None] * total
    if jobs <= 1 or total <= 1:
        for i, (spec, point) in enumerate(points):
            rep = run(spec, device=device)
            rep.point = point
            results[i] = rep
            _stream(jsonl, rep)
            if progress:
                progress(i + 1, total, rep)
        return results  # type: ignore[return-value]
    args = [(i, spec.to_dict(), point, device)
            for i, (spec, point) in enumerate(points)]
    done = 0
    ctx = (multiprocessing.get_context("spawn")
           if str(device).startswith("cuda") else None)
    with ProcessPoolExecutor(max_workers=min(jobs, total),
                             mp_context=ctx) as pool:
        futures = [pool.submit(_sweep_worker, a) for a in args]
        for fut in as_completed(futures):
            i, rep_dict = fut.result()
            if "instances" in rep_dict:      # fleet point
                from repro_torch.fleet import FleetReport
                rep = FleetReport.from_dict(rep_dict)
            else:
                rep = Report.from_dict(rep_dict)
            results[i] = rep
            _stream(jsonl, rep)
            done += 1
            if progress:
                progress(done, total, rep)
    return results  # type: ignore[return-value]


# --------------------------------------------------------------- helpers --
def pareto(reports: Sequence[Report],
           x: str = "throughput_tok_s_per_device",
           y: str = "tpot_p50_s",
           invert_y: bool = True) -> List[Report]:
    """Reports on the (x, interactivity) maximization frontier.

    By default y is TPOT p50 inverted to interactivity (1/latency), the
    paper's throughput-interactivity trade-off plot.
    """
    kept, pts = [], []
    for r in reports:
        xv = r.summary.get(x)
        yv = r.summary.get(y)
        if xv is None or yv is None:
            continue
        kept.append(r)
        pts.append((float(xv),
                    1.0 / max(float(yv), 1e-12) if invert_y else float(yv)))
    front = set(pareto_frontier(pts))
    return [r for r, p in zip(kept, pts) if p in front]


def best_under_slo(reports: Sequence[Report], *,
                   ttft_p99: Optional[float] = None,
                   tpot_p99: Optional[float] = None,
                   key: str = "throughput_tok_s_per_device",
                   require_complete: bool = True) -> Optional[Report]:
    """The highest-``key`` report whose p99 latencies meet the SLOs."""
    ok = []
    for r in reports:
        if require_complete and not r.all_complete:
            continue
        ttft = r.summary.get("ttft_p99_s")
        tpot = r.summary.get("tpot_p99_s")
        if ttft_p99 is not None and not (ttft is not None
                                         and ttft <= ttft_p99):
            continue
        if tpot_p99 is not None and not (tpot is not None
                                         and tpot <= tpot_p99):
            continue
        ok.append(r)

    def _key(r: Report) -> float:
        v = r.summary.get(key)
        return float("-inf") if v is None else v
    return max(ok, key=_key, default=None)
