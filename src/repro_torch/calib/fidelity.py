"""FIDELITY_torch.json: this package's simulator-accuracy trajectory.

One entry per calibration run, appended like ``BENCH_sim_scale.json``:
per-operator MAPE / p50 / p99 relative error for the fitted model and
both baselines (analytical roofline, vidur sqrt-proxy) on the held-out
heterogeneous-batch grid.  CI re-calibrates on a small grid and fails if
the fitted MAPE regresses more than the tolerance vs the last comparable
trajectory entry — accuracy is gated exactly like events/s.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

# an entry is comparable to a baseline entry when the fit problem matches
COMPARABLE_KEYS = ("model", "hardware", "oracle", "smoke", "n_train",
                   "n_eval")


def entry_from_result(result, label: str) -> Dict:
    """Build a trajectory entry from a ``CalibrationResult``."""
    return {
        "label": label,
        "model": result.model,
        "hardware": result.hardware,
        "oracle": result.oracle,
        "smoke": result.smoke,
        "seed": result.seed,
        "n_train": result.n_train,
        "n_eval": result.n_eval,
        "operators": {op: {fam: dict(stats)
                           for fam, stats in fams.items()}
                      for op, fams in result.fidelity.items()},
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


def load_trajectory(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f).get("trajectory", [])


def append_fidelity(path: str, entry: Dict) -> None:
    """Append (or replace, by label) an entry — same contract as
    ``bench_sim_scale.append_trajectory``."""
    traj = [e for e in load_trajectory(path)
            if e.get("label") != entry.get("label")]
    traj.append(entry)
    with open(path, "w") as f:
        json.dump({"trajectory": traj}, f, indent=2, sort_keys=True)
        f.write("\n")


def _cfg(entry: Dict) -> Dict:
    return {k: entry.get(k) for k in COMPARABLE_KEYS}


def pick_baseline(trajectory: List[Dict], fresh: Dict
                  ) -> Tuple[Optional[Dict], bool]:
    """Most recent comparable entry, else most recent entry at all."""
    if not trajectory:
        return None, False
    want = _cfg(fresh)
    for e in reversed(trajectory):
        if _cfg(e) == want:
            return e, True
    return trajectory[-1], False


def check_fidelity_regression(fresh: Dict, trajectory: List[Dict],
                              tolerance: float = 0.2
                              ) -> Tuple[bool, List[str]]:
    """Gate: fitted MAPE must not grow more than ``tolerance`` (relative)
    vs the baseline entry, per operator.  Returns (ok, report lines)."""
    base, comparable = pick_baseline(trajectory, fresh)
    if base is None:
        return True, ["fidelity gate: empty trajectory — pass "
                      "(nothing to compare against)"]
    lines = []
    if not comparable:
        lines.append(f"fidelity gate: no comparable entry "
                     f"(want {_cfg(fresh)}); using most recent "
                     f"{base.get('label', '?')!r}")
    ok = True
    for op, fams in (fresh.get("operators") or {}).items():
        fresh_mape = (fams.get("fitted") or {}).get("mape")
        base_mape = (((base.get("operators") or {}).get(op) or {})
                     .get("fitted") or {}).get("mape")
        if fresh_mape is None or base_mape is None:
            lines.append(f"fidelity gate: {op}: no fitted mape on both "
                         f"sides — skipped")
            continue
        ceiling = base_mape * (1.0 + tolerance)
        verdict = "OK" if fresh_mape <= ceiling else "FAIL"
        lines.append(
            f"fidelity gate: {op}: baseline={base.get('label', '?')} "
            f"mape {base_mape:.3%} -> fresh {fresh_mape:.3%} "
            f"(ceiling {ceiling:.3%}, tolerance {tolerance:.0%}) "
            f"{verdict}")
        if fresh_mape > ceiling:
            ok = False
    if not lines:
        lines.append("fidelity gate: fresh entry has no operators — "
                     "nothing to gate")
        ok = False
    return ok, lines
