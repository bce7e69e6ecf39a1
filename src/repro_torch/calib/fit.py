"""The calibrate() flow: sample → measure → fit → evaluate → persist.

For each operator the oracle supplies ground-truth seconds on a training
grid; a RandomForest is fit in log-space on the operator's feature vector
(``opmodels/features.py``); and the fitted model is scored on a disjoint
held-out grid against the two baselines the paper compares to:

- ``analytical``   the roofline OperatorModelSet (max(flops, bytes) + c)
- ``vidur_proxy``  the sqrt-homogenization proxy over the same kernels

reporting MAPE / p50 / p99 relative error per family — the fitted model
must beat both on heterogeneous batches, which is the repo's tracked
fidelity claim (FIDELITY_torch.json for this package).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.calib.artifacts import (
    CalibrationArtifact, CalibrationError, save_artifact,
)
from repro_torch.calib.grid import CalibGrid, build_grid
from repro_torch.calib.oracle import Oracle, resolve_oracle
from repro_torch.core.hardware import HARDWARE, HardwareSpec
from repro_torch.core.opmodels.analytical import OperatorModelSet
from repro_torch.core.opmodels.calibration import (
    FittedAttention, FittedGroupedGemm,
)
from repro_torch.core.opmodels.features import (
    attention_features, grouped_gemm_features,
)
from repro_torch.core.opmodels.forest import RandomForest
from repro_torch.core.opmodels.kernelsim import VirtualKernels
from repro_torch.core.opmodels.vidur_proxy import VidurProxyModel


@dataclass
class CalibrationResult:
    model: str
    hardware: str
    oracle: str
    smoke: bool
    seed: int
    n_train: int
    n_eval: int
    limits: Dict[str, int]
    # operator -> family -> {mape, p50, p99, n}
    fidelity: Dict[str, Dict[str, Dict[str, float]]]
    artifacts: Dict[str, CalibrationArtifact] = field(default_factory=dict)
    artifact_paths: Dict[str, str] = field(default_factory=dict)
    wall_s: float = 0.0


def _resolve_hw(hardware) -> HardwareSpec:
    if isinstance(hardware, HardwareSpec):
        return hardware
    if hardware not in HARDWARE:
        raise CalibrationError(f"unknown hardware {hardware!r}; "
                               f"available: {sorted(HARDWARE)}")
    return HARDWARE[hardware]


def _stats(rel: List[float]) -> Dict[str, float]:
    a = np.asarray(rel, np.float64)
    return {"mape": float(a.mean()), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "n": int(a.size)}


def _fit_forest(X: List[np.ndarray], y: List[float],
                seed: int) -> RandomForest:
    return RandomForest(seed=seed).fit(np.asarray(X), np.asarray(y))


def calibrate(model: str = "qwen2-7b",
              hardware="A800-SXM4-80G",
              oracle="auto", *,
              smoke: bool = False,
              n_train: int = 400,
              n_eval: int = 120,
              seed: int = 0,
              max_len: Optional[int] = None,
              max_batch: Optional[int] = None,
              window: int = 0,
              out_root: Optional[str] = "artifacts/calib_torch",
              device="cuda",
              ) -> CalibrationResult:
    """Fit per-operator models for (model, hardware) against an oracle and
    score them on a held-out grid.  ``out_root=None`` skips persisting
    (benchmark mode).  ``device`` is where a measuring oracle runs its
    kernels; nothing here steps down from it."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(model, smoke=smoke)
    hw = _resolve_hw(hardware)
    orc: Oracle = resolve_oracle(oracle, hw, device)
    limits = orc.limits()
    grid = build_grid(cfg, n_train=n_train, n_eval=n_eval, seed=seed,
                      limits=limits, max_len=max_len, max_batch=max_batch)
    analytical = OperatorModelSet(hw)
    vidur = VidurProxyModel(VirtualKernels(hw))
    g = grid.geometry
    result = CalibrationResult(
        model=cfg.name, hardware=hw.name, oracle=orc.name, smoke=smoke,
        seed=seed, n_train=n_train, n_eval=n_eval, limits=dict(limits),
        fidelity={})

    # ---------------------------------------------------------- attention --
    X, y = [], []
    for s in grid.attn_train:
        t = orc.attention(s.q_lens, s.kv_lens, g["n_heads"],
                          g["n_kv_heads"], g["head_dim"],
                          causal=s.causal, window=window)
        X.append(attention_features(s.q_lens, s.kv_lens, g["n_heads"],
                                    g["n_kv_heads"], g["head_dim"],
                                    causal=s.causal, window=window))
        y.append(math.log(max(t, 1e-9)))
    fitted_attn = FittedAttention(_fit_forest(X, y, seed), g["n_heads"],
                                  g["n_kv_heads"], g["head_dim"])

    rel: Dict[str, List[float]] = {"fitted": [], "analytical": [],
                                   "vidur_proxy": []}
    for s in grid.attn_eval:
        truth = orc.attention(s.q_lens, s.kv_lens, g["n_heads"],
                              g["n_kv_heads"], g["head_dim"],
                              causal=s.causal, window=window)
        preds = {
            "fitted": fitted_attn.predict(s.q_lens, s.kv_lens,
                                          causal=s.causal, window=window),
            "analytical": (
                analytical.attention_decode(s.kv_lens, g["n_heads"],
                                            g["n_kv_heads"], g["head_dim"],
                                            window=window)
                if s.decode else
                analytical.attention_prefill(s.q_lens, s.kv_lens,
                                             g["n_heads"], g["n_kv_heads"],
                                             g["head_dim"], causal=s.causal,
                                             window=window)),
            "vidur_proxy": (
                vidur.attention_decode(s.kv_lens, g["n_heads"],
                                       g["n_kv_heads"], g["head_dim"],
                                       window=window)
                if s.decode else
                vidur.attention_prefill(s.q_lens, s.kv_lens, g["n_heads"],
                                        g["n_kv_heads"], g["head_dim"],
                                        causal=s.causal, window=window)),
        }
        for fam, p in preds.items():
            rel[fam].append(abs(p - truth) / max(truth, 1e-12))
    result.fidelity["attention"] = {f: _stats(v) for f, v in rel.items()}
    result.artifacts["attention"] = CalibrationArtifact(
        operator="attention", hardware=hw.name, model=cfg.name,
        oracle=orc.name, geometry=dict(g), seed=seed, n_train=n_train,
        metrics=dict(result.fidelity["attention"]["fitted"]),
        forest=fitted_attn.forest.to_dict())

    # ------------------------------------------------------- grouped gemm --
    if grid.moe_geometry is not None:
        mg = grid.moe_geometry
        X, y = [], []
        for s in grid.gg_train:
            t = orc.grouped_gemm(s.tokens_per_expert, mg["d_in"],
                                 mg["d_out"])
            X.append(grouped_gemm_features(s.tokens_per_expert, mg["d_in"],
                                           mg["d_out"]))
            y.append(math.log(max(t, 1e-9)))
        fitted_gg = FittedGroupedGemm(_fit_forest(X, y, seed), mg["d_in"],
                                      mg["d_out"])
        rel = {"fitted": [], "analytical": [], "vidur_proxy": []}
        for s in grid.gg_eval:
            truth = orc.grouped_gemm(s.tokens_per_expert, mg["d_in"],
                                     mg["d_out"])
            preds = {
                "fitted": fitted_gg.predict(s.tokens_per_expert),
                "analytical": analytical.grouped_gemm(
                    s.tokens_per_expert, mg["d_in"], mg["d_out"]),
                "vidur_proxy": vidur.grouped_gemm(
                    s.tokens_per_expert, mg["d_in"], mg["d_out"]),
            }
            for fam, p in preds.items():
                rel[fam].append(abs(p - truth) / max(truth, 1e-12))
        result.fidelity["grouped_gemm"] = {f: _stats(v)
                                           for f, v in rel.items()}
        result.artifacts["grouped_gemm"] = CalibrationArtifact(
            operator="grouped_gemm", hardware=hw.name, model=cfg.name,
            oracle=orc.name, geometry=dict(mg), seed=seed, n_train=n_train,
            metrics=dict(result.fidelity["grouped_gemm"]["fitted"]),
            forest=fitted_gg.forest.to_dict())

    # -------------------------------------------------------------- persist --
    if out_root is not None:
        stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        for art in result.artifacts.values():
            art.created_at = stamp
            result.artifact_paths[art.operator] = save_artifact(art,
                                                                out_root)
    result.wall_s = time.perf_counter() - t0
    return result
