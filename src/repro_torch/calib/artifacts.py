"""Fitted-model artifacts: serialization, provenance, discovery, loading.

Layout: ``artifacts/calib_torch/<hardware>/<operator>.json`` (the port's
own root; the reference's is ``artifacts/calib``) — one fitted
RandomForest per (hardware, operator), carrying the model geometry it was
fitted for, the oracle that produced the ground truth, held-out error
metrics, and a spec-hash provenance digest (sha256 of the canonical
fitting configuration — same recipe as ``SimSpec.spec_hash``).

``load_calibrated_ops`` turns a directory of artifacts into a
``RefinedModels`` instance for ``build()``; every failure mode raises
``CalibrationError`` with an actionable message (the api layer re-raises
as ``SpecError``).
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.opmodels.calibration import FittedAttention, FittedGroupedGemm
from repro_torch.core.opmodels.forest import RandomForest
from repro_torch.core.opmodels.kernelsim import VirtualKernels
from repro_torch.core.opmodels.refined import RefinedModels

ARTIFACT_VERSION = 1
OPERATORS = ("attention", "grouped_gemm")


class CalibrationError(ValueError):
    """Artifact missing / corrupt / fitted for different hardware-geometry."""


@dataclass
class CalibrationArtifact:
    operator: str                  # "attention" | "grouped_gemm"
    hardware: str                  # HardwareSpec.name it was fitted on
    model: str                     # model config name (provenance only)
    oracle: str                    # oracle backend that supplied truth
    geometry: Dict[str, int]       # operator geometry the fit is valid for
    seed: int
    n_train: int
    metrics: Dict[str, float]      # held-out fitted error stats
    forest: Dict                   # RandomForest.to_dict()
    spec_hash: str = ""
    created_at: str = ""
    version: int = ARTIFACT_VERSION

    def provenance_hash(self) -> str:
        """16-hex digest of everything that determines the fit (not the
        timestamp): re-running calibrate with the same inputs must produce
        the same hash."""
        blob = json.dumps(
            {"operator": self.operator, "hardware": self.hardware,
             "model": self.model, "oracle": self.oracle,
             "geometry": self.geometry, "seed": self.seed,
             "n_train": self.n_train, "version": self.version},
            sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict:
        return {"operator": self.operator, "hardware": self.hardware,
                "model": self.model, "oracle": self.oracle,
                "geometry": self.geometry, "seed": self.seed,
                "n_train": self.n_train, "metrics": self.metrics,
                "spec_hash": self.spec_hash, "created_at": self.created_at,
                "version": self.version, "forest": self.forest}

    @classmethod
    def from_dict(cls, data: Dict) -> "CalibrationArtifact":
        missing = [k for k in ("operator", "hardware", "geometry", "forest")
                   if k not in data]
        if missing:
            raise CalibrationError(f"artifact missing field(s) {missing}")
        return cls(operator=data["operator"], hardware=data["hardware"],
                   model=data.get("model", "?"),
                   oracle=data.get("oracle", "?"),
                   geometry={k: int(v)
                             for k, v in data["geometry"].items()},
                   seed=int(data.get("seed", 0)),
                   n_train=int(data.get("n_train", 0)),
                   metrics=data.get("metrics", {}),
                   forest=data["forest"],
                   spec_hash=data.get("spec_hash", ""),
                   created_at=data.get("created_at", ""),
                   version=int(data.get("version", ARTIFACT_VERSION)))

    def to_fitted(self):
        """Rehydrate the fitted predictor this artifact serializes."""
        forest = RandomForest.from_dict(self.forest)
        g = self.geometry
        if self.operator == "attention":
            return FittedAttention(forest, g["n_heads"], g["n_kv_heads"],
                                   g["head_dim"])
        if self.operator == "grouped_gemm":
            return FittedGroupedGemm(forest, g["d_in"], g["d_out"])
        raise CalibrationError(f"unknown operator {self.operator!r}")


def artifact_path(root: str, hardware: str, operator: str) -> str:
    return os.path.join(root, hardware, f"{operator}.json")


def save_artifact(art: CalibrationArtifact, root: str) -> str:
    if not art.spec_hash:
        art.spec_hash = art.provenance_hash()
    path = artifact_path(root, art.hardware, art.operator)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(art.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_artifact(path: str) -> CalibrationArtifact:
    if not os.path.isfile(path):
        raise CalibrationError(
            f"no calibration artifact at {path!r}; run "
            f"`python -m repro_torch calibrate` to fit one")
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CalibrationError(f"unreadable artifact {path!r}: {e}") from e
    art = CalibrationArtifact.from_dict(data)
    if art.version != ARTIFACT_VERSION:
        raise CalibrationError(
            f"artifact {path!r} has version {art.version}, this build "
            f"reads version {ARTIFACT_VERSION}; re-run "
            f"`python -m repro_torch calibrate`")
    return art


def discover_artifacts(root: str = os.path.join("artifacts", "calib_torch")
                       ) -> List[Dict]:
    """Lightweight listing (no forest rehydration) for ``python -m
    repro_torch list``, under the port's own root by default."""
    found = []
    if not os.path.isdir(root):
        return found
    for hw in sorted(os.listdir(root)):
        hw_dir = os.path.join(root, hw)
        if not os.path.isdir(hw_dir):
            continue
        for fn in sorted(os.listdir(hw_dir)):
            if not fn.endswith(".json"):
                continue
            path = os.path.join(hw_dir, fn)
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            found.append({"hardware": hw,
                          "operator": data.get("operator", fn[:-5]),
                          "model": data.get("model", "?"),
                          "oracle": data.get("oracle", "?"),
                          "spec_hash": data.get("spec_hash", ""),
                          "mape": (data.get("metrics") or {}).get("mape"),
                          "path": path})
    return found


def _check_geometry(art: CalibrationArtifact, want: Dict[str, int],
                    path: str, model_name: str) -> None:
    if art.geometry != want:
        raise CalibrationError(
            f"artifact {path!r} was fitted for {art.model!r} geometry "
            f"{art.geometry}, but the spec's model {model_name!r} needs "
            f"{want}; re-run `python -m repro_torch calibrate --model "
            f"{model_name}` (add --smoke for smoke-model specs)")


def load_calibrated_ops(root: str, cfg, hw: HardwareSpec) -> RefinedModels:
    """Build a RefinedModels priced by the fitted artifacts under ``root``.

    ``root`` is an artifact directory: either the calib root (containing a
    ``<hardware>/`` subdirectory) or a hardware directory itself.  The
    attention artifact is required; grouped_gemm is required only for MoE
    model configs.  Artifacts are fitted at the model's tp=1 operator
    geometry — sharded clusters fall back to the virtual-kernel model for
    the sharded shapes (the RefinedModels geometry guard).
    """
    if not os.path.isdir(root):
        raise CalibrationError(
            f"calibration directory {root!r} does not exist; run "
            f"`python -m repro_torch calibrate` to create it")
    hw_dir = os.path.join(root, hw.name)
    base = hw_dir if os.path.isdir(hw_dir) else root
    from repro_torch.calib.grid import geometry_of, moe_geometry_of

    attn_path = os.path.join(base, "attention.json")
    if not os.path.isfile(attn_path):
        have = sorted(d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d)))
        raise CalibrationError(
            f"no attention artifact for hardware {hw.name!r} under "
            f"{root!r} (calibrated hardware dirs: {have or 'none'}); run "
            f"`python -m repro_torch calibrate --hardware {hw.name}`")
    art = load_artifact(attn_path)
    if art.hardware != hw.name:
        raise CalibrationError(
            f"artifact {attn_path!r} was fitted on hardware "
            f"{art.hardware!r}, but the spec targets {hw.name!r}; re-run "
            f"`python -m repro_torch calibrate --hardware {hw.name}`")
    _check_geometry(art, geometry_of(cfg), attn_path, cfg.name)
    attention = art.to_fitted()

    grouped = None
    moe_geo = moe_geometry_of(cfg)
    if moe_geo is not None:
        gg_path = os.path.join(base, "grouped_gemm.json")
        gg = load_artifact(gg_path)
        if gg.hardware != hw.name:
            raise CalibrationError(
                f"artifact {gg_path!r} was fitted on hardware "
                f"{gg.hardware!r}, but the spec targets {hw.name!r}")
        # the fit only depends on the expert dims; expert count / top_k are
        # provenance, so match on the pricing-relevant subset
        want = {"d_in": moe_geo["d_in"], "d_out": moe_geo["d_out"]}
        got = {k: gg.geometry.get(k) for k in want}
        if got != want:
            raise CalibrationError(
                f"artifact {gg_path!r} was fitted for expert dims {got}, "
                f"but {cfg.name!r} needs {want}")
        grouped = gg.to_fitted()

    return RefinedModels(hw, attention=attention, grouped=grouped,
                         kernels=VirtualKernels(hw))
