"""Calibration & fidelity: close the sim-to-real loop.

Measure per-operator latency against an oracle (the hand-written CUDA
kernels, or the virtual-kernel simulator), fit the refined forest models,
persist them as versioned artifacts, load them into an
``ExecutionPredictor`` with ``load_calibrated_ops``, and track
simulator-vs-oracle error as a trajectory (``FIDELITY_torch.json``).

    python -m repro_torch calibrate --oracle kernels --model mixtral-8x7b
"""
from repro_torch.calib.artifacts import (
    ARTIFACT_VERSION, CalibrationArtifact, CalibrationError, artifact_path,
    discover_artifacts, load_artifact, load_calibrated_ops, save_artifact,
)
from repro_torch.calib.fidelity import (
    append_fidelity, check_fidelity_regression, entry_from_result,
    load_trajectory,
)
from repro_torch.calib.fit import CalibrationResult, calibrate
from repro_torch.calib.grid import (
    AttentionSample, CalibGrid, GroupedGemmSample, attention_grid,
    build_grid, geometry_of, grouped_gemm_grid, moe_geometry_of,
)
from repro_torch.calib.oracle import (
    ORACLES, KernelOracle, KernelSimOracle, Oracle,
    default_oracle_name, resolve_oracle,
)

__all__ = [
    "ARTIFACT_VERSION", "AttentionSample", "CalibGrid",
    "CalibrationArtifact", "CalibrationError", "CalibrationResult",
    "GroupedGemmSample", "KernelOracle", "KernelSimOracle", "ORACLES",
    "Oracle", "append_fidelity", "artifact_path",
    "attention_grid", "build_grid", "calibrate",
    "check_fidelity_regression", "default_oracle_name",
    "discover_artifacts", "entry_from_result", "geometry_of",
    "grouped_gemm_grid", "load_artifact", "load_calibrated_ops",
    "load_trajectory", "moe_geometry_of", "resolve_oracle",
    "save_artifact",
]
