"""State carried between the reference package and this one.

Both directions go through plain data, never through an import of the other
package: parameter trees as nested dicts of numpy arrays, calibration
artifacts as the JSON dicts ``save_artifact`` writes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.calib.artifacts import CalibrationArtifact


def from_numpy(tree: Any, device="cuda", dtype=None) -> Any:
    """The same nested structure (dicts, lists, tuples) with every numpy
    array turned into a torch tensor on ``device``.  ``dtype`` casts the
    floating-point leaves only; integer leaves keep their type.  Other
    leaves pass through."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(tree)).to(device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t
    return tree


#: oracle names that mean "the package's real kernels" on each side
_TO_PORT = {"pallas": "kernels"}
_TO_REFERENCE = {v: k for k, v in _TO_PORT.items()}


def artifact_from_reference(data: Dict) -> CalibrationArtifact:
    """An artifact dict written by the reference's ``save_artifact`` as this
    package's ``CalibrationArtifact``.  The forest, geometry, metrics and
    recorded ``spec_hash`` are carried as they are, so the fitted model
    predicts the same seconds; only the oracle's registry name is mapped
    (the reference's real-kernel oracle is ``pallas``, this package's
    ``kernels``)."""
    art = CalibrationArtifact.from_dict(data)
    art.oracle = _TO_PORT.get(art.oracle, art.oracle)
    return art


def artifact_to_reference(art: CalibrationArtifact) -> Dict:
    """The reverse: a dict the reference's ``CalibrationArtifact.from_dict``
    (or ``load_artifact``, once written as JSON) reads."""
    data = art.to_dict()
    data["oracle"] = _TO_REFERENCE.get(art.oracle, art.oracle)
    return data
