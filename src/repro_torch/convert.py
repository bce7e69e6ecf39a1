"""State carried between the reference package and this one.

Both directions go through plain data, never through an import of the other
package: parameter trees as nested dicts of numpy arrays, calibration
artifacts as the JSON dicts ``save_artifact`` writes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.calib.artifacts import CalibrationArtifact
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.common import tree_map


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
        t = torch.from_numpy(np.array(tree)).to(device)   # a copy: jax arrays are read-only
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


# ---------------------------------------------------------------- weights --
# The reference stacks the layers of each position in its block pattern along
# a leading axis (``groups``: one tree per pattern position, leading axis
# n_groups) and keeps the layers past the last whole period apart (``tail``).
# Layer i of the port is ``groups[i % period][i // period]`` for
# i < n_groups * period, else ``tail[i - n_groups * period]``.
def _split(cfg: ModelConfig):
    period = len(cfg.block_pattern)
    return period, cfg.num_layers // period


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, cross_attention=False,
                               num_layers=cfg.encoder_layers)


def _layers_from(cfg: ModelConfig, tree) -> tuple:
    period, n_groups = _split(cfg)
    layers = [tree_map(lambda a, g=i // period: np.asarray(a)[g],
                       tree["groups"][i % period])
              for i in range(n_groups * period)]
    layers += [tree_map(np.asarray, t) for t in tree["tail"]]
    return tuple(layers)


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _layers_to(cfg: ModelConfig, layers) -> Dict[str, tuple]:
    period, n_groups = _split(cfg)
    groups = tuple(_stack([layers[g * period + s] for g in range(n_groups)])
                   for s in range(period))
    return {"groups": groups, "tail": tuple(layers[n_groups * period:])}


def _check_shapes(pds, params, where="params") -> None:
    if isinstance(pds, dict):
        if set(pds) != set(params):
            raise ValueError(f"{where}: keys {sorted(params)} != {sorted(pds)}")
        for k in pds:
            _check_shapes(pds[k], params[k], f"{where}.{k}")
    elif isinstance(pds, tuple):
        if len(pds) != len(params):
            raise ValueError(f"{where}: {len(params)} entries != {len(pds)}")
        for i, (a, b) in enumerate(zip(pds, params)):
            _check_shapes(a, b, f"{where}[{i}]")
    elif tuple(params.shape) != tuple(pds.shape):
        raise ValueError(f"{where}: shape {tuple(params.shape)} != {pds.shape}")


_TOP = ("embed", "final_norm", "head")


def lm_params_from_reference(cfg: ModelConfig, tree, device="cuda",
                             dtype=None) -> Dict[str, Any]:
    """The reference's parameter tree for ``cfg`` (its ``init_tree`` output,
    as nested numpy arrays) as this package's per-layer tree, on ``device``,
    floating leaves cast to ``dtype`` when given.  ``build_model(cfg,
    params=...)`` takes the result."""
    def lm(c, t):
        out = {k: np.asarray(t[k]) for k in _TOP if k in t}
        out["layers"] = _layers_from(c, t)
        return out

    if cfg.encoder_layers:
        out = {"enc": {"layers": _layers_from(_encoder_cfg(cfg), tree["enc"]),
                       "norm": np.asarray(tree["enc"]["norm"])},
               "dec": lm(cfg, tree["dec"])}
    else:
        out = lm(cfg, tree)
    _check_shapes(build_model(cfg).pds(), out)
    return from_numpy(out, device, dtype)


def lm_params_to_reference(cfg: ModelConfig, params) -> Dict[str, Any]:
    """The reverse: this package's parameter tree in the reference's stacked
    layout, as nested numpy arrays.  bf16 leaves come out as float32: numpy
    has no bfloat16."""
    def np_(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def layers_to(c, layers):
        return _layers_to(c, [tree_map(np_, t) for t in layers])

    def lm(c, t):
        out = {k: np_(t[k]) for k in _TOP if k in t}
        out.update(layers_to(c, t["layers"]))
        return out

    if cfg.encoder_layers:
        enc = layers_to(_encoder_cfg(cfg), params["enc"]["layers"])
        enc["norm"] = np_(params["enc"]["norm"])
        return {"enc": enc, "dec": lm(cfg, params["dec"])}
    return lm(cfg, params)
