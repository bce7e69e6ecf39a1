"""Checkpoint and restore, on the reference's on-disk contract
(``repro/training/checkpoint.py``).

A checkpoint is ``step_%08d/`` holding ``tensors.npz`` and ``manifest.json``
(``step``, ``time``, ``keys``, ``extra``).  It is written to
``.tmp_step_%08d_<pid>/`` and renamed, so a reader never sees half of one,
and tmp directories left by crashed writers are pruned after each save.

Keys are the tree paths joined by ``/`` under ``params/`` and ``opt/``: the
port's own layout (``params/layers/3/attn/wq``, ``opt/m/...``,
``opt/step``), not the reference's stacked ``groups``/``tail``;
``convert.train_state_from_reference`` carries the reference's state across.
bf16 tensors are saved as float32 (numpy has no bfloat16) and cast back on
restore.  One device: restoring onto shardings waits for the multi-device
slice.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` on every leaf of nested dicts, tuples and lists,
    ``key`` the path joined by ``/``; the structure is kept."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def flatten(tree) -> Dict[str, Any]:
    """{"a/b/0/c": leaf}, the checkpoint's keys, in ``tree_leaves``' order."""
    flat: Dict[str, Any] = {}
    _map_with_path(flat.__setitem__, tree)
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: str, *, params, opt_state=None, step: int = 0,
         extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint write; returns the final directory."""
    path = Path(path)
    final = path / f"step_{step:08d}"
    tmp = path / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    blobs = {}
    for prefix, tree in (("params", params), ("opt", opt_state or {})):
        for k, v in flatten(tree).items():
            blobs[f"{prefix}/{k}"] = _to_numpy(v)
    np.savez(tmp / "tensors.npz", **blobs)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(blobs),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # prune stale tmp dirs from crashed writers
    for stale in path.glob(".tmp_step_*"):
        shutil.rmtree(stale, ignore_errors=True)
    return str(final)


def latest_step(path: str) -> Optional[int]:
    p = Path(path)
    if not p.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in p.glob("step_*")]
    return max(steps) if steps else None


def restore(path: str, *, params_like, opt_like=None, shardings=None,
            opt_shardings=None, device=None, step: Optional[int] = None
            ) -> Tuple[Any, Any, int, Dict]:
    """Load a checkpoint (the latest unless ``step`` is given) as new trees
    of the ``*_like`` trees' structure and dtypes, each tensor on ``device``
    (default: its ``like`` tensor's device).  Returns ``(params, opt_state,
    step, extra)``."""
    if shardings is not None or opt_shardings is not None:
        raise NotImplementedError("restoring onto shardings waits for the "
                                  "multi-device slice")
    p = Path(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = p / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    with np.load(d / "tensors.npz") as blobs:
        def rebuild(tree, prefix):
            def leaf(key, like):
                return torch.from_numpy(blobs[f"{prefix}/{key}"]).to(
                    device=device if device is not None else like.device,
                    dtype=like.dtype)
            return _map_with_path(leaf, tree)

        params = rebuild(params_like, "params")
        opt = rebuild(opt_like, "opt") if opt_like is not None else None
    return params, opt, step, manifest.get("extra", {})
