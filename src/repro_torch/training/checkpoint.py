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
restore.

Elastic resharding, as the reference's: a tree of DTensors is saved whole
(each leaf's ``full_tensor()``, every rank taking part; global rank 0
writes), and ``restore`` places each leaf onto the placements of a *target*
mesh, so a checkpoint taken on (8,) loads onto (2, 4) or onto one device.
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.convert import place


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
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: str, *, params, opt_state=None, step: int = 0,
         extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint write; returns the final directory.  With DTensor
    leaves every rank must call it: each gathers the full tensors, global
    rank 0 writes, and all wait for the write."""
    path = Path(path)
    final = path / f"step_{step:08d}"
    blobs = {}
    for prefix, tree in (("params", params), ("opt", opt_state or {})):
        for k, v in flatten(tree).items():
            blobs[f"{prefix}/{k}"] = _to_numpy(v)
    sharded = any(isinstance(v, DTensor)
                  for tree in (params, opt_state or {}) for v in flatten(tree).values())
    if not sharded or dist.get_rank() == 0:
        _write(path, final, step, blobs, extra)
    if sharded:
        dist.barrier()
    return str(final)


def _write(path: Path, final: Path, step: int, blobs, extra) -> None:
    tmp = path / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
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


def _at(tree, key: str):
    """The entry of ``tree`` at checkpoint key ``key`` (a placement tuple is
    a leaf here, not a branch)."""
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


def latest_step(path: str) -> Optional[int]:
    p = Path(path)
    if not p.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in p.glob("step_*")]
    return max(steps) if steps else None


def restore(path: str, *, params_like, opt_like=None, shardings=None,
            opt_shardings=None, mesh=None, device=None,
            step: Optional[int] = None) -> Tuple[Any, Any, int, Dict]:
    """Load a checkpoint (the latest unless ``step`` is given) as new trees
    of the ``*_like`` trees' structure and dtypes (tensors, or
    ``TensorSpec``s), each tensor on ``device`` (default: its ``like``
    tensor's device, else the CPU).  ``shardings``/``opt_shardings``: trees of
    placements on the target ``mesh`` (``AxisRules(mesh).placement_tree``),
    matching ``params_like``/``opt_like``; each such leaf is placed from the
    full array onto the mesh's device.  Returns ``(params, opt_state, step,
    extra)``."""
    if (shardings is not None or opt_shardings is not None) and mesh is None:
        raise ValueError("shardings are placements on a mesh: pass mesh=")
    p = Path(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = p / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    with np.load(d / "tensors.npz") as blobs:
        def rebuild(tree, prefix, shard_tree):
            def leaf(key, like):
                t = torch.from_numpy(blobs[f"{prefix}/{key}"])
                if shard_tree is not None:
                    return place(t.to(device=mesh.device_type, dtype=like.dtype),
                                 mesh, _at(shard_tree, key))
                dev = device if device is not None else getattr(like, "device", "cpu")
                return t.to(device=dev, dtype=like.dtype)
            return _map_with_path(leaf, tree)

        params = rebuild(params_like, "params", shardings)
        opt = (rebuild(opt_like, "opt", opt_shardings)
               if opt_like is not None else None)
    return params, opt, step, manifest.get("extra", {})
