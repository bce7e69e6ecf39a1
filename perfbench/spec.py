"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root is the index: its ``workloads``
name the cells, its metrics say which cell reports what.  Everything else is
a file of its own, found by the name the index gives: ``cells/<cell>.json``
(a configuration, a traffic mix, the limits that decide ``correct``),
``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py``.  Adding a cell, a mix, a configuration or a metric
adds files and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str, base: Path = HERE) -> dict:
    return _json(base / "configs" / f"{name}.json")


def load_traffic(name: str, base: Path = HERE) -> dict:
    return _json(base / "traffic" / f"{name}.json")


def load_metric(name: str, base: Path = HERE) -> ModuleType:
    """The reader ``metrics/<name>.py``: ``LAYER``, ``UNIT``, ``MOVES`` and
    ``read(window) -> float | None``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_shapes(cfg: dict) -> Dict:
    """The sizes the counts and the reference read, from a configuration
    file (the source's own keys, as run)."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return {
        "d": d, "H": H, "K": cfg["num_key_value_heads"],
        "hd": cfg.get("head_dim") or d // H,
        "L": cfg["num_hidden_layers"], "V": cfg["vocab_size"],
        "ff": cfg["intermediate_size"], "theta": float(cfg["rope_theta"]),
        "eps": float(cfg["rms_norm_eps"]),
        "window": int(cfg["serving"].get("attention_window", 0)),
        "E": int(cfg.get("num_local_experts", 0)),
        "k": int(cfg.get("num_experts_per_tok", 0)),
        "capacity_factor": float(cfg["serving"].get("moe_capacity_factor", 0.0)),
        "dtype_bytes": {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["dtype"]],
    }


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    base: Path = HERE           # where its metric readers are found


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric with no ``workloads`` is reported by every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files read from
    ``root/perfbench``."""
    base = root / "perfbench"
    index = _json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in index["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = _json(base / "cells" / f"{name}.json")
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise ValueError(f"cells/{name}.json names {key} {own[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    e2e = [m for m in index["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in index["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, config=load_config(own["config"], base),
                traffic=load_traffic(own["traffic"], base), limits=own["limits"],
                chips=int(entry["chips"]), end_to_end=e2e, per_layer=per_layer,
                base=base)
