"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root is the index: its ``workloads``
name the cells, its metrics say which cell reports what.  Everything else is
a file of its own, found by the name the index gives: ``cells/<cell>.json``
(a configuration, a traffic mix, the limits that decide ``correct``),
``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py``.  A configuration names its architecture, its
``"arch"``: the family module ``arch/<family>.py`` (its shapes, weight
layout, the engine's config, the counts), whose plain reference is
``reference/<family>.py``.  Adding a cell, a mix, a configuration, an
architecture or a metric adds files and edits none.
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


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path``, executed as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, base: Path = HERE) -> ModuleType:
    """The reader ``metrics/<name>.py``: ``LAYER``, ``UNIT``, ``MOVES`` and
    ``read(window) -> float | None``."""
    return load_module(base / "metrics" / f"{name}.py", "perfbench_metric_" + name)


# What every family module ``arch/<family>.py`` defines, each a plain
# function documented there.  The counts are those ``counts.py`` hands on.
INTERFACE = ("shapes", "layer_leaves", "outer_leaves", "port_config", "served_logits",
             "prefill_flops", "decode_token_flops", "decode_step_weight_bytes",
             "decode_kv_bytes", "weight_params", "kv_bytes_per_position")

_LOADED: Dict[Path, ModuleType] = {}      # family modules by file
_FAMILIES: Dict[str, ModuleType] = {}     # by name: the one a configuration last loaded


def load_arch(name: str, base: Path = HERE) -> ModuleType:
    """The family module ``arch/<name>.py`` of ``base``, refused where it
    is missing or lacks a function of ``INTERFACE``.  It becomes the family
    that ``family`` finds under ``name``."""
    path = (base / "arch" / f"{name}.py").resolve()
    if Path(name).name != name or not path.is_file():
        raise ValueError(f"no architecture family {name!r}: arch/{name}.py is missing")
    if path not in _LOADED:
        mod = load_module(path, "perfbench_arch_" + name)
        missing = [f for f in INTERFACE if not callable(getattr(mod, f, None))]
        if missing:
            raise ValueError(f"arch/{name}.py does not define {', '.join(missing)}")
        _LOADED[path] = mod
    _FAMILIES[name] = _LOADED[path]
    return _LOADED[path]


def config_family(cfg: dict, base: Path = HERE) -> ModuleType:
    """The family module a configuration names by its ``"arch"``; a
    configuration that names none is refused: there is no default."""
    name = cfg.get("arch")
    if not name:
        raise ValueError(f"configuration {cfg.get('name')!r} names no architecture: "
                         f'give it "arch": "<family>", the module arch/<family>.py')
    return load_arch(name, base)


def model_shapes(cfg: dict, base: Path = HERE) -> Dict:
    """The sizes the counts, the weights and the reference read: the
    family's ``shapes`` of a configuration file, with ``"arch"``, the
    family's name, added."""
    return dict(config_family(cfg, base).shapes(cfg), arch=cfg["arch"])


def family(m: Dict) -> ModuleType:
    """The family module of shapes ``m`` (``model_shapes``): the one last
    loaded under ``m["arch"]``, so that of the configuration being run,
    else this folder's."""
    return _FAMILIES.get(m["arch"]) or load_arch(m["arch"])


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
    config = load_config(own["config"], base)
    config_family(config, base)
    return Cell(name=name, config=config,
                traffic=load_traffic(own["traffic"], base), limits=own["limits"],
                chips=int(entry["chips"]), end_to_end=e2e, per_layer=per_layer,
                base=base)
