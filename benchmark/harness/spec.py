"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<mix>`` joins ``configs/<config>.json``, the traffic mix
``traffic/<mix>.json`` (whose ``driver`` names the module under
``drivers/`` that runs it) and ``limits/<cell>.json`` (the limit of each
number its correctness check compares).  A per-layer metric is read by
``metrics/<metric>.py``.  Adding a cell, a configuration, a mix or a
metric is adding files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    root: Path = ROOT

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files read."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        mix=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json")["limits"],
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        root=root,
    )


def _load_module(path: Path, modname: str):
    """The module at ``path`` (whose file name may hold dots), loaded once
    under ``modname``."""
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(ctx) -> float | dict | None`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    return _load_module(path, _modname("bench_metric", root, name)).read


def driver_module(driver: str, root: Path = ROOT):
    """The module ``benchmark/drivers/<driver>.py``: ``setup``, ``window``,
    ``check``."""
    return _load_module(root / "benchmark" / "drivers" / f"{driver}.py",
                        _modname("bench_driver", root, driver))


def _modname(kind: str, root: Path, name: str) -> str:
    """A module name unique to the checkout and the file."""
    tag = "".join(c if c.isalnum() else "_" for c in f"{root}_{name}")
    return f"{kind}_{tag}"
