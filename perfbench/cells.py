"""A cell of ``BENCHMARK.json`` resolved by name to its files.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in files of its own, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``. A new cell, mix or
metric is new files and new entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # ... and with --trace 1
    readers: Dict[str, Callable]  # per-layer metric name -> read(ctx)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, search) -> Path:
    """``<dir>/<kind>/<name>`` in the first of the ``search`` directories
    that holds it."""
    for d in search:
        path = Path(d) / kind / name
        if path.exists():
            return path
    raise FileNotFoundError(f"{kind}/{name} in none of {[str(d) for d in search]}")


def metric_reader(name: str, search=(HERE,)) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = find("metrics", f"{name}.py", search)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None, search=(HERE,)) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``BENCHMARK.json`` at the
    checkout's root), its files looked up in the ``search`` directories."""
    if bench is None:
        bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    config = load_json(find("configs", f"{w['config']}.json", search))
    traffic = load_json(find("traffic", f"{w['traffic']}.json", search))
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, name)]
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
        per_layer=per_layer,
        readers={m["name"]: metric_reader(m["name"], search)
                 for m in per_layer},
    )
