"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells; the files of a
cell's configuration, traffic mix and limits, and the readers of the
per-layer metrics, sit in files of their own under this folder:

- ``configs/<config>.json``: the catalogue (``file`` in ``BENCHMARK.json``);
- ``mixes/<traffic>.json``: the read model and coverage of one sample;
- ``limits/<cell>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: ``read(ctx)``, the metric's value or None.

A new cell, mix or metric is a new file and a new entry; no code changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, found
    under ``root/benchmark``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    config["name"] = w["config"]
    mix = load_json(root / "benchmark" / "mixes" / f"{w['traffic']}.json")
    mix["name"] = w["traffic"]
    limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``root/benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    module_name = "benchmark_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
