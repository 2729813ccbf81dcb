"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells; the files of a
cell's configuration, traffic mix and limits, and the readers of the
per-layer metrics, sit in files of their own under this folder:

- ``configs/<config>.json``: the catalogue (``file`` in ``BENCHMARK.json``);
- ``mixes/<traffic>.json``: the read model and coverage of one sample;
- ``limits/<cell>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: ``read(ctx)``, the metric's value or None;
- ``<generator>.py`` and ``<reference>.py``: the configuration's inputs and
  its plain reference, named by the configuration file's optional keys
  ``"generator"`` and ``"reference"`` (a module's stem: letters, digits and
  ``_``; by default ``gen`` and ``reference``), imported as
  ``benchmark.<stem>`` and put on the cell as ``cell.gen`` and
  ``cell.reference``.

A new cell, mix, metric or configuration is a new file and a new entry; no
code changes. What ``run.py``, ``calibrate.py`` and the control's test
(``tests/test_bm_control.py``) call of a configuration's modules, and
nothing more:

- the generator: ``make_catalogue(cfg, seed)``, an object with
  ``fasta_dict()`` (any number of chromosomes) and ``write_vcf(path)``;
  ``make_sample(cat, mix, seed, fastq_path)``, an object with ``n_bases``;
- the reference: ``truth_counts(cat, sample, d_over)``,
  ``reference_counts(vcf_text, truth)``,
  ``expected_columns(vcf_text, raw, min_support, err[, halve])``,
  ``compare(vcf_text, job_vcf, job_raw, ref_cols, min_support, err)``,
  ``control_vcf(vcf_text, raw, min_support, err)`` and
  ``vcf_records(text)``.

Neither imports JAX, ``svjedi_tpu`` or ``svjedi_tpu_torch``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: A module's stem as a configuration names it.
STEM = re.compile(r"[A-Za-z0-9_]+")
#: The modules of a configuration that names none.
DEFAULT_MODULES = {"generator": "gen", "reference": "reference"}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    gen: ModuleType
    reference: ModuleType


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
    gen, reference = (config_module(config, key, root)
                      for key in ("generator", "reference"))
    mix = load_json(root / "benchmark" / "mixes" / f"{w['traffic']}.json")
    mix["name"] = w["traffic"]
    limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        gen=gen, reference=reference,
    )


def config_module(config: dict, key: str, root: Path = ROOT) -> ModuleType:
    """The module that ``config`` names under ``key`` (``"generator"`` or
    ``"reference"``), ``root/benchmark/<stem>.py``, as
    ``benchmark.<stem>``. An unknown or missing module raises with its
    name before any set-up."""
    stem = config.get(key, DEFAULT_MODULES[key])
    path = root / "benchmark" / f"{stem}.py"
    if not isinstance(stem, str) or not STEM.fullmatch(stem) \
            or not path.is_file():
        raise ModuleNotFoundError(
            f"configuration {config['name']!r} names {key} {stem!r}, which "
            f"is not a module file under {root / 'benchmark'}", name=stem)
    name = f"benchmark.{stem}"
    if path.parent.resolve() == HERE:
        return importlib.import_module(name)
    # Another checkout's folder: its file under the same name, so that a
    # relative import (``from .gen import ...``) still finds the package.
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``root/benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    module_name = "benchmark_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
